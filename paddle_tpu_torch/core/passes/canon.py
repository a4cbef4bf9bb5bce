"""Attr canonicalization: make the program desc say what the device does.

Counterpart of paddle_tpu/core/passes/canon.py.  64-bit dtype attrs
narrow to their 32-bit twins: the port computes every 64-bit value in 32
bits (core/dtypes.py::torch_dtype), as the JAX package does with x64
disabled, so this is descriptive only.  numpy scalar attrs become Python
numbers.  The reference's second rule, a loop body's initializer
rewritten to an `assign` of an ancestor block's identical constant,
needs sub-blocks, which the port does not have yet; it reports 0.
"""
import numpy as np

__all__ = ['run']

_DTYPE_ATTRS = ('dtype', 'in_dtype', 'out_dtype')
_NARROW = {'int64': 'int32', 'uint64': 'uint32', 'float64': 'float32',
           'complex128': 'complex64'}


def _narrow_attrs(program, stats):
    for block in program.blocks:
        for op in block.ops:
            attr_dicts = [op.attrs]
            # fused sub-programs carry their own attr dicts
            for sub in op.attrs.get('sub_ops') or ():
                attr_dicts.append(sub['attrs'])
            for attrs in attr_dicts:
                for key in _DTYPE_ATTRS:
                    v = attrs.get(key)
                    name = v if isinstance(v, str) else (
                        np.dtype(v).name if v is not None else None)
                    if name in _NARROW:
                        attrs[key] = _NARROW[name]
                        stats['attrs_narrowed'] += 1
                        program._bump()
                # np scalar attrs: normalize so desc json and attr
                # hashing are width-stable
                for k, v in list(attrs.items()):
                    if isinstance(v, np.integer):
                        attrs[k] = int(v)
                    elif isinstance(v, np.floating):
                        attrs[k] = float(v)


def run(program, ctx):
    stats = {'attrs_narrowed': 0, 'initializers_deduped': 0}
    _narrow_attrs(program, stats)
    return stats
