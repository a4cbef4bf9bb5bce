"""Constant folding: collapse compile-time-constant op chains into single
``fill_constant`` ops.

Counterpart of paddle_tpu/core/passes/const_fold.py.  `fill_constant`
(and `assign` of one) seeds the constant environment; whitelisted pure
elementwise ops whose inputs are ALL known constants are evaluated at
optimize time through the op's own registered impl, on the CPU, on
tensors materialized as `fill_constant` materializes them, so the folded
value is dtype-exact.  Only uniform results fold (a fill_constant can
represent nothing else).  Producers a folded chain no longer reads are
swept by the DCE helper.
"""
import torch

from . import dce

__all__ = ['run', 'FOLDABLE_OPS']

# pure ops safe to evaluate on the host at optimize time
FOLDABLE_OPS = {
    'scale', 'cast', 'elementwise_add', 'elementwise_sub',
    'elementwise_mul', 'elementwise_div', 'elementwise_pow',
    'elementwise_max', 'elementwise_min', 'sqrt', 'rsqrt', 'abs',
    'square', 'sign', 'floor', 'ceil', 'round', 'reciprocal', 'exp',
    'log', 'clip', 'pow', 'sigmoid', 'tanh', 'relu',
}

# don't materialize huge arrays on the host just to prove them uniform
_MAX_FOLD_ELEMS = 1 << 16


class _FoldCtx(object):
    """Exec ctx for host evaluation: foldable ops draw no random numbers."""
    is_infer = False
    amp = False
    device = torch.device('cpu')

    def generator(self, seed=0):
        return None

    def wants(self, slot):
        return True


def _const_value(op):
    """(value, shape, dtype) when `op` is a representable constant."""
    if op.type != 'fill_constant':
        return None
    shape = [int(d) for d in op.attrs.get('shape', [])]
    if any(d < 0 for d in shape):
        return None
    return (op.attrs.get('value', 0.0), tuple(shape),
            op.attrs.get('dtype', 'float32'))


def _materialize(const):
    from ...ops.tensor import fill_constant
    value, shape, dtype = const
    return fill_constant(_FoldCtx(), {}, {'shape': list(shape),
                                          'value': value,
                                          'dtype': dtype})['Out']


def _eval_op(op, const_env):
    """Run the op's impl on the materialized constant inputs; returns the
    folded (value, shape, dtype) or None when the result can't be a
    fill_constant."""
    from .. import registry
    from ..dtypes import dtype_str
    impl = registry.get_op(op.type)
    ins = {}
    for slot, names in op.inputs.items():
        if any(max(1, _numel(const_env[n][1])) > _MAX_FOLD_ELEMS
               for n in names):
            return None
        vals = [_materialize(const_env[n]) for n in names]
        ins[slot] = vals if op.input_is_list[slot] else vals[0]
    try:
        outs = impl(_FoldCtx(), ins, op.attrs)
    except Exception:  # noqa: BLE001 - give up, leave the op in place
        return None
    out = outs.get('Out')
    if not isinstance(out, torch.Tensor):
        return None
    if out.numel() == 0 or out.numel() > _MAX_FOLD_ELEMS:
        return None
    flat = out.reshape(-1)
    first = flat[0]
    if not bool((flat == first).all()):  # NaN never folds (NaN != NaN)
        return None
    return (first.item(), tuple(int(d) for d in out.shape),
            dtype_str(out.dtype))


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def run(program, ctx):
    from .. import registry
    stats = {'ops_folded': 0, 'ops_removed': 0}
    multi = ctx.multi_written
    for block in program.blocks:
        const_env = {}
        for op in block.ops:
            outs = op.output_names()
            if any(n in multi for n in outs) or \
                    any(n in multi for n in op.input_names()):
                continue
            if any(n in ctx.persistable or n in ctx.cf_pinned
                   for n in outs):
                continue
            c = _const_value(op)
            if c is not None:
                const_env[outs[0]] = c
                continue
            if op.type == 'assign' and op.input_names() and \
                    op.input_names()[0] in const_env and len(outs) == 1:
                folded = const_env[op.input_names()[0]]
            elif (op.type in FOLDABLE_OPS and len(outs) == 1 and
                    registry.has_op(op.type) and op.input_names() and
                    all(n in const_env for n in op.input_names())):
                folded = _eval_op(op, const_env)
            else:
                continue
            if folded is None or folded[2] is None:
                continue
            value, shape, dtype = folded
            # rewrite IN PLACE into the single equivalent fill_constant;
            # source_loc and the output binding survive untouched
            op.type = 'fill_constant'
            op.inputs = {}
            op.input_is_list = {}
            keep = {k: op.attrs[k] for k in ('op_role', 'recompute_id',
                                             'rng_stream')
                    if k in op.attrs}
            op.attrs = dict(keep, shape=list(shape), value=value,
                            dtype=dtype)
            const_env[outs[0]] = (value, tuple(shape), dtype)
            stats['ops_folded'] += 1
            program._bump()
    if stats['ops_folded']:
        # producers a folded chain no longer reads are now dead
        dce.sweep_dead(program, ctx.fetch_names, stats,
                       pinned=ctx.cf_pinned)
    return stats
