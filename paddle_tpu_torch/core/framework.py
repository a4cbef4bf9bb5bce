"""Graph IR: Program / Block / Operator / Variable.

Counterpart of paddle_tpu/core/framework.py.  The IR is the same pure-Python
structure, so a program serializes to the same desc in both packages
(io.program_to_desc).  Shape inference runs each op's torch impl on `meta`
tensors with two trial batch sizes: output dims that differ between the two
runs are batch dims (-1), exactly as the JAX package does with
`jax.eval_shape`.

The port carries what the serving and training slices need: Variable's
arithmetic operators (the LR schedules use them), op roles, bf16 AMP and
the version counter the rewriter's memo keys on (`Program._version`,
bumped by `append_op`, `create_var`, `create_parameter` and `set_amp`);
no imperative mode, no recompute scopes, and no lint.  Sharding specs,
the mesh, the device limit and the KV plan ride along as opaque JSON so a
desc survives a round trip through the port.
"""
import contextlib
import copy
import os
import sys

import torch

from . import registry
from . import unique_name
from .dtypes import dtype_str, torch_dtype

__all__ = [
    'Program', 'Block', 'Operator', 'Variable', 'Parameter', 'program_guard',
    'default_main_program', 'default_startup_program', 'switch_main_program',
    'switch_startup_program', 'CPUPlace', 'CUDAPlace', 'OpRole',
    'op_role_guard',
]

# ---------------------------------------------------------------- places


class Place(object):
    """Device spec with an explicit torch device."""

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))


class CPUPlace(Place):
    @property
    def device(self):
        return torch.device('cpu')


class CUDAPlace(Place):
    @property
    def device(self):
        return torch.device('cuda', self.device_id)


def require_cuda(what):
    """Entry points run on the card unless the caller asked for the CPU;
    with no card they refuse instead of carrying on on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            '%s runs on a CUDA device and none is available; pass '
            'CPUPlace() (or AnalysisConfig.disable_gpu()) to run on the '
            'CPU' % what)


# ---------------------------------------------------------------- op role

class OpRole(object):
    Forward = 'forward'
    Backward = 'backward'
    Optimize = 'optimize'
    LRSched = 'lr_sched'
    Loss = 'loss'


_current_role = [OpRole.Forward]


@contextlib.contextmanager
def op_role_guard(role):
    _current_role.append(role)
    try:
        yield
    finally:
        _current_role.pop()


# ---------------------------------------------------------------- Variable

class Variable(object):
    """A named tensor in a Block; `shape` uses -1 for the batch dim."""

    def __init__(self, block, name=None, shape=None, dtype='float32',
                 lod_level=0, persistable=False, stop_gradient=False,
                 is_data=False, type=None, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate('_generated_var')
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_str(dtype) if dtype is not None else None
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type or 'lod_tensor'
        # sharding spec in the JAX package's JSON form, carried opaquely
        self.sharding = None
        self.op = None  # producer op

    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def to_string(self, throw_on_error=False, with_details=False):
        return "var %s : shape=%s dtype=%s lod=%d%s" % (
            self.name, self.shape, self.dtype, self.lod_level,
            ' persistable' if self.persistable else '')

    __repr__ = __str__ = lambda self: self.to_string()

    # -------- math operators (the JAX package's math-op patch) --------
    def _cur_block(self):
        # ops emit into the program's current block, not the var's home
        return self.block.program.current_block()

    def _binary(self, other, op_type, reverse=False):
        block = self._cur_block()
        if isinstance(other, Variable):
            x, y = (other, self) if reverse else (self, other)
            out = block.create_var(dtype=self.dtype)
            block.append_op(type=op_type, inputs={'X': x, 'Y': y},
                            outputs={'Out': out}, attrs={'axis': -1})
            return out
        # scalar: add, sub and mul become one scale op
        v = float(other)
        if op_type == 'elementwise_add':
            return self._scale(1.0, v)
        if op_type == 'elementwise_sub':
            if reverse:
                return self._scale(-1.0, v)
            return self._scale(1.0, -v)
        if op_type == 'elementwise_mul':
            return self._scale(v, 0.0)
        # div and pow materialize a [1] constant
        out = block.create_var(dtype=self.dtype)
        const = block.create_var(dtype=self.dtype)
        block.append_op(type='fill_constant', inputs={},
                        outputs={'Out': const},
                        attrs={'shape': [1], 'value': v, 'dtype': self.dtype})
        x, y = (const, self) if reverse else (self, const)
        block.append_op(type=op_type, inputs={'X': x, 'Y': y},
                        outputs={'Out': out}, attrs={'axis': -1})
        return out

    def _scale(self, scale, bias):
        blk = self._cur_block()
        out = blk.create_var(dtype=self.dtype)
        blk.append_op(type='scale', inputs={'X': self}, outputs={'Out': out},
                      attrs={'scale': float(scale), 'bias': float(bias),
                             'bias_after_scale': True})
        return out

    def __add__(self, o):
        return self._binary(o, 'elementwise_add')

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, 'elementwise_sub')

    def __rsub__(self, o):
        return self._binary(o, 'elementwise_sub', reverse=True)

    def __mul__(self, o):
        return self._binary(o, 'elementwise_mul')

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, 'elementwise_div')

    def __rtruediv__(self, o):
        return self._binary(o, 'elementwise_div', reverse=True)

    def __pow__(self, o):
        return self._binary(o, 'elementwise_pow')

    def __rpow__(self, o):
        return self._binary(o, 'elementwise_pow', reverse=True)

    def __neg__(self):
        return self._scale(-1.0, 0.0)

    def _cmp(self, other, op_type):
        blk = self._cur_block()
        out = blk.create_var(dtype='bool')
        other = other if isinstance(other, Variable) else \
            _const_like(self, other)
        blk.append_op(type=op_type, inputs={'X': self, 'Y': other},
                      outputs={'Out': out}, attrs={})
        return out

    def __lt__(self, o):
        return self._cmp(o, 'less_than')

    def __le__(self, o):
        return self._cmp(o, 'less_equal')

    def __gt__(self, o):
        return self._cmp(o, 'greater_than')

    def __ge__(self, o):
        return self._cmp(o, 'greater_equal')


def _const_like(var, value):
    """A [1] fill_constant of `value` in var's dtype, in var's block (the
    reference's)."""
    const = var.block.create_var(dtype=var.dtype)
    var.block.append_op(type='fill_constant', inputs={},
                        outputs={'Out': const},
                        attrs={'shape': [1], 'value': float(value),
                               'dtype': var.dtype})
    return const


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop('trainable', True)
        self.optimize_attr = kwargs.pop('optimize_attr', {'learning_rate': 1.0})
        self.regularizer = kwargs.pop('regularizer', None)
        self.gradient_clip_attr = kwargs.pop('gradient_clip_attr', None)
        self.do_model_average = kwargs.pop('do_model_average', None)
        self.is_distributed = kwargs.pop('is_distributed', False)
        super(Parameter, self).__init__(
            block, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=False, **kwargs)


# ---------------------------------------------------------------- Operator

# Each Operator remembers the (file, line) of the model code that built it.
# Frames inside the package are skipped, except the bundled models.
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODELS_DIR = os.path.join(_PKG_DIR, 'models')


def _capture_source_loc():
    try:
        f = sys._getframe(2)
    except ValueError:
        return None
    depth = 0
    while f is not None and depth < 32:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR) or fn.startswith(_MODELS_DIR):
            return (fn, f.f_lineno)
        f = f.f_back
        depth += 1
    return None


class Operator(object):
    """One node in a Block: op type + named input/output slots + attrs.
    `type` keys into core/registry.py for the torch impl."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.source_loc = _capture_source_loc()
        self.attrs = dict(attrs or {})
        self.attrs.setdefault('op_role', _current_role[-1])
        self.inputs = {}        # slot -> list[str]
        self.outputs = {}       # slot -> list[str]
        self.input_is_list = {}
        self.output_is_list = {}
        for slot, vs in (inputs or {}).items():
            if vs is None:
                continue
            self.input_is_list[slot] = isinstance(vs, (list, tuple))
            vs = vs if isinstance(vs, (list, tuple)) else [vs]
            self.inputs[slot] = [v.name if isinstance(v, Variable) else v
                                 for v in vs]
        for slot, vs in (outputs or {}).items():
            if vs is None:
                continue
            self.output_is_list[slot] = isinstance(vs, (list, tuple))
            vs = vs if isinstance(vs, (list, tuple)) else [vs]
            self.outputs[slot] = [v.name if isinstance(v, Variable) else v
                                  for v in vs]

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def attr(self, name):
        return self.attrs.get(name)

    def to_string(self, *a, **k):
        ats = {k: v for k, v in self.attrs.items() if k != 'op_role'}
        return "{%s} = %s(%s) %s" % (self.outputs, self.type, self.inputs,
                                     ats)

    __repr__ = __str__ = lambda self: self.to_string()


# ---------------------------------------------------------------- Block

_INFER_B1, _INFER_B2 = 7, 11


class Block(object):
    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent(self):
        return (self.program.blocks[self.parent_idx]
                if self.parent_idx >= 0 else None)

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("var %s not found in block %d" % (name, self.idx))
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        return None

    def create_var(self, name=None, **kwargs):
        if name is None:
            name = unique_name.generate('_generated_var')
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name=name, **kwargs)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name=None, shape=None, dtype='float32', **kw):
        if name is None:
            name = unique_name.generate('_param')
        # parameters always live in the root block, as in the JAX package
        root = self.program.blocks[0]
        p = Parameter(root, shape=shape, dtype=dtype, name=name, **kw)
        root.vars[name] = p
        self.program._bump()
        return p

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump()
        for n in op.output_names():
            ov = self._find_var_recursive(n)
            if ov is not None:
                ov.op = op
        if infer_shape and registry.has_op(type):
            self._infer_shapes(op)
        return op

    def _infer_shapes(self, op):
        """Dual-batch abstract eval: run the op's torch impl on meta
        tensors with batch placeholder 7 and again with 11; output dims
        that differ between the two runs are batch dims (-1)."""
        impl = registry.get_op(op.type)
        results = []
        for B in (_INFER_B1, _INFER_B2):
            ins = {}
            for slot, names in op.inputs.items():
                metas = []
                for n in names:
                    v = self._find_var_recursive(n)
                    if v is None or v.shape is None:
                        return  # shapeless input: leave the outputs as-is
                    shape = tuple(B if d in (-1, None) else int(d)
                                  for d in v.shape)
                    metas.append(torch.empty(shape, dtype=torch_dtype(v.dtype),
                                             device='meta'))
                ins[slot] = metas if op.input_is_list[slot] else metas[0]
            try:
                out = impl(registry.InferCtx(op), ins, op.attrs)
            except Exception as e:
                raise RuntimeError(
                    "shape inference failed for op %s: %s\n%s" %
                    (op.type, e, op.to_string()))
            results.append(out)
        r1, r2 = results
        for slot, names in op.outputs.items():
            o1, o2 = r1.get(slot), r2.get(slot)
            if o1 is None:
                continue
            l1 = o1 if isinstance(o1, (list, tuple)) else [o1]
            l2 = o2 if isinstance(o2, (list, tuple)) else [o2]
            for n, s1, s2 in zip(names, l1, l2):
                v = self._find_var_recursive(n)
                if v is None:
                    continue
                v.shape = tuple(int(a) if a == b else -1
                                for a, b in zip(s1.shape, s2.shape))
                v.dtype = dtype_str(s1.dtype)

    def to_string(self, throw_on_error=False, with_details=False):
        lines = ["block %d:" % self.idx]
        lines += ["  " + v.to_string() for v in self.vars.values()]
        lines += ["  " + op.to_string() for op in self.ops]
        return "\n".join(lines)

    __repr__ = __str__ = lambda self: self.to_string()


# ---------------------------------------------------------------- Program

class Program(object):
    """An ordered collection of Blocks."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        # carried through a desc round trip; the serving slice reads none
        self._mesh_axes = None
        self._device_limit_bytes = None
        self._kv_plan = None
        self._amp = False
        # bumped on every change made through the builder API; the
        # rewriter's memo (core/passes) keys on it
        self._version = 0

    def _bump(self):
        self._version += 1

    def set_amp(self, flag=True):
        """bf16 auto-mixed precision: matrix-product ops run on bfloat16
        inputs, everything else stays float32 (core/executor.py has the
        policy)."""
        self._amp = bool(flag)
        self._bump()

    def set_kv_plan(self, **cache_config_kwargs):
        """Declare the serving KV-cache pool this program runs against
        (the JAX package's memplan lint reads it)."""
        self._kv_plan = dict(cache_config_kwargs) or None

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def block(self, idx):
        return self.blocks[idx]

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    def all_parameters(self):
        return self.global_block().all_parameters()

    @property
    def num_blocks(self):
        return len(self.blocks)

    def clone(self, for_test=False):
        """Deep-copy the program.  for_test=True keeps only forward ops and
        flips is_test attrs on."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                if isinstance(v, Parameter):
                    nv = Parameter(nb, shape=v.shape, dtype=v.dtype, name=name,
                                   trainable=v.trainable,
                                   optimize_attr=v.optimize_attr,
                                   regularizer=v.regularizer,
                                   gradient_clip_attr=v.gradient_clip_attr)
                else:
                    nv = Variable(nb, name=name, shape=v.shape, dtype=v.dtype,
                                  lod_level=v.lod_level,
                                  persistable=v.persistable,
                                  stop_gradient=v.stop_gradient,
                                  is_data=v.is_data, type=v.type)
                nv.sharding = copy.deepcopy(v.sharding)
                # a ragged var's lengths companion (layers/io.py data)
                for attr in ('lod_length_name', 'lod_outer_length_name'):
                    if getattr(v, attr, None):
                        setattr(nv, attr, getattr(v, attr))
                nb.vars[name] = nv
            for op in b.ops:
                role = op.attrs.get('op_role', OpRole.Forward)
                if for_test and role in (OpRole.Backward, OpRole.Optimize,
                                         OpRole.LRSched):
                    continue
                nattrs = copy.deepcopy(op.attrs)
                if for_test and 'is_test' in nattrs:
                    nattrs['is_test'] = True
                nop = Operator(nb, op.type)
                nop.attrs = nattrs
                nop.source_loc = op.source_loc
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nop.input_is_list = dict(op.input_is_list)
                nop.output_is_list = dict(op.output_is_list)
                nb.ops.append(nop)
            p.blocks.append(nb)
        p._mesh_axes = self._mesh_axes
        p._device_limit_bytes = self._device_limit_bytes
        p._kv_plan = dict(self._kv_plan) if self._kv_plan else None
        return p

    def _prune(self, feeds, fetches):
        """A clone keeping only the ops needed to compute `fetches` from
        `feeds` (used by save_inference_model)."""
        feed_names = set(v.name if isinstance(v, Variable) else v
                         for v in feeds)
        fetch_names = set(v.name if isinstance(v, Variable) else v
                          for v in fetches)
        p = self.clone(for_test=True)
        b = p.global_block()
        needed = set(fetch_names)
        kept = []
        for op in reversed(b.ops):
            if set(op.output_names()) & needed:
                kept.append(op)
                for n in op.input_names():
                    if n not in feed_names:
                        needed.add(n)
        b.ops = list(reversed(kept))
        used = set(feed_names) | set(fetch_names)
        for op in b.ops:
            used.update(op.input_names())
            used.update(op.output_names())
        b.vars = {n: v for n, v in b.vars.items() if n in used}
        return p

    def to_string(self, throw_on_error=False, with_details=False):
        return "\n".join(b.to_string() for b in self.blocks)

    __repr__ = __str__ = lambda self: self.to_string()


# ------------------------------------------------- default program stack

_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    old = _main_program
    _main_program = program
    return old


def switch_startup_program(program):
    global _startup_program
    old = _startup_program
    _startup_program = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_start = None
    if startup_program is not None:
        old_start = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_start is not None:
            switch_startup_program(old_start)
