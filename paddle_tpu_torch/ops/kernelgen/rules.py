"""KERNEL_RULES: how each fusable op runs inside a generated kernel.

Counterpart of paddle_tpu/ops/kernelgen/rules.py.  Where the reference
reuses each op's jnp impl on flat Pallas blocks, a CUDA kernel needs the
op written out in C++, so an `ew` rule here carries a template: a Python
function from the op's operand expressions (C++ expressions of one
element, each with its dtype after the AMP policy) to the C++ expression
of each output element.  Every template repeats its op's impl in
ops/{math,tensor,nn}.py operation by operation, in the same order and
in PyTorch's arithmetic: float32 math on float32 or bfloat16 values,
each PyTorch operation's result rounded to that operation's dtype
(`kg_rbf` rounds to bfloat16), IEEE intrinsics that the compiler cannot
contract into FMAs, a Python scalar converted to float32 first.  That
is what makes a generated kernel compute what the unfused ops compute.

Kinds:

``ew``
    Elementwise compute inside the kernel (`emit`).  ``bcast_y`` binary
    ops align Y by the fluid `axis` rule first (ops/math.py `_bcast_y`).
``layout``
    Zero-flop glue: a flat alias inside the kernel, or a view / an
    order-changing transpose between kernels.
``rng``
    Random draws happen outside the kernel, on the op's own generator
    and pinned stream (`dropout`'s mask rides in as one more operand;
    `uniform_random` / `gaussian_random` are whole-op draws), as the
    reference draws outside its Pallas kernels.
``row``
    softmax -> K5 (csrc/softmax.cu), layer_norm -> K6
    (csrc/layer_norm.cu): the registered op runs between kernels.
``attention``
    flash_attention -> K1 (csrc/flash_fwd.cu), the registered op.
``optimizer``
    consecutive in-place `adam` sub-ops with the same betas and epsilon
    -> one `adam_multi` call (csrc/adam.cu, K7's Adam instance).

Not carried over yet (ROADMAP): rules for the fusable ops the port does
not register (the other activations, comparisons, `label_smooth`, the
other optimizers).
"""
import numpy as np
import torch

__all__ = ['KERNEL_RULES', 'KRule', 'to_dtype', 'Unsupported']

FLOAT_DTYPES = ('float32', 'bfloat16')


class KRule(object):
    __slots__ = ('kind', 'emit', 'bcast_y', 'shape_only')

    def __init__(self, kind='ew', emit=None, bcast_y=False, shape_only=()):
        self.kind = kind              # ew|layout|rng|row|attention|optimizer
        self.emit = emit              # ew / rng: operand exprs -> outputs
        self.bcast_y = bcast_y        # binary op with _bcast_y(Y, axis)
        self.shape_only = shape_only  # slots read for shape, not data


KERNEL_RULES = {}


def _r(name, **kw):
    KERNEL_RULES[name] = KRule(**kw)


class Unsupported(Exception):
    """A template cannot express this op at these dtypes (the builder
    turns it into KernelgenUnsupported naming the sub-op)."""


# ---------------------------------------------------- expression helpers

def float_lit(v):
    """A float32 constant, bit-exact (NaN and inf included)."""
    bits = int(np.asarray(v, np.float32).view(np.uint32))
    return '__int_as_float(0x%08x)' % bits


def _f(e, dt):
    """Operand as a float32 compute value."""
    if dt in FLOAT_DTYPES:
        return e
    if dt == 'int32':
        return '((float)(%s))' % e
    raise Unsupported('dtype %s' % dt)


def to_dtype(e, frm, to):
    """A value of dtype `frm` converted to `to`, as a PyTorch conversion
    of a tensor does (bfloat16 values live in float32 registers); a float
    to int32 as the cast op (ops/math.py) does: the card's conversion
    (cvt.rzi) saturates and takes NaN to 0."""
    if to == frm:
        return e
    if to == 'int32':
        if frm in FLOAT_DTYPES:
            return '((int)(%s))' % e
        raise Unsupported('cast %s -> %s' % (frm, to))
    if to == 'float32':
        return _f(e, frm)
    if to == 'bfloat16':
        return 'kg_rbf(%s)' % _f(e, frm)
    raise Unsupported('dtype %s' % to)


def _rnd(e, dt):
    """A float32 result of one PyTorch operation, stored in `dt`."""
    if dt == 'float32':
        return e
    if dt == 'bfloat16':
        return 'kg_rbf(%s)' % e
    raise Unsupported('dtype %s' % dt)


def _scalar_dt(dt):
    # tensor (op) Python float: a float tensor keeps its dtype, an
    # integer tensor promotes to float32
    return dt if dt in FLOAT_DTYPES else 'float32'


def _const(value, dtype):
    """The element of a fill of `value` in `dtype`, as ops/tensor.py's
    `_full` makes it."""
    from ..tensor import _fill_value
    from ...core.dtypes import NARROW
    name = NARROW.get(dtype, dtype)
    if name not in ('float32', 'bfloat16', 'int32'):
        raise Unsupported('fill dtype %s' % dtype)
    v = _fill_value(value, name)
    t = torch.full((), v, dtype=getattr(torch, name))
    if name == 'int32':
        return '(%d)' % int(t)
    return float_lit(float(t.float()))


# ------------------------------------------------------- ew templates

_F_BIN = {'elementwise_add': '__fadd_rn(%s, %s)',
          'elementwise_sub': '__fsub_rn(%s, %s)',
          'elementwise_mul': '__fmul_rn(%s, %s)',
          'elementwise_div': '__fdiv_rn(%s, %s)',
          'elementwise_pow': 'powf(%s, %s)',
          'elementwise_min': 'kg_nanmin(%s, %s)',
          'elementwise_max': 'kg_nanmax(%s, %s)'}
_I_BIN = {'elementwise_add': '(%s + %s)',
          'elementwise_sub': '(%s - %s)',
          'elementwise_mul': '(%s * %s)',
          'elementwise_min': 'min(%s, %s)',
          'elementwise_max': 'max(%s, %s)'}


def _binary(name):
    def emit(ins, attrs, outs):
        (x, dx), (y, dy) = ins['X'][0], ins['Y'][0]
        od = outs['Out'][0]
        if od == 'int32':
            if name not in _I_BIN or dx != 'int32' or dy != 'int32':
                raise Unsupported('%s on %s, %s' % (name, dx, dy))
            return {'Out': [_I_BIN[name] % (x, y)]}
        return {'Out': [_rnd(_F_BIN[name] % (_f(x, dx), _f(y, dy)), od)]}
    return emit


for _name in _F_BIN:
    _r(_name, emit=_binary(_name), bcast_y=True)


def _scale(ins, attrs, outs):
    # ops/math.py scale: the bias in x's dtype first, x * s + b (or
    # (x + b) * s), then .to(x.dtype)
    x, dx = ins['X'][0]
    md = _scalar_dt(dx)
    s = float_lit(attrs.get('scale', 1.0))
    b = float_lit(torch.tensor(attrs.get('bias', 0.0)).to(
        getattr(torch, dx)).item())
    xf = _f(x, dx)
    if attrs.get('bias_after_scale', True):
        t = _rnd('__fmul_rn(%s, %s)' % (xf, s), md)
        t = _rnd('__fadd_rn(%s, %s)' % (t, b), md)
    else:
        t = _rnd('__fadd_rn(%s, %s)' % (xf, b), md)
        t = _rnd('__fmul_rn(%s, %s)' % (t, s), md)
    return {'Out': [to_dtype(t, md, outs['Out'][0])]}


def _cast(ins, attrs, outs):
    x, dx = ins['X'][0]
    return {'Out': [to_dtype(x, dx, outs['Out'][0])]}


def _increment(ins, attrs, outs):
    # the step converts to x's dtype first (ops/math.py increment)
    x, dx = ins['X'][0]
    step = attrs.get('step', 1.0)
    if dx == 'int32':
        return {'Out': ['(%s + (%d))' % (x, int(step))]}
    return {'Out': [_rnd('__fadd_rn(%s, %s)' % (_f(x, dx),
                                                 float_lit(step)), dx)]}


def _relu(ins, attrs, outs):
    x, dx = ins['X'][0]
    if dx == 'int32':
        return {'Out': ['max(%s, 0)' % x]}
    return {'Out': ['kg_relu(%s)' % _f(x, dx)]}


def _swish(ins, attrs, outs):
    # ops/math.py swish: x * sigmoid(beta * x), three PyTorch operations
    x, dx = ins['X'][0]
    if dx not in FLOAT_DTYPES:
        raise Unsupported('swish on %s' % dx)
    t = _rnd('__fmul_rn(%s, %s)' % (float_lit(attrs.get('beta', 1.0)), x),
             dx)
    sg = _rnd('__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-(%s))))' % t, dx)
    return {'Out': [_rnd('__fmul_rn(%s, %s)' % (x, sg), dx)]}


def _unary_float(fn):
    # one PyTorch operation of a float tensor: float32 math, rounded to
    # the output's dtype
    def emit(ins, attrs, outs):
        x, dx = ins['X'][0]
        if dx not in FLOAT_DTYPES:
            raise Unsupported('float op on %s' % dx)
        return {'Out': [_rnd(fn(x, attrs), outs['Out'][0])]}
    return emit


def _sign(ins, attrs, outs):
    # ops/math.py _sign: NaN and zeros pass through, else +-1
    x, dx = ins['X'][0]
    if dx == 'int32':
        return {'Out': ['((%s) > 0) - ((%s) < 0)' % (x, x)]}
    return {'Out': ['kg_sign(%s)' % _f(x, dx)]}


def _assign(ins, attrs, outs):
    return {'Out': [ins['X'][0][0]]}


def _fill(ins, attrs, outs):
    return {'Out': [_const(attrs['value'], attrs.get('dtype', 'float32'))]}


def _dropout(ins, attrs, outs):
    """ops/nn.py dropout: training reads the drawn mask (operand
    `Mask`); at test time x * (1 - p) or x, and a mask of ones."""
    x, dx = ins['X'][0]
    if dx not in FLOAT_DTYPES:
        raise Unsupported('dropout on %s' % dx)
    p = attrs.get('dropout_prob', 0.5)
    impl = attrs.get('dropout_implementation', 'downgrade_in_infer')
    if attrs.get('is_test', False):
        out = x if impl != 'downgrade_in_infer' else \
            _rnd('__fmul_rn(%s, %s)' % (x, float_lit(1.0 - p)), dx)
        return {'Out': [out], 'Mask': [float_lit(1.0)]}
    m, _ = ins['Mask'][0]
    out = _rnd('__fmul_rn(%s, %s)' % (x, m), dx)
    if impl == 'upscale_in_train' and p < 1.0:
        # x / (1 - p) with a Python scalar divisor: PyTorch's CUDA kernel
        # multiplies by the float32 reciprocal of float32(1 - p)
        inv = np.float32(1.0) / np.float32(1.0 - p)
        out = _rnd('__fmul_rn(%s, %s)' % (out, float_lit(inv)), dx)
    return {'Out': [out]}


_r('scale', emit=_scale)
_r('cast', emit=_cast)
_r('increment', emit=_increment)
_r('relu', emit=_relu)
_r('square', emit=_unary_float(lambda x, a: '__fmul_rn(%s, %s)' % (x, x)))
_r('sqrt', emit=_unary_float(lambda x, a: '__fsqrt_rn(%s)' % x))
_r('sign', emit=_sign)
# torch.clamp with Python bounds: float32 bounds, NaN passes through
_r('clip', emit=_unary_float(lambda x, a: 'kg_clamp(%s, %s, %s)' % (
    x, float_lit(a['min']), float_lit(a['max']))))
_r('swish', emit=_swish)
_r('assign', emit=_assign)
_r('fill_constant', emit=_fill)
_r('fill_constant_batch_size_like', emit=_fill, shape_only=('Input',))

# ------------------------------------------------------------ layout glue
for _name in ('reshape', 'squeeze', 'unsqueeze', 'transpose'):
    _r(_name, kind='layout')

# ------------------------------------------------------------- rng rules
_r('dropout', kind='rng', emit=_dropout)
for _name in ('uniform_random', 'gaussian_random'):
    _r(_name, kind='rng')

# --------------------------------------- dedicated kernels between segments
_r('softmax', kind='row')
_r('layer_norm', kind='row')
_r('flash_attention', kind='attention')
_r('adam', kind='optimizer')
_r('momentum', kind='optimizer')
