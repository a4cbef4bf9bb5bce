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
    -> one `adam_multi` call (csrc/adam.cu, K7's Adam instance); of
    `momentum` -> `momentum_multi` (csrc/momentum.cu); of `sgd`,
    `adagrad`, `decayed_adagrad`, `adamax`, `adadelta`, `rmsprop` or
    `ftrl` sharing their attributes -> one `optim_multi` call
    (csrc/optim_multi.cu, that type's instance).

Bool values (the comparisons' and logical ops' outputs) live in `bool`
registers and are stored as one byte, as torch stores them.

Not carried over yet (ROADMAP): rules for the fusable ops the port does
not register (`label_smooth`, `fill_zeros_like`, `flatten`).
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


def _weak(v, dt):
    """A Python constant as it meets a value of dtype `dt`: rounded to
    bfloat16 first where `dt` is bfloat16, as jnp rounds a weak-typed
    scalar (core/dtypes.py `weak`, ROADMAP C12)."""
    if dt == 'bfloat16':
        return float(torch.tensor(float(v), dtype=torch.bfloat16))
    return float(v)


def wlit(v, dt):
    """`_weak(v, dt)` as a literal."""
    return float_lit(_weak(v, dt))


def _f(e, dt):
    """Operand as a float32 compute value."""
    if dt in FLOAT_DTYPES:
        return e
    if dt in ('int32', 'bool'):
        return '((float)(%s))' % e
    raise Unsupported('dtype %s' % dt)


def _truth(e, dt):
    """A value as torch's logical ops read it: nonzero (NaN too) is true."""
    if dt == 'bool':
        return '(%s)' % e
    if dt == 'int32':
        return '((%s) != 0)' % e
    if dt in FLOAT_DTYPES:
        return '((%s) != 0.f)' % e
    raise Unsupported('dtype %s' % dt)


def to_dtype(e, frm, to):
    """A value of dtype `frm` converted to `to`, as a PyTorch conversion
    of a tensor does (bfloat16 values live in float32 registers); a float
    to int32 as the cast op (ops/math.py) does: the card's conversion
    (cvt.rzi) saturates and takes NaN to 0."""
    if to == frm:
        return e
    if to == 'bool':
        return _truth(e, frm)
    if to == 'int32':
        if frm in FLOAT_DTYPES or frm == 'bool':
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
    s = wlit(attrs.get('scale', 1.0), md)
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
                                                 wlit(step, dx)), dx)]}


def _relu(ins, attrs, outs):
    x, dx = ins['X'][0]
    if dx == 'int32':
        return {'Out': ['max(%s, 0)' % x]}
    return {'Out': ['kg_relu(%s)' % _f(x, dx)]}


def _sigmoid_expr(x, dt):
    # ops/math.py _sigmoid: one operation in float32; in bfloat16 jnp's
    # three, exp(-x), 1 + e and 1 / s, each rounded
    if dt == 'bfloat16':
        e = _rnd('expf(-(%s))' % x, dt)
        return _rnd('__fdiv_rn(1.0f, %s)' % _rnd(
            '__fadd_rn(1.0f, %s)' % e, dt), dt)
    return _rnd('__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-(%s))))' % x, dt)


def _swish(ins, attrs, outs):
    # ops/math.py swish: x * sigmoid(beta * x)
    x, dx = ins['X'][0]
    if dx not in FLOAT_DTYPES:
        raise Unsupported('swish on %s' % dx)
    t = _rnd('__fmul_rn(%s, %s)' % (wlit(attrs.get('beta', 1.0), dx), x),
             dx)
    sg = _sigmoid_expr(t, dx)
    return {'Out': [_rnd('__fmul_rn(%s, %s)' % (x, sg), dx)]}


def _unary_float(fn):
    # one PyTorch operation of a float tensor: float32 math, rounded to
    # the output's dtype
    def emit(ins, attrs, outs):
        x, dx = ins['X'][0]
        if dx not in FLOAT_DTYPES:
            raise Unsupported('float op on %s' % dx)
        return {'Out': [_rnd(fn(x, attrs, dx), outs['Out'][0])]}
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
            _rnd('__fmul_rn(%s, %s)' % (x, wlit(1.0 - p, dx)), dx)
        return {'Out': [out], 'Mask': [float_lit(1.0)]}
    m, _ = ins['Mask'][0]
    out = _rnd('__fmul_rn(%s, %s)' % (x, m), dx)
    if impl == 'upscale_in_train' and p < 1.0:
        # x / (1 - p) with a Python scalar divisor, (1 - p) rounded to
        # x's dtype first: PyTorch's CUDA kernel multiplies by its float32
        # reciprocal
        inv = np.float32(1.0) / np.float32(_weak(1.0 - p, dx))
        out = _rnd('__fmul_rn(%s, %s)' % (out, float_lit(inv)), dx)
    return {'Out': [out]}


_r('scale', emit=_scale)
_r('cast', emit=_cast)
_r('increment', emit=_increment)
_r('relu', emit=_relu)
_r('square', emit=_unary_float(lambda x, a, dt: '__fmul_rn(%s, %s)' % (
    x, x)))
_r('sqrt', emit=_unary_float(lambda x, a, dt: '__fsqrt_rn(%s)' % x))
_r('sign', emit=_sign)
# ops/math.py clip: jnp.clip, the bounds in x's dtype, NaN passes through
_r('clip', emit=_unary_float(lambda x, a, dt: _jclip(x, a['min'],
                                                     a['max'], dt)))
_r('swish', emit=_swish)
_r('assign', emit=_assign)
_r('fill_constant', emit=_fill)
_r('fill_constant_batch_size_like', emit=_fill, shape_only=('Input',))


# ------------------------------- mod, floordiv, comparisons, logical ops

def _bf(dt):
    # the template argument of the prelude's helpers that round each
    # operation to bfloat16
    return 'true' if dt == 'bfloat16' else 'false'


def _divmod_rule(helper, ihelper):
    # ops/math.py _mod / _floordiv: integers by XLA's conventions at 0,
    # floats operation by operation in the output's dtype
    def emit(ins, attrs, outs):
        (x, dx), (y, dy) = ins['X'][0], ins['Y'][0]
        od = outs['Out'][0]
        if od == 'int32':
            if dx != 'int32' or dy != 'int32':
                raise Unsupported('integer %s on %s, %s' % (helper, dx, dy))
            return {'Out': ['%s(%s, %s)' % (ihelper, x, y)]}
        if od not in FLOAT_DTYPES:
            raise Unsupported('%s to %s' % (helper, od))
        return {'Out': ['%s<%s>(%s, %s)' % (helper, _bf(od), _f(x, dx),
                                           _f(y, dy))]}
    return emit


_r('elementwise_mod', emit=_divmod_rule('kg_mod', 'kg_imod'), bcast_y=True)
_r('elementwise_floordiv', emit=_divmod_rule('kg_floordiv', 'kg_ifloordiv'),
   bcast_y=True)

_CMP = {'less_than': '<', 'less_equal': '<=', 'greater_than': '>',
        'greater_equal': '>=', 'equal': '==', 'not_equal': '!='}


def _compare(name):
    # torch's comparison after promotion: integers and bools as int,
    # anything else as float (a bfloat16 value is exact in float)
    def emit(ins, attrs, outs):
        (x, dx), (y, dy) = ins['X'][0], ins['Y'][0]
        if dx in ('int32', 'bool') and dy in ('int32', 'bool'):
            x, y = '((int)(%s))' % x, '((int)(%s))' % y
        else:
            x, y = _f(x, dx), _f(y, dy)
        return {'Out': ['((%s) %s (%s))' % (x, _CMP[name], y)]}
    return emit


for _name in _CMP:
    _r(_name, emit=_compare(_name), bcast_y=True)

_LOGICAL = {'logical_and': '(%s && %s)', 'logical_or': '(%s || %s)',
            'logical_xor': '(%s != %s)'}


def _logical(name):
    def emit(ins, attrs, outs):
        if name == 'logical_not':
            return {'Out': ['(!%s)' % _truth(*ins['X'][0])]}
        return {'Out': [_LOGICAL[name] % (_truth(*ins['X'][0]),
                                          _truth(*ins['Y'][0]))]}
    return emit


for _name in list(_LOGICAL) + ['logical_not']:
    _r(_name, emit=_logical(_name))


# ------------------------------------------ the unary and activation family

def _act(fn, int_ok=None):
    """A float op as its plain impl in ops/math.py writes it: `fn(x, a,
    R)` -> the C++ expression, `a` the attrs, `R` rounding one torch
    operation's float32 result to the output's dtype."""
    def emit(ins, attrs, outs):
        x, dx = ins['X'][0]
        od = outs['Out'][0]
        if dx == 'int32' and int_ok:
            return {'Out': [int_ok % x]}
        if dx not in FLOAT_DTYPES:
            raise Unsupported('float op on %s' % dx)
        return {'Out': [fn(x, attrs, lambda e: _rnd(e, od), od)]}
    return emit


def _lit(v):
    return float_lit(float(v))


def _jclip(x, lo, hi, dt='float32'):
    # ops/math.py _clip: jnp.maximum then jnp.minimum, -0 < +0; the flag
    # says whether an equal x (a signed zero) is taken; the bounds in
    # x's dtype `dt`
    lo, hi = _weak(lo, dt), _weak(hi, dt)
    return 'kg_jmin(kg_jmax(%s, %s, %s), %s, %s)' % (
        x, _lit(lo), 'true' if np.signbit(lo) else 'false', _lit(hi),
        'false' if np.signbit(hi) else 'true')


def _elu_expr(x, a, R, od):
    return '((%s) >= 0.f ? (%s) : %s)' % (x, x, R('__fmul_rn(%s, %s)' % (
        wlit(a, od), R('__fsub_rn(%s, 1.0f)' % R('expf(%s)' % x)))))


def _pow_expr(x, a, R, od):
    # torch.pow(x, f) as PyTorch's CUDA kernel computes it (sqrt, rsqrt,
    # reciprocal, x*x, x*x*x, 1/(x*x) for those exponents; powf with the
    # exponent in x's dtype else), then ops/math.py's fixups
    from ..math import pow_fixups
    f = float(a.get('factor', 1.0))
    if f == 0.5:
        e = R('__fsqrt_rn(%s)' % x)
    elif f == -0.5:
        e = R('rsqrtf(%s)' % x)
    elif f == -1.0:
        e = R('__fdiv_rn(1.0f, %s)' % x)
    elif f == 2.0:
        e = R('__fmul_rn(%s, %s)' % (x, x))
    elif f == 3.0:
        e = R('__fmul_rn(%s, %s)' % (R('__fmul_rn(%s, %s)' % (x, x)), x))
    elif f == -2.0:
        if od != 'float32':
            raise Unsupported('pow -2 on %s' % od)
        e = '__fdiv_rn(1.0f, __fmul_rn(%s, %s))' % (x, x)
    else:
        e = R('powf(%s, %s)' % (x, wlit(f, od)))
    for at, v in pow_fixups(float(a.get('factor', 1.0))):
        e = '((%s) == %s ? %s : %s)' % (x, _lit(at), _lit(v), e)
    return e


_ACTS = {
    # one torch operation each, float32 math rounded once
    'sigmoid': lambda x, a, R, od: _sigmoid_expr(x, od),
    'tanh': lambda x, a, R, od: R('tanhf(%s)' % x),
    'exp': lambda x, a, R, od: R('expf(%s)' % x),
    'log': lambda x, a, R, od: R('logf(%s)' % x),
    'rsqrt': lambda x, a, R, od: R('rsqrtf(%s)' % x),
    'cos': lambda x, a, R, od: R('cosf(%s)' % x),
    'sin': lambda x, a, R, od: R('sinf(%s)' % x),
    'erf': lambda x, a, R, od: R('erff(%s)' % x),
    'reciprocal': lambda x, a, R, od: R('__fdiv_rn(1.0f, %s)' % x),
    'ceil': lambda x, a, R, od: 'ceilf(%s)' % x,
    'floor': lambda x, a, R, od: 'floorf(%s)' % x,
    # torch.round and jnp.round: half to even
    'round': lambda x, a, R, od: 'rintf(%s)' % x,
    # compositions, each torch operation rounded, each Python constant
    # in x's dtype (`wlit`)
    'tanh_shrink': lambda x, a, R, od: R('__fsub_rn(%s, %s)' % (
        x, R('tanhf(%s)' % x))),
    'softplus': lambda x, a, R, od: 'kg_softplus<%s>(%s)' % (_bf(od), x),
    'logsigmoid': lambda x, a, R, od: '(-kg_softplus<%s>(-(%s)))' % (
        _bf(od), x),
    'softsign': lambda x, a, R, od: R('__fdiv_rn(%s, %s)' % (
        x, R('__fadd_rn(fabsf(%s), 1.0f)' % x))),
    'relu6': lambda x, a, R, od: _jclip(x, 0.0, a.get('threshold', 6.0),
                                        od),
    'brelu': lambda x, a, R, od: _jclip(x, a.get('t_min', 0.0),
                                        a.get('t_max', 24.0), od),
    'leaky_relu': lambda x, a, R, od: '((%s) >= 0.f ? (%s) : %s)' % (
        x, x, R('__fmul_rn(%s, %s)' % (wlit(a.get('alpha', 0.02), od), x))),
    'elu': lambda x, a, R, od: _elu_expr(x, a.get('alpha', 1.0), R, od),
    'selu': lambda x, a, R, od: R('__fmul_rn(%s, %s)' % (
        wlit(a.get('scale', 1.0507009873554805), od),
        _elu_expr(x, a.get('alpha', 1.6732632423543772), R, od))),
    'soft_relu': lambda x, a, R, od: R('log1pf(%s)' % R('expf(%s)' % _jclip(
        x, -float(a.get('threshold', 40.0)),
        float(a.get('threshold', 40.0)), od))),
    'hard_sigmoid': lambda x, a, R, od: _jclip(R('__fadd_rn(%s, %s)' % (
        R('__fmul_rn(%s, %s)' % (wlit(a.get('slope', 0.2), od), x)),
        wlit(a.get('offset', 0.5), od))), 0.0, 1.0),
    'stanh': lambda x, a, R, od: R('__fmul_rn(%s, %s)' % (
        wlit(a.get('scale_b', 1.7159), od), R('tanhf(%s)' % R(
            '__fmul_rn(%s, %s)' % (wlit(a.get('scale_a', 2.0 / 3.0), od),
                                   x))))),
    'pow': _pow_expr,
    'thresholded_relu': lambda x, a, R, od: '((%s) > %s ? (%s) : 0.f)' % (
        x, wlit(a.get('threshold', 1.0), od), x),
    'hard_shrink': lambda x, a, R, od: '(fabsf(%s) > %s ? (%s) : 0.f)' % (
        x, wlit(a.get('threshold', 0.5), od), x),
    'softshrink': lambda x, a, R, od: (
        '((%s) > %s ? %s : ((%s) < %s ? %s : 0.f))' % (
            x, wlit(a.get('lambda', 0.5), od), R('__fsub_rn(%s, %s)' % (
                x, wlit(a.get('lambda', 0.5), od))),
            x, wlit(-a.get('lambda', 0.5), od), R('__fadd_rn(%s, %s)' % (
                x, wlit(a.get('lambda', 0.5), od))))),
}

for _name, _fn in _ACTS.items():
    _r(_name, emit=_act(_fn))
_r('abs', emit=_act(lambda x, a, R, od: 'fabsf(%s)' % x, int_ok='abs(%s)'))

# ------------------------------------------------------------ layout glue
for _name in ('reshape', 'squeeze', 'unsqueeze', 'transpose'):
    _r(_name, kind='layout')

# ------------------------------------------------------------- rng rules
_r('dropout', kind='rng', emit=_dropout)
for _name in ('uniform_random', 'gaussian_random',
              'truncated_gaussian_random'):
    _r(_name, kind='rng')

# --------------------------------------- dedicated kernels between segments
_r('softmax', kind='row')
_r('layer_norm', kind='row')
_r('flash_attention', kind='attention')
for _name in ('adam', 'momentum', 'sgd', 'adagrad', 'decayed_adagrad',
              'adamax', 'adadelta', 'rmsprop', 'ftrl'):
    _r(_name, kind='optimizer')
