"""Elementwise, activation and matrix-product ops.

Counterpart of paddle_tpu/ops/math.py: the elementwise ops with the fluid
`axis` broadcast rule (mod and floordiv too), the comparisons and logical
ops, the unary and activation family, prelu, scale, clip, clip_by_norm,
cast, increment, cumsum, the reductions (reduce_sum, _mean, _max, _min,
_prod, _all, _any), mean, sum, cos_sim, l2_normalize, isfinite, has_inf,
has_nan, maxout, mul and matmul, each
with the JAX impl's semantics on tensors, NaN, infinities and signed
zeros included: where a torch function differs from the jnp one there (clamp
at -0, pow's sqrt at -inf, softplus's threshold), the op is the jnp
formula in torch operations.  A large
matrix product stays `torch.matmul`, as the JAX package left it to XLA;
float32 products run in full float32 (TF32 off, PyTorch's default).
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import torch_dtype, weak
from ..core.registry import register


def _bcast_y(x, y, axis):
    """Fluid elementwise broadcast: y's shape must be a contiguous
    subsequence of x's; `axis` is where it aligns (-1 = align trailing)."""
    if x.shape == y.shape or y.ndim == 0:
        return y
    ax = axis if axis >= 0 else x.ndim - y.ndim
    # trim trailing 1s of y (fluid allows y shape [N, 1])
    yshape = list(y.shape)
    while len(yshape) > 1 and yshape[-1] == 1 and ax + len(yshape) > x.ndim:
        yshape = yshape[:-1]
    return y.reshape([1] * ax + yshape + [1] * (x.ndim - ax - len(yshape)))


def _ew(name, fn):
    @register(name)
    def impl(ctx, ins, attrs):
        x, y = ins['X'], ins['Y']
        return {'Out': fn(x, _bcast_y(x, y, attrs.get('axis', -1)))}
    return impl


_ew('elementwise_add', torch.add)
_ew('elementwise_sub', torch.sub)
_ew('elementwise_mul', torch.mul)
_ew('elementwise_div', torch.div)


def _maximum(x, y):
    """jnp.maximum, y a tensor or a Python float: NaN propagates and -0 <
    +0 (torch.maximum and torch.clamp keep -0)."""
    neg = torch.signbit(y) if isinstance(y, torch.Tensor) else \
        bool(np.signbit(y))
    return torch.where(torch.isnan(x) | (x > y) | ((x == y) & neg), x, y)


def _minimum(x, y):
    """jnp.minimum, as _maximum."""
    return torch.where(torch.isnan(x) | (x < y) | ((x == y) &
                                                   torch.signbit(x)), x, y)


_ew('elementwise_max', _maximum)
_ew('elementwise_min', _minimum)
_ew('elementwise_pow', torch.pow)


def _isign(x):
    # lax.sign of integers
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)


def _mod(x, y):
    """jnp.mod: the remainder takes the divisor's sign (torch.remainder,
    not torch.fmod); an integer divisor of 0 counts as 1."""
    if not x.is_floating_point():
        y = torch.where(y == 0, torch.ones_like(y), y)
    t = torch.fmod(x, y)
    return torch.where((t != 0) & ((t < 0) != (y < 0)), t + y, t)


def _round_away(d):
    # lax.round's default, half away from zero; a zero keeps its sign
    r = torch.trunc(d)
    return torch.where(torch.abs(d - r) >= 0.5, r + torch.sign(d), r)


def _floordiv(x, y):
    """jnp.floor_divide.  Floats: CPython's float_divmod as jnp writes it
    (x / 0 is NaN, not torch's inf; 0 // negative is -0 where torch gives
    +0).  Integers: XLA's truncating division, whose x / 0 is -1 and
    x % 0 is x, then one less where the signs differ."""
    if x.is_floating_point():
        mod = torch.fmod(x, y)
        div = (x - mod) / y
        ind = (mod != 0) & (_sign(y) != _sign(mod))
        return _round_away(torch.where(ind, div - 1, div))
    zero = y == 0
    ys = torch.where(zero, torch.ones_like(y), y)
    q = torch.where(zero, torch.full_like(x, -1),
                    torch.div(x, ys, rounding_mode='trunc'))
    r = torch.where(zero, x, torch.fmod(x, ys))
    return torch.where((_isign(x) != _isign(y)) & (r != 0), q - 1, q)


_ew('elementwise_mod', _mod)
_ew('elementwise_floordiv', _floordiv)


def _cmp(name, fn):
    @register(name)
    def impl(ctx, ins, attrs):
        x, y = ins['X'], ins['Y']
        return {'Out': fn(x, _bcast_y(x, y, attrs.get('axis', -1)))}
    return impl


_cmp('less_than', torch.lt)
_cmp('less_equal', torch.le)
_cmp('greater_than', torch.gt)
_cmp('greater_equal', torch.ge)
_cmp('equal', torch.eq)
_cmp('not_equal', torch.ne)


def _logical(name, fn, binary=True):
    # numpy broadcasting, no `axis` (as the reference's)
    @register(name)
    def impl(ctx, ins, attrs):
        if binary:
            return {'Out': fn(ins['X'], ins['Y'])}
        return {'Out': fn(ins['X'])}
    return impl


_logical('logical_and', torch.logical_and)
_logical('logical_or', torch.logical_or)
_logical('logical_xor', torch.logical_xor)
_logical('logical_not', torch.logical_not, binary=False)


def _unary(name, fn):
    @register(name)
    def impl(ctx, ins, attrs):
        return {'Out': fn(ins['X'])}
    return impl


def _sign(x):
    # jnp.sign: NaN stays NaN and a zero keeps its sign (torch.sign gives 0)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def _softplus(x):
    # jax.nn.softplus, jnp.logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|))
    # at every x (F.softplus returns x above a threshold)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _sigmoid(x):
    """jax.nn.sigmoid: one operation in float32; on a bf16 tensor jnp's
    three, exp(-x), 1 + e and 1 / s, each rounded to bf16 (torch.sigmoid
    rounds once)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return torch.reciprocal(1.0 + torch.exp(-x))


def _clip(x, lo, hi):
    # jnp.clip: minimum(maximum(x, lo), hi)
    return _minimum(_maximum(x, lo), hi)


_unary('square', torch.square)
_unary('sqrt', torch.sqrt)
_unary('sign', _sign)
_unary('sigmoid', _sigmoid)
_unary('logsigmoid', lambda x: -_softplus(-x))
_unary('tanh', torch.tanh)
_unary('tanh_shrink', lambda x: x - torch.tanh(x))
_unary('exp', torch.exp)
_unary('log', torch.log)
_unary('rsqrt', torch.rsqrt)
_unary('abs', torch.abs)
_unary('ceil', torch.ceil)
_unary('floor', torch.floor)
_unary('cos', torch.cos)
_unary('sin', torch.sin)
_unary('round', torch.round)        # half to even, as jnp.round
_unary('reciprocal', torch.reciprocal)
_unary('softplus', _softplus)
_unary('softsign', lambda x: x / (torch.abs(x) + 1))
_unary('erf', torch.erf)


# Each Python constant below meets its tensor as jnp meets a weak-typed
# scalar: rounded to the tensor's dtype first (`weak`, ROADMAP C12)

@register('relu6')
def relu6(ctx, ins, attrs):
    x = ins['X']
    return {'Out': _clip(x, 0.0, weak(float(attrs.get('threshold', 6.0)),
                                      x))}


@register('leaky_relu')
def leaky_relu(ctx, ins, attrs):
    x = ins['X']
    return {'Out': torch.where(x >= 0, x,
                               weak(attrs.get('alpha', 0.02), x) * x)}


def _elu(x, a):
    return torch.where(x >= 0, x, weak(a, x) * (torch.exp(x) - 1.0))


@register('elu')
def elu(ctx, ins, attrs):
    return {'Out': _elu(ins['X'], attrs.get('alpha', 1.0))}


@register('selu')
def selu(ctx, ins, attrs):
    x = ins['X']
    return {'Out': weak(attrs.get('scale', 1.0507009873554805), x) * _elu(
        x, attrs.get('alpha', 1.6732632423543772))}


@register('brelu')
def brelu(ctx, ins, attrs):
    x = ins['X']
    return {'Out': _clip(x, weak(float(attrs.get('t_min', 0.0)), x),
                         weak(float(attrs.get('t_max', 24.0)), x))}


@register('soft_relu')
def soft_relu(ctx, ins, attrs):
    x = ins['X']
    t = float(attrs.get('threshold', 40.0))
    return {'Out': torch.log1p(torch.exp(_clip(x, weak(-t, x),
                                               weak(t, x))))}


@register('hard_sigmoid')
def hard_sigmoid(ctx, ins, attrs):
    x = ins['X']
    return {'Out': _clip(weak(attrs.get('slope', 0.2), x) * x +
                         weak(attrs.get('offset', 0.5), x), 0.0, 1.0)}


@register('stanh')
def stanh(ctx, ins, attrs):
    x = ins['X']
    return {'Out': weak(attrs.get('scale_b', 1.7159), x) * torch.tanh(
        weak(attrs.get('scale_a', 2.0 / 3.0), x) * x)}


def pow_fixups(f):
    """torch.pow(x, f) takes f = 0.5 and -0.5 as sqrt and rsqrt, which
    differ from pow (jnp.power) at -inf and at -0: those entries, as
    pow's IEEE special cases -> [(x, value)]."""
    if f == 0.5:
        return [(float('-inf'), float('inf')), (0.0, 0.0)]
    if f == -0.5:
        return [(float('-inf'), 0.0), (0.0, float('inf'))]
    return []


@register('pow')
def pow_op(ctx, ins, attrs):
    x, f = ins['X'], float(attrs.get('factor', 1.0))
    out = torch.pow(x, weak(f, x))
    for at, v in pow_fixups(f):
        out = torch.where(x == at, v, out)
    return {'Out': out}


@register('thresholded_relu')
def thresholded_relu(ctx, ins, attrs):
    x = ins['X']
    return {'Out': torch.where(x > weak(attrs.get('threshold', 1.0), x),
                               x, 0.0)}


@register('hard_shrink')
def hard_shrink(ctx, ins, attrs):
    x = ins['X']
    return {'Out': torch.where(
        torch.abs(x) > weak(attrs.get('threshold', 0.5), x), x, 0.0)}


@register('softshrink')
def softshrink(ctx, ins, attrs):
    x = ins['X']
    lam = weak(attrs.get('lambda', 0.5), x)
    return {'Out': torch.where(x > lam, x - lam,
                               torch.where(x < -lam, x + lam, 0.0))}


@register('relu')
def relu(ctx, ins, attrs):
    # jax.nn.relu, jnp.maximum(x, 0): -0 gives +0 (torch.relu keeps -0),
    # NaN stays NaN; one kernel, as torch.relu
    return {'Out': F.threshold(ins['X'], 0, 0)}


@register('scale')
def scale(ctx, ins, attrs):
    x = ins['X']
    s = weak(attrs.get('scale', 1.0), x)
    b = attrs.get('bias', 0.0)
    # the bias takes x's dtype first, as jnp.asarray(b, x.dtype) does: an
    # int32 x with bias 1.5 adds 1
    b = torch.tensor(b).to(x.dtype).item()
    if attrs.get('bias_after_scale', True):
        out = x * s + b
    else:
        out = (x + b) * s
    # the dtype is preserved (an int counter stays int)
    return {'Out': out.to(x.dtype)}


@register('clip')
def clip(ctx, ins, attrs):
    # jnp.clip (torch.clamp keeps -0 against a bound of +0)
    x = ins['X']
    return {'Out': _clip(x, weak(float(attrs['min']), x),
                         weak(float(attrs['max']), x))}


@register('clip_by_norm')
def clip_by_norm(ctx, ins, attrs):
    # x * min(max_norm / max(||x||, 1e-12), 1), in x's dtype, each Python
    # scalar first in x's dtype as jnp takes it (a 0-d host tensor, which
    # a CUDA op reads as a scalar: no copy, so a graph capture takes it)
    x = ins['X']

    def c(v):
        return torch.tensor(v, dtype=x.dtype)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.minimum(c(attrs['max_norm']) / torch.maximum(norm,
                                                               c(1e-12)),
                          c(1.0))
    return {'Out': x * scale}


# the integer dtypes a float converts into by saturating, as XLA's convert
# (the reference's astype) does
_SATURATED = (torch.int8, torch.int16, torch.int32, torch.uint8)


@register('cast')
def cast(ctx, ins, attrs):
    x, dt = ins['X'], torch_dtype(attrs['out_dtype'])
    if not (x.is_floating_point() and dt in _SATURATED):
        return {'Out': x.to(dt)}
    # NaN -> 0 and every value clamped to the target's range, on every
    # device (Tensor.to wraps there, or gives the minimum).  The limits
    # compare in x's dtype, where int32's maximum rounds up to 2^31 (and
    # int16's in bf16 to 2^15), one past the range: what reaches it is
    # the maximum
    info = torch.iinfo(dt)
    x = torch.nan_to_num(x, nan=0.0).clamp(info.min, info.max)
    return {'Out': torch.where(x >= info.max, info.max, x.to(dt))}


@register('increment')
def increment(ctx, ins, attrs):
    x = ins['X']
    step = attrs.get('step', 1.0)
    # the step converts to x's dtype first, as jnp.asarray(step, x.dtype);
    # a new tensor each run, which a CUDA graph copies into the scope's
    # tensor at the end of its step (core/graphs.py)
    return {'Out': x + (weak(step, x) if x.is_floating_point()
                        else int(step))}


@register('cumsum')
def cumsum(ctx, ins, attrs):
    # jnp.cumsum: integers and bools sum in int32; `exclusive` subtracts
    # x, `reverse` sums the flipped x (then `exclusive` again), in the
    # reference's order
    x = ins['X']
    axis = attrs.get('axis', -1)
    dt = None if x.is_floating_point() else torch.int32

    def cs(v):
        return torch.cumsum(v, dim=axis, dtype=dt)
    out = cs(x)
    if attrs.get('exclusive', False):
        out = out - x
    if attrs.get('reverse', False):
        out = torch.flip(cs(torch.flip(x, [axis])), [axis])
        if attrs.get('exclusive', False):
            out = out - x
    return {'Out': out}


def _int32_acc(x):
    """The dtype jnp.sum and jnp.prod accumulate `x` in: integers and
    bools in int32 (torch widens them to int64; jnp's uint32 for a uint8
    input has no torch sum), None for floats (their own dtype)."""
    return None if x.is_floating_point() or x.is_complex() else torch.int32


def _mean(x, dim, keepdim):
    # jnp.mean: integers and bools average in float32; a half-width float
    # sums and divides in float32, then rounds once
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float().mean(dim=dim, keepdim=keepdim).to(x.dtype)
    return (x if x.is_floating_point() else x.float()).mean(
        dim=dim, keepdim=keepdim)


def _prod(x, dim, keepdim):
    dt = _int32_acc(x)
    if dim is None:
        return x.prod(dtype=dt)
    out = x
    for d in sorted(dim, reverse=True):   # torch.prod takes one dim
        out = out.prod(dim=d, keepdim=keepdim, dtype=dt)
    return out


def _truthy(x):
    # jnp.all / jnp.any read nonzero (NaN too) as true
    return x if x.dtype == torch.bool else x != 0


_REDUCERS = {
    'reduce_sum': lambda x, dim, keep: x.sum(dtype=_int32_acc(x)) if
    dim is None else x.sum(dim=dim, keepdim=keep, dtype=_int32_acc(x)),
    'reduce_mean': _mean,
    # amax / amin propagate NaN and split the gradient among ties evenly,
    # as jnp.max / jnp.min do
    'reduce_max': lambda x, dim, keep: x.amax() if dim is None else
    x.amax(dim=dim, keepdim=keep),
    'reduce_min': lambda x, dim, keep: x.amin() if dim is None else
    x.amin(dim=dim, keepdim=keep),
    'reduce_prod': _prod,
    'reduce_all': lambda x, dim, keep: _truthy(x).all() if dim is None
    else _truthy(x).all(dim=dim, keepdim=keep),
    'reduce_any': lambda x, dim, keep: _truthy(x).any() if dim is None
    else _truthy(x).any(dim=dim, keepdim=keep),
}


def _reduce(name):
    fn = _REDUCERS[name]

    @register(name)
    def impl(ctx, ins, attrs):
        """jnp's reduction over `dim` (or every axis with `reduce_all`),
        `keep_dim` keeping the reduced axes; a 0-d result as shape [1]."""
        x = ins['X']
        keep = attrs.get('keep_dim', False)
        if attrs.get('reduce_all', False):
            out = fn(x, None, keep)
            if keep:
                out = out.reshape([1] * x.ndim)
        else:
            dim = attrs.get('dim', [0])
            dim = [dim] if isinstance(dim, int) else list(dim)
            out = fn(x, tuple(d % x.ndim for d in dim), keep)
        if out.ndim == 0:
            out = out.reshape(1)
        return {'Out': out}
    return impl


for _name in _REDUCERS:
    _reduce(_name)


@register('mean')
def mean(ctx, ins, attrs):
    """The mean of every entry, shape [1] (jnp.mean: an integer input's
    mean is float32)."""
    x = ins['X']
    return {'Out': (x if x.is_floating_point() else x.float()).mean()
            .reshape(1)}


@register('sum')
def sum_op(ctx, ins, attrs):
    # left to right, each add promoting as jnp's `+` does
    xs = ins['X']
    xs = xs if isinstance(xs, (list, tuple)) else [xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {'Out': out}


@register('cos_sim')
def cos_sim(ctx, ins, attrs):
    # sum(x y) / (|x| |y| + 1e-12) over the last axis, keepdim
    x, y = ins['X'], ins['Y']
    xn = torch.sqrt(torch.sum(x * x, -1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, -1, keepdim=True))
    den = xn * yn
    out = torch.sum(x * y, -1, keepdim=True) / (den + weak(1e-12, den))
    return {'Out': out, 'XNorm': xn, 'YNorm': yn}


@register('swish')
def swish(ctx, ins, attrs):
    x = ins['X']
    return {'Out': x * _sigmoid(weak(attrs.get('beta', 1.0), x) * x)}


def _promote(x, y):
    """Both operands of a product in their common dtype, as jnp promotes
    them (a float32 feed times a bf16 weight is a float32 product)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


@register('matmul')
def matmul(ctx, ins, attrs):
    x, y = ins['X'], ins['Y']
    if x.ndim == 1:
        x = x.reshape(1, -1)
    if y.ndim == 1:
        y = y.reshape(-1, 1)
    if attrs.get('transpose_X', False):
        x = x.transpose(-1, -2)
    if attrs.get('transpose_Y', False):
        y = y.transpose(-1, -2)
    x, y = _promote(x, y)
    out = torch.matmul(x, y)
    alpha = attrs.get('alpha', 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {'Out': out}


@register('mul')
def mul(ctx, ins, attrs):
    # flatten both sides to 2-D, then one GEMM; the weight keeps the fluid
    # [in, out] layout and is used as x @ W
    x, y = ins['X'], ins['Y']
    xn = attrs.get('x_num_col_dims', 1)
    yn = attrs.get('y_num_col_dims', 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2, y2 = _promote(x.reshape(int(np.prod(xs[:xn])), -1),
                      y.reshape(int(np.prod(ys[:yn])), -1))
    return {'Out': torch.matmul(x2, y2).reshape(xs[:xn] + ys[yn:])}


@register('prelu')
def prelu(ctx, ins, attrs):
    # alpha one value ('all'), one a channel ('channel', axis 1) or one an
    # element of x's trailing shape ('element')
    x, alpha = ins['X'], ins['Alpha']
    mode = attrs.get('mode', 'all')
    if mode == 'channel':
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    elif mode == 'all':
        alpha = alpha.reshape((1,) * x.ndim)
    return {'Out': torch.where(x >= 0, x, alpha * x)}


@register('l2_normalize')
def l2_normalize(ctx, ins, attrs):
    # x / max(sqrt(sum(x^2, axis)), epsilon)
    x = ins['X']
    norm = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get('axis', -1),
                                keepdim=True))
    norm = _maximum(norm, weak(attrs.get('epsilon', 1e-12), norm))
    return {'Out': x / norm, 'Norm': norm}


@register('isfinite')
def isfinite(ctx, ins, attrs):
    return {'Out': torch.isfinite(ins['X']).all().reshape(1)}


@register('has_inf')
def has_inf(ctx, ins, attrs):
    return {'Out': torch.isinf(ins['X']).any().reshape(1)}


@register('has_nan')
def has_nan(ctx, ins, attrs):
    return {'Out': torch.isnan(ins['X']).any().reshape(1)}


@register('maxout')
def maxout(ctx, ins, attrs):
    # NCHW: the max over each run of `groups` consecutive channels
    x = ins['X']
    g = attrs['groups']
    n, c, h, w = x.shape
    return {'Out': x.reshape(n, c // g, g, h, w).amax(dim=2)}
