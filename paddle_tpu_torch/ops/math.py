"""Elementwise, activation and matrix-product ops.

Counterpart of paddle_tpu/ops/math.py: the elementwise ops with the fluid
`axis` broadcast rule, relu, square, sqrt, sign, swish, scale, clip,
clip_by_norm, cast, increment, reduce_sum, mean, sum, mul and matmul, each with
the JAX impl's semantics on tensors.  A large
matrix product stays `torch.matmul`, as the JAX package left it to XLA;
float32 products run in full float32 (TF32 off, PyTorch's default).
"""
import numpy as np
import torch

from ..core.dtypes import torch_dtype
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
_ew('elementwise_max', torch.maximum)
_ew('elementwise_min', torch.minimum)
_ew('elementwise_pow', torch.pow)


def _unary(name, fn):
    @register(name)
    def impl(ctx, ins, attrs):
        return {'Out': fn(ins['X'])}
    return impl


def _sign(x):
    # jnp.sign: NaN stays NaN and a zero keeps its sign (torch.sign gives 0)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


_unary('square', torch.square)
_unary('sqrt', torch.sqrt)
_unary('sign', _sign)


@register('relu')
def relu(ctx, ins, attrs):
    return {'Out': torch.relu(ins['X'])}


@register('scale')
def scale(ctx, ins, attrs):
    s = attrs.get('scale', 1.0)
    b = attrs.get('bias', 0.0)
    x = ins['X']
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
    return {'Out': torch.clamp(ins['X'], attrs['min'], attrs['max'])}


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
    return {'Out': x + (step if x.is_floating_point() else int(step))}


@register('reduce_sum')
def reduce_sum(ctx, ins, attrs):
    x = ins['X']
    keep = attrs.get('keep_dim', False)
    # integers and bools sum in int32, as jnp.sum does (torch.sum widens
    # them to int64; jnp's uint32 for a uint8 input has no torch sum)
    dt = None if x.is_floating_point() or x.is_complex() else torch.int32
    if attrs.get('reduce_all', False):
        out = x.sum(dtype=dt)
        if keep:
            out = out.reshape([1] * x.ndim)
    else:
        dim = attrs.get('dim', [0])
        dim = [dim] if isinstance(dim, int) else list(dim)
        out = x.sum(dim=tuple(d % x.ndim for d in dim), keepdim=keep,
                    dtype=dt)
    if out.ndim == 0:
        out = out.reshape(1)
    return {'Out': out}


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


@register('swish')
def swish(ctx, ins, attrs):
    x = ins['X']
    return {'Out': x * torch.sigmoid(attrs.get('beta', 1.0) * x)}


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
