"""Elementwise, activation and matrix-product ops.

Counterpart of paddle_tpu/ops/math.py: the elementwise ops with the fluid
`axis` broadcast rule, relu, swish, scale, cast, increment, reduce_sum,
mul and matmul, each with the JAX impl's semantics on tensors.  A large
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
_ew('elementwise_min', torch.minimum)
_ew('elementwise_pow', torch.pow)


@register('relu')
def relu(ctx, ins, attrs):
    return {'Out': torch.relu(ins['X'])}


@register('scale')
def scale(ctx, ins, attrs):
    s = attrs.get('scale', 1.0)
    b = attrs.get('bias', 0.0)
    x = ins['X']
    if attrs.get('bias_after_scale', True):
        out = x * s + b
    else:
        out = (x + b) * s
    # the dtype is preserved (an int counter stays int)
    return {'Out': out.to(x.dtype)}


@register('cast')
def cast(ctx, ins, attrs):
    return {'Out': ins['X'].to(torch_dtype(attrs['out_dtype']))}


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
    if attrs.get('reduce_all', False):
        out = x.sum()
        if keep:
            out = out.reshape([1] * x.ndim)
    else:
        dim = attrs.get('dim', [0])
        dim = [dim] if isinstance(dim, int) else list(dim)
        out = x.sum(dim=tuple(d % x.ndim for d in dim), keepdim=keep)
    if out.ndim == 0:
        out = out.reshape(1)
    return {'Out': out}


@register('swish')
def swish(ctx, ins, attrs):
    x = ins['X']
    return {'Out': x * torch.sigmoid(attrs.get('beta', 1.0) * x)}


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
    x2 = x.reshape(int(np.prod(xs[:xn])), -1)
    y2 = y.reshape(int(np.prod(ys[:yn])), -1)
    return {'Out': torch.matmul(x2, y2).reshape(xs[:xn] + ys[yn:])}
