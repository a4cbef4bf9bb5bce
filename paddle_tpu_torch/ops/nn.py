"""Normalisation, position, softmax and dropout ops: rms_norm, rope,
layer_norm, add_position_encoding, softmax and dropout.

Counterpart of paddle_tpu/ops/nn.py.  rms_norm and rope compute in float32
and return the input dtype.  `layer_norm` is the JAX op's function, rows x
cols after `begin_norm_axis`: one-pass statistics shifted by each row's
first element (`var = max(E[d^2] - E[d]^2, 0)`), or the exact two-pass
form under PT_TWO_PASS_NORM=1, optional Scale and Bias, Y in the input
dtype and float32 Mean / Variance.  On a CUDA tensor its forward launches
csrc/layer_norm.cu (which replaces the TPU kernel `_layer_norm_step`); on a
CPU tensor it runs `layer_norm_reference`.  Its backward is the analytic
LayerNorm gradient in plain PyTorch: the JAX package has no backward
kernel and differentiates the plain ops (the pilot shift is
stop_gradient and cancels).

`softmax` is the JAX op's function, `jax.nn.softmax(x.astype(f32))` cast
back to x's dtype, over any axis.  The axis moves to the end around rows
x cols; on a CUDA tensor the rows go to csrc/softmax.cu (which replaces
the TPU kernel `_softmax_step`), on a CPU tensor to `softmax_reference`.
Its backward is plain PyTorch, y * (g - sum(g * y)) in float32: the JAX
package has no backward kernel and differentiates the plain op.

`dropout` has the JAX op's semantics: at test time x * (1 - p) for
`downgrade_in_infer` (x for `upscale_in_train`) and a mask of ones; in
training a keep mask drawn with probability 1 - p, out = x * mask, divided
by 1 - p for `upscale_in_train`.  The mask is drawn as the JAX package
draws it, outside any kernel (`jax.random.bernoulli` there, `bernoulli_`
on the op's own `torch.Generator` here, on the device); the two packages'
draws differ, as their generators do.
"""
import os

import numpy as np
import torch

from .. import kernels
from ..core.registry import register

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@register('rms_norm')
def rms_norm(ctx, ins, attrs):
    """Root-mean-square LayerNorm: no mean-centering, no bias."""
    x = ins['X']
    w = ins.get('Scale')
    eps = attrs.get('epsilon', 1e-6)
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if w is not None:
        out = out * w.float()
    return {'Y': out.to(x.dtype)}


@register('rope')
def rope(ctx, ins, attrs):
    """Rotary position embedding on [B, H, T, D] (D even): rotate feature
    pairs (2i, 2i+1) by position-dependent angles.  `Positions` (optional
    int [B, T]) overrides 0..T-1."""
    x = ins['X']
    theta = attrs.get('theta', 10000.0)
    B, H, T, D = x.shape
    pos = ins.get('Positions')
    if pos is None:
        pos = torch.arange(T, device=x.device)[None, :]          # [1, T]
    half = torch.arange(0, D // 2, dtype=torch.float32, device=x.device)
    freqs = torch.pow(theta, -half * 2.0 / D)                    # [D/2]
    ang = pos[:, None, :, None].float() * freqs                  # [B,1,T,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return {'Out': out.reshape(B, H, T, D).to(x.dtype)}


# ------------------------------------------------------------ layer_norm

def two_pass_norm():
    """PT_TWO_PASS_NORM=1 selects the exact two-pass statistics, read at
    each call as the JAX package's op and kernel step read it."""
    return os.environ.get('PT_TWO_PASS_NORM', '0') == '1'


def layer_norm_reference(x, scale, bias, eps, two_pass=False):
    """Plain version on rows x cols: -> (y in x's dtype, mean f32 [rows],
    variance f32 [rows])."""
    xf = x.float()
    if two_pass:
        m = xf.mean(dim=1, keepdim=True)
        v = (xf - m).square().mean(dim=1, keepdim=True)
        y = (xf - m) * torch.rsqrt(v + eps)
    else:
        c = xf[:, :1]
        d = xf - c
        md = d.mean(dim=1, keepdim=True)
        v = torch.clamp_min(d.square().mean(dim=1, keepdim=True)
                            - md.square(), 0.0)
        m = md + c
        y = (d - md) * torch.rsqrt(v + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype), m.reshape(-1), v.reshape(-1)


def _launch_layer_norm(x, scale, bias, eps, two_pass):
    if x.dim() != 2:
        raise ValueError('layer_norm kernel takes rows x cols, got %s'
                         % (tuple(x.shape),))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError('layer_norm kernel takes float32 or bfloat16 input, '
                        'got %s' % x.dtype)
    rows, cols = x.shape
    if rows < 1 or cols < 1:
        raise ValueError('layer_norm kernel takes non-empty rows')
    if not x.is_contiguous():
        raise ValueError('layer_norm kernel takes a contiguous input')
    params = []
    for name, p in (('Scale', scale), ('Bias', bias)):
        if p is not None:
            if p.numel() != cols or p.device != x.device:
                raise ValueError('layer_norm %s must hold %d values on %s'
                                 % (name, cols, x.device))
            # float32 on the kernel side; an exact conversion of a bf16
            # parameter, as float32 math promotes it in the JAX op
            p = p.reshape(cols).float().contiguous()
        params.append(p)
    scale, bias = params
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    var = torch.empty(rows, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = kernels.library().pt_layer_norm(
            x.data_ptr(), scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            mean.data_ptr(), var.data_ptr(), rows, cols, float(eps),
            _DTYPE_CODE[x.dtype], int(bool(two_pass)), stream)
    kernels.check(rc, 'layer_norm')
    kernels.launches['layer_norm'] += 1
    return y, mean, var


def layer_norm_rows(x, scale=None, bias=None, eps=1e-5, two_pass=None):
    """(y, mean, variance) of rows x cols `x`: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU (or shape-only `meta`) tensor."""
    if two_pass is None:
        two_pass = two_pass_norm()
    if x.device.type == 'cuda':
        return _launch_layer_norm(x, scale, bias, eps, two_pass)
    if x.device.type in ('cpu', 'meta'):
        return layer_norm_reference(x, scale, bias, eps, two_pass)
    raise RuntimeError('layer_norm: no kernel for device %s' % x.device)


def layer_norm_backward(dy, x, scale, mean, rstd, has_bias):
    """The analytic LayerNorm gradient on rows x cols, in float32: ->
    (dx in x's dtype, dscale or None, dbias or None)."""
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mean[:, None]) * rstd[:, None]
    g = dyf * scale.float().reshape(1, -1) if scale is not None else dyf
    dx = rstd[:, None] * (g - g.mean(dim=1, keepdim=True)
                          - xhat * (g * xhat).mean(dim=1, keepdim=True))
    dscale = (dyf * xhat).sum(dim=0).to(scale.dtype).reshape(scale.shape) \
        if scale is not None else None
    dbias = dyf.sum(dim=0) if has_bias else None
    return dx.to(x.dtype), dscale, dbias


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, two_pass):
        y, mean, var = layer_norm_rows(x, scale, bias, eps, two_pass)
        ctx.save_for_backward(x, scale, mean, torch.rsqrt(var + eps))
        ctx.bias_meta = (bias.dtype, bias.shape) if bias is not None \
            else None
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward(dy, x, scale, mean, rstd,
                                                ctx.bias_meta is not None)
        if dbias is not None:
            dbias = dbias.to(ctx.bias_meta[0]).reshape(ctx.bias_meta[1])
        return dx, dscale, dbias, None, None


def layer_norm(x, scale=None, bias=None, eps=1e-5, two_pass=None):
    """Differentiable LayerNorm over rows x cols: (y, mean, variance)."""
    if two_pass is None:
        two_pass = two_pass_norm()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, bias)):
        return _LayerNorm.apply(x, scale, bias, eps, two_pass)
    return layer_norm_rows(x, scale, bias, eps, two_pass)


@register('layer_norm')
def layer_norm_op(ctx, ins, attrs):
    x = ins['X']
    begin = attrs.get('begin_norm_axis', 1)
    lead = tuple(x.shape[:begin])
    rows = int(np.prod(lead)) if lead else 1
    y, m, v = layer_norm(x.reshape(rows, -1).contiguous(), ins.get('Scale'),
                         ins.get('Bias'), attrs.get('epsilon', 1e-5))
    return {'Y': y.reshape(x.shape), 'Mean': m.reshape(lead),
            'Variance': v.reshape(lead)}


@register('add_position_encoding')
def add_position_encoding(ctx, ins, attrs):
    x = ins['X']  # [B, T, D]
    alpha = attrs.get('alpha', 1.0)
    beta = attrs.get('beta', 1.0)
    _, t, d = x.shape
    pos = torch.arange(t, dtype=x.dtype, device=x.device)[:, None]
    half = d // 2
    div = torch.pow(10000.0, torch.arange(half, dtype=x.dtype,
                                          device=x.device) / half)
    pe = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    return {'Out': alpha * x + beta * pe[None, :, :]}


# --------------------------------------------------------------- softmax

def softmax_reference(x):
    """Plain version on rows x cols: float32 max-subtract, exp and
    sum-normalize over the last axis, in x's dtype."""
    xf = x.float()
    u = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (u / u.sum(dim=-1, keepdim=True)).to(x.dtype)


def _launch_softmax(x):
    if x.dim() != 2:
        raise ValueError('softmax kernel takes rows x cols, got %s'
                         % (tuple(x.shape),))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError('softmax kernel takes float32 or bfloat16 input, '
                        'got %s' % x.dtype)
    rows, cols = x.shape
    if rows < 1 or cols < 1:
        raise ValueError('softmax kernel takes non-empty rows')
    if not x.is_contiguous():
        raise ValueError('softmax kernel takes a contiguous input')
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = kernels.library().pt_softmax(x.data_ptr(), y.data_ptr(), rows,
                                          cols, _DTYPE_CODE[x.dtype], stream)
    kernels.check(rc, 'softmax')
    kernels.launches['softmax'] += 1
    return y


def softmax_rows(x):
    """Softmax of rows x cols `x` over its last axis: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU (or shape-only `meta`)
    tensor."""
    if x.device.type == 'cuda':
        return _launch_softmax(x)
    if x.device.type in ('cpu', 'meta'):
        return softmax_reference(x)
    raise RuntimeError('softmax: no kernel for device %s' % x.device)


def softmax_backward(g, y):
    """The softmax gradient on rows x cols, in float32, in y's dtype."""
    yf, gf = y.float(), g.float()
    return (yf * (gf - (gf * yf).sum(dim=-1, keepdim=True))).to(y.dtype)


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = softmax_rows(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return softmax_backward(g, y)


def softmax(x, axis=-1):
    """Differentiable softmax of `x` (at least 1-D, non-empty) over
    `axis`; a non-trailing axis moves to the end around the rows."""
    axis = axis % x.dim()
    xt = x.movedim(axis, -1)
    x2 = xt.reshape(-1, xt.shape[-1]).contiguous()
    if torch.is_grad_enabled() and x2.requires_grad:
        y2 = _Softmax.apply(x2)
    else:
        y2 = softmax_rows(x2)
    return y2.reshape(xt.shape).movedim(-1, axis)


@register('softmax')
def softmax_op(ctx, ins, attrs):
    return {'Out': softmax(ins['X'], attrs.get('axis', -1))}


# --------------------------------------------------------------- dropout

def dropout_mask(shape, dtype, device, p, generator):
    """The keep mask of a training dropout: 1 with probability 1 - p,
    drawn in float32 on `device` from `generator`, in `dtype` (a
    shape-only `meta` run, with no generator, draws nothing)."""
    m = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if generator is not None:
        m.bernoulli_(1.0 - p, generator=generator)
    return m.to(dtype)


def dropout_apply(x, mask, attrs):
    """Out of a training dropout from its drawn mask."""
    p = attrs.get('dropout_prob', 0.5)
    out = x * mask
    if attrs.get('dropout_implementation',
                 'downgrade_in_infer') == 'upscale_in_train' and p < 1.0:
        out = out / (1.0 - p)
    return out


@register('dropout')
def dropout(ctx, ins, attrs):
    x = ins['X']
    p = attrs.get('dropout_prob', 0.5)
    if attrs.get('is_test', False):
        impl = attrs.get('dropout_implementation', 'downgrade_in_infer')
        out = x * (1.0 - p) if impl == 'downgrade_in_infer' else x
        return {'Out': out, 'Mask': torch.ones_like(x)}
    mask = dropout_mask(x.shape, x.dtype, x.device, p,
                        ctx.generator(attrs.get('seed', 0)))
    return {'Out': dropout_apply(x, mask, attrs), 'Mask': mask}
