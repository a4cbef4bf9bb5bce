"""Normalisation, position, softmax, dropout, convolution and pooling ops:
rms_norm, rope, layer_norm, add_position_encoding, softmax, dropout,
conv2d, pool2d and batch_norm.

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

`conv2d` is `F.conv2d` (cuDNN on the card), NCHW / OIHW, as the JAX
package leaves its convolution to XLA (`lax.conv_general_dilated`) outside
any kernel of its own.  A float32 convolution computes in float32 on the
card whatever `torch.backends.cudnn.allow_tf32` says: the op turns cuDNN's
TF32 off around its forward and its backward (`_Conv2d`).  `pool2d` pads
explicitly as the JAX op does (`_pool`): -inf for max and 0 for avg on the
low side, and on the high side under `ceil_mode` as far as the last window
that starts inside the padded input needs, then pools without padding; avg
divides the window sums by the count of real elements (`exclusive`) or by
the window's size.  `batch_norm` is the JAX op's formula in torch ops:
float32 one-pass statistics shifted by each channel's first element,
`var = max(E[d^2] - E[d]^2, 0)`, Y in the input's dtype, and the moving
statistics `momentum * old + (1 - momentum) * batch` with the biased
variance, written in place into the persistable Mean and Variance (not
`F.batch_norm`, whose momentum is the other way round and whose running
variance is the unbiased one).
"""
import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..core.registry import register
from ..core.dtypes import weak

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
        out = out / weak(1.0 - p, out)
    return out


@register('dropout')
def dropout(ctx, ins, attrs):
    x = ins['X']
    p = attrs.get('dropout_prob', 0.5)
    if attrs.get('is_test', False):
        impl = attrs.get('dropout_implementation', 'downgrade_in_infer')
        out = x * weak(1.0 - p, x) if impl == 'downgrade_in_infer' else x
        return {'Out': out, 'Mask': torch.ones_like(x)}
    # under a CUDA graph ctx.generator is one the capture registered,
    # seeded before each replay as this run would seed it (core/graphs.py)
    mask = dropout_mask(x.shape, x.dtype, x.device, p,
                        ctx.generator(attrs.get('seed', 0)))
    return {'Out': dropout_apply(x, mask, attrs), 'Mask': mask}


# ------------------------------------------------------------ convolution

def _pair(v):
    return tuple(int(a) for a in v) if isinstance(v, (list, tuple)) \
        else (int(v), int(v))


@contextlib.contextmanager
def _cudnn_float32():
    """cuDNN's TF32 off: a float32 convolution in float32, as the JAX
    package's is."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


class _Conv2d(torch.autograd.Function):
    """F.conv2d, forward and backward under `_cudnn_float32`: the
    backward reads cuDNN's TF32 flag when it runs, outside the op."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        with _cudnn_float32():
            return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        want = ctx.needs_input_grad
        with _cudnn_float32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, list(stride), list(padding), list(dilation),
                False, [0, 0], groups, [want[0], want[1], False])
        return gx, gw, None, None, None, None


def conv2d_nchw(x, w, strides=(1, 1), paddings=(0, 0), dilations=(1, 1),
                groups=1):
    """The convolution of `x` [N, C, H, W] with `w` [O, C / groups, kh, kw]
    and symmetric zero padding."""
    return _Conv2d.apply(x, w, _pair(strides), _pair(paddings),
                         _pair(dilations), int(groups or 1))


@register('conv2d')
def conv2d(ctx, ins, attrs):
    out = conv2d_nchw(ins['Input'], ins['Filter'],
                      attrs.get('strides', [1, 1]),
                      attrs.get('paddings', [0, 0]),
                      attrs.get('dilations', [1, 1]),
                      attrs.get('groups', 1))
    if 'Bias' in ins:
        out = out + ins['Bias'].reshape(1, -1, 1, 1)
    return {'Output': out}


# ---------------------------------------------------------------- pooling

def _pool2d(x, ksize, strides, paddings, ptype='max', exclusive=True,
                ceil_mode=False, global_pooling=False):
    """The JAX op's `_pool` on [N, C, H, W]."""
    if global_pooling:
        if ptype == 'max':
            return x.amax(dim=(2, 3), keepdim=True)
        return x.mean(dim=(2, 3), keepdim=True)
    ksize, strides, pads = _pair(ksize), _pair(strides), _pair(paddings)
    hi = []
    for i in range(2):
        h = pads[i]
        if ceil_mode:
            size = x.shape[2 + i]
            out = -(-(size + 2 * pads[i] - ksize[i]) // strides[i]) + 1
            needed = (out - 1) * strides[i] + ksize[i] - size - pads[i]
            h = max(pads[i], needed)
        hi.append(h)
    spec = (pads[1], hi[1], pads[0], hi[0])
    if ptype == 'max':
        return F.max_pool2d(F.pad(x, spec, value=float('-inf')), ksize,
                            strides)
    s = F.avg_pool2d(F.pad(x, spec), ksize, strides, divisor_override=1)
    if exclusive:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        return s / F.avg_pool2d(F.pad(ones, spec), ksize, strides,
                                divisor_override=1)
    return s / float(ksize[0] * ksize[1])


@register('pool2d')
def pool2d(ctx, ins, attrs):
    return {'Out': _pool2d(ins['X'], attrs.get('ksize', [2, 2]),
                           attrs.get('strides', [1, 1]),
                           attrs.get('paddings', [0, 0]),
                           attrs.get('pooling_type', 'max'),
                           attrs.get('exclusive', True),
                           attrs.get('ceil_mode', False),
                           attrs.get('global_pooling', False))}


# ------------------------------------------------------------- batch norm

@register('batch_norm')
def batch_norm(ctx, ins, attrs):
    x = ins['X']
    scale, bias = ins['Scale'], ins['Bias']
    mean, var = ins['Mean'], ins['Variance']
    eps = attrs.get('epsilon', 1e-5)
    momentum = attrs.get('momentum', 0.9)
    ch = 1 if attrs.get('data_layout', 'NCHW') == 'NCHW' else x.ndim - 1
    axes = tuple(i for i in range(x.ndim) if i != ch)
    bshape = [1] * x.ndim
    bshape[ch] = x.shape[ch]
    xf = x.float()
    if attrs.get('is_test', False) or attrs.get('use_global_stats', False):
        y = (xf - mean.reshape(bshape)) * (
            scale.reshape(bshape) * torch.rsqrt(var.reshape(bshape) + eps)) \
            + bias.reshape(bshape)
        return {'Y': y.to(x.dtype), 'MeanOut': mean, 'VarianceOut': var,
                'SavedMean': mean, 'SavedVariance': var}
    # one read of x for both sums, shifted by the channel's first element
    # so that E[d^2] - E[d]^2 does not cancel when |mean| >> std; the shift
    # is stop_gradient and cancels analytically
    c = xf[tuple(slice(None) if i == ch else slice(0, 1)
                 for i in range(x.ndim))].detach()
    d = xf - c
    md = d.mean(dim=axes, keepdim=True)
    v = torch.clamp_min(d.square().mean(dim=axes, keepdim=True) -
                        md.square(), 0.0)
    m = (md + c).reshape(x.shape[ch])
    v = v.reshape(x.shape[ch])
    y = (d - md) * (scale.reshape(bshape) *
                    torch.rsqrt(v.reshape(bshape) + eps)) + \
        bias.reshape(bshape)
    with torch.no_grad():
        mean.copy_(momentum * mean + (1 - momentum) * m)
        var.copy_(momentum * var + (1 - momentum) * v)
    return {'Y': y.to(x.dtype), 'MeanOut': mean, 'VarianceOut': var,
            'SavedMean': m, 'SavedVariance': v}
