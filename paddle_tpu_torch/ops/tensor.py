"""Shape/layout/indexing ops and fill_constant.

Counterpart of paddle_tpu/ops/tensor.py: reshape, squeeze, unsqueeze,
transpose, split, slice, lookup_table, fill_constant,
fill_constant_batch_size_like, assign and assign_value.
"""
import numpy as np
import torch

from ..core.dtypes import convert_dtype, dtype_str, torch_dtype, NARROW
from ..core.registry import register


@register('reshape')
def reshape(ctx, ins, attrs):
    x = ins['X']
    # fluid semantics: 0 -> copy the input dim, -1 -> infer
    out_shape = [x.shape[i] if d == 0 else int(d)
                 for i, d in enumerate(attrs['shape'])]
    return {'Out': x.reshape(out_shape)}


@register('squeeze')
def squeeze(ctx, ins, attrs):
    x = ins['X']
    axes = attrs.get('axes', [])
    if not axes:
        return {'Out': torch.squeeze(x)}
    return {'Out': torch.squeeze(x, dim=tuple(a % x.ndim for a in axes))}


@register('unsqueeze')
def unsqueeze(ctx, ins, attrs):
    x = ins['X']
    for a in sorted(attrs['axes']):
        x = x.unsqueeze(a)
    return {'Out': x}


@register('split')
def split(ctx, ins, attrs):
    x = ins['X']
    axis = attrs.get('axis', 0)
    sections = attrs.get('sections', [])
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        num = attrs.get('num', 0)
        if x.shape[axis] % num:
            raise ValueError('split: dim %d of size %d does not divide into '
                             '%d parts' % (axis, x.shape[axis], num))
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    return {'Out': list(outs)}


@register('transpose')
def transpose(ctx, ins, attrs):
    return {'Out': ins['X'].permute(*attrs['axis'])}


@register('slice')
def slice_op(ctx, ins, attrs):
    x = ins['Input']
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(attrs['axes'], attrs['starts'], attrs['ends']):
        dim = x.shape[a]
        s = s + dim if s < 0 else s
        e = e + dim if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {'Out': x[tuple(idx)]}


@register('lookup_table')
def lookup_table(ctx, ins, attrs):
    # ids [..., 1] int, W [V, D]; the row gather is the hand-written kernel
    # on the card, differentiable through scatter-add (ops/gather.py);
    # padding_idx masking stays here
    from .gather import lookup
    w, ids = ins['W'], ins['Ids']
    padding_idx = attrs.get('padding_idx', -1)
    idx = ids[..., 0] if ids.ndim >= 2 and ids.shape[-1] == 1 else ids
    out = lookup(w, idx)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (idx != padding_idx)[..., None].to(out.dtype)
    return {'Out': out}


def _fill_value(value, dtype_name):
    """Wrap an out-of-range fill value the way a C cast does, as the JAX
    package's `_fill_value` does before its 32-bit narrowing."""
    if dtype_name in ('bfloat16', 'bool'):
        return value
    with np.errstate(over='ignore', invalid='ignore'):
        return np.asarray(value).astype(convert_dtype(dtype_name)).item()


def _full(shape, attrs, device):
    name = dtype_str(attrs.get('dtype', 'float32'))
    return torch.full(shape, _fill_value(attrs['value'],
                                         NARROW.get(name, name)),
                      dtype=torch_dtype(name), device=device)


@register('fill_constant')
def fill_constant(ctx, ins, attrs):
    return {'Out': _full([int(d) for d in attrs['shape']], attrs,
                         ctx.device)}


@register('fill_constant_batch_size_like')
def fill_constant_batch_size_like(ctx, ins, attrs):
    ref = ins['Input']
    shape = [int(d) for d in attrs['shape']]
    shape[attrs.get('output_dim_idx', 0)] = \
        ref.shape[attrs.get('input_dim_idx', 0)]
    return {'Out': _full(shape, attrs, ctx.device)}


@register('assign_value')
def assign_value(ctx, ins, attrs):
    dtype = convert_dtype(attrs.get('dtype', 'float32'))
    vals = np.array(attrs['values'], dtype=dtype).reshape(attrs['shape'])
    return {'Out': ctx.upload(vals).to(torch_dtype(dtype))}


@register('assign')
def assign(ctx, ins, attrs):
    return {'Out': ins['X']}
