"""Shape/layout/indexing ops and fill_constant.

Counterpart of paddle_tpu/ops/tensor.py: reshape, squeeze, unsqueeze,
transpose, flatten, split, slice, strided_slice, stack, unstack, expand,
expand_as, gather, scatter, gather_nd, pad, pad2d, pad_constant_like,
lookup_table, one_hot, label_smooth, fill_constant,
fill_constant_batch_size_like, fill_zeros_like, assign, assign_value,
shape, top_k, arg_max, arg_min, argsort, reverse, multiplex,
space_to_depth, shuffle_channel, concat and the two `*_batch_size_like`
draws.

Indexing follows jnp's modes: `gather` is `jnp.take` (a negative index
wraps once, one still out of range gives NaN, or int32's minimum for
integers); `gather_nd` and `multiplex` index as `x[idx]` does (a negative
index wraps once, then the index is clamped to the axis); `scatter` is
`x.at[ids]` (a negative id wraps once, an update at an id still out of
range is dropped).  None of them syncs with the host, so a CUDA graph
captures them.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import convert_dtype, dtype_str, torch_dtype, weak, NARROW
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
    axes = tuple(a % x.ndim for a in axes)
    big = [a for a in axes if x.shape[a] != 1]
    if big:
        # jnp.squeeze raises here; torch.squeeze would keep the axis
        raise ValueError('squeeze: axes %s of shape %s are not of size 1'
                         % (big, tuple(x.shape)))
    return {'Out': torch.squeeze(x, dim=axes)}


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
        # split at the running sums of the sections, as the JAX package
        # does: a -1 section takes what is left before the next cut
        cuts = np.cumsum(sections)[:-1].tolist()
        sizes = np.diff([0] + cuts + [x.shape[axis]]).tolist()
        if min(sizes) < 0:
            raise ValueError('split: sections %s cut dim %d of size %d into '
                             'negative sizes %s' % (list(sections), axis,
                                                    x.shape[axis], sizes))
        outs = torch.split(x, sizes, dim=axis)
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


@register('top_k')
def top_k(ctx, ins, attrs):
    """The k largest entries of the last axis, largest first, a tie in the
    lower index first (`lax.top_k`'s order: a stable descending sort, where
    `torch.topk` leaves the order of ties open); indices int64, computed
    as int32."""
    k = int(attrs['k'])
    vals, idx = torch.sort(ins['X'], dim=-1, descending=True, stable=True)
    return {'Out': vals[..., :k],
            'Indices': idx[..., :k].to(torch_dtype('int64'))}


@register('concat')
def concat(ctx, ins, attrs):
    """jnp.concatenate of the `X` list along `axis`; its gradient comes
    from autograd."""
    xs = ins['X']
    xs = xs if isinstance(xs, (list, tuple)) else [xs]
    return {'Out': torch.cat(list(xs), dim=attrs.get('axis', 0))}


@register('flatten')
def flatten(ctx, ins, attrs):
    x = ins['X']
    ax = attrs.get('axis', 1)
    lead = int(np.prod(x.shape[:ax])) if ax > 0 else 1
    return {'Out': x.reshape(lead, -1)}


@register('stack')
def stack(ctx, ins, attrs):
    xs = ins['X']
    xs = xs if isinstance(xs, (list, tuple)) else [xs]
    return {'Y': torch.stack(list(xs), dim=attrs.get('axis', 0))}


@register('unstack')
def unstack(ctx, ins, attrs):
    return {'Y': list(torch.unbind(ins['X'], dim=attrs.get('axis', 0)))}


@register('expand')
def expand(ctx, ins, attrs):
    # jnp.tile (torch.tile has numpy's semantics too)
    return {'Out': torch.tile(ins['X'], tuple(attrs['expand_times']))}


@register('expand_as')
def expand_as(ctx, ins, attrs):
    x, y = ins['X'], ins['target_tensor']
    return {'Out': torch.tile(x, tuple(t // s for s, t in
                                       zip(x.shape, y.shape)))}


@register('strided_slice')
def strided_slice(ctx, ins, attrs):
    """x[s:e:st] on each listed axis, Python's slice rules; a negative
    stride slices the flipped axis (torch views take positive ones)."""
    x = ins['Input']
    for a, s, e, st in zip(attrs['axes'], attrs['starts'], attrs['ends'],
                           attrs['strides']):
        n = x.shape[a]
        start, stop, step = slice(s, e, st).indices(n)
        if step < 0:
            x = torch.flip(x, [a])
            start, stop, step = n - 1 - start, n - 1 - stop, -step
        idx = [slice(None)] * x.ndim
        idx[a] = slice(start, max(start, stop), step)
        x = x[tuple(idx)]
    return {'Out': x}


def _wrap(idx, n):
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def _squeeze_ids(ids):
    return ids[:, 0] if ids.ndim == 2 and ids.shape[1] == 1 else ids


def _fill_of(dtype):
    """jnp.take's fill for an index out of range."""
    if dtype.is_floating_point:
        return float('nan')
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min


@register('gather')
def gather(ctx, ins, attrs):
    x = ins['X']
    n = x.shape[0]
    idx = _wrap(_squeeze_ids(ins['Index']), n)
    inside = (idx >= 0) & (idx < n)
    out = x[idx.clamp(0, n - 1)]
    mask = inside.reshape(inside.shape + (1,) * (x.ndim - 1))
    return {'Out': torch.where(mask, out, torch.full_like(
        out, _fill_of(x.dtype)))}


@register('scatter')
def scatter(ctx, ins, attrs):
    """x.at[ids].set(updates) (or .add with overwrite=False).  An id out
    of range writes into one extra row that is then cut off."""
    x, upd = ins['X'], ins['Updates']
    n = x.shape[0]
    idx = _wrap(_squeeze_ids(ins['Ids']), n)
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    out = ext.index_put((idx,), upd.to(x.dtype),
                        accumulate=not attrs.get('overwrite', True))
    return {'Out': out[:n]}


def _index(x, idx):
    """x[idx] as jnp indexes, `idx[..., a]` the index along axis a: a
    negative one wraps once, then each is clamped to its axis; the
    gradient of an entry whose index was clamped is dropped, as XLA's
    scatter drops an update out of bounds."""
    wrapped = [_wrap(idx[..., a], n) for a, n in enumerate(
        x.shape[:idx.shape[-1]])]
    inside = None
    for w, n in zip(wrapped, x.shape):
        ok = (w >= 0) & (w < n)
        inside = ok if inside is None else inside & ok
    out = x[tuple(w.clamp(0, n - 1) for w, n in zip(wrapped, x.shape))]
    if not out.requires_grad:
        return out
    mask = inside.reshape(inside.shape + (1,) * (out.ndim - inside.ndim))
    return torch.where(mask, out, out.detach())


@register('gather_nd')
def gather_nd(ctx, ins, attrs):
    return {'Out': _index(ins['X'], ins['Index'])}


def _pad_spec(p, ndim):
    # [before_0, after_0, before_1, ...] -> F.pad's last-axis-first order
    spec = []
    for i in range(ndim - 1, -1, -1):
        spec += [int(p[2 * i]), int(p[2 * i + 1])]
    return spec


@register('pad')
def pad(ctx, ins, attrs):
    x = ins['X']
    return {'Out': F.pad(x, _pad_spec(attrs['paddings'], x.ndim),
                         value=attrs.get('pad_value', 0.0))}


@register('pad2d')
def pad2d(ctx, ins, attrs):
    """NCHW (or NHWC) padding of H and W: constant, reflect (numpy's, the
    edge not repeated) or edge."""
    x = ins['X']
    t, b, l, r = [int(v) for v in attrs['paddings']]
    nhwc = attrs.get('data_format', 'NCHW') == 'NHWC'
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    mode = attrs.get('mode', 'constant')
    if mode == 'constant':
        out = F.pad(x, (l, r, t, b), value=attrs.get('pad_value', 0.0))
    else:
        out = F.pad(x, (l, r, t, b),
                    mode={'reflect': 'reflect', 'edge': 'replicate'}[mode])
    return {'Out': out.permute(0, 2, 3, 1) if nhwc else out}


@register('pad_constant_like')
def pad_constant_like(ctx, ins, attrs):
    x, y = ins['X'], ins['Y']
    spec = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        spec += [0, int(xs - ys)]
    return {'Out': F.pad(y, spec, value=attrs.get('pad_value', 0.0))}


@register('one_hot')
def one_hot(ctx, ins, attrs):
    """jax.nn.one_hot in float32: a label outside [0, depth) gives a row
    of zeros."""
    x = ins['X']
    if x.ndim >= 2 and x.shape[-1] == 1:
        x = x[..., 0]
    depth = int(attrs['depth'])
    cls = torch.arange(depth, device=x.device, dtype=torch.int64)
    return {'Out': (x.long()[..., None] == cls).to(torch.float32)}


@register('label_smooth')
def label_smooth(ctx, ins, attrs):
    """(1 - eps) x + eps / V, or + eps PriorDist; each Python constant in
    the dtype of the tensor it meets (ROADMAP C12)."""
    x = ins['X']
    eps = attrs.get('epsilon', 0.0)
    kept = x * weak(1 - eps, x)
    if ins.get('PriorDist') is not None:
        prior = ins['PriorDist']
        return {'Out': kept + prior * weak(eps, prior)}
    return {'Out': kept + weak(eps / x.shape[-1], kept)}


@register('fill_zeros_like')
def fill_zeros_like(ctx, ins, attrs):
    x = ins['X']
    dev = ctx.device if ctx is not None else x.device
    return {'Out': torch.zeros(tuple(x.shape), dtype=x.dtype, device=dev)}


@register('shape')
def shape_op(ctx, ins, attrs):
    shape = np.array(ins['Input'].shape, dtype=np.int32)
    if ctx is None:
        return {'Out': torch.from_numpy(shape)}
    return {'Out': ctx.upload(shape)}


@register('arg_max')
def arg_max(ctx, ins, attrs):
    # the first maximum, a NaN counting as one, as jnp.argmax; int64 as int32
    return {'Out': torch.argmax(ins['X'], dim=attrs.get('axis', -1))
            .to(torch_dtype('int64'))}


@register('arg_min')
def arg_min(ctx, ins, attrs):
    return {'Out': torch.argmin(ins['X'], dim=attrs.get('axis', -1))
            .to(torch_dtype('int64'))}


@register('argsort')
def argsort(ctx, ins, attrs):
    # a stable ascending sort, NaN last and -0 equal to +0, as jnp.sort
    vals, idx = torch.sort(ins['X'], dim=attrs.get('axis', -1), stable=True)
    return {'Out': vals, 'Indices': idx.to(torch_dtype('int64'))}


@register('reverse')
def reverse(ctx, ins, attrs):
    x = ins['X']
    return {'Out': torch.flip(x, [a % x.ndim for a in attrs['axis']])}


@register('multiplex')
def multiplex(ctx, ins, attrs):
    # row b of X[ids[b]], the id indexed as x[idx] indexes
    xs = torch.stack(list(ins['X']), dim=0)
    ids = ins['Ids'][:, :1].long()
    rows = torch.arange(xs.shape[1], device=xs.device)[:, None]
    return {'Out': _index(xs, torch.cat([ids, rows], dim=1))}


@register('space_to_depth')
def space_to_depth(ctx, ins, attrs):
    x = ins['X']
    bs = attrs['blocksize']
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return {'Out': x.reshape(n, c * bs * bs, h // bs, w // bs)}


@register('shuffle_channel')
def shuffle_channel(ctx, ins, attrs):
    x = ins['X']
    g = attrs['group']
    n, c, h, w = x.shape
    return {'Out': x.reshape(n, g, c // g, h, w).transpose(1, 2)
            .reshape(n, c, h, w)}


def _batch_size_like(ctx, ins, attrs, fill):
    """ops/rand.py's draw at `shape` with dim output_dim_idx taken from
    Input's dim input_dim_idx."""
    from .rand import _random_fill
    shape = [int(d) for d in attrs['shape']]
    shape[attrs.get('output_dim_idx', 0)] = \
        ins['Input'].shape[attrs.get('input_dim_idx', 0)]
    return _random_fill(ctx, dict(attrs, shape=shape), fill)


@register('uniform_random_batch_size_like')
def uniform_random_batch_size_like(ctx, ins, attrs):
    lo, hi = attrs.get('min', -1.0), attrs.get('max', 1.0)
    return _batch_size_like(ctx, ins, attrs, lambda out, g: out.uniform_(
        lo, hi, generator=g))


@register('gaussian_random_batch_size_like')
def gaussian_random_batch_size_like(ctx, ins, attrs):
    mean, std = attrs.get('mean', 0.0), attrs.get('std', 1.0)
    return _batch_size_like(ctx, ins, attrs, lambda out, g: out.normal_(
        mean, std, generator=g))
