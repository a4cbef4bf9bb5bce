"""Sequence ops over the padded-batch (+ lengths) layout, and the RNNs.

Counterpart of paddle_tpu/ops/sequence.py: sequence_pool, sequence_softmax,
sequence_conv, sequence_expand / expand_as, sequence_reverse,
sequence_pad / unpad, sequence_mask, sequence_slice, sequence_concat,
sequence_enumerate, sequence_reshape, sequence_scatter, sequence_erase,
lstm, gru, lstm_unit and gru_unit.  Every op is a masked dense
computation over [B, T, ...] with an int32 `Length` [B] input, so shapes
are static: nothing is read back to the host, and a CUDA graph captured
for one T bucket is right for every batch of it (the lengths are a feed,
copied in before each replay).  The recurrences, a `lax.scan` in the
reference, are a Python loop over T of torch ops here, the step's math in
the reference's order; autograd records it for the backward.
"""
import torch

from ..core.dtypes import torch_dtype, weak
from ..core.registry import register
from .math import _clip, _sigmoid


def _mask(x, length):
    """[B, T] validity mask broadcastable to x [B, T, ...]."""
    B, T = x.shape[0], x.shape[1]
    m = torch.arange(T, device=x.device)[None, :] < length[:, None]
    return m.reshape((B, T) + (1,) * (x.ndim - 2))


def _length_or_full(ins, x, key='Length'):
    if ins.get(key) is not None:
        return ins[key]
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                      device=x.device)


def _take_t(x, idx):
    """x[b, idx[b, t]] along axis 1 (jnp.take_along_axis), idx [B, T']."""
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(
        tuple(idx.shape) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx.long())


@register('sequence_pool')
def sequence_pool(ctx, ins, attrs):
    x = ins['X']  # [B, T, ...]
    length = _length_or_full(ins, x)
    ptype = attrs.get('pooltype', 'AVERAGE').upper()
    m = _mask(x, length)
    mf = m.to(x.dtype)
    cnt = torch.clamp_min(length.to(x.dtype), 1).reshape(
        (-1,) + (1,) * (x.ndim - 2))
    if ptype == 'SUM':
        out = torch.sum(x * mf, dim=1)
    elif ptype == 'AVERAGE':
        out = torch.sum(x * mf, dim=1) / cnt
    elif ptype == 'SQRT':
        out = torch.sum(x * mf, dim=1) / torch.sqrt(cnt)
    elif ptype == 'MAX':
        # amax, as jnp.max, splits the gradient equally among ties
        # (torch.max(dim=) sends it all to one index)
        neg = torch.finfo(x.dtype).min
        out = torch.amax(torch.where(m, x, neg), dim=1)
    elif ptype == 'LAST':
        idx = torch.clamp_min(length - 1, 0)
        out = _take_t(x, idx.reshape(-1, 1))[:, 0]
    elif ptype == 'FIRST':
        out = x[:, 0]
    else:
        raise ValueError('bad pooltype %s' % ptype)
    return {'Out': out, 'MaxIndex': None}


@register('sequence_softmax')
def sequence_softmax(ctx, ins, attrs):
    x = ins['X']  # [B, T] or [B, T, 1]
    length = _length_or_full(ins, x)
    m = _mask(x, length)
    neg = torch.finfo(x.dtype).min
    out = torch.softmax(torch.where(m, x, neg), dim=1)
    return {'Out': out * m.to(x.dtype)}


@register('sequence_expand')
def sequence_expand(ctx, ins, attrs):
    # x: [B, ...] (one row per sequence), y gives the time dim ->
    # out [B, T, ...], the row repeated along it
    x, y = ins['X'], ins['Y']
    if x.ndim == y.ndim:
        return {'Out': x}
    T = y.shape[1]
    return {'Out': x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
            .contiguous()}


@register('sequence_expand_as')
def sequence_expand_as(ctx, ins, attrs):
    x, y = ins['X'], ins['Y']
    T = y.shape[1]
    return {'Out': x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
            .contiguous()}


@register('sequence_reverse')
def sequence_reverse(ctx, ins, attrs):
    x = ins['X']
    length = _length_or_full(ins, x)
    T = x.shape[1]
    # reverse only the valid prefix: index len - 1 - t for t < len
    t = torch.arange(T, device=x.device)[None, :]
    idx = torch.where(t < length[:, None], length[:, None] - 1 - t, t)
    return {'Y': _take_t(x, idx)}


@register('sequence_conv')
def sequence_conv(ctx, ins, attrs):
    x, w = ins['X'], ins['Filter']  # x [B, T, D], w [ctx_len * D, out]
    length = _length_or_full(ins, x)
    ctx_len = attrs.get('contextLength', 3)
    ctx_start = attrs.get('contextStart', -(ctx_len // 2))
    B, T, D = x.shape
    xm = x * _mask(x, length).to(x.dtype)
    t = torch.arange(T, device=x.device)
    cols = []
    for i in range(ctx_len):
        off = ctx_start + i
        shifted = torch.roll(xm, -off, dims=1)
        # valid against T, not against the row's length: past the length
        # the masked zeros come in
        valid = (t + off >= 0) & (t + off < T)
        cols.append(shifted * valid[None, :, None].to(x.dtype))
    col = torch.cat(cols, dim=-1)  # [B, T, ctx_len * D]
    out = torch.matmul(col, w)
    return {'Out': out * _mask(out, length).to(out.dtype)}


@register('sequence_pad')
def sequence_pad(ctx, ins, attrs):
    x = ins['X']
    length = _length_or_full(ins, x)
    # already padded in this layout
    return {'Out': x, 'Length': length.to(torch_dtype('int64'))}


@register('sequence_unpad')
def sequence_unpad(ctx, ins, attrs):
    return {'Out': ins['X'], 'OutLength': ins['Length'].to(torch.int32)}


@register('sequence_mask')
def sequence_mask(ctx, ins, attrs):
    x = ins['X']  # lengths
    maxlen = attrs.get('maxlen', -1)
    dtype = torch_dtype(attrs.get('out_dtype', 'int64'))
    if maxlen is None or maxlen < 0:
        raise ValueError('sequence_mask needs a static maxlen attr (a '
                         'shape read from the lengths would sync the host)')
    m = torch.arange(maxlen, device=x.device)[None, :] < x.reshape(-1, 1)
    return {'Y': m.reshape(tuple(x.shape) + (maxlen,)).to(dtype)}


@register('sequence_slice')
def sequence_slice(ctx, ins, attrs):
    x, offset, length = ins['X'], ins['Offset'], ins['Length']
    T = x.shape[1]
    off = offset.reshape(-1).to(torch.int32)
    t = torch.arange(T, device=x.device)[None, :]
    out = _take_t(x, torch.clamp_max(off[:, None] + t, T - 1))
    # clamped to the row's valid end, so padding never counts as tokens
    row_len = _length_or_full(ins, x, key='XLength').to(torch.int32)
    new_len = torch.minimum(
        torch.clamp_min(length.reshape(-1).to(torch.int32), 0),
        torch.clamp_min(row_len - off, 0))
    m = (t < new_len[:, None]).reshape((x.shape[0], T) + (1,) * (x.ndim - 2))
    return {'Out': out * m.to(x.dtype), 'OutLength': new_len}


def _compact(x, keep, T):
    """The kept positions of each row moved left in order (a stable sort
    on (dropped, position)) -> (gathered x, the positions [B, T])."""
    t = torch.arange(T, device=keep.device)[None, :].expand(keep.shape)
    order = torch.argsort(torch.where(keep, t, t + T), dim=1, stable=True)
    return _take_t(x, order), t


@register('sequence_concat')
def sequence_concat(ctx, ins, attrs):
    """Row i of the output is input 0's valid tokens then input 1's, with
    length the sum: the concatenated padded blocks compacted left."""
    xs = ins['X']
    xs = xs if isinstance(xs, (list, tuple)) else [xs]
    lens = ins.get('Length')
    combined = torch.cat(list(xs), dim=1)            # [B, sum T, ...]
    B, T = combined.shape[:2]
    if lens is None:
        return {'Out': combined,
                'OutLength': torch.full((B,), T, dtype=torch.int32,
                                        device=combined.device)}
    lens = lens if isinstance(lens, (list, tuple)) else [lens]
    valid = torch.cat([
        torch.arange(x.shape[1], device=x.device)[None, :] <
        l.reshape(-1).to(torch.int32)[:, None] for x, l in zip(xs, lens)],
        dim=1)
    out, t = _compact(combined, valid, T)
    new_len = valid.sum(dim=1).to(torch.int32)
    tail = (t < new_len[:, None]).reshape((B, T) + (1,) * (combined.ndim - 2))
    return {'Out': torch.where(tail, out, torch.zeros_like(out)),
            'OutLength': new_len}


@register('sequence_enumerate')
def sequence_enumerate(ctx, ins, attrs):
    x = ins['X']  # [B, T] or [B, T, 1] int
    win = attrs['win_size']
    pad_value = attrs.get('pad_value', 0)
    ids = x[..., 0] if x.ndim == 3 else x
    T = ids.shape[1]
    outs = []
    for i in range(win):
        shifted = torch.roll(ids, -i, dims=1)
        valid = (torch.arange(T, device=x.device) + i < T)[None, :]
        outs.append(torch.where(valid, shifted,
                                torch.full_like(shifted, pad_value)))
    return {'Out': torch.stack(outs, dim=-1)}


@register('sequence_reshape')
def sequence_reshape(ctx, ins, attrs):
    x = ins['X']  # [B, T, D]
    new_dim = attrs['new_dim']
    B, T, D = x.shape
    # suffix padding keeps a row's data contiguous through the flatten,
    # so only the lengths rescale
    length = _length_or_full(ins, x)
    new_len = torch.div(length.to(torch.int32) * D, new_dim,
                        rounding_mode='floor').to(torch.int32)
    return {'Out': x.reshape(B, T * D // new_dim, new_dim),
            'OutLength': new_len}


@register('sequence_scatter')
def sequence_scatter(ctx, ins, attrs):
    x, ids, updates = ins['X'], ins['Ids'], ins['Updates']
    # ids / updates [B, T(, 1)]: scatter-add along axis 1 of x
    idx = ids[..., 0] if ids.ndim == 3 else ids
    upd = updates[..., 0] if updates.ndim == 3 else updates
    idx = torch.where(idx < 0, idx + x.shape[1], idx).long()
    return {'Out': x.scatter_add(1, idx, upd.to(x.dtype))}


@register('sequence_erase')
def sequence_erase(ctx, ins, attrs):
    """Each row without the attr `tokens`: kept tokens compacted left, the
    tail zero, the new lengths in OutLength."""
    x = ins['X']  # [B, T] or [B, T, 1] int tokens
    tokens = attrs.get('tokens', [])
    length = _length_or_full(ins, x)
    ids = x[..., 0] if x.ndim == 3 else x
    B, T = ids.shape
    t = torch.arange(T, device=x.device)[None, :]
    keep = t < length[:, None]
    for tok in tokens:
        keep = keep & (ids != tok)
    compacted, t = _compact(ids, keep, T)
    new_len = keep.sum(dim=1).to(torch.int32)
    out = torch.where(t < new_len[:, None], compacted,
                      torch.zeros_like(compacted))
    if x.ndim == 3:
        out = out[..., None]
    return {'Out': out, 'OutLength': new_len}


# --------------------------------------------------------------- RNNs

def _relu(x):
    # jax.nn.relu (ops/math.py relu)
    return torch.nn.functional.threshold(x, 0, 0)


def _hard_sigmoid(x):
    return _clip(weak(0.2, x) * x + weak(0.5, x), 0., 1.)


_ACTS = {'sigmoid': _sigmoid, 'tanh': torch.tanh, 'relu': _relu,
         'identity': lambda x: x, 'hard_sigmoid': _hard_sigmoid}


def _step_masks(x, length, is_reverse):
    """The T step masks [B, 1] (flipped for a reverse pass) in x's dtype,
    and their complements 1 - m, as views of two [B, T] tensors."""
    T = x.shape[1]
    m = (torch.arange(T, device=x.device)[None, :] <
         length[:, None]).to(x.dtype)
    if is_reverse:
        m = torch.flip(m, dims=[1])
    m = m[:, :, None]
    return m.unbind(1), (1 - m).unbind(1)


def lstm_scan(xproj, h0, c0, w, bias, length, gate_act, cell_act, cand_act,
              use_peepholes, is_reverse):
    """The reference's `_lstm_scan`: xproj [B, T, 4D] already projected,
    w [D, 4D] recurrent, gate layout [i, f, g (candidate), o], the carry
    kept where a step is past the row's length.  -> (hs, cs) [B, T, D]
    each."""
    D = xproj.shape[2] // 4
    if is_reverse:
        xproj = torch.flip(xproj, dims=[1])
    ms, ims = _step_masks(xproj, length, is_reverse)
    if use_peepholes:
        b_g, w_ic, w_fc, w_oc = (bias[:, :4 * D], bias[:, 4 * D:5 * D],
                                 bias[:, 5 * D:6 * D], bias[:, 6 * D:7 * D])
    else:
        b_g = bias
    h, c = h0, c0
    hs, cs = [], []
    # one unbind, whose backward stacks the T step gradients once
    # (xproj[:, t] in the loop would write a zero [B, T, 4D] gradient a
    # step)
    for t, xt in enumerate(xproj.unbind(1)):
        gates = xt + torch.matmul(h, w) + b_g
        i, f, g, o = torch.split(gates, D, dim=-1)
        if use_peepholes:
            i = i + c * w_ic
            f = f + c * w_fc
        i, f = gate_act(i), gate_act(f)
        g = cand_act(g)
        c_new = f * c + i * g
        if use_peepholes:
            o = o + c_new * w_oc
        o = gate_act(o)
        h_new = o * cell_act(c_new)
        h = ms[t] * h_new + ims[t] * h
        c = ms[t] * c_new + ims[t] * c
        hs.append(h)
        cs.append(c)
    hs, cs = torch.stack(hs, dim=1), torch.stack(cs, dim=1)
    if is_reverse:
        hs, cs = torch.flip(hs, dims=[1]), torch.flip(cs, dims=[1])
    return hs, cs


@register('lstm')
def lstm(ctx, ins, attrs):
    """dynamic_lstm: Input [B, T, 4D] (pre-projected), Weight [D, 4D],
    Bias [1, 4D or 7D], optional H0 / C0 [B, D]."""
    x, w, bias = ins['Input'], ins['Weight'], ins['Bias']
    length = _length_or_full(ins, x)
    D, B = w.shape[0], x.shape[0]
    h0, c0 = ins.get('H0'), ins.get('C0')
    if h0 is None:
        h0 = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    hs, cs = lstm_scan(
        x, h0, c0, w, bias, length,
        _ACTS[attrs.get('gate_activation', 'sigmoid')],
        _ACTS[attrs.get('cell_activation', 'tanh')],
        _ACTS[attrs.get('candidate_activation', 'tanh')],
        attrs.get('use_peepholes', True), attrs.get('is_reverse', False))
    return {'Hidden': hs, 'Cell': cs}


@register('gru')
def gru(ctx, ins, attrs):
    """dynamic_gru: Input [B, T, 3D] pre-projected, Weight [D, 3D] as
    [W_update | W_reset | W_candidate], Bias [1, 3D]."""
    x, w = ins['Input'], ins['Weight']
    bias = ins.get('Bias')
    length = _length_or_full(ins, x)
    D, B = w.shape[0], x.shape[0]
    h0 = ins.get('H0')
    if h0 is None:
        h0 = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    if bias is None:
        bias = torch.zeros((1, 3 * D), dtype=x.dtype, device=x.device)
    gact = _ACTS[attrs.get('gate_activation', 'sigmoid')]
    cact = _ACTS[attrs.get('activation', 'tanh')]
    is_reverse = attrs.get('is_reverse', False)
    w_ur, w_c = w[:, :2 * D], w[:, 2 * D:]
    if is_reverse:
        x = torch.flip(x, dims=[1])
    ms, ims = _step_masks(x, length, is_reverse)
    h, hs = h0, []
    for t, xt in enumerate(x.unbind(1)):
        xu, xr, xc = torch.split(xt + bias, D, dim=-1)
        ur = gact(torch.cat([xu, xr], -1) + torch.matmul(h, w_ur))
        u, r = torch.split(ur, D, dim=-1)
        c = cact(xc + torch.matmul(r * h, w_c))
        h_new = u * h + (1 - u) * c
        h = ms[t] * h_new + ims[t] * h
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    if is_reverse:
        hs = torch.flip(hs, dims=[1])
    return {'Hidden': hs}


_UNIT_ACTS = {1: 'sigmoid', 2: 'tanh', 0: 'identity', 3: 'relu'}


@register('gru_unit')
def gru_unit(ctx, ins, attrs):
    x, h_prev, w = ins['Input'], ins['HiddenPrev'], ins['Weight']
    D = h_prev.shape[-1]
    bias = ins.get('Bias')
    if bias is None:
        bias = torch.zeros((1, 3 * D), dtype=x.dtype, device=x.device)
    gact = _ACTS[_UNIT_ACTS.get(attrs.get('gate_activation', 1), 'sigmoid')]
    cact = _ACTS[_UNIT_ACTS.get(attrs.get('activation', 2), 'tanh')]
    xu, xr, xc = torch.split(x + bias, D, dim=-1)
    w_ur, w_c = w[:, :2 * D], w[:, 2 * D:]
    ur = gact(torch.cat([xu, xr], -1) + torch.matmul(h_prev, w_ur))
    u, r = torch.split(ur, D, dim=-1)
    c = cact(xc + torch.matmul(r * h_prev, w_c))
    h = u * h_prev + (1 - u) * c
    return {'Hidden': h, 'Gate': torch.cat([u, r, c], -1),
            'ResetHiddenPrev': r * h_prev}


@register('lstm_unit')
def lstm_unit(ctx, ins, attrs):
    x, c_prev = ins['X'], ins['C_prev']
    forget_bias = attrs.get('forget_bias', 0.0)
    i, f, g, o = torch.chunk(x, 4, dim=-1)
    c = _sigmoid(f + weak(forget_bias, f)) * c_prev + \
        _sigmoid(i) * torch.tanh(g)
    h = _sigmoid(o) * torch.tanh(c)
    return {'C': c, 'H': h}
