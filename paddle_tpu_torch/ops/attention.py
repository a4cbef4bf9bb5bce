"""Flash attention: the hand-written CUDA kernels (forward, dQ, dK/dV),
their plain versions and the differentiable `flash_attention` op.

Counterpart of paddle_tpu/ops/attention.py.  `flash_forward` computes what
the JAX package's `_flash_forward` / `_flash_kernel` compute: online-softmax
attention over q [B, H, Tq, D] and k/v [B, Hkv, Tk, D] (GQA by row map,
no copies of K/V heads), per-batch valid key lengths `k_len`, a causal mask
end-aligned at Tk - Tq, and the per-row float32 logsumexp (as [B*H, Tq]).
On a CUDA tensor it launches csrc/flash_fwd.cu; on a CPU tensor it runs
`_ref_attention`, the same function in plain PyTorch.

`flash_attention` is a `torch.autograd.Function`: forward is
`flash_forward`, which keeps q, k, v, k_len, out and lse as the JAX
`_fwd` does; backward is `flash_backward`, which rebuilds P = exp(S - LSE)
tile by tile under the same masks and runs csrc/flash_bwd.cu (dQ, and
dK/dV with the GQA group summed into its KV head; they replace the TPU
kernels `_flash_dq_kernel` and `_flash_dkv_kernel[_resident]`), or
`flash_backward_reference` on a CPU tensor.

`cached_attention` and `write_cache`, the KV-cache read and write of
streaming generation (serving/generation), are plain torch, as the
reference computes them in jnp outside any Pallas kernel.

There are no size gates: `_FWD_PALLAS_MIN_T` and `_BWD_PALLAS_SCORE_BYTES`
were measured on a TPU and say nothing about this card, so every shape the
kernels take goes to the kernels.  The head dim picks the kernels (same
wrappers, same launch counts): the forward runs the tensor-core kernel
at every multiple of 8 up to 256, bf16 and float32 (as 3xTF32) alike (D
other than 64, 128 and 256 in the instance of padded width 64, 128 or
256, TMA reading the columns past D as zeros); the backward
(`bwd_tensor_core`) runs the tensor-core kernels at every multiple of 8
up to 256 too (the same padded widths; at width 256 the bf16 dK/dV
kernel computes dV and dK in blocks of their own, and the float32 pair
runs as clusters of two blocks, each taking 128 columns of D and adding
its partial S and dP to the other's); no path runs the CUDA-core kernels
of csrc/flash_cc.cu.  A head dim off the multiples of 8 takes
`composed_attention`, the reference's composed path, on purpose and
counted (`flash_attention`).
"""
import torch

from .. import kernels
from ..core.registry import register

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256


def bwd_tensor_core(D, dtype):
    """Whether the flash backward (dQ, dK/dV) at head dim D in `dtype` (a
    torch dtype: bf16 directly, float32 as 3xTF32) is the tensor-core pair
    of csrc/flash_bwd.cu: at every multiple of 8 up to _MAX_D, D other
    than 64, 128 and 256 in the instance of padded width 64, 128 or 256
    (float32 at width 256 in clusters of two blocks that split D)."""
    return dtype in _DTYPE_CODE and D % 8 == 0 and 8 <= D <= _MAX_D


def _ref_attention(q, k, v, causal, scale, k_len=None):
    """Plain version -> (out [B, H, Tq, D] in q's dtype, lse f32 [B*H, Tq]).

    Precision contract of the JAX package's `_ref_attention`: products of
    the input dtype accumulate in float32 (bf16 -> f32 is exact), masking
    and softmax statistics are float32, the output returns in q's dtype.
    A row with no valid key returns zeros and lse -1e30, as the kernels'
    empty loop does; the JAX `_ref_attention` gives the mean of V there."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.float().reshape(B, Hkv, g, Tq, D) * scale
    s = torch.einsum('bhgqd,bhkd->bhgqk', qg, k.float())
    valid = _valid_mask(B, Tq, Tk, causal, k_len, q.device)
    m = torch.where(valid, s, torch.full_like(s, float('-inf'))).amax(
        dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.full_like(m, _NEG_INF))
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum('bhgqk,bhkd->bhgqd', p, v.float())
    o = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(o))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, _NEG_INF))
    return (o.reshape(B, H, Tq, D).to(q.dtype),
            lse.reshape(B * H, Tq))


def _valid_mask(B, Tq, Tk, causal, k_len, device):
    """[B, 1, 1, Tq, Tk] key validity: k_pos < k_len and, when causal,
    k_pos <= q_pos + (Tk - Tq)."""
    kpos = torch.arange(Tk, device=device)
    if k_len is None:
        valid = torch.ones((B, 1, 1, Tq, Tk), dtype=torch.bool, device=device)
    else:
        valid = (kpos[None, :] < k_len.reshape(B, 1).long())[:, None, None,
                                                             None, :]
    if causal:
        qpos = torch.arange(Tq, device=device)
        valid = valid & (kpos[None, :] <= qpos[:, None] + (Tk - Tq))
    return valid


def _check_qkv(q, k, v):
    B, H, Tq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or \
            k.shape[3] != D:
        raise ValueError('flash attention: q %s, k %s, v %s do not match'
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    Hkv, Tk = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError('flash attention: H=%d is not a multiple of Hkv=%d'
                         % (H, Hkv))
    if D % 8 or D > _MAX_D:
        raise ValueError('flash attention kernels take head dims that are '
                         'multiples of 8 up to %d, got %d (ROADMAP C3)'
                         % (_MAX_D, D))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError('flash attention kernel takes float32 or bfloat16 '
                        'q/k/v of one dtype, got %s/%s/%s'
                        % (q.dtype, k.dtype, v.dtype))
    if not (q.device == k.device == v.device):
        raise ValueError('flash attention: q/k/v on different devices')
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError('flash attention kernel takes contiguous q/k/v')
    if min(B, Tq, Tk) < 1:
        raise ValueError('flash attention kernel takes non-empty q and k')


def _check_k_len(k_len, B, Tk, device):
    if k_len is None:
        return torch.full((B,), Tk, dtype=torch.int32, device=device)
    if k_len.dtype != torch.int32 or tuple(k_len.shape) != (B,) or \
            k_len.device != device or not k_len.is_contiguous():
        raise ValueError('flash attention: k_len must be a contiguous int32 '
                         '[B] tensor on the device of q')
    return k_len


def _launch_flash(q, k, v, causal, scale, k_len):
    _check_qkv(q, k, v)
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    k_len = _check_k_len(k_len, B, Tk, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernels.library().pt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_len.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, H, Hkv, Tq, Tk, D,
            _DTYPE_CODE[q.dtype], int(bool(causal)), float(scale), stream)
    kernels.check(rc, 'flash_attention_fwd')
    kernels.launches['flash_attention_fwd'] += 1
    return out, lse


def flash_forward(q, k, v, causal=False, scale=None, k_len=None):
    """-> (out [B, H, Tq, D], lse f32 [B*H, Tq]).  The CUDA kernel for CUDA
    tensors, the plain version for CPU (or shape-only `meta`) tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == 'cuda':
        return _launch_flash(q, k, v, causal, scale, k_len)
    if q.device.type in ('cpu', 'meta'):
        return _ref_attention(q, k, v, causal, scale, k_len)
    raise RuntimeError('flash_attention: no kernel for device %s' % q.device)


def flash_backward_reference(q, k, v, k_len, out, lse, dout, causal, scale):
    """Plain version of the backward -> (dq, dk, dv) in q's / k's / v's
    dtype.  P = exp(S - LSE) is rebuilt from the saved LSE under the masks
    (P = 0 where masked, so rows with LSE -1e30 get zero gradients), dS =
    P * (dO V^T - delta) with delta = rowsum(dO * O); products accumulate
    in float32, as the JAX kernels' `_masked_p_ds` (in float64 for float64
    inputs: the exact gradients a float32 check is held to)."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.to(acc).reshape(B, Hkv, g, Tq, D) * scale
    s = torch.einsum('bhgqd,bhkd->bhgqk', qg, k.to(acc))
    valid = _valid_mask(B, Tq, Tk, causal, k_len, q.device)
    p = torch.where(valid, torch.exp(s - lse.to(acc).reshape(B, Hkv, g, Tq,
                                                             1)),
                    torch.zeros_like(s))
    do = dout.to(acc).reshape(B, Hkv, g, Tq, D)
    delta = (do * out.to(acc).reshape(B, Hkv, g, Tq, D)).sum(-1,
                                                             keepdim=True)
    dp = torch.einsum('bhgqd,bhkd->bhgqk', do, v.to(acc))
    ds = p * (dp - delta)
    dq = torch.einsum('bhgqk,bhkd->bhgqd', ds, k.to(acc)) * scale
    dk = torch.einsum('bhgqk,bhgqd->bhkd', ds, qg)
    dv = torch.einsum('bhgqk,bhgqd->bhkd', p, do)
    return (dq.reshape(B, H, Tq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _launch_bwd_dq(q, k, v, k_len, lse, delta, dout, causal, scale):
    """The dQ kernel on arguments _launch_flash_bwd checked."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = kernels.library().pt_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_len.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dout.data_ptr(), dq.data_ptr(),
            B, H, Hkv, Tq, Tk, D, _DTYPE_CODE[q.dtype], int(bool(causal)),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, 'flash_attention_bwd_dq')
    kernels.launches['flash_attention_bwd_dq'] += 1
    return dq


def _launch_bwd_dkv(q, k, v, k_len, lse, delta, dout, causal, scale):
    """The dK/dV kernel on arguments _launch_flash_bwd checked."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = kernels.library().pt_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_len.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dout.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, Hkv, Tq, Tk, D, _DTYPE_CODE[q.dtype],
            int(bool(causal)), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, 'flash_attention_bwd_dkv')
    kernels.launches['flash_attention_bwd_dkv'] += 1
    return dk, dv


def _bwd_delta(out, dout):
    """delta = rowsum(dO * O) in float32, [B*H, Tq]: one fused reduction,
    outside the kernels as in the JAX package (attention.py:417-419)."""
    return (dout.float() * out.float()).sum(-1).reshape(-1, out.shape[2])


def _launch_flash_bwd(q, k, v, k_len, out, lse, dout, causal, scale):
    _check_qkv(q, k, v)
    B, H, Tq, D = q.shape
    k_len = _check_k_len(k_len, B, k.shape[2], q.device)
    for name, t in (('out', out), ('dout', dout)):
        if t.shape != q.shape or t.dtype != q.dtype or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError('flash attention backward: %s must be a '
                             'contiguous tensor like q' % name)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B * H, Tq) or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError('flash attention backward: lse must be a contiguous '
                         'float32 [B*H, Tq] tensor on the device of q')
    delta = _bwd_delta(out, dout)
    dq = _launch_bwd_dq(q, k, v, k_len, lse, delta, dout, causal, scale)
    dk, dv = _launch_bwd_dkv(q, k, v, k_len, lse, delta, dout, causal, scale)
    return dq, dk, dv


def flash_backward(q, k, v, k_len, out, lse, dout, causal=False,
                   scale=None):
    """-> (dq, dk, dv).  The CUDA kernels for CUDA tensors, the plain
    version for CPU (or shape-only `meta`) tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == 'cuda':
        return _launch_flash_bwd(q, k, v, k_len, out, lse, dout, causal,
                                 scale)
    if q.device.type in ('cpu', 'meta'):
        return flash_backward_reference(q, k, v, k_len, out, lse, dout,
                                        causal, scale)
    raise RuntimeError('flash_attention: no kernel for device %s' % q.device)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, k_len, causal, scale):
        out, lse = flash_forward(q, k, v, causal, scale, k_len)
        ctx.save_for_backward(q, k, v, k_len, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, k_len, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, k_len, out, lse,
                                    dout.contiguous(), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def composed_attention(q, k, v, causal, scale, k_len=None):
    """The JAX package's composed `_ref_attention`, differentiated by
    autograd: the route of the head dims no flash kernel tiles (D % 8 !=
    0), as the reference routes them.  Scores in float32, masked with
    -1e30 (a row with no valid key averages V, as the reference's does),
    the softmax weights in v's dtype for the product, the output in q's."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, Tq, D)
    s = torch.einsum('bhgqd,bhkd->bhgqk', qg.float(), k.float()) * scale
    valid = _valid_mask(B, Tq, Tk, causal, k_len, q.device)
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum('bhgqk,bhkd->bhgqd', w.float(), v.float())
    return out.reshape(B, H, Tq, D).to(q.dtype)


def flash_attention(q, k, v, causal=False, scale=None, k_len=None):
    """q: [B, H, Tq, D]; k/v: [B, Hkv, Tk, D]; k_len: optional int32 [B].
    Differentiable w.r.t. q, k and v.

    The route by head dim, on every device: the forward and the backward
    (`bwd_tensor_core`) on the tensor cores at every multiple of 8 up to
    256 (csrc/flash_fwd.cu, csrc/flash_bwd.cu); D % 8 != 0,
    `composed_attention`, counted as
    `kernels.launches['flash_attention_composed']`, as the JAX package
    routes the shapes its Pallas kernel does not tile; a larger multiple
    of 8 raises (ROADMAP C3).  On the CPU the kernels' plain versions
    run."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    D = q.shape[-1]
    if D % 8:
        kernels.launches['flash_attention_composed'] += 1
        return composed_attention(q, k, v, causal, scale, k_len)
    if D > _MAX_D:
        raise ValueError('flash attention: head dim %d is above the %d the '
                         'kernels take (ROADMAP C3)' % (D, _MAX_D))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        if k_len is None:
            k_len = torch.full((q.shape[0],), k.shape[2], dtype=torch.int32,
                               device=q.device)
        return _FlashAttention.apply(q, k, v, k_len, causal, scale)
    return flash_forward(q, k, v, causal, scale, k_len)[0]


@register('flash_attention')
def flash_attention_op(ctx, ins, attrs):
    # the op owns the layout: transposed views are materialized here, the
    # kernel wrapper takes contiguous tensors only
    q, k, v = (ins[s].contiguous() for s in ('Q', 'K', 'V'))
    k_len = ins.get('KLength')
    if k_len is not None:
        k_len = k_len.reshape(-1).to(torch.int32).contiguous()
    return {'Out': flash_attention(
        q, k, v, causal=attrs.get('causal', False),
        scale=attrs.get('scale', None), k_len=k_len)}


# --------------------------------------------------- KV-cache read path
#
# Counterparts of paddle_tpu/ops/attention.py's cached_attention and
# write_cache.  The reference computes both in jnp outside any Pallas
# kernel, so they stay plain torch here.

def cached_attention(q, kcache, vcache, qpos, scale=None):
    """Attention of new-position queries against KV cache rows.

    q: [B, H, Tq, D], the Tq new positions (a prefill chunk, or Tq = 1 for
    a decode step); kcache/vcache: [B, Hkv, Tk, D] with the new positions'
    K/V already written; qpos: [B, Tq] integer ABSOLUTE positions of the
    queries.  Masking is positional: key position kpos is visible iff
    ``kpos <= qpos``, so chunk offsets and per-slot decode lengths share
    one rule and rows past a slot's length are never attended.  GQA by
    head groups (no copies of K/V heads); products accumulate in float32
    and the output returns in q's dtype."""
    B, H, Tq, D = q.shape
    Hkv, Tk = kcache.shape[1], kcache.shape[2]
    if scale is None:
        scale = D ** -0.5
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Tq, D).float()
    s = torch.einsum('bhgqd,bhkd->bhgqk', qg, kcache.float()) * scale
    kpos = torch.arange(Tk, device=q.device)
    mask = kpos[None, None, :] <= qpos.long()[:, :, None]     # [B, Tq, Tk]
    s = torch.where(mask[:, None, None], s,
                    torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum('bhgqk,bhkd->bhgqd', p.to(vcache.dtype).float(),
                       vcache.float())
    return out.reshape(B, H, Tq, D).to(q.dtype)


def write_cache(kcache, vcache, k, v, slot, layer, offset):
    """Write one layer's new K/V for one slot at a position offset, in
    place (the JAX function returns updated copies; torch tensors are
    updated where they lie), and return the two caches.

    kcache/vcache: [S, L, Hkv, Tmax, D] slot-major; k/v: [Hkv, C, D] for
    the C new positions of layer ``layer``.  ``offset`` is an int or a
    0-d integer tensor; like `dynamic_update_slice` it is clamped so that
    the C rows stay inside Tmax."""
    C, Tmax = k.shape[1], kcache.shape[3]
    if isinstance(offset, torch.Tensor):
        start = offset.to(device=kcache.device, dtype=torch.long).clamp(
            0, Tmax - C)
    else:
        start = min(max(int(offset), 0), Tmax - C)
    idx = start + torch.arange(C, device=kcache.device)
    kcache[int(slot), int(layer)].index_copy_(1, idx, k.to(kcache.dtype))
    vcache[int(slot), int(layer)].index_copy_(1, idx, v.to(vcache.dtype))
    return kcache, vcache
