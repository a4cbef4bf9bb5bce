"""Token sampling: the `sample_tokens` op and the decode-time draws.

Counterpart of paddle_tpu/ops/sampling.py: the `sample_tokens` op, and
`token_key`, `sample_logits` and `sample_tokens_at`, the position-keyed
draws of streaming generation (serving/generation), below.

``temperature <= 0`` is greedy: the argmax over the last axis, first index
on ties, the same token as the JAX package.  ``top_k > 0`` restricts a
draw to the logits >= the k-th highest (ties at the k-th all stay
eligible).  With ``temperature > 0`` the draw is a Gumbel-max sample from a
torch.Generator seeded from the op's ``seed`` attr or the run's stream
(core/registry.py); it cannot match the JAX package's threefry
``fold_in(key, row)`` stream, so only its distribution agrees.
"""
import torch

from ..core.dtypes import torch_dtype
from ..core.registry import register

_NEG_INF = -1e30


@register('sample_tokens')
def sample_tokens(ctx, ins, attrs):
    logits = ins['Logits']                     # [..., V]
    temp = float(attrs.get('temperature', 0.0))
    top_k = int(attrs.get('top_k', 0))
    flat = logits.reshape(-1, logits.shape[-1]).float()
    out = torch.argmax(flat, dim=-1)
    g = ctx.generator(int(attrs.get('seed', 0))) if temp > 0 else None
    if g is not None:
        k = min(max(top_k, 0), flat.shape[-1])
        if k > 0:
            thresh = torch.topk(flat, k, dim=-1).values[:, k - 1:k]
            flat = torch.where(flat >= thresh, flat,
                               torch.full_like(flat, _NEG_INF))
        u = torch.rand(flat.shape, generator=g, device=flat.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out = torch.argmax(flat / temp + gumbel, dim=-1)
    return {'Out': out.reshape(logits.shape[:-1]).to(torch_dtype('int64'))}


# ------------------------------------------------- decode-time sampling
#
# Counterparts of paddle_tpu/ops/sampling.py's token_key, sample_logits and
# sample_tokens_at.  The contract is the reference's, the stream is not:
# a draw is a pure function of (request seed, absolute position, logits),
# with no stateful generator anywhere, so the same request samples the same
# stream across fused and single-step decode windows, reruns and batch
# compositions.  JAX's threefry `fold_in` cannot be reproduced in torch, so
# the draw is Gumbel-max over uniforms from a counter-based integer hash of
# (seed, position, vocabulary index), computed in int64 torch ops on the
# logits' device and batched over rows.

_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash of an int64 tensor of values in [0, 2**32):
    xor-shift-multiply rounds whose multipliers are below 2**31, so no
    int64 product overflows and every shift is a logical one."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def token_key(seed, position, device=None):
    """The per-token key: keyed by (request seed, absolute position of the
    token being sampled) and nothing else.  Ints or int tensors (of one
    shape) -> an int64 tensor of keys in [0, 2**32)."""
    seed = torch.as_tensor(seed, device=device).long() & _M32
    pos = torch.as_tensor(position, device=seed.device).long() & _M32
    return _mix32(_mix32(seed) ^ ((pos * 0x61C88647) & _M32))


def _gumbel(keys, V):
    """[B] keys -> [B, V] float32 Gumbel noise, one uniform per (key,
    vocabulary index) from the top 24 bits of the hash, in (0, 1)."""
    idx = _mix32(torch.arange(V, device=keys.device, dtype=torch.int64))
    h = _mix32(keys[:, None] ^ idx[None, :])
    u = ((h >> 8).float() + 0.5) * (2.0 ** -24)
    return -torch.log(-torch.log(u))


def _sample_rows(logits, keys, temperatures, top_ks):
    """logits [B, V], keys [B] (token_key), per-row temperatures and top_ks
    ([B], or scalars) -> int32 [B] token ids."""
    logits = logits.float()
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    k = torch.as_tensor(top_ks, device=logits.device).long().clamp(
        0, V).expand(B)
    thresh = torch.sort(logits, dim=-1, descending=True).values.gather(
        1, (k - 1).clamp(0, V - 1)[:, None])
    allowed = (logits >= thresh) | (k[:, None] <= 0)
    temp = torch.as_tensor(temperatures, device=logits.device).float(
        ).expand(B)
    scaled = torch.where(allowed, logits, torch.full_like(logits, _NEG_INF)) \
        / torch.where(temp > 0, temp, torch.ones_like(temp))[:, None]
    drawn = torch.argmax(scaled + _gumbel(keys.reshape(B), V), dim=-1)
    return torch.where(temp > 0, drawn, greedy).to(torch.int32)


def sample_logits(logits, key, temperature=0.0, top_k=0):
    """One row: logits [V] and its `token_key` -> the int32 token id (a
    0-d tensor).  `temperature <= 0` is greedy (argmax, first index on
    ties); `top_k > 0` keeps the logits >= the k-th highest, so ties at the
    k-th all stay eligible."""
    return _sample_rows(logits.reshape(1, -1), torch.as_tensor(key),
                        temperature, top_k)[0]


def sample_tokens_at(logits, seeds, positions, temperatures, top_ks):
    """Independent rows: logits [B, V] with per-row seeds, absolute
    positions, temperatures and top_ks (each [B], on the logits' device)
    -> int32 [B], each row drawn as `sample_logits` draws it."""
    return _sample_rows(logits, token_key(seeds, positions, logits.device),
                        temperatures, top_ks)
