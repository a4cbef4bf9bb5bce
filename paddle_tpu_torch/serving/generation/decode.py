"""Prefill, decode and verify over the PAGED KV pool, in torch.

Counterpart of paddle_tpu/serving/generation/decode.py.  The reference
compiles each window into one AOT executable (a `lax.scan` with the page
pools as donated carry); the port runs the same step body as a Python
loop of K steps whose carry (the pools and the per-slot ``lengths`` /
``tok`` vectors) stays on the device and is updated in place: nothing is
read back to the host until the window ends.  K/V live in a shared page
pool (kv_cache.py); every read and write goes through a per-slot BLOCK
TABLE, plain ``[slots, max_pages]`` int32 data uploaded once a launch.

Inactive slots ride along under a mask with their write target forced to
the GARBAGE page 0; active slots past their reservation fall through to
page 0 as well (unmapped block-table entries are 0).

Token embedding goes through K4 (ops/gather.py::embedding_gather), after
the ids are normalised exactly as JAX indexing does (a negative id gets
+V once, then the id is clamped to [0, V-1]).

Prefill is chunked: each chunk scatters its K/V rows into the pages its
block table maps and attends (ops/attention.py::cached_attention, plain
torch as in the reference) against the GATHERED logical rows, with the
positional mask ``kpos <= qpos``.  As in the reference, every layer
reassembles all ``max_len`` rows of every slot, so the shapes of a
step's products never depend on the lengths of the other slots in the
batch, nor a stream on the batch it runs in.  With
``quant='int8'`` rows are stored as int8 with one float32 scale per
(token, kv head), quantized on write and dequantized in the gather.

`verify_window` is the speculative-decode twin of `decode_window`: the
same step body, but step j feeds a HOST-PROVIDED token (last emitted
token, then the draft's proposals) and returns the target model's
samples.  The position-keyed sampling (ops/sampling.py) makes a verified
prefix bitwise what sequential decode produces.  `dense_reference` is the
independent, page-free oracle.

Not ported: the ring prefill (`prefill_ring`, `ring_pad`), the AOT
executables and their disk cache, the flight recorder and trace spans,
and the fault hooks.
"""
import os

import numpy as np
import torch

from ...core.executor import to_device
from ...core.framework import require_cuda
from ...ops.attention import cached_attention
from ...ops.gather import embedding_gather
from ...ops.sampling import sample_logits, sample_tokens_at, token_key
from ..counters import Counters
from .kv_cache import (CacheConfig, PagePool, PrefixCache, SlotAllocator,
                       init_state)

__all__ = ['DecodeRuntime', 'dense_reference', 'weight_names',
           'random_weights']

_WEIGHT_SLOTS = ('att_q_w', 'att_k_w', 'att_v_w', 'att_o_w', 'att_norm',
                 'ffn_norm', 'ffn_fc1_w', 'ffn_fc2_w', 'ffn_fc3_w')


def weight_names(cfg):
    """The decode-side parameter names: the names a llama program leaves in
    its scope (models/llama.py layout)."""
    names = ['tok_emb', 'final_norm', 'lm_proj_w']
    for i in range(int(cfg['n_layer'])):
        names.extend('layer_%d_%s' % (i, s) for s in _WEIGHT_SLOTS)
    return names


def random_weights(cfg, seed=0, scale=0.08):
    """Random weight dict (numpy float32) with the llama layout, drawn from
    ``np.random.RandomState(seed)`` in the reference's order, so one seed
    gives the same arrays in both packages."""
    rng = np.random.RandomState(seed)
    d, v, h = int(cfg['d_model']), int(cfg['vocab']), int(cfg['n_head'])
    hkv, f = int(cfg['n_kv_head']), int(cfg['d_ffn'])
    dh = d // h
    shapes = {'tok_emb': (v, d), 'final_norm': (d,), 'lm_proj_w': (d, v)}
    for i in range(int(cfg['n_layer'])):
        p = 'layer_%d_' % i
        shapes.update({p + 'att_q_w': (d, h * dh), p + 'att_k_w': (d, hkv * dh),
                       p + 'att_v_w': (d, hkv * dh), p + 'att_o_w': (d, d),
                       p + 'att_norm': (d,), p + 'ffn_norm': (d,),
                       p + 'ffn_fc1_w': (d, f), p + 'ffn_fc3_w': (d, f),
                       p + 'ffn_fc2_w': (f, d)})
    out = {}
    for n, s in shapes.items():
        if n.endswith('norm'):
            out[n] = np.ones(s, np.float32)
        else:
            out[n] = (scale * rng.randn(*s)).astype(np.float32)
    return out


# ------------------------------------------------------- forward pieces

def _rms(x, scale):
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * scale


def _rope_at(x, pos, theta):
    """x: [B, h, T, dh]; pos: [B, T] absolute positions (per row: decode
    slots all sit at different lengths)."""
    dh = x.shape[-1]
    half = torch.arange(0, dh // 2, dtype=torch.float32, device=x.device)
    freqs = torch.pow(theta, -half * 2.0 / dh)
    ang = pos[:, None, :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def _qkv(w, cfg, h, i):
    """h: [B, T, D] -> q [B, H, T, dh], k/v [B, Hkv, T, dh] (pre-rope)."""
    B, T = h.shape[0], h.shape[1]
    H, Hkv = int(cfg['n_head']), int(cfg['n_kv_head'])
    dh = int(cfg['d_model']) // H
    p = 'layer_%d_' % i
    q = (h @ w[p + 'att_q_w']).reshape(B, T, H, dh).transpose(1, 2)
    k = (h @ w[p + 'att_k_w']).reshape(B, T, Hkv, dh).transpose(1, 2)
    v = (h @ w[p + 'att_v_w']).reshape(B, T, Hkv, dh).transpose(1, 2)
    return q, k, v


def _ffn(w, x, i):
    p = 'layer_%d_' % i
    hh = _rms(x, w[p + 'ffn_norm'])
    gate = torch.nn.functional.silu(hh @ w[p + 'ffn_fc1_w'])
    return x + (gate * (hh @ w[p + 'ffn_fc3_w'])) @ w[p + 'ffn_fc2_w']


def jax_index_ids(ids, V):
    """Token ids as JAX indexing reads them: a negative id gets +V once,
    then the id is clamped to [0, V-1] (K4 itself gives a NaN row for an
    id out of range)."""
    ids = ids.long()
    return torch.where(ids < 0, ids + V, ids).clamp(0, V - 1)


def _embed(w, ids):
    """Rows of the token table through K4 (the CUDA gather on the card)."""
    table = w['tok_emb']
    return embedding_gather(table, jax_index_ids(ids, table.shape[0]))


# -------------------------------------------------- paged read / write

def _quantize_rows(x):
    """x [..., dh] float32 -> (int8 rows, float32 per-row scale).  amax/127
    scaling, clamped so that an all-zero row round-trips to zeros."""
    s = torch.clamp_min(x.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _write_rows(st, i, pg, rw, k_new, v_new, quant):
    """Scatter per-token K/V rows into layer ``i`` of the pools, in place.

    pg/rw: [N] page ids and in-page rows; k_new/v_new: [N, Hkv, dh]
    float32.  Rows routed to page 0 (masked or invalid targets) are
    write-only garbage, never attended."""
    if quant:
        qk, sk = _quantize_rows(k_new)
        qv, sv = _quantize_rows(v_new)
        st['k'][:, i][pg, :, rw, :] = qk
        st['v'][:, i][pg, :, rw, :] = qv
        st['k_scale'][:, i][pg, :, rw] = sk
        st['v_scale'][:, i][pg, :, rw] = sv
    else:
        st['k'][:, i][pg, :, rw, :] = k_new.to(st['k'].dtype)
        st['v'][:, i][pg, :, rw, :] = v_new.to(st['v'].dtype)


def _logical_rows(st, bt, i, cache):
    """Gather layer ``i``'s logical rows through the block table.

    bt: [B, max_pages] -> (k, v) each [B, Hkv, max_len, dh].
    Unmapped entries (0) pull the garbage page: those positions sit at or
    past every live length, so the positional mask hides them.  int8
    pools are dequantized here; attention math stays float32."""
    B = bt.shape[0]
    Hkv, T, dh = cache.kv_heads, cache.max_len, cache.head_dim

    def assemble(pool, scale):
        rows = pool[:, i][bt]                  # [B, M, Hkv, PL, dh]
        rows = rows.permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, dh)
        if scale is None:
            return rows
        sc = scale[:, i][bt]                   # [B, M, Hkv, PL]
        sc = sc.permute(0, 2, 1, 3).reshape(B, Hkv, T)
        return rows.float() * sc[..., None]

    if cache.quant == 'int8':
        return (assemble(st['k'], st['k_scale']),
                assemble(st['v'], st['v_scale']))
    return assemble(st['k'], None), assemble(st['v'], None)


def _step(w, cfg, cache, st, bt, fed, active, seeds, temps, topks):
    """One decode/verify step over ALL slots, in place on ``st``: write the
    fed token's K/V through the block table, attend against the gathered
    logical rows, sample each slot's next token with the position-keyed
    stream, and advance ACTIVE slots only.  Inactive slots compute masked
    garbage routed to page 0.  Returns the [S] int32 samples."""
    L = int(cfg['n_layer'])
    theta = float(cfg['theta'])
    M, PL = cache.max_pages, cache.page_len
    quant = cache.quant == 'int8'
    S = bt.shape[0]
    pos = st['lengths'].long()                                # [S]
    pg = bt[torch.arange(S, device=bt.device), (pos // PL).clamp(0, M - 1)]
    pg = torch.where(active, pg, torch.zeros_like(pg))
    rw = pos % PL
    x = _embed(w, fed)[:, None, :]                            # [S, 1, D]
    for i in range(L):
        h = _rms(x, w['layer_%d_att_norm' % i])
        q, k, v = _qkv(w, cfg, h, i)
        q = _rope_at(q, pos[:, None], theta)
        k = _rope_at(k, pos[:, None], theta)
        _write_rows(st, i, pg, rw, k[:, :, 0, :], v[:, :, 0, :], quant)
        kl, vl = _logical_rows(st, bt, i, cache)
        att = cached_attention(q, kl, vl, pos[:, None])
        att = att.transpose(1, 2).reshape(S, 1, -1)
        x = x + att @ w['layer_%d_att_o_w' % i]
        x = _ffn(w, x, i)
    x = _rms(x, w['final_norm'])
    logits = x[:, 0] @ w['lm_proj_w']                         # [S, V]
    nxt = sample_tokens_at(logits, seeds, pos + 1, temps, topks)
    st['tok'] = torch.where(active, nxt, st['tok'])
    st['lengths'] = torch.where(active, pos + 1, pos).to(torch.int32)
    return nxt


def dense_reference(weights, cfg, prompt):
    """Independent prefill reference: ordinary dense causal attention over
    the whole prompt, with no cache pages, no positional masking and no
    chunking (an intentionally different code path from
    `cached_attention`), and a plain row gather for the embedding.
    ``weights`` maps names to numpy arrays (computed on the CPU) or to
    tensors (computed on their device).  Returns numpy (k [L, Hkv, P, dh],
    v, last-position logits [V])."""
    dev = next((t.device for t in weights.values()
                if isinstance(t, torch.Tensor)), torch.device('cpu'))
    w = {n: to_device(weights[n], None, dev) for n in weight_names(cfg)}
    L = int(cfg['n_layer'])
    theta = float(cfg['theta'])
    ids = torch.as_tensor(np.asarray(prompt, np.int64).reshape(-1),
                          device=dev)
    P = ids.shape[0]
    pos = torch.arange(P, device=dev)[None]
    with torch.inference_mode():
        x = torch.index_select(w['tok_emb'], 0, jax_index_ids(
            ids, w['tok_emb'].shape[0]))[None]
        ks, vs = [], []
        mask = torch.tril(torch.ones((P, P), dtype=torch.bool, device=dev))
        for i in range(L):
            h = _rms(x, w['layer_%d_att_norm' % i])
            q, k, v = _qkv(w, cfg, h, i)
            q = _rope_at(q, pos, theta)
            k = _rope_at(k, pos, theta)
            ks.append(k[0])
            vs.append(v[0])
            H, Hkv, dh = q.shape[1], k.shape[1], q.shape[-1]
            qg = q.reshape(1, Hkv, H // Hkv, P, dh)
            s = torch.einsum('bhgqd,bhkd->bhgqk', qg, k) * (dh ** -0.5)
            s = torch.where(mask, s, torch.full((), -1e30, device=dev))
            att = torch.einsum('bhgqk,bhkd->bhgqd', torch.softmax(s, -1), v)
            att = att.reshape(1, H, P, dh).transpose(1, 2)
            x = x + att.reshape(1, P, H * dh) @ w['layer_%d_att_o_w' % i]
            x = _ffn(w, x, i)
        x = _rms(x, w['final_norm'])
        logits = x[0, P - 1] @ w['lm_proj_w']
        return (torch.stack(ks).cpu().numpy(), torch.stack(vs).cpu().numpy(),
                logits.cpu().numpy())


def _env_quant(kv_quant):
    if kv_quant is not None:
        q = str(kv_quant)
    else:
        q = os.environ.get('PT_KV_QUANT', 'none')
    return 'none' if q.strip().lower() in ('', '0', 'none', 'off',
                                           'false') else q.strip().lower()


def _env_prefix(prefix_cache):
    if prefix_cache is not None:
        return bool(prefix_cache)
    return os.environ.get('PT_PREFIX_CACHE', '1').strip().lower() not in (
        '0', 'off', 'false', '')


class DecodeRuntime(object):
    """The device half of the streaming decode server: the paged KV pool,
    block tables and the prefill / decode / verify steps over one weight
    set.

    ``weights`` maps llama parameter names to arrays or tensors (a llama
    scope via models.llama.generation_weights, or `random_weights`);
    ``cfg`` is the model config dict.  ``device`` defaults to CUDA: with
    no card the runtime raises unless ``device='cpu'`` is passed.

    Paging knobs: ``page_len`` (default: largest divisor of max_len <= 8),
    ``pages`` (pool depth incl. the garbage page; default dense-equivalent
    capacity), ``kv_quant`` ('none'/'int8', default env PT_KV_QUANT),
    ``prefix_cache`` (default env PT_PREFIX_CACHE, on).  A slot is a batch
    row; PAGES are the memory: admission goes through `try_begin` (prefix
    match + all-or-nothing page claim) and each window through
    `ensure_capacity`, both of which report shortage as a clean False /
    None that the scheduler turns into backpressure or a terminal
    ``kv_oom``.  Gauges and counters go to ``counters`` (a
    serving.counters.Counters; a new one when None).
    """

    def __init__(self, weights, cfg, slots=4, prefill_chunk=8,
                 cache_dtype='float32', page_len=None, pages=None,
                 kv_quant=None, prefix_cache=None, device=None,
                 counters=None):
        if device is None or torch.device(device).type == 'cuda':
            require_cuda('DecodeRuntime')
            device = 'cuda' if device is None else device
        self.device = torch.device(device)
        self.cfg = dict(cfg)
        self.w = {n: to_device(weights[n], None, self.device)
                  for n in weight_names(cfg)}
        H = int(cfg['n_head'])
        self.cache = CacheConfig(
            slots=slots, layers=int(cfg['n_layer']),
            kv_heads=int(cfg['n_kv_head']), max_len=int(cfg['max_len']),
            head_dim=int(cfg['d_model']) // H, dtype=cache_dtype,
            page_len=page_len, pages=pages, quant=_env_quant(kv_quant))
        self.counters = counters if counters is not None else Counters()
        self.allocator = SlotAllocator(self.cache.slots, self.counters)
        self.pool = PagePool(self.cache, self.counters)
        self.prefix = (PrefixCache(self.pool, self.cache.page_len,
                                   self.counters)
                       if _env_prefix(prefix_cache) else None)
        S = self.cache.slots
        self.block_tables = np.zeros((S, self.cache.max_pages), np.int32)
        self.owned = [[] for _ in range(S)]
        self.host_len = np.zeros(S, np.int32)
        self.host_tok = np.zeros(S, np.int32)
        self.state = init_state(self.cache, self.device)
        self.prefill_chunk = int(prefill_chunk)
        if not 0 < self.prefill_chunk <= self.cache.max_len:
            raise ValueError('prefill_chunk must be in (0, max_len]')
        self.counters.set('generation.kv_cache_bytes', self.cache.bytes())

    # ------------------------------------------------------- geometry
    @property
    def slots(self):
        return self.cache.slots

    @property
    def max_len(self):
        return self.cache.max_len

    def free_slots(self):
        return self.allocator.free_count()

    def alloc_slot(self):
        return self.allocator.alloc()

    def free_slot(self, slot):
        """Retire a slot: release every page its block table maps (a shared
        prefix page survives in the cache or other streams) and unmap the
        row.  Pages are never zeroed."""
        slot = int(slot)
        pages, self.owned[slot] = self.owned[slot], []
        if pages:
            self.pool.release(pages)
        self.block_tables[slot] = 0
        self.host_len[slot] = 0
        self.host_tok[slot] = 0
        self.allocator.free(slot)

    def reset(self):
        """Fresh state and allocators (the weights stay)."""
        for s in range(self.cache.slots):
            self.owned[s] = []
        if self.prefix is not None:
            self.prefix.reset()
        self.allocator.reset()
        self.pool.reset()
        self.block_tables[:] = 0
        self.host_len[:] = 0
        self.host_tok[:] = 0
        self.state = init_state(self.cache, self.device)

    # ------------------------------------------------ page accounting
    def never_fits(self, prompt_len, max_new):
        """True when prompt+max_new could not run even on an idle pool: the
        admission-time terminal ``kv_oom``."""
        span = min(int(prompt_len) + int(max_new), self.cache.max_len)
        return self.cache.pages_for(span) > self.pool.capacity

    def try_begin(self, slot, prompt, window):
        """Claim pages for ``prompt`` plus one decode window on ``slot``:
        the longest shared-prefix match first (mapped read-only: full by
        construction, so the request's own writes start in its first fresh
        page), then an all-or-nothing claim of the rest.  Returns the
        PREFILL START OFFSET (matched tokens are skipped), or None on page
        shortage with nothing leaked: the scheduler's backpressure
        signal."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        span = min(prompt.size + max(1, int(window)), self.cache.max_len)
        need = self.cache.pages_for(span)
        matched = self.prefix.match(prompt) if self.prefix is not None else []
        evict = self.prefix.evict_one if self.prefix is not None else None
        fresh = self.pool.alloc(max(0, need - len(matched)), evict=evict)
        if fresh is None:
            if matched:
                self.pool.release(matched)
            return None
        pages = list(matched) + list(fresh)
        self.owned[slot] = pages
        self.block_tables[slot] = 0
        self.block_tables[slot, :len(pages)] = pages
        self.host_len[slot] = 0
        self.host_tok[slot] = 0
        return len(matched) * self.cache.page_len

    def ensure_capacity(self, slot, target_len):
        """Grow ``slot``'s block table to cover ``target_len`` tokens.  True
        when covered or grown; False on pool exhaustion (mid-stream
        ``kv_oom``: the caller retires the stream with a terminal reply,
        never truncates it silently)."""
        slot = int(slot)
        need = self.cache.pages_for(min(int(target_len),
                                        self.cache.max_len))
        have = len(self.owned[slot])
        if need <= have:
            return True
        evict = self.prefix.evict_one if self.prefix is not None else None
        fresh = self.pool.alloc(need - have, evict=evict)
        if fresh is None:
            return False
        self.owned[slot].extend(fresh)
        self.block_tables[slot, have:need] = fresh
        return True

    def promote_prefix(self, slot, prompt):
        """Publish a freshly prefilled prompt's full pages into the prefix
        cache (no-op when prefix caching is off)."""
        if self.prefix is None:
            return 0
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        full = prompt.size // self.cache.page_len
        return self.prefix.insert(prompt, self.owned[int(slot)][:full])

    def pool_snapshot(self):
        """Host-side pool gauges (the payload of a kv_oom reply)."""
        return {'pages_capacity': self.pool.capacity,
                'pages_in_use': self.pool.in_use(),
                'page_bytes': self.pool.page_bytes,
                'bytes_reserved': self.cache.bytes(),
                'bytes_live': self.pool.in_use() * self.pool.page_bytes,
                'prefix_entries': (len(self.prefix)
                                   if self.prefix is not None else 0),
                'slots_in_use': self.allocator.in_use()}

    def _ints(self, a):
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    # -------------------------------------------------------- prefill
    def prefill(self, slot, tokens, offset, params):
        """Run ONE prefill chunk for ``slot``: tokens[offset:offset+C] of
        the prompt (the final chunk may be short: it is padded to the chunk
        width and masked by its true count).  Returns (next_token, logits
        [V] numpy), meaningful on the final chunk.  ``params`` is a
        SamplingParams.  The slot's block table must already cover the
        chunk (`try_begin` / `ensure_capacity`)."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        n, C = tokens.shape[0], self.prefill_chunk
        if not 0 < n <= C:
            raise ValueError('chunk of %d tokens does not fit the %d-wide '
                             'prefill' % (n, C))
        if offset + n > self.cache.max_len:
            raise ValueError('prefill past max_len=%d' % self.cache.max_len)
        cfg, cache, w, st = self.cfg, self.cache, self.w, self.state
        L, theta = int(cfg['n_layer']), float(cfg['theta'])
        M, PL = cache.max_pages, cache.page_len
        buf = np.zeros(C, np.int64)
        buf[:n] = tokens
        with torch.inference_mode():
            bt_row = self._ints(self.block_tables[slot])
            p_abs = offset + torch.arange(C, device=self.device)
            valid = torch.arange(C, device=self.device) < n
            pg = torch.where(valid, bt_row[(p_abs // PL).clamp(0, M - 1)],
                             torch.zeros_like(bt_row[:1]))
            rw = p_abs % PL
            pos = p_abs[None]                                 # [1, C]
            x = _embed(w, self._ints(buf))[None]              # [1, C, D]
            for i in range(L):
                h = _rms(x, w['layer_%d_att_norm' % i])
                q, k, v = _qkv(w, cfg, h, i)
                q = _rope_at(q, pos, theta)
                k = _rope_at(k, pos, theta)
                _write_rows(st, i, pg, rw, k[0].transpose(0, 1),
                            v[0].transpose(0, 1), cache.quant == 'int8')
                kl, vl = _logical_rows(st, bt_row[None], i, cache)
                att = cached_attention(q, kl, vl, pos)
                att = att.transpose(1, 2).reshape(1, C, -1)
                x = x + att @ w['layer_%d_att_o_w' % i]
                x = _ffn(w, x, i)
            x = _rms(x[0, n - 1], w['final_norm'])
            logits = x @ w['lm_proj_w']                       # [V]
            new_len = offset + n
            nxt = sample_logits(logits, token_key(params.seed, new_len,
                                                  self.device),
                                params.temperature, params.top_k)
            st['lengths'][slot] = new_len
            st['tok'][slot] = nxt
            nxt, logits = int(nxt), logits.cpu().numpy()
        self.host_len[slot] = new_len
        self.host_tok[slot] = nxt
        return nxt, logits

    # --------------------------------------------------------- decode
    def _window(self, steps, fed, active, seeds, temps, topks):
        """K steps over every slot; ``fed`` is None (each step feeds the
        carry token) or [S, K] host tokens.  Returns the [S, K] samples."""
        S = self.cache.slots
        with torch.inference_mode():
            bt = self._ints(self.block_tables)
            act_d = torch.as_tensor(np.asarray(active, bool).reshape(S),
                                    device=self.device)
            seeds_d = self._ints(np.asarray(seeds).reshape(S))
            temps_d = torch.as_tensor(np.asarray(temps, np.float32)
                                      .reshape(S), device=self.device)
            topks_d = self._ints(np.asarray(topks).reshape(S))
            fed_d = None if fed is None else self._ints(fed)
            out = []
            for j in range(int(steps)):
                tok = self.state['tok'] if fed_d is None else fed_d[:, j]
                out.append(_step(self.w, self.cfg, self.cache, self.state,
                                 bt, tok, act_d, seeds_d, temps_d, topks_d))
            return torch.stack(out, dim=1).cpu().numpy()

    def decode_window(self, steps, active, seeds, temps, topks):
        """Advance every ACTIVE slot ``steps`` tokens, each step feeding the
        slot's own last token, with no host round trip inside the window.
        active/seeds/temps/topks are per-slot vectors; so is the block
        table.  Returns the [slots, steps] token matrix; inactive rows are
        garbage."""
        act = np.asarray(active, bool).reshape(self.cache.slots)
        out = self._window(steps, None, act, seeds, temps, topks)
        self.host_len[act] = np.minimum(
            self.host_len[act] + int(steps), np.iinfo(np.int32).max)
        self.host_tok[act] = out[act, -1]
        return out

    def verify_window(self, steps, fed, active, seeds, temps, topks):
        """Speculative verify: feed ``fed`` [slots, steps] (per slot: last
        emitted token, then the draft's proposals) through the window and
        return the [slots, steps] TARGET samples g_0..g_{K-1}.  Device
        lengths advance K for active slots: the caller MUST follow with
        `commit_speculation` before any other launch."""
        fed = np.asarray(fed, np.int64).reshape(self.cache.slots,
                                                int(steps))
        return self._window(steps, fed, active, seeds, temps, topks)

    def commit_speculation(self, accepted):
        """Roll the post-verify state back to the accepted prefix.

        ``accepted`` maps slot -> (m, last_token): m tokens of the window
        were emitted (1 <= m <= K) and ``last_token`` (g_{m-1}) is the next
        token to feed.  Every ACTIVE slot of the verify window must appear.
        Rejected positions' K/V rows stay in the pool at or past the
        committed length, unreachable under the positional mask and
        overwritten by the next window.  Host metadata only: the [slots]
        lengths / tok vectors are uploaded again."""
        for slot, (m, last_tok) in accepted.items():
            self.host_len[int(slot)] += int(m)
            self.host_tok[int(slot)] = int(last_tok)
        self.state['lengths'] = torch.as_tensor(
            self.host_len.astype(np.int32), device=self.device)
        self.state['tok'] = torch.as_tensor(
            self.host_tok.astype(np.int32), device=self.device)

    # ----------------------------------------------- test conveniences
    def cache_row(self, slot):
        """Host copies (k [L, Hkv, Tmax, dh], v, length) of one slot's
        LOGICAL row, reassembled (and dequantized) through its block
        table."""
        st = self.state
        bt = self._ints(self.block_tables[int(slot)])
        L, Hkv = self.cache.layers, self.cache.kv_heads
        Tmax, dh = self.cache.max_len, self.cache.head_dim

        def assemble(pool, scale):
            rows = pool[bt]                    # [M, L, Hkv, PL, dh]
            rows = rows.permute(1, 2, 0, 3, 4).reshape(L, Hkv, Tmax, dh)
            if scale is None:
                return rows.cpu().numpy()
            sc = scale[bt].permute(1, 2, 0, 3).reshape(L, Hkv, Tmax)
            return (rows.float() * sc[..., None]).cpu().numpy()

        with torch.inference_mode():
            if self.cache.quant == 'int8':
                k = assemble(st['k'], st['k_scale'])
                v = assemble(st['v'], st['v_scale'])
            else:
                k, v = assemble(st['k'], None), assemble(st['v'], None)
            return k, v, int(st['lengths'][int(slot)])

    def generate(self, prompt, max_new, params=None, steps_per_window=4,
                 speculative=False):
        """Single-request decode (tests, parity references): prefill the
        prompt, then advance in windows; returns the generated ids (a list
        of max_new).  steps_per_window=1 IS the sequential single-token
        path.  ``speculative`` runs draft-propose + verify windows instead
        of plain decode (greedy streams are the same either way)."""
        from .sampling import SamplingParams, draft_ngram
        params = params or SamplingParams()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + int(max_new) > self.cache.max_len:
            raise ValueError(
                'prompt of %d + max_new=%d exceeds max_len=%d: requests are '
                'never truncated; shorten the prompt or lower max_new'
                % (prompt.size, max_new, self.cache.max_len))
        slot = self.alloc_slot()
        if slot is None:
            raise RuntimeError('no free kv slot')
        started = False
        try:
            start = self.try_begin(slot, prompt, int(max_new))
            if start is None:
                raise RuntimeError(
                    'kv_oom: pool of %d pages cannot hold prompt of %d + '
                    'max_new=%d' % (self.pool.capacity, prompt.size,
                                    max_new))
            started = True
            first = None
            for off in range(start, prompt.size, self.prefill_chunk):
                first, _ = self.prefill(
                    slot, prompt[off:off + self.prefill_chunk], off, params)
            self.promote_prefix(slot, prompt)
            out = [int(first)]
            S = self.cache.slots
            active = np.zeros(S, bool)
            active[slot] = True
            seeds = np.zeros(S, np.int64)
            temps = np.zeros(S, np.float32)
            topks = np.zeros(S, np.int64)
            seeds[slot] = params.seed
            temps[slot] = params.temperature
            topks[slot] = params.top_k
            K = int(steps_per_window)
            while len(out) < int(max_new):
                if not self.ensure_capacity(slot, self.host_len[slot] + K):
                    raise RuntimeError('kv_oom: pool exhausted mid-stream')
                if speculative:
                    ctx = np.concatenate([prompt, np.asarray(out, np.int32)])
                    fed = np.zeros((S, K), np.int64)
                    fed[slot, 0] = out[-1]
                    fed[slot, 1:] = draft_ngram(ctx, K - 1)
                    g = self.verify_window(K, fed, active, seeds, temps,
                                           topks)[slot]
                    m = 1
                    while m < K and fed[slot, m] == g[m - 1]:
                        m += 1
                    self.counters.inc('generation.spec_proposed', K - 1)
                    self.counters.inc('generation.spec_accepted', m - 1)
                    self.commit_speculation({slot: (m, int(g[m - 1]))})
                    out.extend(int(t) for t in g[:m])
                else:
                    toks = self.decode_window(K, active, seeds, temps, topks)
                    out.extend(int(t) for t in toks[slot])
            return out[:int(max_new)]
        finally:
            if started:
                self.free_slot(slot)
            else:
                self.allocator.free(slot)
