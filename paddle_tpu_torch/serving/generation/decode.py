"""Prefill, decode and verify over the PAGED KV pool, in torch.

Counterpart of paddle_tpu/serving/generation/decode.py.  The reference
compiles one executable for each ``(kind, shape)`` key, ``('prefill',
C)``, ``('decode', K)`` and ``('verify', K)`` (a `lax.scan` of K steps
with the page pools as donated carry).  The port captures one CUDA graph
for each of those keys (`DecodeRuntime._compiled`, through
core/graphs.py's `GraphPool`): the whole K-step window, or one prefill
chunk, replayed with no Python between its kernels.  K/V live in a
shared page pool (kv_cache.py); every read and write goes through a
per-slot BLOCK TABLE, plain ``[slots, max_pages]`` data.

What a capture needs of the step, and where it is done:

- The state is updated IN PLACE: the pools by `index_put_`, ``lengths``
  and ``tok`` by `copy_` / `index_copy_`, `reset` zeroes them and
  `commit_speculation` copies its host vectors into them, so every
  tensor `init_state` made keeps its address for the runtime's life.
- Host inputs (block tables, the per-slot active / seed / temperature /
  top-k vectors, verify's fed tokens, prefill's tokens and its slot,
  offset, count, seed, temperature and top-k) are STATIC device buffers
  of the key's entry, each filled by one host copy before the replay;
  prefill takes its scalars as device values, so one graph a chunk width
  serves every chunk.
- Building an entry on the card runs its body once on a side stream
  with every input zero (`_Compiled.warm_up`: every slot inactive, a
  prefill of no tokens), which builds K4 and writes only to the garbage
  page 0, then captures it.  `warmup` builds the keys a server will use
  before its first request and changes no state outside page 0.
- Sampling stays on the device (ops/sampling.py: a sort, the hash and
  Gumbel noise, no generator and no host sync), so a replay depends only
  on its inputs.  A window's only device-to-host copy is its ``[S, K]``
  token matrix.
- K4's launch counter is credited once a replay with what the capture
  launched.

On the CPU the same entry points run the body eagerly on the same
static buffers (the Executor's CPU interprets too); the eager body on the
card stays reachable as the ``eager=True`` of the private `_window` and
`_prefill`, which the tests and chip_smoke.py compare the graphs with.

Inactive slots ride along under a mask with their write target forced to
the GARBAGE page 0; active slots past their reservation fall through to
page 0 as well (unmapped block-table entries are 0).

Token embedding goes through K4 (ops/gather.py::embedding_gather), after
the ids are normalised exactly as JAX indexing does (a negative id gets
+V once, then the id is clamped to [0, V-1]).  Each layer makes q, k and
v in one product against a concatenated ``[D, (H + 2 Hkv) dh]`` weight
(``self.w``'s q, k and v entries are column views of it), and rope's
cos / sin tables are made once a step for every layer.

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

Not ported: the ring prefill (`prefill_ring`, `ring_pad`), the compile
cache's disk tier (a CUDA graph cannot be persisted; the kernels' nvcc
builds are cached as before), and the flight recorder and trace spans.
"""
import os
import threading
import time

import numpy as np
import torch

from ...core.executor import to_device
from ...core.framework import require_cuda
from ...core.graphs import GraphPool, credit_launches
from ...ops.attention import cached_attention
from ...ops.gather import embedding_gather
from ...ops.math import _promote
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

def _mm(a, b):
    """a @ b in the operands' common dtype, as jnp promotes them: bf16
    weights meet the float32 attention output and rope's float32 q/k."""
    a, b = _promote(a, b)
    return a @ b


def _rms(x, scale):
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * scale


def _rope_freqs(dh, theta, device):
    """Rope's inverse frequencies [dh / 2], as the reference computes
    them."""
    half = torch.arange(0, dh // 2, dtype=torch.float32, device=device)
    return torch.pow(theta, -half * 2.0 / dh)


def _rope_tables(pos, freqs):
    """pos: [B, T] absolute positions (per row: decode slots all sit at
    different lengths) -> (cos, sin) [B, 1, T, dh / 2], made once a step
    and shared by every layer's q and k."""
    ang = pos[:, None, :, None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def _rope(x, cos, sin):
    """x: [B, h, T, dh] rotated by `_rope_tables`' cos and sin."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def _qkv(w, cfg, h, i):
    """h: [B, T, D] -> q [B, H, T, dh], k/v [B, Hkv, T, dh] (pre-rope), as
    three products (dense_reference's)."""
    B, T = h.shape[0], h.shape[1]
    H, Hkv = int(cfg['n_head']), int(cfg['n_kv_head'])
    dh = int(cfg['d_model']) // H
    p = 'layer_%d_' % i
    q = _mm(h, w[p + 'att_q_w']).reshape(B, T, H, dh).transpose(1, 2)
    k = _mm(h, w[p + 'att_k_w']).reshape(B, T, Hkv, dh).transpose(1, 2)
    v = _mm(h, w[p + 'att_v_w']).reshape(B, T, Hkv, dh).transpose(1, 2)
    return q, k, v


def _qkv_fused(wqkv, cfg, h):
    """h: [B, T, D] times the concatenated [D, (H + 2 Hkv) dh] weight, one
    product -> q [B, H, T, dh], k/v [B, Hkv, T, dh] (pre-rope)."""
    B, T = h.shape[0], h.shape[1]
    H, Hkv = int(cfg['n_head']), int(cfg['n_kv_head'])
    dh = int(cfg['d_model']) // H
    y = _mm(h, wqkv).reshape(B, T, H + 2 * Hkv, dh).transpose(1, 2)
    return y[:, :H], y[:, H:H + Hkv], y[:, H + Hkv:]


def _ffn(w, x, i):
    p = 'layer_%d_' % i
    hh = _rms(x, w[p + 'ffn_norm'])
    gate = torch.nn.functional.silu(_mm(hh, w[p + 'ffn_fc1_w']))
    return x + _mm(gate * _mm(hh, w[p + 'ffn_fc3_w']), w[p + 'ffn_fc2_w'])


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
    H = int(cfg['n_head'])
    cos, sin = _rope_tables(pos, _rope_freqs(int(cfg['d_model']) // H, theta,
                                             dev))
    with torch.inference_mode():
        x = torch.index_select(w['tok_emb'], 0, jax_index_ids(
            ids, w['tok_emb'].shape[0]))[None]
        ks, vs = [], []
        mask = torch.tril(torch.ones((P, P), dtype=torch.bool, device=dev))
        for i in range(L):
            h = _rms(x, w['layer_%d_att_norm' % i])
            q, k, v = _qkv(w, cfg, h, i)
            q, k = _rope(q, cos, sin), _rope(k, cos, sin)
            ks.append(k[0])
            vs.append(v[0])
            H, Hkv, dh = q.shape[1], k.shape[1], q.shape[-1]
            qg = q.reshape(1, Hkv, H // Hkv, P, dh)
            s = torch.einsum('bhgqd,bhkd->bhgqk', qg, k) * (dh ** -0.5)
            s = torch.where(mask, s, torch.full((), -1e30, device=dev))
            att = torch.einsum('bhgqk,bhkd->bhgqd', torch.softmax(s, -1), v)
            att = att.reshape(1, H, P, dh).transpose(1, 2)
            x = x + _mm(att.reshape(1, P, H * dh), w['layer_%d_att_o_w' % i])
            x = _ffn(w, x, i)
        x = _rms(x, w['final_norm'])
        logits = _mm(x[0, P - 1], w['lm_proj_w'])
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


class _Compiled(object):
    """One ``(kind, shape)`` key of a DecodeRuntime: its static inputs
    (name -> device tensor), its body over them and the runtime's state,
    and on the card (``graphs``, the runtime's core.graphs.GraphPool) the
    body's captured CUDA graph.

    On the card the entry is built by `warm_up` on the side stream (its
    seconds `warm_up_s`, the kernels' builds included), then a capture
    (`capture_s`; `launches_per_replay` is what a replay adds to the
    launch counters).  A call fills each static input with
    one host copy, then replays the graph (its outputs are static: the
    caller copies them out before the next replay of the runtime's pool)
    or, on the CPU or with ``eager``, runs the body."""

    def __init__(self, graphs, key, inputs, body):
        self.inputs = inputs
        self._body = body
        self._graphs = graphs
        self.graph = None
        self.out = None
        self.warm_up_s = self.capture_s = None
        self.launches_per_replay = None
        if self._graphs is not None:
            t0 = time.perf_counter()
            self.warm_up()
            torch.cuda.synchronize(self._graphs.device)
            self.warm_up_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            self.out, self.launches_per_replay = self._graphs.capture(
                graph, self._run, 'generation %r' % (key,))
            self.graph = graph
            self.capture_s = time.perf_counter() - t0

    def _run(self):
        with torch.inference_mode():
            return self._body(self.inputs)

    def warm_up(self):
        """The body once with every input zero: every slot inactive, or a
        prefill of no tokens.  It writes only to the garbage page 0 and
        leaves lengths and tok as they were; on the card it runs on the
        side stream and builds every kernel the body launches."""
        for t in self.inputs.values():
            t.zero_()
        if self._graphs is None:
            return self._run()
        return self._graphs.run_on_side(self._run)

    def __call__(self, values, eager=False):
        for n, v in values.items():
            self.inputs[n].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        if self.graph is None or eager:
            return self._run()
        self.graph.replay()
        credit_launches(self.launches_per_replay)
        return self.out


class DecodeRuntime(object):
    """The device half of the streaming decode server: the paged KV pool,
    block tables and the prefill / decode / verify steps over one weight
    set.

    ``weights`` maps llama parameter names to arrays or tensors (a llama
    scope via models.llama.generation_weights, or `random_weights`);
    ``cfg`` is the model config dict.  ``device`` defaults to CUDA: with
    no card the runtime raises unless ``device='cpu'`` is passed.

    On the card `prefill`, `decode_window` and `verify_window` replay one
    captured CUDA graph per key (``('prefill', C)``, ``('decode', K)``,
    ``('verify', K)``, built at the key's first use or by `warmup`); on
    the CPU they run the same body eagerly.

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
        self._wqkv = [self._fuse_qkv(i) for i in range(self.cache.layers)]
        self._freqs = _rope_freqs(self.cache.head_dim, float(cfg['theta']),
                                  self.device)
        self._graphs = (GraphPool(self.device)
                        if self.device.type == 'cuda' else None)
        self._execs = {}
        self._lock = threading.Lock()
        self.counters.set('generation.kv_cache_bytes', self.cache.bytes())

    def _fuse_qkv(self, i):
        """Layer i's q, k and v weights as one [D, (H + 2 Hkv) dh] tensor;
        ``self.w`` keeps column views of it, so the weights take no more
        memory."""
        names = ['layer_%d_att_%s_w' % (i, x) for x in 'qkv']
        wqkv = torch.cat([self.w[n] for n in names], dim=1)
        at = 0
        for n in names:
            width = self.w[n].shape[1]
            self.w[n] = wqkv[:, at:at + width]
            at += width
        return wqkv

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
        """Fresh state and allocators (the weights and compiled windows
        stay): the state tensors are zeroed in place."""
        for s in range(self.cache.slots):
            self.owned[s] = []
        if self.prefix is not None:
            self.prefix.reset()
        self.allocator.reset()
        self.pool.reset()
        self.block_tables[:] = 0
        self.host_len[:] = 0
        self.host_tok[:] = 0
        for t in self.state.values():
            t.zero_()

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

    # --------------------------------------------------- compiled keys
    def _compiled(self, key, build):
        """One entry per (kind, shape) key, built at its first use: on the
        card a captured CUDA graph (a failed capture raises naming the
        op; nothing falls back to eager runs), on the CPU the eager
        body."""
        with self._lock:
            entry = self._execs.get(key)
            if entry is None:
                entry = self._execs[key] = build()
        return entry

    def _zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _prefill_exec(self, chunk):
        def build():
            inputs = {'bt': self._zeros((self.cache.max_pages,), torch.int64),
                      'toks': self._zeros((chunk,), torch.int64),
                      # slot, offset, true count, seed, top_k
                      'ints': self._zeros((5,), torch.int64),
                      'temp': self._zeros((1,), torch.float32)}
            return _Compiled(self._graphs, ('prefill', chunk), inputs,
                             self._prefill_body)

        return self._compiled(('prefill', chunk), build)

    def _window_exec(self, kind, steps):
        def build():
            S, M = self.cache.slots, self.cache.max_pages
            inputs = {'bt': self._zeros((S, M), torch.int64),
                      'active': self._zeros((S,), torch.bool),
                      'seeds': self._zeros((S,), torch.int64),
                      'temps': self._zeros((S,), torch.float32),
                      'topks': self._zeros((S,), torch.int64)}
            if kind == 'verify':
                inputs['fed'] = self._zeros((S, steps), torch.int64)
            return _Compiled(self._graphs, (kind, steps), inputs,
                             lambda inp: self._window_body(steps, inp))

        return self._compiled((kind, steps), build)

    def _decode_exec(self, steps):
        return self._window_exec('decode', steps)

    def _verify_exec(self, steps):
        return self._window_exec('verify', steps)

    def warmup(self, steps=None, speculative=False):
        """Build the steady-state keys before the first request: the
        prefill chunk, and with ``steps`` the decode window (and with
        ``speculative`` the verify window) of that many steps.  On the
        card each is captured after one run with every slot inactive, so
        no state changes outside the garbage page 0."""
        self._prefill_exec(self.prefill_chunk)
        if steps:
            self._decode_exec(int(steps))
            if speculative:
                self._verify_exec(int(steps))

    # ------------------------------------------------------ the bodies
    def _layer(self, x, i, cos, sin, pg, rw, bt, qpos):
        """Decoder layer i over x [B, T, D] at positions qpos [B, T]: K/V
        rows written to pages pg [B T] at rows rw, attention against the
        logical rows that block tables bt [B, max_pages] gather."""
        w, cache = self.w, self.cache
        B, T = x.shape[0], x.shape[1]
        h = _rms(x, w['layer_%d_att_norm' % i])
        q, k, v = _qkv_fused(self._wqkv[i], self.cfg, h)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        rows = (B * T, cache.kv_heads, cache.head_dim)
        _write_rows(self.state, i, pg, rw, k.transpose(1, 2).reshape(rows),
                    v.transpose(1, 2).reshape(rows), cache.quant == 'int8')
        kl, vl = _logical_rows(self.state, bt, i, cache)
        att = cached_attention(q, kl, vl, qpos)
        att = att.transpose(1, 2).reshape(B, T, -1)
        x = x + _mm(att, w['layer_%d_att_o_w' % i])
        return _ffn(w, x, i)

    def _prefill_body(self, inp):
        """One prefill chunk: its K/V rows into the pages ``inp['bt']``
        maps (rows past the true count to page 0), the logits of its last
        true row, the token sampled at its position, and lengths / tok of
        the slot SET (left as they were for a chunk of no tokens).
        -> (token, logits [V])."""
        st, M, PL = self.state, self.cache.max_pages, self.cache.page_len
        C = inp['toks'].shape[0]
        ints, bt = inp['ints'], inp['bt']
        slot, offset, n = ints[0:1], ints[1], ints[2]
        ar = torch.arange(C, device=self.device)
        p_abs = offset + ar
        pg = torch.where(ar < n, bt[(p_abs // PL).clamp(0, M - 1)],
                         torch.zeros_like(p_abs))
        pos = p_abs[None]                                     # [1, C]
        cos, sin = _rope_tables(pos, self._freqs)
        x = _embed(self.w, inp['toks'])[None]                 # [1, C, D]
        for i in range(self.cache.layers):
            x = self._layer(x, i, cos, sin, pg, p_abs % PL, bt[None], pos)
        last = (n - 1).clamp(min=0).reshape(1)
        x = _rms(x[0].index_select(0, last)[0], self.w['final_norm'])
        logits = _mm(x, self.w['lm_proj_w'])                      # [V]
        new_len = offset + n
        nxt = sample_logits(logits, token_key(ints[3], new_len, self.device),
                            inp['temp'][0], ints[4])
        live = n > 0
        st['lengths'].index_copy_(0, slot, torch.where(
            live, new_len, st['lengths'].index_select(0, slot)).int())
        st['tok'].index_copy_(0, slot, torch.where(
            live, nxt, st['tok'].index_select(0, slot)))
        return nxt, logits

    def _step(self, bt, fed, active, seeds, temps, topks):
        """One decode/verify step over ALL slots, in place on the state:
        write the fed token's K/V through the block table, attend against
        the gathered logical rows, sample each slot's next token with the
        position-keyed stream, and advance ACTIVE slots only.  Inactive
        slots compute masked garbage routed to page 0.  -> [S] int32."""
        st, M, PL = self.state, self.cache.max_pages, self.cache.page_len
        S = bt.shape[0]
        pos = st['lengths'].long()                                # [S]
        pg = bt[torch.arange(S, device=bt.device), (pos // PL).clamp(0, M - 1)]
        pg = torch.where(active, pg, torch.zeros_like(pg))
        cos, sin = _rope_tables(pos[:, None], self._freqs)
        x = _embed(self.w, fed)[:, None, :]                       # [S, 1, D]
        for i in range(self.cache.layers):
            x = self._layer(x, i, cos, sin, pg, pos % PL, bt, pos[:, None])
        x = _rms(x, self.w['final_norm'])
        logits = _mm(x[:, 0], self.w['lm_proj_w'])                    # [S, V]
        nxt = sample_tokens_at(logits, seeds, pos + 1, temps, topks)
        st['tok'].copy_(torch.where(active, nxt, st['tok']))
        st['lengths'].copy_(torch.where(active, pos + 1, pos))
        return nxt

    def _window_body(self, steps, inp):
        """K steps over every slot; each feeds the carry token, or verify's
        ``inp['fed'][:, j]``.  -> the [S, K] samples."""
        fed = inp.get('fed')
        out = []
        for j in range(steps):
            tok = self.state['tok'] if fed is None else fed[:, j]
            out.append(self._step(inp['bt'], tok, inp['active'],
                                  inp['seeds'], inp['temps'], inp['topks']))
        return torch.stack(out, dim=1)

    # -------------------------------------------------------- prefill
    def prefill(self, slot, tokens, offset, params):
        """Run ONE prefill chunk for ``slot``: tokens[offset:offset+C] of
        the prompt (the final chunk may be short: it is padded to the chunk
        width and masked by its true count).  Returns (next_token, logits
        [V] numpy), meaningful on the final chunk.  ``params`` is a
        SamplingParams.  The slot's block table must already cover the
        chunk (`try_begin` / `ensure_capacity`)."""
        nxt, logits = self._prefill(slot, tokens, offset, params)
        self.host_len[slot] = offset + np.size(tokens)
        self.host_tok[slot] = nxt
        return nxt, logits

    def _prefill(self, slot, tokens, offset, params, eager=False):
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        n, C = tokens.shape[0], self.prefill_chunk
        if not 0 < n <= C:
            raise ValueError('chunk of %d tokens does not fit the %d-wide '
                             'prefill' % (n, C))
        if offset + n > self.cache.max_len:
            raise ValueError('prefill past max_len=%d' % self.cache.max_len)
        buf = np.zeros(C, np.int64)
        buf[:n] = tokens
        nxt, logits = self._prefill_exec(C)({
            'bt': self.block_tables[slot].astype(np.int64), 'toks': buf,
            'ints': np.asarray([slot, offset, n, params.seed, params.top_k],
                               np.int64),
            'temp': np.asarray([params.temperature], np.float32)}, eager)
        return int(nxt), logits.cpu().numpy()

    # --------------------------------------------------------- decode
    def _window(self, kind, steps, fed, active, seeds, temps, topks,
                eager=False):
        """The (kind, steps) window over every slot; ``fed`` is None
        (decode: each step feeds the carry token) or [S, K] host tokens.
        Returns the [S, K] samples."""
        S = self.cache.slots
        values = {'bt': self.block_tables.astype(np.int64),
                  'active': np.asarray(active, bool).reshape(S),
                  'seeds': np.asarray(seeds, np.int64).reshape(S),
                  'temps': np.asarray(temps, np.float32).reshape(S),
                  'topks': np.asarray(topks, np.int64).reshape(S)}
        if fed is not None:
            values['fed'] = np.asarray(fed, np.int64).reshape(S, steps)
        out = self._window_exec(kind, int(steps))(values, eager)
        return out.cpu().numpy()

    def decode_window(self, steps, active, seeds, temps, topks):
        """Advance every ACTIVE slot ``steps`` tokens, each step feeding the
        slot's own last token, with no host round trip inside the window.
        active/seeds/temps/topks are per-slot vectors; so is the block
        table.  Returns the [slots, steps] token matrix; inactive rows are
        garbage."""
        act = np.asarray(active, bool).reshape(self.cache.slots)
        out = self._window('decode', steps, None, act, seeds, temps, topks)
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
        return self._window('verify', steps, fed, active, seeds, temps,
                            topks)

    def commit_speculation(self, accepted):
        """Roll the post-verify state back to the accepted prefix.

        ``accepted`` maps slot -> (m, last_token): m tokens of the window
        were emitted (1 <= m <= K) and ``last_token`` (g_{m-1}) is the next
        token to feed.  Every ACTIVE slot of the verify window must appear.
        Rejected positions' K/V rows stay in the pool at or past the
        committed length, unreachable under the positional mask and
        overwritten by the next window.  Host metadata, then the [slots]
        lengths / tok vectors copied into the state's tensors."""
        for slot, (m, last_tok) in accepted.items():
            self.host_len[int(slot)] += int(m)
            self.host_tok[int(slot)] = int(last_tok)
        self.state['lengths'].copy_(torch.from_numpy(self.host_len))
        self.state['tok'].copy_(torch.from_numpy(self.host_tok))

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
