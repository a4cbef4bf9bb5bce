"""Paged KV cache: a shared page pool + per-slot block tables.

Counterpart of paddle_tpu/serving/generation/kv_cache.py.  One
preallocated pair of ``[pages, layers, kv_heads, page_len, head_dim]``
pools holds every in-flight request's keys and values; a request owns a
*slot* (its row in the fixed-width decode batch) and a list of *pages*
its block table maps, so its footprint is ``ceil(len / page_len)`` pages
instead of a dense ``max_len`` strip.  Allocation is a host-side free
list over pages (`PagePool`); device state is the pool pair plus per-slot
``lengths`` / ``tok`` vectors, torch tensors on the runtime's device that
the decode loop updates in place (decode.py).  Block tables are plain
per-launch data (int32 ``[slots, max_pages]``).

Page 0 is the reserved GARBAGE page: unmapped block-table entries are 0,
so an inactive slot's masked ride-along write lands there and is never
attended (the positional mask ``kpos <= qpos`` makes any row beyond a
slot's live length unreachable).  Freed pages are never zeroed: reuse is
metadata only.

``quant='int8'`` stores the pools as int8 with one float32 scale per
written row (per token, per kv head): ``scale = amax/127`` on write,
dequantized when the rows are gathered for attention (decode.py), with
float32 attention math.

`PrefixCache` maps chain-hashed FULL prompt pages to refcounted page ids,
so requests sharing a prompt prefix map the same read-only pages instead
of prefilling them again.  Shared pages are full by construction, so a
request's own writes always land in freshly allocated pages.

The gauges and counters (``generation.kv_pages_in_use``,
``generation.prefix_hits``, ...) go to a `serving.counters.Counters`
passed in by the owner (the DecodeRuntime's), not to a global registry.
`PagePool.alloc` is the ``kv_oom`` fault site (testing/faults.py), as in
the reference: an armed fire reports the pool exhausted.
"""
import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from ...testing import faults as _faults
from ..counters import Counters

__all__ = ['CacheConfig', 'SlotAllocator', 'PagePool', 'PrefixCache',
           'init_state', 'default_page_len']

# bytes an element of a pool dtype takes, by dtype name (numpy has no
# bfloat16)
ITEMSIZE = {'float32': 4, 'bfloat16': 2, 'int8': 1}


def default_page_len(max_len, want=8):
    """Largest divisor of ``max_len`` that is <= ``want`` (page length
    must tile the context window exactly)."""
    max_len, want = int(max_len), int(want)
    for d in range(min(want, max_len), 0, -1):
        if max_len % d == 0:
            return d
    return 1


class CacheConfig(object):
    """Geometry of the paged KV pool.

    ``slots`` is the decode-batch width (rows of ``lengths``/``tok`` and
    of the block table); ``pages`` the pool depth INCLUDING the reserved
    garbage page 0; ``page_len`` tokens per page (must divide
    ``max_len``); ``quant`` is ``'none'`` or ``'int8'``.
    """
    __slots__ = ('slots', 'layers', 'kv_heads', 'max_len', 'head_dim',
                 'dtype', 'page_len', 'pages', 'quant')

    def __init__(self, slots, layers, kv_heads, max_len, head_dim,
                 dtype='float32', page_len=None, pages=None, quant='none'):
        if int(slots) < 1:
            raise ValueError('kv cache needs >= 1 slot, got %r' % (slots,))
        self.slots = int(slots)
        self.layers = int(layers)
        self.kv_heads = int(kv_heads)
        self.max_len = int(max_len)
        self.head_dim = int(head_dim)
        self.dtype = str(dtype)
        self.page_len = (default_page_len(self.max_len) if page_len is None
                         else int(page_len))
        if self.page_len < 1 or self.max_len % self.page_len:
            raise ValueError('page_len=%r must divide max_len=%d'
                             % (page_len, self.max_len))
        # default pool: dense-equivalent capacity (every slot can grow to
        # max_len) + the garbage page; callers shrink it to create real
        # memory pressure
        self.pages = (self.slots * self.max_pages + 1 if pages is None
                      else int(pages))
        if self.pages < 2:
            raise ValueError('kv pool needs >= 2 pages (page 0 is the '
                             'reserved garbage page), got %r' % (pages,))
        self.quant = str(quant or 'none')
        if self.quant not in ('none', 'int8'):
            raise ValueError("quant must be 'none' or 'int8', got %r"
                             % (quant,))

    @property
    def max_pages(self):
        """Block-table width: pages needed for a max_len sequence."""
        return self.max_len // self.page_len

    @property
    def store_dtype(self):
        return 'int8' if self.quant == 'int8' else self.dtype

    @property
    def pool_shape(self):
        return (self.pages, self.layers, self.kv_heads, self.page_len,
                self.head_dim)

    @property
    def scale_shape(self):
        """Per-row dequant scales (int8 mode): one float32 per written
        (page, layer, kv head, row)."""
        return (self.pages, self.layers, self.kv_heads, self.page_len)

    def pages_for(self, n_tokens):
        """Pages a sequence of ``n_tokens`` occupies."""
        return -(-max(0, int(n_tokens)) // self.page_len)

    def page_bytes(self):
        """Bytes ONE page costs across both pools (K+V, plus the scale
        rows when quantized): the unit of the kv_bytes gauges."""
        per = ITEMSIZE[self.store_dtype]
        elems = self.layers * self.kv_heads * self.page_len * self.head_dim
        b = 2 * per * elems
        if self.quant == 'int8':
            b += 2 * 4 * self.layers * self.kv_heads * self.page_len
        return b

    def bytes(self):
        """Total K+V pool bytes (capacity-planning helper)."""
        return self.pages * self.page_bytes()

    def dense_slot_bytes(self):
        """What ONE slot would reserve as a dense float32 max_len strip."""
        per = ITEMSIZE[self.dtype]
        return 2 * per * (self.layers * self.kv_heads * self.max_len *
                          self.head_dim)


def init_state(cache_cfg, device):
    """Fresh decode state on ``device``: the K/V page pools plus per-slot
    ``lengths`` (tokens written so far) and ``tok`` (the next token to
    feed: set by prefill, advanced by every decode step).  int8 mode adds
    the per-row dequant scale pools."""
    dt = getattr(torch, cache_cfg.store_dtype)
    k = torch.zeros(cache_cfg.pool_shape, dtype=dt, device=device)
    st = {'k': k, 'v': torch.zeros_like(k),
          'lengths': torch.zeros(cache_cfg.slots, dtype=torch.int32,
                                 device=device),
          'tok': torch.zeros(cache_cfg.slots, dtype=torch.int32,
                             device=device)}
    if cache_cfg.quant == 'int8':
        ks = torch.zeros(cache_cfg.scale_shape, dtype=torch.float32,
                         device=device)
        st['k_scale'] = ks
        st['v_scale'] = torch.zeros_like(ks)
    return st


class SlotAllocator(object):
    """Free-list slot allocation, lowest index first (the same admission
    order always lands on the same slots).  Keeps the live occupancy in
    the ``generation.kv_slots_in_use`` gauge.  Slots are cheap batch rows;
    the MEMORY gate is the PagePool."""

    def __init__(self, slots, counters=None):
        self._capacity = int(slots)
        self._free = list(range(self._capacity))
        self._lock = threading.Lock()
        self._counters = counters if counters is not None else Counters()
        self._counters.set('generation.kv_slots_in_use', 0)

    @property
    def capacity(self):
        return self._capacity

    def free_count(self):
        with self._lock:
            return len(self._free)

    def in_use(self):
        return self._capacity - self.free_count()

    def alloc(self):
        """Claim the lowest free slot, or None when fully occupied."""
        with self._lock:
            if not self._free:
                return None
            slot = min(self._free)
            self._free.remove(slot)
            used = self._capacity - len(self._free)
        self._counters.set('generation.kv_slots_in_use', used)
        return slot

    def free(self, slot):
        slot = int(slot)
        with self._lock:
            if not 0 <= slot < self._capacity:
                raise ValueError('slot %d out of range [0, %d)'
                                 % (slot, self._capacity))
            if slot in self._free:
                raise ValueError('double free of kv slot %d' % slot)
            self._free.append(slot)
            used = self._capacity - len(self._free)
        self._counters.set('generation.kv_slots_in_use', used)

    def reset(self):
        with self._lock:
            self._free = list(range(self._capacity))
        self._counters.set('generation.kv_slots_in_use', 0)


class PagePool(object):
    """Refcounted free-list allocation over the KV page pool.

    Page 0 is reserved (the garbage page) and never handed out.  ``alloc``
    is all-or-nothing and lowest-index-first; when short it asks the
    optional ``evict`` callback (the PrefixCache) to drop unreferenced
    cached pages, oldest first.  Shared pages (prefix-cache hits) carry
    one refcount per holder and return to the free list only when the
    LAST holder releases.  Exhaustion is a clean ``None``: the scheduler
    turns it into admission backpressure or a terminal ``kv_oom`` reply,
    never a truncation.

    Gauges: ``generation.kv_pages_in_use``, ``generation.
    kv_bytes_reserved`` (fixed pool footprint) and ``generation.
    kv_bytes_live`` (pages in use x page_bytes).
    """

    def __init__(self, cache_cfg, counters=None):
        self._cfg = cache_cfg
        self._page_bytes = cache_cfg.page_bytes()
        self._capacity = cache_cfg.pages - 1      # page 0 reserved
        self._free = list(range(1, cache_cfg.pages))
        self._refs = {}
        self._lock = threading.RLock()
        self._counters = counters if counters is not None else Counters()
        self._counters.set('generation.kv_bytes_reserved', cache_cfg.bytes())
        self._set_gauges(0)

    def _set_gauges(self, used):
        self._counters.set('generation.kv_pages_in_use', used)
        self._counters.set('generation.kv_bytes_live',
                           used * self._page_bytes)

    @property
    def capacity(self):
        """Allocatable pages (the garbage page excluded)."""
        return self._capacity

    @property
    def page_bytes(self):
        return self._page_bytes

    def free_count(self):
        with self._lock:
            return len(self._free)

    def in_use(self):
        return self._capacity - self.free_count()

    def alloc(self, n, evict=None):
        """Claim ``n`` pages (refcount 1 each) or None, all or nothing.
        ``evict`` is called repeatedly (under the pool lock; it may
        re-enter release()) while the free list is short."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            if _faults.any_active() and _faults.fire('kv_oom'):
                return None
            while len(self._free) < n and evict is not None:
                if not evict():
                    break
            if len(self._free) < n:
                return None
            self._free.sort()
            got, self._free = self._free[:n], self._free[n:]
            for p in got:
                self._refs[p] = 1
            self._set_gauges(self._capacity - len(self._free))
        return got

    def retain(self, pages):
        """One more holder for already-allocated pages (shared prefix
        hits)."""
        with self._lock:
            for p in pages:
                if p not in self._refs:
                    raise ValueError('retain of unallocated kv page %d'
                                     % int(p))
                self._refs[p] += 1

    def release(self, pages):
        """Drop one holder per page; pages reaching refcount 0 return to
        the free list (never zeroed: positional masking makes stale rows
        unreachable)."""
        with self._lock:
            for p in pages:
                p = int(p)
                c = self._refs.get(p)
                if c is None:
                    raise ValueError('release of free kv page %d' % p)
                if c > 1:
                    self._refs[p] = c - 1
                else:
                    del self._refs[p]
                    self._free.append(p)
            self._set_gauges(self._capacity - len(self._free))

    def refcount(self, page):
        with self._lock:
            return self._refs.get(int(page), 0)

    def reset(self):
        with self._lock:
            self._free = list(range(1, self._cfg.pages))
            self._refs.clear()
            self._set_gauges(0)


def _chain_digest(prev, tokens):
    h = hashlib.sha1(prev)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


class PrefixCache(object):
    """Fingerprinted prefix -> pages map at FULL-page granularity.

    Keys are chained page digests, ``h_j = sha1(h_{j-1} || tokens of page
    j)``, so a depth-j entry certifies the whole prefix, not one page.
    Each entry holds its own refcount (PagePool.retain) on every page of
    its chain; `match` retains the matched pages again FOR THE CALLER, so
    a cached page is pinned while any stream maps it and survives, cached,
    after all streams retire.

    Matching is capped at ``(prompt_len - 1) // page_len`` pages so at
    least one suffix token always prefills: the final chunk's forward pass
    produces the request's first-token logits.  Eviction drops the OLDEST
    entry (`evict_one`, PagePool's under-pressure callback).
    """

    def __init__(self, pool, page_len, counters=None):
        self._pool = pool
        self._page_len = int(page_len)
        self._entries = OrderedDict()     # digest -> tuple(pages)
        self._lock = threading.Lock()
        self._counters = counters if counters is not None else Counters()

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def _keys_for(self, prompt, depth):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        keys, h = [], b'pt-prefix-v1'
        for j in range(depth):
            h = _chain_digest(
                h, prompt[j * self._page_len:(j + 1) * self._page_len])
            keys.append(h)
        return keys

    def match(self, prompt):
        """Longest cached full-page prefix of ``prompt``: the page list,
        retained for the caller (released with the rest of the request's
        pages), or [] on a miss."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cap = max(0, (prompt.size - 1) // self._page_len)
        if cap == 0:
            return []
        keys = self._keys_for(prompt, cap)
        with self._lock:
            for j in range(cap, 0, -1):
                pages = self._entries.get(keys[j - 1])
                if pages is not None:
                    self._pool.retain(pages)
                    self._counters.inc('generation.prefix_hits')
                    self._counters.inc('generation.prefix_pages_reused',
                                       len(pages))
                    return list(pages)
        return []

    def insert(self, prompt, pages):
        """Publish a freshly prefilled request's FULL pages (``pages`` = its
        block-table prefix).  Every depth 1..full gets an entry, so later
        prompts sharing a shorter prefix still hit; existing entries are
        kept (first writer wins: their contents are the same)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        full = min(prompt.size // self._page_len, len(pages))
        if full == 0:
            return 0
        keys = self._keys_for(prompt, full)
        added = 0
        with self._lock:
            for j in range(1, full + 1):
                if keys[j - 1] in self._entries:
                    continue
                chain = tuple(int(p) for p in pages[:j])
                self._pool.retain(chain)
                self._entries[keys[j - 1]] = chain
                added += 1
        if added:
            self._counters.inc('generation.prefix_inserts', added)
        return added

    def evict_one(self):
        """Drop the oldest entry.  True when an entry was dropped: its
        pages free only if nothing else holds them, so PagePool.alloc
        keeps calling until satisfied or empty."""
        with self._lock:
            if not self._entries:
                return False
            _key, pages = self._entries.popitem(last=False)
        self._pool.release(pages)
        self._counters.inc('generation.prefix_evictions')
        return True

    def reset(self):
        while self.evict_one():
            pass
