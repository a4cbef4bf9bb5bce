"""Streaming generation through the port (paddle_tpu_torch/serving/
generation) against the JAX package (paddle_tpu/serving/generation), on
the CPU: the same random weights, prefill and decode logits, greedy
streams against the JAX runtime and the page-free `dense_reference`,
the position-keyed sampling contract, the page pool, the prefix cache,
int8 KV and speculative decode.

Float32 tolerance (as tests/test_torch_llama_serving.py states it):
rtol 1e-5 plus atol 1e-5 of the largest |logit|.  Both packages compute
in float32 but sum matrix products in other orders and take pow/sin/cos
(rope) from other libraries, a few units in the last place apart, so the
error scales with the logits' magnitude.  Greedy tokens must be equal
wherever the top-two gap exceeds 4x that tolerance; a stream is compared
up to its first position with a smaller gap (with random weights,
near-ties are real, and after one the two streams may rightly part).

Seeded streams cannot match the JAX package's (threefry `fold_in` is not
torch's hash): they are held to the port's own contract instead, bitwise
across decode windows, runtimes, prefix hits and speculation.  The JAX
side runs with PT_CACHE=0, so its AOT disk tier is never touched."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import attention as jatt
from paddle_tpu.serving.generation import decode as jdec
from paddle_tpu.serving import generation as jgen
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import sampling as tsamp
from paddle_tpu_torch.serving import generation as tgen
from paddle_tpu_torch.serving.generation import decode as tdec
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

CFG = dict(vocab=64, d_model=32, n_layer=2, n_head=4, n_kv_head=2,
           d_ffn=64, theta=10000.0, max_len=32)
PROMPT = [1, 5, 9, 2, 7, 3]


@pytest.fixture(autouse=True)
def fresh_port_programs(monkeypatch):
    """Fresh default programs, scope and name generator for the port (the
    root conftest does the same for the JAX package), and the JAX side's
    compile cache off."""
    monkeypatch.setenv('PT_CACHE', '0')
    from paddle_tpu_torch.core import executor, framework, unique_name
    main, startup = framework.Program(), framework.Program()
    old_main = framework.switch_main_program(main)
    old_startup = framework.switch_startup_program(startup)
    old_gen = unique_name.switch()
    old_scope = executor._global_scope
    executor._global_scope = executor.Scope()
    yield
    framework.switch_main_program(old_main)
    framework.switch_startup_program(old_startup)
    unique_name.switch(old_gen)
    executor._global_scope = old_scope


def _pair(slots=3, chunk=4, cfg=CFG, seed=0, **kw):
    """The JAX and the port runtime over the same random weights."""
    w = jdec.random_weights(cfg, seed=seed)
    return (jgen.DecodeRuntime(w, cfg, slots=slots, prefill_chunk=chunk,
                               **kw),
            tgen.DecodeRuntime(w, cfg, slots=slots, prefill_chunk=chunk,
                               device='cpu', **kw))


def _tol(ref):
    return 1e-5 * float(np.abs(ref).max())


def _assert_logits(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=_tol(ref))


def _gap(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float(top2[..., 1] - top2[..., 0])


def _compare_streams(got, ref, prompt, weights, cfg=CFG):
    """Token for token while the dense reference's top-two gap clears 4x
    the float32 tolerance; each compared token must also be the dense
    reference's greedy token.  Returns the number compared."""
    n = 0
    for t in range(len(ref)):
        _, _, lref = tdec.dense_reference(weights, cfg,
                                          list(prompt) + list(got[:t]))
        if _gap(lref) <= 4 * _tol(lref):
            break
        assert got[t] == ref[t] == int(np.argmax(lref)), (t, got, ref)
        n += 1
    return n


# ------------------------------------------------------------- weights

@pytest.mark.parametrize('seed', [0, 3])
def test_random_weights_equal_in_both_packages(seed):
    a = jdec.random_weights(CFG, seed=seed)
    b = tdec.random_weights(CFG, seed=seed)
    assert list(a) == list(b)
    assert tdec.weight_names(CFG) == jdec.weight_names(CFG)
    for n in a:
        assert a[n].dtype == b[n].dtype == np.float32
        np.testing.assert_array_equal(a[n], b[n])


# ------------------------------------------------------- ops against JAX

@pytest.mark.parametrize('Tq,Tk,H,Hkv', [(1, 32, 4, 2), (4, 16, 4, 4),
                                         (3, 24, 8, 2)])
def test_cached_attention_matches_jax(Tq, Tk, H, Hkv):
    rng = np.random.RandomState(Tq + Tk)
    B, D = 2, 8
    q = rng.randn(B, H, Tq, D).astype(np.float32)
    k = rng.randn(B, Hkv, Tk, D).astype(np.float32)
    v = rng.randn(B, Hkv, Tk, D).astype(np.float32)
    qpos = np.stack([np.arange(Tq) + 5, np.arange(Tq) + Tk - Tq]).astype(
        np.int32)
    ref = np.asarray(jatt.cached_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v),
                                           jnp.asarray(qpos)))
    got = tatt.cached_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                torch.from_numpy(qpos)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('offset', [0, 3, 30])
def test_write_cache_matches_jax(offset):
    rng = np.random.RandomState(offset)
    kc = rng.randn(3, 2, 2, 32, 8).astype(np.float32)
    vc = rng.randn(3, 2, 2, 32, 8).astype(np.float32)
    k = rng.randn(2, 4, 8).astype(np.float32)
    v = rng.randn(2, 4, 8).astype(np.float32)
    jk, jv = jatt.write_cache(jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(k), jnp.asarray(v), 1, 1, offset)
    tk, tv = tatt.write_cache(torch.from_numpy(kc.copy()),
                              torch.from_numpy(vc.copy()),
                              torch.from_numpy(k), torch.from_numpy(v),
                              1, 1, torch.tensor(offset))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_token_ids_normalised_as_jax_indexing():
    """A negative id gets +V once, then ids clamp to [0, V-1]: JAX
    indexing's rows, which K4 alone would answer with NaN rows."""
    table = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    ids = np.asarray([-1, 4, 7, -9, 2], np.int32)
    ref = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    got = tdec._embed({'tok_emb': torch.from_numpy(table)},
                      torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ref[:4], table[[3, 3, 3, 0]])


# ------------------------------------------------------------- sampling

def test_sample_logits_greedy_and_topk1_are_argmax():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(16).astype('float32'))
    am = int(torch.argmax(logits))
    assert int(tsamp.sample_logits(logits, tsamp.token_key(7, 3))) == am
    for seed in range(5):
        got = int(tsamp.sample_logits(logits, tsamp.token_key(seed, 0),
                                      temperature=2.0, top_k=1))
        assert got == am


def test_sample_logits_greedy_takes_the_first_index_on_ties():
    logits = torch.tensor([0.5, 2.0, -1.0, 2.0, 2.0])
    assert int(tsamp.sample_logits(logits, tsamp.token_key(1, 1))) == 1
    assert int(np.asarray(jnp.argmax(jnp.asarray(logits.numpy())))) == 1


def test_sample_logits_topk_respects_support_and_keeps_ties():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(32).astype('float32'))
    top5 = set(np.argsort(logits.numpy())[-5:].tolist())
    for seed in range(20):
        got = int(tsamp.sample_logits(logits, tsamp.token_key(seed, 0),
                                      temperature=1.5, top_k=5))
        assert got in top5
    # a tie at the k-th highest keeps every tied logit eligible
    tied = torch.tensor([3.0, 1.0, 1.0, 1.0, -2.0])
    drawn = {int(tsamp.sample_logits(tied, tsamp.token_key(s, 0),
                                     temperature=50.0, top_k=2))
             for s in range(200)}
    assert drawn == {0, 1, 2, 3}


def test_sampling_is_position_and_seed_keyed():
    rng = np.random.RandomState(2)
    logits = torch.from_numpy(rng.randn(64).astype('float32'))

    def draw(seed, pos):
        return int(tsamp.sample_logits(logits, tsamp.token_key(seed, pos),
                                       temperature=1.0))

    assert draw(3, 11) == draw(3, 11)
    assert len({draw(3, p) for p in range(40)}) > 1
    assert [draw(3, p) for p in range(40)] != [draw(4, p) for p in range(40)]


def test_sample_tokens_at_rows_are_independent_of_the_batch():
    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.randn(5, 40).astype('float32'))
    seeds = torch.tensor([1, 2, 3, 4, 5])
    pos = torch.tensor([7, 7, 9, 100, 3])
    temps = torch.tensor([0.0, 0.7, 1.0, 2.0, 0.5])
    topks = torch.tensor([0, 0, 4, 1, 10])
    rows = tsamp.sample_tokens_at(logits, seeds, pos, temps, topks)
    assert rows.dtype == torch.int32
    for i in range(5):
        one = tsamp.sample_logits(logits[i], tsamp.token_key(
            int(seeds[i]), int(pos[i])), float(temps[i]), int(topks[i]))
        assert int(one) == int(rows[i])
    assert int(rows[0]) == int(torch.argmax(logits[0]))
    assert int(rows[3]) == int(torch.argmax(logits[3]))


def test_draft_ngram_prompt_lookup():
    ctx = np.asarray([3, 5, 8, 13, 5], np.int32)
    for mod in (jgen, tgen):
        np.testing.assert_array_equal(mod.draft_ngram(ctx, 3), [8, 13, 5])
        np.testing.assert_array_equal(
            mod.draft_ngram(np.asarray([1, 2, 3]), 2), [3, 3])


# ----------------------------------------------------- allocator, pool

def test_slot_allocator_lowest_first_and_exhaustion():
    a = tgen.SlotAllocator(3)
    assert [a.alloc(), a.alloc(), a.alloc()] == [0, 1, 2]
    assert a.alloc() is None
    assert a.in_use() == 3
    a.free(1)
    assert a.alloc() == 1
    for s in (0, 1, 2):
        a.free(s)
    assert a.free_count() == 3
    with pytest.raises(ValueError, match='out of range'):
        a.free(5)
    a.alloc()
    a.free(0)
    with pytest.raises(ValueError, match='double free'):
        a.free(0)


def _cc(**kw):
    kw.setdefault('page_len', 4)
    return tgen.CacheConfig(slots=2, layers=2, kv_heads=2, max_len=32,
                            head_dim=8, **kw)


def test_cache_config_geometry_matches_the_reference():
    for kw in (dict(), dict(page_len=4, quant='int8'), dict(pages=9)):
        c = tgen.CacheConfig(slots=4, layers=2, kv_heads=2, max_len=32,
                             head_dim=8, **kw)
        r = jgen.CacheConfig(slots=4, layers=2, kv_heads=2, max_len=32,
                             head_dim=8, **kw)
        assert (c.page_len, c.pages, c.max_pages, c.pool_shape,
                c.scale_shape, c.store_dtype, c.page_bytes(), c.bytes(),
                c.dense_slot_bytes()) == \
            (r.page_len, r.pages, r.max_pages, r.pool_shape, r.scale_shape,
             r.store_dtype, r.page_bytes(), r.bytes(), r.dense_slot_bytes())
        assert [c.pages_for(n) for n in (0, 1, 8, 9)] == \
            [r.pages_for(n) for n in (0, 1, 8, 9)]
    c = tgen.CacheConfig(slots=4, layers=2, kv_heads=2, max_len=32,
                         head_dim=8)
    assert c.page_len == 8 and c.pages == 4 * 4 + 1
    for bad in (dict(slots=0), dict(page_len=3), dict(quant='int4')):
        kw = dict(slots=1, layers=1, kv_heads=1, max_len=8, head_dim=4)
        kw.update(bad)
        with pytest.raises(ValueError):
            tgen.CacheConfig(**kw)
    assert [tgen.default_page_len(n) for n in (32, 24, 20, 7)] == \
        [8, 8, 5, 7]


def test_init_state_on_the_runtime_device():
    st = tgen.init_state(_cc(quant='int8'), 'cpu')
    assert st['k'].dtype == torch.int8 and tuple(st['k'].shape) == \
        _cc().pool_shape
    assert st['k_scale'].dtype == torch.float32
    assert st['lengths'].dtype == st['tok'].dtype == torch.int32
    assert 'k_scale' not in tgen.init_state(_cc(), 'cpu')


def test_page_pool_alloc_lowest_first_all_or_nothing():
    pool = tgen.PagePool(_cc(pages=6))
    assert pool.capacity == 5
    a = pool.alloc(3)
    assert a == [1, 2, 3]                 # page 0 reserved, lowest first
    assert pool.alloc(3) is None          # all or nothing
    assert pool.in_use() == 3
    b = pool.alloc(2)
    assert b == [4, 5]
    pool.release(a)
    pool.release(b)
    assert pool.free_count() == 5 and pool.alloc(0) == []


def test_page_pool_refcounts_and_the_garbage_page():
    pool = tgen.PagePool(_cc(pages=4))
    pages = pool.alloc(2)
    assert 0 not in pages and pool.refcount(0) == 0
    pool.retain(pages)
    pool.release(pages)
    assert pool.in_use() == 2 and pool.refcount(pages[0]) == 1
    pool.release(pages)
    assert pool.in_use() == 0
    with pytest.raises(ValueError, match='release of free'):
        pool.release(pages)
    with pytest.raises(ValueError, match='retain of unallocated'):
        pool.retain([3])
    with pytest.raises(ValueError, match='release of free'):
        pool.release([0])                 # the garbage page is never owned


def test_page_pool_evict_callback_frees_under_pressure():
    pool = tgen.PagePool(_cc(pages=4))
    held = [pool.alloc(1), pool.alloc(1), pool.alloc(1)]

    def evict():
        if held:
            pool.release(held.pop(0))
            return True
        return False

    assert pool.alloc(2) is None
    got = pool.alloc(2, evict=evict)
    assert got is not None and len(got) == 2 and len(held) == 1


def test_prefix_cache_chain_match_insert_evict():
    from paddle_tpu_torch.serving import Counters
    c = Counters()
    pool = tgen.PagePool(_cc(pages=8), c)
    pc = tgen.PrefixCache(pool, page_len=4, counters=c)
    prompt = np.arange(1, 13, dtype=np.int32)
    pages = pool.alloc(3)
    assert pc.insert(prompt, pages) == 3 and len(pc) == 3
    assert c.get('generation.prefix_inserts') == 3
    other = np.concatenate([prompt[:8], [60, 61, 62]]).astype(np.int32)
    got = pc.match(other)
    assert got == pages[:2] and c.get('generation.prefix_hits') == 1
    assert pool.refcount(pages[0]) == 5
    pool.release(got)
    assert pc.match(np.asarray([9] * 6, np.int32)) == []
    assert pc.match(prompt[:4]) == []     # one token always prefills
    one = pc.match(prompt[:5])
    assert one == pages[:1]
    pool.release(one)
    assert pc.evict_one() and len(pc) == 2
    assert c.get('generation.prefix_evictions') == 1
    pc.reset()
    pool.release(pages)
    assert len(pc) == 0 and pool.in_use() == 0
    assert c.get('generation.kv_pages_in_use') == 0


# ------------------------------------------------- runtime against JAX

def test_runtime_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    w = tdec.random_weights(CFG)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tgen.DecodeRuntime(w, CFG)
    with pytest.raises(RuntimeError, match='CUDA'):
        tgen.DecodeRuntime(w, CFG, device='cuda')
    rt = tgen.DecodeRuntime(w, CFG, device='cpu')
    assert rt.device.type == 'cpu' and rt.state['k'].device.type == 'cpu'
    assert rt.w['tok_emb'].device.type == 'cpu'


@pytest.mark.parametrize('prompt,chunk,page_len', [
    (PROMPT, 4, None),                    # 4 does not divide 6
    ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], 3, 4),  # 3 pages, chunks of 3
    ([7, 7], 8, 2),
])
def test_chunked_prefill_matches_jax_and_dense_reference(prompt, chunk,
                                                         page_len):
    jr, tr = _pair(chunk=chunk, page_len=page_len)
    p = np.asarray(prompt, np.int32)
    outs = []
    for rt, sp in ((jr, jgen.SamplingParams()), (tr, tgen.SamplingParams())):
        slot = rt.alloc_slot()
        assert rt.ensure_capacity(slot, p.size)
        for off in range(0, p.size, chunk):
            first, logits = rt.prefill(slot, p[off:off + chunk], off, sp)
        outs.append((first, logits, rt.cache_row(slot)))
    (jfirst, jlogits, (jk, jv, jlen)), (tfirst, tlogits, (tk, tv, tlen)) = \
        outs
    _assert_logits(tlogits, jlogits)
    assert tlen == jlen == p.size
    np.testing.assert_allclose(tk[:, :, :p.size], jk[:, :, :p.size],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv[:, :, :p.size], jv[:, :, :p.size],
                               rtol=1e-5, atol=1e-6)
    kref, vref, lref = tdec.dense_reference(tr.w, CFG, p)
    np.testing.assert_allclose(tk[:, :, :p.size], kref, atol=1e-5)
    np.testing.assert_allclose(tv[:, :, :p.size], vref, atol=1e-5)
    _assert_logits(tlogits, lref)
    if _gap(jlogits) > 4 * _tol(jlogits):
        assert tfirst == jfirst == int(np.argmax(lref))


def test_dense_reference_matches_jax():
    w = jdec.random_weights(CFG, seed=1)
    jk, jv, jl = jdec.dense_reference(w, CFG, PROMPT)
    tk, tv, tl = tdec.dense_reference(w, CFG, PROMPT)
    np.testing.assert_allclose(tk, jk, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    _assert_logits(tl, jl)


def test_out_of_range_and_negative_prompt_ids_match_jax():
    jr, tr = _pair(chunk=8)
    prompt = np.asarray([-1, 70, 5, -9, 2, 63, -64, 64], np.int32)
    res = []
    for rt, sp in ((jr, jgen.SamplingParams()), (tr, tgen.SamplingParams())):
        slot = rt.alloc_slot()
        assert rt.ensure_capacity(slot, prompt.size)
        res.append(rt.prefill(slot, prompt, 0, sp))
    assert np.isfinite(res[1][1]).all()
    _assert_logits(res[1][1], res[0][1])


def _spy_jax(monkeypatch, store):
    real = jdec.sample_tokens_at

    def spy(logits, seeds, positions, temps, topks):
        jax.debug.callback(
            lambda lg, pos: store.append((np.asarray(pos).copy(),
                                          np.asarray(lg).copy())),
            logits, positions)
        return real(logits, seeds, positions, temps, topks)

    monkeypatch.setattr(jdec, 'sample_tokens_at', spy)


def _spy_port(monkeypatch, store):
    real = tdec.sample_tokens_at

    def spy(logits, seeds, positions, temps, topks):
        store.append((positions.numpy().copy(), logits.numpy().copy()))
        return real(logits, seeds, positions, temps, topks)

    monkeypatch.setattr(tdec, 'sample_tokens_at', spy)


def test_multi_slot_decode_logits_and_streams_match_jax(monkeypatch):
    """Two slots at different lengths (6 and 3 prompt tokens, chunks of 4
    that divide neither), two windows of 4 with both active: each step's
    logits within the float32 tolerance of the JAX runtime's, and both
    greedy streams token for token against the JAX runtime and the dense
    reference."""
    jstore, tstore = [], []
    _spy_jax(monkeypatch, jstore)
    _spy_port(monkeypatch, tstore)
    jr, tr = _pair(slots=3, chunk=4)
    prompts = [np.asarray(PROMPT, np.int32), np.asarray([4, 4, 9], np.int32)]
    streams = []
    for rt, SP in ((jr, jgen.SamplingParams), (tr, tgen.SamplingParams)):
        toks = {}
        for p in prompts:
            slot = rt.alloc_slot()
            assert rt.try_begin(slot, p, 8) == 0
            for off in range(0, p.size, 4):
                first, _ = rt.prefill(slot, p[off:off + 4], off, SP())
            toks[slot] = [first]
        active = np.asarray([True, True, False])
        zeros = np.zeros(3)
        for _ in range(2):
            out = rt.decode_window(4, active, zeros.astype(np.int32),
                                   zeros.astype(np.float32),
                                   zeros.astype(np.int32))
            for s in toks:
                toks[s].extend(int(t) for t in out[s])
        streams.append(toks)
    assert len(jstore) == len(tstore) == 8
    jsteps = {tuple(p[:2]): lg for p, lg in jstore}
    for pos, lg in tstore:
        ref = jsteps[tuple(pos[:2])]
        _assert_logits(lg[:2], ref[:2])
    for s, p in enumerate(prompts):
        n = _compare_streams(streams[1][s], streams[0][s], p, tr.w)
        assert n >= 6, (s, n)


@pytest.mark.parametrize('window', [1, 4])
def test_greedy_generate_matches_jax_and_dense_reference(window):
    jr, tr = _pair(slots=2, chunk=4)
    ref = jr.generate(PROMPT, 10, steps_per_window=window)
    got = tr.generate(PROMPT, 10, steps_per_window=window)
    assert _compare_streams(got, ref, PROMPT, tr.w) >= 8


def test_long_max_len_matches_jax_and_is_window_independent():
    """max_len 512, a 120-token prompt in chunks of 32 (both packages
    gather all 512 rows a layer): logits stay within the float32
    tolerance and a seeded stream is bitwise the same for windows of 1
    and 4."""
    cfg = dict(CFG, max_len=512)
    jr, tr = _pair(slots=2, chunk=32, cfg=cfg, prefix_cache=False)
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, 64, 120).astype(np.int32)
    res = []
    for rt, SP in ((jr, jgen.SamplingParams), (tr, tgen.SamplingParams)):
        slot = rt.alloc_slot()
        assert rt.ensure_capacity(slot, prompt.size)
        for off in range(0, prompt.size, 32):
            _, logits = rt.prefill(slot, prompt[off:off + 32], off, SP())
        res.append(logits)
        rt.free_slot(slot)
    _assert_logits(res[1], res[0])
    ref = jr.generate(prompt, 12, steps_per_window=4)
    got = tr.generate(prompt, 12, steps_per_window=4)
    assert _compare_streams(got, ref, prompt, tr.w, cfg) >= 6
    p = tgen.SamplingParams(0.9, 5, 11)
    one = tr.generate(prompt, 12, p, steps_per_window=1)
    four = tr.generate(prompt, 12, p, steps_per_window=4)
    assert one == four


# --------------------------------------------- the sampling contract

def _seeded_stream(rt, prompt, params, n, beside=None):
    """``n`` tokens of one seeded stream on slot 0 through windows of 3,
    with ``beside`` (a prompt) prefilled on slot 1 and decoding greedily
    in the same windows when given."""
    S = rt.slots
    slots = [(prompt, params)] + ([] if beside is None else
                                  [(beside, tgen.SamplingParams())])
    out = []
    for p, sp in slots:
        slot = rt.alloc_slot()
        assert rt.try_begin(slot, p, n) == 0
        for off in range(0, len(p), rt.prefill_chunk):
            first, _ = rt.prefill(slot, p[off:off + rt.prefill_chunk], off,
                                  sp)
        out.append([first])
    active = np.arange(S) < len(slots)
    seeds, temps, topks = (np.zeros(S, np.int64), np.zeros(S, np.float32),
                           np.zeros(S, np.int64))
    seeds[0], temps[0], topks[0] = params.seed, params.temperature, \
        params.top_k
    while len(out[0]) < n:
        toks = rt.decode_window(3, active, seeds, temps, topks)
        for s in range(len(slots)):
            out[s].extend(int(t) for t in toks[s])
    return out[0][:n]


def test_a_stream_does_not_depend_on_its_batch():
    """A seeded top-k stream run alone and beside a slot four times as long
    (decoding greedily in the same windows) is bitwise the same: every
    slot attends over all max_len rows, so no product's shape depends on
    the other slots' lengths."""
    cfg = dict(CFG, max_len=64)
    rt = _pair(slots=2, chunk=8, cfg=cfg, prefix_cache=False)[1]
    rng = np.random.RandomState(8)
    short = rng.randint(0, 64, 6).astype(np.int32)
    long_ = rng.randint(0, 64, 30).astype(np.int32)
    p = tgen.SamplingParams(0.9, 5, 13)
    alone = _seeded_stream(rt, short, p, 12)
    rt.reset()
    beside = _seeded_stream(rt, short, p, 12, beside=long_)
    assert beside == alone
    assert all(0 <= t < cfg['vocab'] for t in alone)


@pytest.mark.parametrize('params', [(0.0, 0, 0), (0.9, 5, 11), (1.3, 0, 2)],
                         ids=['greedy', 'topk', 'temperature'])
def test_window_size_and_runtime_never_move_a_stream(params):
    p = tgen.SamplingParams(*params)
    rt = _pair()[1]
    seq = rt.generate(PROMPT, 8, p, steps_per_window=1)
    rt.reset()
    fused = rt.generate(PROMPT, 8, p, steps_per_window=4)
    other = tgen.DecodeRuntime(tdec.random_weights(CFG), CFG, slots=2,
                               prefill_chunk=4, device='cpu')
    again = other.generate(PROMPT, 8, p, steps_per_window=3)
    assert fused == seq == again
    assert all(0 <= t < CFG['vocab'] for t in seq)


def test_topk1_stream_equals_greedy():
    rt = _pair()[1]
    greedy = rt.generate(PROMPT, 8)
    for seed in (0, 9):
        assert rt.generate(PROMPT, 8, tgen.SamplingParams(2.0, 1, seed)) == \
            greedy


def test_seeded_stream_moves_with_the_seed():
    rt = _pair()[1]
    a = rt.generate(PROMPT, 12, tgen.SamplingParams(1.5, 0, 1))
    b = rt.generate(PROMPT, 12, tgen.SamplingParams(1.5, 0, 2))
    assert a != b


def test_runtime_generate_refuses_overlong():
    rt = _pair()[1]
    with pytest.raises(ValueError, match='never truncated'):
        rt.generate(list(range(30)), 8)


# --------------------------------- prefix cache, int8 KV, speculation

def test_prefix_hit_stream_equals_cold():
    rt = _pair(slots=2, page_len=4)[1]
    assert rt.prefix is not None
    prompt = [7, 3, 11, 2, 9, 1, 4, 6, 13, 5]      # 2 full pages + tail
    cold = rt.generate(prompt, 8)
    assert rt.counters.get('generation.prefix_inserts') >= 2
    warm = rt.generate(prompt, 8)
    assert rt.counters.get('generation.prefix_hits') == 1
    assert warm == cold
    p = tgen.SamplingParams(temperature=0.9, top_k=5, seed=11)
    assert rt.generate(prompt, 8, p) == rt.generate(prompt, 8, p)
    assert rt.pool.in_use() > 0 and rt.allocator.in_use() == 0
    rt.prefix.reset()
    assert rt.pool.in_use() == 0


def test_int8_kv_matches_the_jax_int8_runtime():
    """Both packages quantize the same way (amax / 127 per (token, kv
    head), round half to even, float32 scales), so the two int8 runtimes
    agree within the float32 tolerance above.  The reference documents an
    int8 budget of 2e-2 (absolute) between a runtime's int8 and float32
    final-chunk logits (tests/test_paged_kv.py): the port's int8 logits
    are held to it against its own float32 ones, and its int8 greedy
    stream equals its float32 one, as in the reference."""
    prompt = [1, 5, 9, 2, 7, 3, 11, 4, 8, 2]
    kw = dict(slots=2, chunk=4, page_len=4, prefix_cache=False)
    jr8, tr8 = _pair(kv_quant='int8', **kw)
    jr32, tr32 = _pair(**kw)
    assert tr8.cache.store_dtype == 'int8'
    assert tr8.state['k'].dtype == torch.int8
    assert tr8.cache.page_bytes() == jr8.cache.page_bytes() < \
        tr32.cache.page_bytes()
    last = {}
    for name, rt, SP in (('j8', jr8, jgen.SamplingParams),
                         ('t8', tr8, tgen.SamplingParams),
                         ('j32', jr32, jgen.SamplingParams),
                         ('t32', tr32, tgen.SamplingParams)):
        slot = rt.alloc_slot()
        assert rt.ensure_capacity(slot, len(prompt))
        for off in range(0, len(prompt), 4):
            _, last[name] = rt.prefill(slot, prompt[off:off + 4], off, SP())
        rt.free_slot(slot)
    _assert_logits(last['t32'], last['j32'])
    _assert_logits(last['t8'], last['j8'])
    assert float(np.abs(last['t8'] - last['t32']).max()) <= 2e-2
    assert tr8.generate(prompt, 10) == tr32.generate(prompt, 10)
    assert tr8.generate(prompt, 10) == jr8.generate(prompt, 10)


def test_speculative_stream_equals_plain():
    rt = _pair(slots=2, page_len=4, prefix_cache=False)[1]
    prompt = [1, 5, 9, 2, 7, 3]
    plain = rt.generate(prompt, 14)
    spec = rt.generate(prompt, 14, speculative=True)
    assert spec == plain
    assert rt.counters.get('generation.spec_proposed') > 0
    assert rt.counters.get('generation.spec_accepted') >= 0
    p = tgen.SamplingParams(temperature=0.9, top_k=5, seed=11)
    assert rt.generate(prompt, 10, p, speculative=True) == \
        rt.generate(prompt, 10, p)
    assert rt.allocator.in_use() == 0 and rt.pool.in_use() == 0


def test_decode_window_reads_nothing_back_inside_the_window(monkeypatch):
    """The window's carry stays on the device: no .item(), .cpu() or
    .tolist() until its K steps are queued (one .cpu() at the end)."""
    rt = _pair()[1]
    slot = rt.alloc_slot()
    rt.try_begin(slot, PROMPT, 8)
    rt.prefill(slot, PROMPT[:4], 0, tgen.SamplingParams())
    rt.prefill(slot, PROMPT[4:], 4, tgen.SamplingParams())
    calls = []
    for name in ('item', 'cpu', 'tolist'):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    act = np.asarray([True, False, False])
    rt.decode_window(4, act, np.zeros(3, np.int32), np.zeros(3, np.float32),
                     np.zeros(3, np.int32))
    assert calls == ['cpu']


# -------------------------------------------------------- models.llama

def _llama_scopes():
    """The tiny llama program's startup weights in the JAX package, and
    the same arrays in a port scope."""
    import paddle_tpu as jf
    import paddle_tpu_torch as tf
    from paddle_tpu.models import llama as jllama
    main, startup = jf.Program(), jf.Program()
    with jf.program_guard(main, startup), jf.unique_name.guard():
        jllama.generation_program('tiny', mode='prefill')
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(startup)
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
    return jscope, tf.scope_from_numpy(arrays, tf.Scope(), 'cpu')


def test_make_decoder_greedy_matches_jax():
    from paddle_tpu.models import llama as jllama
    from paddle_tpu_torch.models import llama as tllama
    jscope, tscope = _llama_scopes()
    prompt = np.asarray([[1, 2, 3, 4], [9, 8, 7, 6]], np.int32)
    ref = jllama.make_decoder(jscope, 'tiny')(prompt, 6)
    got = tllama.make_decoder(tscope, 'tiny')(prompt, 6)
    assert got.shape == ref.shape == (2, 10)
    np.testing.assert_array_equal(got[:, :4], prompt)
    w = tllama.generation_weights(tscope, 'tiny')
    cfg = tllama.CONFIGS['tiny']
    for b in range(2):
        assert _compare_streams(list(got[b, 4:]), list(ref[b, 4:]),
                                prompt[b], w, cfg) >= 4
    # seeded draws stay in range and replay for one seed
    dec = tllama.make_decoder(tscope, 'tiny', temperature=0.8)
    a, b = dec(prompt, 5, seed=3), dec(prompt, 5, seed=3)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < cfg['vocab'])).all()


def test_make_streaming_runtime_matches_the_jax_runtime():
    from paddle_tpu.models import llama as jllama
    from paddle_tpu_torch.models import llama as tllama
    jscope, tscope = _llama_scopes()
    w = tllama.generation_weights(tscope, 'tiny')
    assert list(w) == tdec.weight_names(tllama.CONFIGS['tiny'])
    rt = tllama.make_streaming_runtime(tscope, 'tiny', slots=2,
                                       prefill_chunk=8, device='cpu')
    jrt = jllama.make_streaming_runtime(jscope, 'tiny', slots=2,
                                        prefill_chunk=8)
    assert rt.slots == 2 and rt.max_len == 32
    got = rt.generate([1, 2, 3, 4, 5], 6, steps_per_window=2)
    ref = jrt.generate([1, 2, 3, 4, 5], 6, steps_per_window=2)
    assert _compare_streams(got, ref, [1, 2, 3, 4, 5], w,
                            tllama.CONFIGS['tiny']) >= 4
