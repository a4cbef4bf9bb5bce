"""The port's GenerationEngine (paddle_tpu_torch/serving/generation/
scheduler.py) on the CPU: the reference's engine cases
(tests/test_generation.py, tests/test_paged_kv.py) without the AOT-cache
and ring-prefill ones: streaming, EOS / max-token / cancel / deadline
termination, refusals, mixed prefill and decode rounds, TTFT / ITL
histograms, drain, page-pool backpressure and the two kv_oom surfaces,
speculative decode, a failing decode window (a monkeypatch in place of
the reference's fault hook), and the greedy stream against the JAX
engine's.  Every request must end in exactly one terminal reply: each
test checks the engine's reply counts against its admissions.

Greedy streams are compared with the JAX package's token for token up to
the first position whose top-two logit gap is within 4x the float32
tolerance (1e-5 of the largest |logit|), as tests/test_torch_generation.py
does."""
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.serving import generation as jgen
from paddle_tpu.serving.engine import ServingConfig as JServingConfig
from paddle_tpu_torch.serving import ServingConfig
from paddle_tpu_torch.serving import generation as tgen
from paddle_tpu_torch.serving.generation import decode as tdec
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

CFG = dict(vocab=64, d_model=32, n_layer=2, n_head=4, n_kv_head=2,
           d_ffn=64, theta=10000.0, max_len=32)
PROMPT = [1, 5, 9, 2, 7, 3]


@pytest.fixture(autouse=True)
def fresh_port_programs(monkeypatch):
    """Fresh default programs, scope and name generator for the port, and
    the JAX side's compile cache off."""
    monkeypatch.setenv('PT_CACHE', '0')
    monkeypatch.delenv('PT_SPEC_DECODE', raising=False)
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


def _runtime(slots=3, chunk=4, **kw):
    return tgen.DecodeRuntime(tdec.random_weights(CFG, seed=0), CFG,
                              slots=slots, prefill_chunk=chunk,
                              device='cpu', **kw)


def _engine(rt=None, window=4, config=None, **gen_kw):
    rt = rt or _runtime()
    return tgen.GenerationEngine(
        rt, config=config or ServingConfig(),
        gen_config=tgen.GenerationConfig(decode_window=window,
                                         **gen_kw)).start()


def _replies_once(eng):
    """Every admitted request got exactly one terminal reply, and every
    refused one its rejection: no deadlock and no double count."""
    c = eng.counters
    replies = {k: c.get('serving.' + k) for k in (
        'completed', 'shed', 'deadline_exceeded', 'errors', 'rejected')}
    assert c.get('serving.deadlocks') == 0
    assert sum(replies.values()) == c.get('serving.submitted'), replies
    assert c.get('serving.admitted') + c.get('serving.rejected') == \
        c.get('serving.submitted')


def _tol(ref):
    return 1e-5 * float(np.abs(ref).max())


def _greedy_prefix_equal(got, ref, prompt, weights):
    n = 0
    for t in range(len(ref)):
        _, _, lref = tdec.dense_reference(weights, CFG,
                                          list(prompt) + list(got[:t]))
        top2 = np.sort(lref)[-2:]
        if top2[1] - top2[0] <= 4 * _tol(lref):
            break
        assert got[t] == ref[t] == int(np.argmax(lref)), (t, got, ref)
        n += 1
    return n


# ----------------------------------------------------------- streaming

def test_engine_streams_and_resolves_max_tokens():
    eng = _engine()
    try:
        s = eng.generate(PROMPT, max_new=8)
        toks = list(s.tokens(timeout=30))
        r = s.result(5)
        assert r.ok and r.reason == 'max_tokens'
        assert toks == list(r.outputs[0]) and len(toks) == 8
        assert s.tokens_so_far() == toks
        # engine stream == direct sequential runtime stream
        assert toks == _runtime().generate(PROMPT, 8, steps_per_window=1)
    finally:
        eng.stop()
    _replies_once(eng)


def test_engine_greedy_stream_matches_the_jax_engine():
    w = tdec.random_weights(CFG, seed=0)
    jeng = jgen.GenerationEngine(
        jgen.DecodeRuntime(w, CFG, slots=3, prefill_chunk=4),
        config=JServingConfig(),
        gen_config=jgen.GenerationConfig(decode_window=4)).start()
    eng = _engine()
    try:
        prompts = [PROMPT, [4, 4, 9], [11, 3, 8, 1, 1, 6, 2, 9, 5]]
        jres = [jeng.generate(p, max_new=7) for p in prompts]
        tres = [eng.generate(p, max_new=7) for p in prompts]
        for p, j, t in zip(prompts, jres, tres):
            jr, tr = j.result(60), t.result(60)
            assert jr.ok and tr.ok
            assert _greedy_prefix_equal(list(tr.outputs[0]),
                                        list(jr.outputs[0]), p, w) >= 4
    finally:
        jeng.stop()
        eng.stop()
    _replies_once(eng)


def test_engine_eos_terminates():
    rt = _runtime()
    eos = rt.generate(PROMPT, 1)[0]          # the first greedy token
    rt.reset()
    eng = _engine(rt, eos_id=eos)
    try:
        r = eng.generate(PROMPT, max_new=8).result(30)
        assert r.ok and r.reason == 'eos'
        assert len(r.outputs[0]) == 1 and int(r.outputs[0][0]) == eos
    finally:
        eng.stop()
    _replies_once(eng)


def test_engine_rejects_overlong_prompt_never_truncates():
    eng = _engine()
    try:
        r = eng.generate(list(range(30)), max_new=8).result(1)
        assert r.status == 'rejected' and r.reason == 'too_long'
        assert 'truncated' in r.error and 'max_len=32' in r.error
        assert eng.counters.get('serving.rejected.too_long') == 1
        ok = eng.generate(list(range(1, 29)), max_new=4).result(30)
        assert ok.ok and len(ok.outputs[0]) == 4   # exactly max_len fits
    finally:
        eng.stop()
    _replies_once(eng)


@pytest.mark.parametrize('prompt,max_new,timeout_s,reason', [
    ([], 4, None, 'bad_request'),
    ([1], 0, None, 'bad_request'),
    ([[1, 2], [3]], 4, None, 'bad_request'),
    ([1, 2], 4, 0.0, 'deadline'),
])
def test_engine_refusals_come_back_as_closed_streams(prompt, max_new,
                                                     timeout_s, reason):
    eng = _engine()
    try:
        s = eng.generate(prompt, max_new=max_new, timeout_s=timeout_s)
        assert isinstance(s, tgen.TokenStream)
        r = s.result(1)
        assert r.status == 'rejected' and r.reason == reason
        assert list(s.tokens(timeout=1)) == []
    finally:
        eng.stop()
    _replies_once(eng)


def test_engine_submit_is_closed_off():
    eng = _engine()
    try:
        with pytest.raises(TypeError, match='generate'):
            eng.submit({'x': np.ones((1, 2))})
    finally:
        eng.stop()


def test_engine_refuses_after_drain():
    eng = _engine()
    eng.stop()
    r = eng.generate(PROMPT, max_new=2).result(1)
    assert r.status == 'rejected' and r.reason == 'draining'
    _replies_once(eng)


def test_engine_seeded_topk_deterministic_across_restarts():
    outs = []
    for _ in range(2):
        eng = _engine(window=3)
        try:
            r = eng.generate(PROMPT, max_new=6, temperature=0.8, top_k=5,
                             seed=42).result(30)
            assert r.ok
            outs.append(list(r.outputs[0]))
        finally:
            eng.stop()
    assert outs[0] == outs[1]
    # and equal to the runtime's own stream at another window size
    assert outs[0] == _runtime().generate(
        PROMPT, 6, tgen.SamplingParams(0.8, 5, 42), steps_per_window=1)


def test_engine_cancel_mid_stream_sheds():
    eng = _engine(window=1)
    try:
        s = eng.generate(PROMPT, max_new=24, temperature=0.5, seed=1)
        it = s.tokens(timeout=30)
        next(it)                       # the stream is live
        s.cancel()
        r = s.result(10)
        assert r.status == 'shed' and r.reason == 'cancelled'
        assert eng.counters.get('generation.cancelled') == 1
    finally:
        eng.stop()
    _replies_once(eng)
    assert eng.runtime.free_slots() == eng.runtime.slots


def test_engine_concurrent_mixed_prefill_decode():
    eng = _engine(_runtime(slots=3))
    try:
        streams = [None] * 6

        def client(i):
            streams[i] = eng.generate([i + 1] * (3 + i), max_new=5, seed=i)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]        # 6 requests, 3 slots
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        results = [s.result(60) for s in streams]
        assert all(r.ok and len(r.outputs[0]) == 5 for r in results)
        assert eng.counters.get('generation.mixed_dispatches') > 0
        for i, r in enumerate(results):
            assert list(r.outputs[0]) == _runtime().generate(
                [i + 1] * (3 + i), 5, tgen.SamplingParams(seed=i),
                steps_per_window=1)
    finally:
        eng.stop()
    _replies_once(eng)


def test_engine_ttft_itl_histograms_and_gauges():
    eng = _engine()
    try:
        r = eng.generate(PROMPT, max_new=6).result(30)
        assert r.ok
    finally:
        eng.stop()
    c = eng.counters
    assert c is eng.runtime.counters
    assert c.histogram('serving.ttft_ms')['count'] == 1
    assert c.histogram('serving.itl_ms')['count'] == 5
    for name in ('serving.ttft_ms', 'serving.itl_ms'):
        for q in (0.5, 0.99):
            assert c.quantile(name, q) is not None
    assert c.get('generation.tokens') == 6
    assert c.get('generation.kv_slots_in_use') == 0
    assert c.get('generation.kv_pages_in_use') == \
        eng.runtime.pool.in_use()
    assert c.get('generation.prefill_chunks') == 2
    assert c.get('generation.decode_windows') >= 2
    _replies_once(eng)


def test_engine_overall_deadline_mid_stream():
    eng = _engine(window=1)
    try:
        r = eng.generate(PROMPT, max_new=26, timeout_s=0.01).result(10)
        assert r.status == 'deadline_exceeded'
    finally:
        eng.stop()
    _replies_once(eng)


def test_engine_ttft_budget_expires():
    eng = _engine(window=1, ttft_timeout_s=0.0)
    try:
        r = eng.generate(list(range(1, 21)), max_new=2).result(10)
        assert r.status == 'deadline_exceeded' and r.reason == 'ttft'
    finally:
        eng.stop()
    _replies_once(eng)


def test_engine_drain_sheds_active_streams():
    eng = _engine(window=1)
    s = eng.generate([1, 2], max_new=26)
    it = s.tokens(timeout=30)
    next(it)                            # actively decoding now
    eng.stop()
    r = s.result(5)
    # finished in time or shed at shutdown: never silent
    assert r.status in ('ok', 'shed')
    _replies_once(eng)


def test_engine_decode_window_failure_gives_error_replies_and_frees_slots(
        monkeypatch):
    """The reference injects a `decode_step` fault; here decode_window
    itself raises on its first call."""
    rt = _runtime(slots=2)
    real = rt.decode_window
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError('injected decode failure')
        return real(*a, **k)

    monkeypatch.setattr(rt, 'decode_window', failing)
    eng = _engine(rt)
    try:
        streams = [eng.generate(PROMPT, max_new=6, seed=i) for i in range(2)]
        results = [s.result(30) for s in streams]
        assert any(r.status == 'error' and r.reason == 'decode_step'
                   for r in results)
        assert all(r.status in ('ok', 'error') for r in results)
        assert rt.free_slots() == rt.slots     # no leaked slots
        assert eng.counters.get('serving.batch_failures') == 1
        r2 = eng.generate(PROMPT, max_new=3).result(30)
        assert r2.ok                           # the engine keeps serving
    finally:
        eng.stop()
    _replies_once(eng)


# ------------------------------------------------- paging and kv_oom

def test_admission_never_fits_rejected_and_backpressure_queues():
    # 2 allocatable pages of 4 tokens: one stream fills the pool
    rt = _runtime(slots=2, page_len=4, pages=3, prefix_cache=False)
    eng = _engine(rt, config=ServingConfig(max_queue=16))
    try:
        res = eng.generate(list(range(1, 10)), max_new=9).result(30)
        assert res.status == 'rejected' and res.reason == 'kv_oom'
        streams = [eng.generate([1 + i, 5, 9, 2], max_new=4, timeout_s=60.0)
                   for i in range(4)]
        results = [s.result(60) for s in streams]
        assert all(r.ok for r in results)
        assert eng.counters.get('generation.kv_backpressure') > 0
    finally:
        eng.stop()
    assert rt.pool.in_use() == 0 and rt.free_slots() == rt.slots
    _replies_once(eng)


def test_midstream_kv_oom_is_a_terminal_error(monkeypatch):
    """The reference forces the second page claim to fail with its kv_oom
    fault site; here PagePool.alloc fails on its second call."""
    rt = _runtime(slots=1, page_len=4, prefix_cache=False)
    real = rt.pool.alloc
    calls = []

    def alloc(n, evict=None):
        calls.append(n)
        return None if len(calls) == 2 else real(n, evict=evict)

    monkeypatch.setattr(rt.pool, 'alloc', alloc)
    eng = _engine(rt)
    try:
        s = eng.generate([2, 7], max_new=8, timeout_s=60.0)
        res = s.result(60)
        assert res.status == 'error' and res.reason == 'kv_oom'
        assert 'exhausted' in res.error
        assert len(s.tokens_so_far()) >= 1     # streamed work stays readable
        assert eng.counters.get('generation.kv_oom') == 1
    finally:
        eng.stop()
    assert rt.free_slots() == rt.slots and rt.pool.in_use() == 0
    _replies_once(eng)


def test_engine_prefix_hit_skips_the_shared_pages():
    rt = _runtime(slots=2, page_len=4)
    eng = _engine(rt)
    prompt = [7, 3, 11, 2, 9, 1, 4, 6, 13, 5]
    try:
        cold = eng.generate(prompt, max_new=5).result(30)
        warm = eng.generate(prompt, max_new=5).result(30)
        assert cold.ok and warm.ok
        assert list(warm.outputs[0]) == list(cold.outputs[0])
        assert eng.counters.get('generation.prefix_hits') == 1
        # the hit skipped its two shared pages: 3 chunks cold, 1 warm
        assert eng.counters.get('generation.prefill_chunks') == 4
    finally:
        eng.stop()
    _replies_once(eng)


@pytest.mark.parametrize('temperature,top_k,seed', [(0.0, 0, 0),
                                                    (0.9, 5, 11)])
def test_engine_speculative_stream_equals_plain(temperature, top_k, seed):
    outs = []
    for spec in (False, True):
        eng = _engine(_runtime(slots=2, prefix_cache=False),
                      speculative=spec)
        try:
            r = eng.generate(PROMPT, max_new=12, temperature=temperature,
                             top_k=top_k, seed=seed).result(60)
            assert r.ok
            outs.append(list(r.outputs[0]))
            if spec:
                assert eng.counters.get('generation.spec_proposed') > 0
        finally:
            eng.stop()
        _replies_once(eng)
    assert outs[0] == outs[1]


def test_speculative_kill_switch(monkeypatch):
    monkeypatch.setenv('PT_SPEC_DECODE', '0')
    assert not tgen.GenerationConfig(speculative=True).speculative
    monkeypatch.setenv('PT_SPEC_DECODE', '1')
    assert tgen.GenerationConfig().speculative
    with pytest.raises(ValueError):
        tgen.GenerationConfig(decode_window=0)


# ------------------------------------------------------- models.llama

def test_llama_make_streaming_runtime_end_to_end():
    import paddle_tpu_torch as tf
    from paddle_tpu_torch.models import llama

    main, start = tf.Program(), tf.Program()
    with tf.program_guard(main, start):
        llama.generation_program('tiny', mode='prefill')
    scope = tf.Scope()
    with tf.scope_guard(scope):
        tf.Executor(tf.CPUPlace()).run(start)
    rt = llama.make_streaming_runtime(scope, 'tiny', slots=2,
                                      prefill_chunk=8, device='cpu')
    assert rt.w['tok_emb'].device.type == 'cpu'
    eng = tgen.GenerationEngine(rt, gen_config=tgen.GenerationConfig(
        decode_window=2)).start()
    try:
        r = eng.generate([1, 2, 3, 4], max_new=4).result(60)
        assert r.ok and len(r.outputs[0]) == 4
        assert all(0 <= t < llama.CONFIGS['tiny']['vocab']
                   for t in r.outputs[0])
    finally:
        eng.stop()
    _replies_once(eng)


def test_engine_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    import paddle_tpu_torch as tf
    from paddle_tpu_torch.models import llama
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    main, start = tf.Program(), tf.Program()
    with tf.program_guard(main, start):
        llama.generation_program('tiny', mode='prefill')
    scope = tf.Scope()
    with tf.scope_guard(scope):
        tf.Executor(tf.CPUPlace()).run(start)
    with pytest.raises(RuntimeError, match='CUDA'):
        llama.make_streaming_runtime(scope, 'tiny')
