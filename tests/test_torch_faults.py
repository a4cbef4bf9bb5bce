"""The port's fault injection (paddle_tpu_torch/testing/faults.py) against
the JAX package's (paddle_tpu/testing/faults.py), and its two generation
sites, on the CPU.

The same ``PT_FAULT`` spec must give the same sequence of fires in both
modules: hit-indexed and step-indexed sites, `fire_in` windows, spent
budgets, forensic replay and `poison_nan`'s row and stacked cases (the
cases of tests/test_faults.py).  Then the sites the port calls, through
the real code and no monkeypatch: ``kv_oom`` in `PagePool.alloc`, at
admission (the request waits) and mid-stream (a terminal reply), and
``decode_step`` in `GenerationEngine._decode_step` (every decoding stream
gets an error reply); each frees its slots and pages, and a request after
it equals the same request run alone.  Each test starts and ends with
both modules disarmed."""
import signal

import numpy as np
import pytest

from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.serving import ServingConfig
from paddle_tpu_torch.serving import generation as tgen
from paddle_tpu_torch.serving.generation import decode as tdec
from paddle_tpu_torch.serving.generation.kv_cache import (CacheConfig,
                                                          PagePool)
from paddle_tpu_torch.testing import faults as tfaults
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

CFG = dict(vocab=64, d_model=32, n_layer=2, n_head=4, n_kv_head=2,
           d_ffn=64, theta=10000.0, max_len=32)
PROMPT = [1, 5, 9, 2, 7, 3]


@pytest.fixture(autouse=True)
def disarmed(monkeypatch):
    monkeypatch.delenv('PT_FAULT', raising=False)
    monkeypatch.delenv('PT_SPEC_DECODE', raising=False)
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def _in_both(spec, fn):
    """fn(module) in each package after configuring `spec` there."""
    out = []
    for m in (jfaults, tfaults):
        m.configure(spec)
        out.append(fn(m))
    return out


def _armed(m):
    return {s: (f.site, f.at, f.times, f.sleep_s, f.row, f.hits, f.fired)
            for s, f in m._ACTIVE.items()}


# ------------------------------------------------------------ the module

def test_sites_and_names_match_the_reference():
    assert tfaults.SITES == jfaults.SITES
    assert 'kv_oom' in tfaults.SITES and 'decode_step' in tfaults.SITES
    assert set(jfaults.__all__) <= set(tfaults.__all__)
    assert issubclass(tfaults.InjectedFault, OSError)


def test_spec_parsing_matches_the_reference():
    spec = ('ckpt_write:at=2,nan_step:at=5:times=3:row=1,'
            'prefetch_stall:at=1:s=0.25')
    j, t = _in_both(spec, _armed)
    assert j == t
    assert t['nan_step'][1:5] == (5, 3, 0.05, 1)
    assert t['prefetch_stall'][3] == 0.25
    assert tfaults.spec('nan_step').row == 1
    assert tfaults.spec('cache_read') is None
    assert tfaults.active('ckpt_write') and not tfaults.active('cache_read')


def test_unknown_field_is_refused_in_both():
    for m in (jfaults, tfaults):
        with pytest.raises(ValueError, match='not understood'):
            m.configure('ckpt_write:frequency=2')


def test_env_parse_is_lazy_and_resettable(monkeypatch):
    monkeypatch.setenv('PT_FAULT', 'kv_oom:at=1')
    for m in (jfaults, tfaults):
        m.reset()
        assert m.any_active() and m.active('kv_oom')
    monkeypatch.delenv('PT_FAULT')
    for m in (jfaults, tfaults):
        m.reset()
        assert not m.any_active()


def _call(m, c):
    kind, site = c[0], c[1]
    if kind == 'fire':
        return m.fire(site, *c[2:])
    return m.fire_in(site, *c[2:])


@pytest.mark.parametrize('spec,calls,expect', [
    ('cache_read:at=3:times=2', [('fire', 'cache_read')] * 6,
     [False, False, True, True, False, False]),
    ('nan_step:at=4', [('fire', 'nan_step', 3), ('fire', 'nan_step', 4),
                       ('fire', 'nan_step', 4)], [False, True, False]),
    ('sigterm:at=5', [('fire_in', 'sigterm', 0, 4),
                      ('fire_in', 'sigterm', 4, 4),
                      ('fire_in', 'sigterm', 4, 4)], [False, True, False]),
    ('nan_step:at=2:times=3', [('fire_in', 'nan_step', 0, 2),
                               ('fire_in', 'nan_step', 2, 2),
                               ('fire_in', 'nan_step', 4, 2),
                               ('fire_in', 'nan_step', 6, 2)],
     [False, True, True, False]),
    ('decode_step:at=2,kv_oom:at=1:times=2',
     [('fire', 'decode_step'), ('fire', 'kv_oom'), ('fire', 'decode_step'),
      ('fire', 'kv_oom'), ('fire', 'kv_oom'), ('fire', 'decode_step'),
      ('fire', 'io_read')],
     [False, True, True, True, False, False, False]),
], ids=['hit_indexed', 'step_indexed_budget', 'fire_in_window',
        'fire_in_times', 'two_generation_sites'])
def test_one_spec_fires_alike_in_both(spec, calls, expect):
    j, t = _in_both(spec, lambda m: ([_call(m, c) for c in calls],
                                     m.stats()))
    assert j == t
    assert t[0] == expect


def test_forensic_replay_fires_alike_and_keeps_the_spent_budget():
    def run(m):
        c0 = m.fire_in('nan_step', 4, 2)
        c1 = m.fire_in('nan_step', 4, 2)
        with m.forensic_replay():
            r = [m.fire_in('nan_step', 4, 2), m.fire('nan_step', step=4)]
        return c0, c1, r, m.fire_in('nan_step', 4, 2), m.stats()

    before = tfaults.counters.get('faults.injected.nan_step')
    j, t = _in_both('nan_step:at=4', run)
    assert j == t
    assert t[:4] == (True, False, [True, True], False)
    # the replay's fires were not counted as injections
    assert tfaults.counters.get('faults.injected.nan_step') == before + 1


def test_forensic_replay_only_covers_nan_step():
    def run(m):
        first = m.fire('cache_read')
        with m.forensic_replay():
            return first, m.fire('cache_read')

    j, t = _in_both('cache_read:at=1', run)
    assert j == t == (True, False)


def test_maybe_fail_raises_alike_and_counts():
    c0 = tfaults.counters.get('faults.injected')
    msgs = []
    for m in (jfaults, tfaults):
        m.configure('io_write:at=2')
        m.maybe_fail('io_write')                  # hit 1: no fire
        with pytest.raises(m.InjectedFault) as e:
            m.maybe_fail('io_write')
        msgs.append(str(e.value))
        m.maybe_fail('io_write')                  # budget spent
    assert msgs[0] == msgs[1]
    assert tfaults.counters.get('faults.injected') == c0 + 1
    assert tfaults.counters.get('faults.injected.io_write') >= 1


def test_maybe_sleep_fires_alike():
    j, t = _in_both('serve_slow_batch:at=2:s=0.001', lambda m: [
        m.maybe_sleep('serve_slow_batch') for _ in range(3)])
    assert j == t == [False, True, False]


def test_maybe_kill_delivers_the_signal_alike():
    got = []
    old = signal.signal(signal.SIGUSR1, lambda *a: got.append(len(got)))
    try:
        for m in (jfaults, tfaults):
            m.configure('sigterm:at=3')
            m.maybe_kill('sigterm', step=0, count=2, sig=signal.SIGUSR1)
            m.maybe_kill('sigterm', step=2, count=2, sig=signal.SIGUSR1)
            m.maybe_kill('sigterm', step=2, count=2, sig=signal.SIGUSR1)
    finally:
        signal.signal(signal.SIGUSR1, old)
    assert got == [0, 1]                        # one kill per package


@pytest.mark.parametrize('spec,shape,step,count', [
    ('nan_step:at=0:row=1', (4, 3), 0, 1),
    ('nan_step:at=2:row=1', (4, 3, 2), 0, 4),
    ('nan_step:at=1', (3, 2, 2), 0, 3),
    ('nan_step:at=7:row=0', (2, 2), 0, 2),
], ids=['row', 'row_stacked', 'whole_step_stacked', 'outside_window'])
def test_poison_nan_alike(spec, shape, step, count):
    feed = {'x': np.ones(shape, np.float32),
            'lbl': np.zeros((shape[0], 1), np.int64)}
    j, t = _in_both(spec, lambda m: m.poison_nan(feed, step, count))
    assert sorted(j) == sorted(t)
    for k in t:
        np.testing.assert_array_equal(np.isnan(t[k]), np.isnan(j[k]))
    np.testing.assert_array_equal(t['lbl'], feed['lbl'])
    assert np.isfinite(feed['x']).all()              # input not mutated
    if spec.endswith('row=0'):
        assert t is feed                             # a miss copies nothing


# ------------------------------------------------ the generation sites

def test_page_pool_kv_oom_site_forces_exhaustion():
    pool = PagePool(CacheConfig(slots=2, layers=1, kv_heads=1, max_len=16,
                                head_dim=4, page_len=4, pages=6))
    tfaults.configure('kv_oom:at=1:times=1')
    assert pool.alloc(1) is None                     # injected exhaustion
    assert pool.alloc(1) == [1]                      # budget spent
    assert tfaults.counters.get('faults.injected.kv_oom') >= 1


def _runtime(**kw):
    kw.setdefault('slots', 2)
    return tgen.DecodeRuntime(tdec.random_weights(CFG, seed=0), CFG,
                              prefill_chunk=4, device='cpu', **kw)


def _engine(rt, window=4):
    return tgen.GenerationEngine(
        rt, config=ServingConfig(max_queue=16),
        gen_config=tgen.GenerationConfig(decode_window=window)).start()


def _alone(prompt, max_new, params, **kw):
    """The same request through a fresh runtime of its own."""
    return _runtime(**kw).generate(prompt, max_new, params,
                                   steps_per_window=4)


def _replies_once(eng):
    c = eng.counters
    replies = sum(c.get('serving.' + k) for k in (
        'completed', 'shed', 'deadline_exceeded', 'errors', 'rejected'))
    assert c.get('serving.deadlocks') == 0
    assert replies == c.get('serving.submitted')


def test_kv_oom_at_admission_keeps_the_request_queued():
    rt = _runtime(page_len=4, prefix_cache=False)
    eng = _engine(rt)
    try:
        tfaults.configure('kv_oom:at=1:times=1')
        r = eng.generate(PROMPT, max_new=6, timeout_s=60.0).result(60)
        assert r.ok and r.reason == 'max_tokens'
        assert eng.counters.get('generation.kv_backpressure') >= 1
        assert tfaults.counters.get('faults.injected.kv_oom') >= 1
    finally:
        eng.stop()
    assert list(r.outputs[0]) == _alone(PROMPT, 6, tgen.SamplingParams(),
                                        page_len=4, prefix_cache=False)
    _replies_once(eng)


def test_kv_oom_mid_stream_is_terminal_and_the_next_request_is_whole():
    rt = _runtime(slots=1, page_len=4, prefix_cache=False)
    eng = _engine(rt)
    params = tgen.SamplingParams(temperature=0.9, top_k=5, seed=11)
    try:
        # alloc 1 claims the admission span, alloc 2 is the growth before
        # the second window: the fault fires there
        tfaults.configure('kv_oom:at=2:times=1')
        s = eng.generate([2, 7], max_new=8, timeout_s=60.0)
        res = s.result(60)
        assert res.status == 'error' and res.reason == 'kv_oom'
        assert 'exhausted' in res.error
        assert len(s.tokens_so_far()) >= 1
        assert eng.counters.get('generation.kv_oom') == 1
        assert rt.free_slots() == rt.slots and rt.pool.in_use() == 0
        after = eng.generate(PROMPT, max_new=9, temperature=0.9, top_k=5,
                             seed=11).result(60)
        assert after.ok
    finally:
        eng.stop()
    assert list(after.outputs[0]) == _alone(PROMPT, 9, params, slots=1,
                                            page_len=4, prefix_cache=False)
    assert rt.free_slots() == rt.slots and rt.pool.in_use() == 0
    _replies_once(eng)


def test_decode_step_fault_errors_the_window_and_frees_its_slots():
    rt = _runtime()
    eng = _engine(rt)
    try:
        tfaults.configure('decode_step:at=1')
        streams = [eng.generate(PROMPT, max_new=6, seed=i) for i in range(2)]
        results = [s.result(30) for s in streams]
        # the faulted window errors every decoding stream; a stream still
        # prefilling when it fired finishes afterwards
        assert any(r.status == 'error' and r.reason == 'decode_step'
                   for r in results)
        assert all(r.status in ('ok', 'error') for r in results)
        assert tfaults.counters.get('faults.injected.decode_step') >= 1
        assert tfaults.stats()['decode_step'][1] == 1
        assert rt.free_slots() == rt.slots and rt.pool.in_use() == 0
        assert eng.counters.get('serving.batch_failures') >= 1
        after = eng.generate(PROMPT, max_new=7, temperature=0.8, top_k=4,
                             seed=5).result(30)
        assert after.ok
    finally:
        eng.stop()
    assert list(after.outputs[0]) == _alone(
        PROMPT, 7, tgen.SamplingParams(temperature=0.8, top_k=4, seed=5))
    _replies_once(eng)
