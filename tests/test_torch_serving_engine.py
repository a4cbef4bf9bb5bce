"""The port's serving runtime with plain-function backends: coalescing and
scatter, admission refusals, deadlines, overflow policies, the token
bucket, the circuit breaker, drain and stop — every admitted request gets
a terminal reply.  Mirrors tests/test_serving.py for the JAX package."""
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.data_feeder import FeedBucketer
from paddle_tpu_torch.serving import ServingConfig, ServingEngine, TokenBucket
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)


class GatedBackend(object):
    """Backend that blocks each call on a gate and records batch shapes;
    the first `fail_first` calls raise."""

    def __init__(self, fail_first=0):
        self.gate = threading.Semaphore(0)
        self.entered = threading.Semaphore(0)   # one release per call
        self.calls = []
        self.fail_first = fail_first

    def __call__(self, feed):
        self.entered.release()
        assert self.gate.acquire(timeout=10)
        self.calls.append({k: np.asarray(v).shape for k, v in feed.items()})
        if len(self.calls) <= self.fail_first:
            raise RuntimeError('backend down')
        x = np.asarray(feed['x'])
        return [x * 2.0, np.asarray(x.shape[0])]   # per-row + aggregate


class FlakyBackend(object):
    """Raises on its first `fail_first` calls, echoes after."""

    def __init__(self, fail_first):
        self.fail_first = fail_first
        self.n = 0

    def __call__(self, feed):
        self.n += 1
        if self.n <= self.fail_first:
            raise RuntimeError('backend down')
        return [np.asarray(feed['x']) * 2.0]


def _echo_backend(feed):
    return [np.asarray(feed['x']) * 2.0]


def _feed(rows, cols=3, fill=None):
    a = np.arange(rows * cols, dtype='float32').reshape(rows, cols)
    if fill is not None:
        a = np.full((rows, cols), fill, dtype='float32')
    return {'x': a}


def test_coalesce_pad_and_scatter():
    be = GatedBackend()
    eng = ServingEngine(be, bucketer=FeedBucketer(boundaries=[1, 2, 4, 8]),
                        config=ServingConfig(max_queue=16))
    with eng:
        f1 = eng.submit(_feed(1, fill=1.0))
        assert be.entered.acquire(timeout=5)   # dispatcher holds batch 1
        f2 = eng.submit(_feed(2, fill=2.0))     # these two queue up and
        f3 = eng.submit(_feed(1, fill=3.0))     # coalesce into one batch
        for _ in range(3):
            be.gate.release()
        r1, r2, r3 = (f.result(5) for f in (f1, f2, f3))
    assert r1.ok and r2.ok and r3.ok
    assert len(be.calls) == 2, be.calls
    assert be.calls[1]['x'] == (4, 3)          # 2+1 rows padded to 4
    assert r2.outputs[0].shape == (2, 3) and np.all(r2.outputs[0] == 4.0)
    assert r3.outputs[0].shape == (1, 3) and np.all(r3.outputs[0] == 6.0)
    assert r1.outputs[1].ndim == 0             # aggregates handed whole
    assert eng.counters.histogram('serving.dispatched_rows')['max'] == 4


def test_batch_zero_and_too_large_rejected_clearly():
    eng = ServingEngine(_echo_backend, bucketer=FeedBucketer([1, 2, 4]),
                        config=ServingConfig(max_batch_rows=64))
    with eng:
        r0 = eng.submit(_feed(0)).result(1)
        assert r0.status == 'rejected' and r0.reason == 'empty_batch'
        rbig = eng.submit(_feed(5)).result(1)
        assert rbig.status == 'rejected' and rbig.reason == 'too_large'
        assert 'truncat' in rbig.error
        rbad = eng.submit({'x': np.ones((2, 3), 'f'),
                           'y': np.ones((3, 3), 'f')}).result(1)
        assert rbad.status == 'rejected' and rbad.reason == 'bad_request'
        assert eng.submit(_feed(2)).result(5).ok
    assert eng.counters.get('serving.rejected.too_large') == 1


def test_bucketer_pads_edge_rows_like_the_jax_bucketer():
    from paddle_tpu.data_feeder import FeedBucketer as JaxBucketer
    b, jb = FeedBucketer(boundaries=[1, 2, 4, 8]), JaxBucketer([1, 2, 4, 8])
    feed = {'x': _feed(3)['x'], 'n': np.arange(5)}   # 'n' is not batched
    out, n = b.bucket_feed(feed)
    jout, jn = jb.bucket_feed(feed)
    assert n == jn == 3 and out['x'].shape == (4, 3)
    np.testing.assert_array_equal(out['x'], jout['x'])
    np.testing.assert_array_equal(out['x'][3], out['x'][2])
    np.testing.assert_array_equal(out['n'], np.arange(5))
    for rows in (1, 5, 8, 9, 17, 100):
        assert b.boundary(rows) == jb.boundary(rows)
    assert FeedBucketer().boundaries == JaxBucketer().boundaries
    with pytest.raises(ValueError):
        b.boundary(0)


def test_expired_deadline_rejected_at_admission():
    with ServingEngine(_echo_backend) as eng:
        r = eng.submit(_feed(1), timeout_s=0).result(1)
    assert r.status == 'rejected' and r.reason == 'deadline'


def test_queued_past_deadline_dropped_pre_dispatch():
    be = GatedBackend()
    eng = ServingEngine(be, config=ServingConfig(max_queue=16))
    with eng:
        f1 = eng.submit(_feed(1), timeout_s=30)
        assert be.entered.acquire(timeout=5)        # f1 is mid-dispatch
        f2 = eng.submit(_feed(1), timeout_s=0.05)   # expires while queued
        time.sleep(0.12)
        be.gate.release()
        be.gate.release()
        r1, r2 = f1.result(5), f2.result(5)
    assert r1.ok
    assert r2.status == 'deadline_exceeded' and r2.reason == 'queue_wait'
    assert len(be.calls) == 1                       # no compute spent on f2


@pytest.mark.parametrize('policy', ['reject', 'shed_oldest'])
def test_overflow_policies(policy):
    be = GatedBackend()
    eng = ServingEngine(be, config=ServingConfig(max_queue=1,
                                                 overflow_policy=policy))
    with eng:
        f1 = eng.submit(_feed(1))          # dispatched, blocked in backend
        assert be.entered.acquire(timeout=5)
        f2 = eng.submit(_feed(1))          # fills the queue
        f3 = eng.submit(_feed(1))          # overflow
        if policy == 'reject':
            r3 = f3.result(1)
            assert r3.status == 'rejected' and r3.reason == 'full'
            survivor = f2
        else:
            r2 = f2.result(1)
            assert r2.status == 'shed' and r2.reason == 'overflow'
            survivor = f3
        be.gate.release()
        be.gate.release()
        assert f1.result(5).ok and survivor.result(5).ok


def test_overflow_block_policy_admits_after_drain():
    be = GatedBackend()
    eng = ServingEngine(be, config=ServingConfig(
        max_queue=1, overflow_policy='block', block_timeout_s=5.0))
    with eng:
        f1 = eng.submit(_feed(1))
        assert be.entered.acquire(timeout=5)
        f2 = eng.submit(_feed(1))          # queue now full
        got = []
        t = threading.Thread(target=lambda: got.append(eng.submit(_feed(1))))
        t.start()
        time.sleep(0.1)
        assert not got or not got[0].done()   # blocked, not refused
        for _ in range(3):
            be.gate.release()
        t.join(5)
        assert not t.is_alive()
        assert f1.result(5).ok and f2.result(5).ok and got[0].result(5).ok


def test_token_bucket_and_rate_limited_submit():
    now = [0.0]
    tb = TokenBucket(qps=10.0, burst=2.0, clock=lambda: now[0])
    assert tb.try_acquire() and tb.try_acquire() and not tb.try_acquire()
    now[0] += 0.1           # refills exactly one token
    assert tb.try_acquire() and not tb.try_acquire()
    eng = ServingEngine(_echo_backend, config=ServingConfig(
        rate_qps=0.001, rate_burst=2))
    with eng:
        assert eng.submit(_feed(1)).result(5).ok
        assert eng.submit(_feed(1)).result(5).ok
        r = eng.submit(_feed(1)).result(1)
    assert r.status == 'rejected' and r.reason == 'rate'


def test_breaker_trips_on_failures_and_recovers_on_probe():
    eng = ServingEngine(FlakyBackend(fail_first=3), config=ServingConfig(
        breaker_failure_threshold=3, breaker_cooldown_s=0.05))
    with eng:
        results = [eng.submit(_feed(1)).result(5) for _ in range(3)]
        assert all(r.status == 'error' and r.reason == 'dispatch'
                   for r in results)
        assert eng.breaker.state == 'open'
        assert eng.state == 'degraded'
        time.sleep(0.08)                   # cooldown elapses
        assert eng.submit(_feed(1)).result(5).ok
        assert eng.breaker.state == 'closed' and eng.state == 'ready'
    assert eng.counters.get('serving.breaker_trips') == 1
    assert eng.breaker.trips == 1 and eng.breaker.recoveries == 1


def test_breaker_open_serves_one_request_per_batch():
    be = GatedBackend(fail_first=3)
    eng = ServingEngine(be, config=ServingConfig(
        breaker_failure_threshold=3, breaker_cooldown_s=30.0))
    with eng:
        for _ in range(3):
            be.gate.release()
        for _ in range(3):
            assert eng.submit(_feed(1)).result(5).status == 'error'
        assert eng.breaker.state == 'open'
        futs = [eng.submit(_feed(1)) for _ in range(3)]
        for _ in range(3):
            be.gate.release()
        assert all(f.result(5).ok for f in futs)
    assert all(c['x'][0] == 1 for c in be.calls)
    assert eng.counters.get('serving.slow_path_batches') == 3


def test_drain_finishes_queue_then_refuses():
    be = GatedBackend()
    eng = ServingEngine(be, config=ServingConfig(max_queue=16))
    eng.start()
    f1 = eng.submit(_feed(1))
    f2 = eng.submit(_feed(1))
    eng.begin_drain()
    r_late = eng.submit(_feed(1)).result(1)
    assert r_late.status == 'rejected' and r_late.reason == 'draining'
    for _ in range(2):
        be.gate.release()
    assert eng.drain(timeout=5)
    assert f1.result(1).ok and f2.result(1).ok
    assert eng.state == 'stopped' and not eng.ready()


def test_every_admitted_request_gets_a_terminal_reply():
    def slow_backend(feed):
        time.sleep(0.05)
        return [np.asarray(feed['x']) * 2.0]

    eng = ServingEngine(slow_backend, config=ServingConfig(
        max_queue=4, overflow_policy='shed_oldest', max_batch_rows=2))
    eng.start()
    futs = []
    threads = [threading.Thread(target=lambda i=i: futs.append(
        eng.submit(_feed(1, fill=float(i)), timeout_s=0.5 if i % 3 else None)))
        for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
        assert not t.is_alive()
    eng.stop(timeout=0.05)
    statuses = [f.result(5).status for f in futs]
    assert len(statuses) == 24
    assert set(statuses) <= {'ok', 'shed', 'deadline_exceeded', 'rejected'}
    c = eng.counters
    assert c.get('serving.deadlocks') == 0
    terminal = (c.get('serving.completed') + c.get('serving.shed')
                + c.get('serving.deadline_exceeded') + c.get('serving.errors'))
    assert c.get('serving.admitted') == terminal
