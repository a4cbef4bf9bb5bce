"""The port's asynchronous runtime on the CPU: check_nan with its fused
verdict, read every step or deferred (core/async_runtime.py
DeferredNanVerdict), the naming pass, FetchFuture and the host-block
meter, and FeedPrefetcher (data_feeder.py).  Counterpart of the
reference's tests/test_run_steps.py :126, :192-312 and of its async
runtime's contract; the reference's check_nan test poisons an SGD step,
the port's an Adam step (the port's only optimizer).

Comparisons are bit for bit: check_nan reads the step's results and
changes none of them."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tf
from paddle_tpu.core import async_runtime as jasync
from paddle_tpu_torch.core import async_runtime as tasync
from paddle_tpu_torch.core import executor as texec


@pytest.fixture(autouse=True)
def fresh_port_programs():
    """Fresh default programs, scope and name generator for the port (the
    root conftest does the same for the JAX package)."""
    from paddle_tpu_torch.core import framework, unique_name
    main, startup = framework.Program(), framework.Program()
    old_main = framework.switch_main_program(main)
    old_startup = framework.switch_startup_program(startup)
    old_gen = unique_name.switch()
    old_scope = texec._global_scope
    texec._global_scope = texec.Scope()
    yield
    framework.switch_main_program(old_main)
    framework.switch_startup_program(old_startup)
    unique_name.switch(old_gen)
    texec._global_scope = old_scope


def _model(dropout=0.3):
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 5
    with tf.program_guard(main, startup), tf.unique_name.guard():
        x = tf.layers.data('x', shape=[8], dtype='float32')
        lbl = tf.layers.data('lbl', shape=[1], dtype='int64')
        h = tf.layers.fc(x, 16, act='relu')
        h = tf.layers.dropout(h, dropout_prob=dropout)
        logits = tf.layers.fc(h, 4)
        loss = tf.layers.scale(tf.layers.reduce_sum(
            tf.layers.softmax_with_cross_entropy(logits, lbl)), 1.0 / 6)
        tf.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _feeds(K, seed=0):
    rng = np.random.RandomState(seed)
    return [{'x': rng.randn(6, 8).astype('float32'),
             'lbl': rng.randint(0, 4, (6, 1)).astype('int64')}
            for _ in range(K)]


def _sqrt_model():
    """loss = sum(sqrt(x @ w_ms)), Adam: a feed of negative x makes the
    loss, the gradient and after the update w_ms itself NaN."""
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        x = tf.layers.data('x', shape=[2], dtype='float32')
        y = tf.layers.fc(x, 1, param_attr=tf.ParamAttr(name='w_ms'),
                         bias_attr=False)
        half = tf.layers.fill_constant([1], 'float32', 0.5)
        loss = tf.layers.reduce_sum(tf.layers.elementwise_pow(y, half))
        tf.optimizer.Adam(0.1).minimize(loss)
    return main, startup, loss


GOOD = {'x': np.array([[1.0, 1.0]], 'float32')}
BAD = {'x': np.array([[-100.0, -100.0]], 'float32')}


def _exe(**kw):
    return tf.Executor(tf.CPUPlace(), **kw)


def _losses(check_nan, runs_steps):
    main, startup, loss = _model()
    feeds = _feeds(3)
    exe, scope = _exe(check_nan=check_nan), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        if runs_steps:
            out, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss])
        else:
            out = np.stack([exe.run(main, feed=f, fetch_list=[loss])[0]
                            for f in feeds])
    return out, scope


@pytest.mark.parametrize('runs_steps', [False, True],
                         ids=['run', 'run_steps'])
def test_check_nan_changes_no_result(runs_steps):
    off, s_off = _losses(False, runs_steps)
    on, s_on = _losses(True, runs_steps)
    assert on.tobytes() == off.tobytes()
    for n in s_off.vars:
        assert torch.equal(s_on.vars[n], s_off.vars[n]), n


def test_check_nan_flag_from_the_environment(monkeypatch):
    monkeypatch.setenv('FLAGS_check_nan_inf', '1')
    assert _exe().check_nan
    monkeypatch.setenv('FLAGS_check_nan_inf', '0')
    assert not _exe().check_nan
    assert _exe(check_nan=True).check_nan


def test_check_nan_names_the_poisoned_parameter():
    main, startup, loss = _sqrt_model()
    exe, scope = _exe(check_nan=True), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=GOOD, fetch_list=[loss])
        with pytest.raises(RuntimeError, match='w_ms') as e:
            exe.run(main, feed=BAD, fetch_list=[loss])
    assert str(e.value).startswith('check_nan: non-finite values')
    assert e.value.nan_window_steps == 1
    # written back before the check: the scope holds the NaN update
    assert not bool(torch.isfinite(scope.vars['w_ms']).all())


def test_check_nan_trips_in_any_step_of_run_steps():
    main, startup, loss = _sqrt_model()
    exe, scope = _exe(check_nan=True), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        with pytest.raises(RuntimeError, match='w_ms') as e:
            exe.run_steps(main, feed_list=[GOOD, BAD, GOOD],
                          fetch_list=[loss])
    assert e.value.nan_window_steps == 3


def test_deferred_verdict_trips_at_the_poll_with_its_window():
    main, startup, loss = _sqrt_model()
    exe, scope = _exe(check_nan=True, nan_poll=4), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)      # a window of its own stream: 1 step pending
        assert not exe.nan_clean()
        exe.reset_nan_window()
        assert exe.nan_clean()
        for feed in (GOOD, BAD, GOOD):   # 3 pending: nothing read yet
            exe.run(main, feed=feed, fetch_list=[loss])
        assert not exe.nan_clean()
        with pytest.raises(RuntimeError, match='w_ms') as e:
            exe.run(main, feed=GOOD, fetch_list=[loss])
    assert e.value.nan_window_steps == 4
    assert e.value.nan_window_start == 0
    assert exe.nan_clean()


def test_poll_nan_raises_the_deferred_message():
    main, startup, loss = _sqrt_model()
    exe, scope = _exe(check_nan=True, nan_poll=8), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        exe.poll_nan()                   # the startup's clean window
        exe.run(main, feed=BAD, fetch_list=[loss])
        exe.run(main, feed=GOOD, fetch_list=[loss])
        with pytest.raises(RuntimeError) as e:
            exe.poll_nan()
    assert str(e.value) == tasync.DEFERRED_TRIP_MSG % 2
    assert e.value.nan_window_steps == 2
    exe.poll_nan()                       # the window was reset
    # a dropped window is never read
    with tf.scope_guard(scope):
        exe.run(main, feed=BAD, fetch_list=[loss])
    exe.reset_nan_window()
    exe.poll_nan()
    # check_nan off: nothing pends, nothing raises
    off = _exe(check_nan=False, nan_poll=8)
    assert off.nan_clean()
    off.poll_nan()


def test_deferred_message_and_poll_default_are_the_references(monkeypatch):
    assert tasync.DEFERRED_TRIP_MSG == jasync.DEFERRED_TRIP_MSG
    for env in ({}, {'PT_ASYNC': '1'}, {'PT_NAN_POLL': '3'},
                {'PT_ASYNC': '1', 'PT_NAN_POLL': '2'}):
        monkeypatch.delenv('PT_ASYNC', raising=False)
        monkeypatch.delenv('PT_NAN_POLL', raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tasync.default_nan_poll() == jasync.default_nan_poll(), env
        assert _exe(check_nan=True).nan_poll == tasync.default_nan_poll()


def test_deferred_verdict_ands_on_the_device():
    v = tasync.DeferredNanVerdict(poll_every=3)
    t, f = torch.tensor(True), torch.tensor(False)
    v.push(t, start=7)
    v.push(f)
    assert not v.due() and v.pending_steps == 2
    v.push(t)
    assert v.due()
    assert v.poll() == 3 and v.last_window_start == 7
    assert v.poll() == 0 and v.pending_steps == 0
    v.push(t, steps=5)
    assert v.poll() == 0


def test_fetch_futures_and_the_host_block_meter():
    main, startup, loss = _model()
    feeds = _feeds(3)
    ref, _ = _losses(False, True)
    exe, scope = _exe(), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        blocked0 = tasync.counters['executor.host_blocked_s']
        fetch0 = tasync.counters['executor.fetch_sync_s']
        fut, = exe.run(main, feed=feeds[0], fetch_list=[loss],
                       as_futures=True)
        assert isinstance(fut, tasync.FetchFuture) and fut.ready()
        assert fut.shape == (1,) and fut.dtype == torch.float32
        assert 'pending' in repr(fut)
        assert float(fut[0]) == float(ref[0][0])
        assert 'pending' in repr(fut)    # the slice synced, not fut
        assert fut.numpy().tobytes() == ref[0].tobytes()
        assert 'synced' in repr(fut)
        assert np.asarray(fut).tobytes() == ref[0].tobytes()
        assert fut.block() is fut
        assert tasync.counters['executor.host_blocked_s'] > blocked0
        assert tasync.counters['executor.fetch_sync_s'] == fetch0
        rest, = exe.run_steps(main, feed_list=feeds[1:], fetch_list=[loss],
                              as_futures=True)
        assert len(rest) == 2 and isinstance(rest[1], tasync.FetchFuture)
        assert rest[1].numpy().tobytes() == ref[2].tobytes()
        assert isinstance(rest.device(), torch.Tensor)
        exe.run(main, feed=feeds[0], fetch_list=[loss])
    assert tasync.counters['executor.fetch_sync_s'] > fetch0


def test_host_block_meters_into_a_named_counter():
    before = dict(tasync.counters)
    with tasync.host_block('test', extra_counter='executor.fetch_sync_s'):
        pass
    assert tasync.counters['executor.host_blocked_s'] >= \
        before['executor.host_blocked_s']
    assert tasync.counters['executor.fetch_sync_s'] >= \
        before['executor.fetch_sync_s']


# ---------------------------------------------------------- FeedPrefetcher

def test_feed_prefetcher_preserves_order_and_drains():
    feeds = ({'x': np.full((2, 3), i, 'float32'),
              'y': np.full((2,), -i, 'int64')} for i in range(10))
    pf = tf.FeedPrefetcher(feeds, steps=4, capacity=2, to_device=False)
    got = list(pf)
    assert [k for _, k in got] == [4, 4, 2]   # the partial tail flushed
    seen = []
    for stacked, k in got:
        assert stacked['x'].shape == (k, 2, 3)
        seen.extend(stacked['x'][:, 0, 0].tolist())
    assert seen == list(range(10))
    assert pf.cursor() == {'steps': 10, 'superbatches': 3, 'skipped': 0}
    assert list(pf) == []
    pf.close()
    pf.close()


def test_feed_prefetcher_uploads_to_the_given_device():
    feeds = [{'x': np.full((2,), i, 'float32')} for i in range(4)]
    (stacked, k), = list(tf.FeedPrefetcher(feeds, steps=4,
                                           to_device=tf.CPUPlace()))
    assert k == 4 and isinstance(stacked['x'], torch.Tensor)
    assert stacked['x'][:, 0].tolist() == [0, 1, 2, 3]
    (again, _), = list(tf.FeedPrefetcher(feeds, steps=4, to_device='cpu'))
    assert torch.equal(again['x'], stacked['x'])


def test_feed_prefetcher_skip_steps_and_bucketer():
    feeds = [{'x': np.full((3 if i % 2 else 2, 1), i, 'float32')}
             for i in range(6)]
    pf = tf.FeedPrefetcher(feeds, steps=2, to_device=False, skip_steps=1,
                           bucketer=tf.FeedBucketer([4]))
    got = list(pf)
    assert [k for _, k in got] == [2, 2, 1]
    assert got[0][0]['x'].shape == (2, 4, 1)     # padded to the bucket
    assert got[0][0]['x'][:, 0, 0].tolist() == [1, 2]
    assert pf.cursor()['steps'] == 6
    assert list(tf.FeedPrefetcher(feeds, steps=2, to_device=False,
                                  skip_steps=9)) == []


def test_feed_prefetcher_relays_a_reader_error():
    def gen():
        yield {'x': np.zeros((2,), 'float32')}
        yield {'x': np.ones((2,), 'float32')}
        raise RuntimeError('reader exploded')

    it = iter(tf.FeedPrefetcher(gen(), steps=2, to_device=False))
    stacked, k = next(it)
    assert k == 2
    with pytest.raises(RuntimeError, match='reader exploded'):
        next(it)


def test_feed_prefetcher_key_mismatch_is_an_error():
    feeds = [{'x': np.zeros(2, 'float32')}, {'y': np.zeros(2, 'float32')}]
    with pytest.raises(ValueError, match='disagree'):
        list(tf.FeedPrefetcher(feeds, steps=2, to_device=False))
    for bad in (dict(steps=0), dict(capacity=0), dict(skip_steps=-1)):
        with pytest.raises(ValueError):
            tf.FeedPrefetcher([], to_device=False, **bad)


def test_feed_prefetcher_close_stops_a_blocked_worker():
    pf = tf.FeedPrefetcher(({'x': np.zeros(1, 'float32')} for _ in
                            iter(int, 1)), steps=1, capacity=1,
                           to_device=False)
    it = iter(pf)
    next(it)
    pf.close()
    assert not pf._thread.is_alive()
    assert list(pf) == []


def test_feed_prefetcher_feeds_run_steps_bitwise():
    main, startup, loss = _model(dropout=0.3)
    feeds = _feeds(5)
    ref, ref_scope = None, None
    exe, scope = _exe(), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        ref = np.stack([exe.run(main, feed=f, fetch_list=[loss])[0]
                        for f in feeds])
    exe, scope2 = _exe(), tf.Scope()
    got = []
    with tf.scope_guard(scope2):
        exe.run(startup)
        for superbatch, k in tf.FeedPrefetcher(feeds, steps=2,
                                               to_device='cpu'):
            out, = exe.run_steps(main, feed_list=superbatch, steps=k,
                                 fetch_list=[loss])
            got.append(out)
    assert np.concatenate(got).tobytes() == ref.tobytes()
    for n in scope.vars:
        assert torch.equal(scope.vars[n], scope2.vars[n]), n
