"""The port's `Executor.run_steps`, its run counters and CompiledProgram
on the CPU, against the JAX package's `run_steps` and against K port
runs (paddle_tpu/core/executor.py :1008, tests/test_run_steps.py).

The model is tests/test_run_steps.py's: fc, relu, dropout, fc, the
softmax cross entropy's mean, Adam; feeds from a numpy seed.

Tolerances, each with its reason:
- against the JAX package (float32, dropout 0, the JAX startup's scope
  carried into the port): losses and every scope tensor within 1e-5
  relative, with an absolute floor of 1e-7 for entries that are float
  noise (an Adam moment of a near-zero gradient); both sides compute the
  same float32 operations in other summation orders;
- port `run_steps` against port runs: bit for bit, dropout included (the
  same ops on the same counters).

The counter repair: a run counter per (program, version, feed names,
fetch names, scope), as the reference keys it (:1420-1436).  The
shared-stream, independent-stream and `rng_state` resume tests fail on a
single counter per executor."""
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
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


BATCH = 6


def _model(fluid, seed=7, dropout=0.5):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data('x', shape=[8], dtype='float32')
        lbl = fluid.layers.data('lbl', shape=[1], dtype='int64')
        h = fluid.layers.fc(x, 16, act='relu')
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=dropout)
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.scale(fluid.layers.reduce_sum(
            fluid.layers.softmax_with_cross_entropy(logits, lbl)),
            1.0 / BATCH)
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _feeds(K, seed=0):
    rng = np.random.RandomState(seed)
    return [{'x': rng.randn(BATCH, 8).astype('float32'),
             'lbl': rng.randint(0, 4, (BATCH, 1)).astype('int64')}
            for _ in range(K)]


def _exe():
    return tf.Executor(tf.CPUPlace())


def _sequential(main, startup, loss, feeds):
    exe, scope = _exe(), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        losses = [exe.run(main, feed=f, fetch_list=[loss])[0]
                  for f in feeds]
    return np.stack(losses), scope


def _same_scopes(a, b):
    assert set(a.vars) == set(b.vars)
    for n in a.vars:
        assert torch.equal(a.vars[n], b.vars[n]), n


def test_run_steps_matches_the_jax_package():
    K = 4
    feeds = _feeds(K)
    jmain, jstart, jloss = _model(jf, dropout=0.0)
    tmain, _, tloss = _model(tf, dropout=0.0)
    jscope = jf.Scope()
    jexe = jf.Executor()
    with jf.scope_guard(jscope):
        jexe.run(jstart)
        names = tf.persistable_names(tmain)
        assert set(names) == set(jscope.vars)
        tscope = tf.scope_from_numpy({n: np.asarray(jscope.vars[n])
                                      for n in names}, tf.Scope(), 'cpu')
        jl, = jexe.run_steps(jmain, feed_list=feeds, fetch_list=[jloss])
    with tf.scope_guard(tscope):
        tl, = _exe().run_steps(tmain, feed_list=feeds, fetch_list=[tloss])
    assert tl.shape == np.asarray(jl).shape == (K, 1)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5, atol=1e-7)
    assert not np.array_equal(tl[0], tl[-1])   # Adam moved the weights
    for n in names:
        np.testing.assert_allclose(tscope.vars[n].numpy(),
                                   np.asarray(jscope.vars[n]),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


@pytest.mark.parametrize('form', ['list', 'stacked'])
def test_run_steps_equals_k_runs_bitwise_with_dropout(form):
    K = 4
    main, startup, loss = _model(tf, dropout=0.3)
    feeds = _feeds(K)
    seq, seq_scope = _sequential(main, startup, loss, feeds)
    exe, scope = _exe(), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        if form == 'list':
            got, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss])
        else:
            stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
            got, = exe.run_steps(main, feed_list=stacked, steps=K,
                                 fetch_list=[loss])
    assert got.shape == (K, 1)
    assert got.tobytes() == seq.tobytes()
    assert len({v.tobytes() for v in got}) == K
    _same_scopes(scope, seq_scope)


def test_run_then_run_steps_consumes_the_stream_of_three_runs():
    main, startup, loss = _model(tf, dropout=0.5)
    feeds = _feeds(3)
    seq, seq_scope = _sequential(main, startup, loss, feeds)
    exe, scope = _exe(), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        first, = exe.run(main, feed=feeds[0], fetch_list=[loss])
        rest, = exe.run_steps(main, feed_list=feeds[1:], fetch_list=[loss])
    assert np.concatenate([first[None], rest]).tobytes() == seq.tobytes()
    _same_scopes(scope, seq_scope)
    assert exe.stream_counter(['lbl', 'x'], [loss.name]) == 3


def test_two_programs_keep_independent_streams():
    """Runs of program B between runs of program A do not shift A's
    masks: A's losses equal A's run alone."""
    main_a, startup_a, loss_a = _model(tf, seed=7, dropout=0.5)
    main_b, startup_b, loss_b = _model(tf, seed=11, dropout=0.5)
    feeds = _feeds(3)
    alone, _ = _sequential(main_a, startup_a, loss_a, feeds)
    exe, sa, sb = _exe(), tf.Scope(), tf.Scope()
    got = []
    for f in feeds:
        with tf.scope_guard(sa):
            if not got:
                exe.run(startup_a)
            got.append(exe.run(main_a, feed=f, fetch_list=[loss_a])[0])
        with tf.scope_guard(sb):
            if len(got) == 1:
                exe.run(startup_b)
            exe.run(main_b, feed=f, fetch_list=[loss_b])
    assert np.stack(got).tobytes() == alone.tobytes()


@pytest.mark.parametrize('where', ['same_process', 'fresh_executor'])
def test_rng_state_resume_is_bitwise(where):
    """Two steps, a snapshot of scope and counters, two more steps; a
    restore of both replays the last two bit for bit: a rollback of the
    same scope in the same executor, or a resume in a new executor and a
    new scope (its counter parked until the stream's first run)."""
    main, startup, loss = _model(tf, dropout=0.5)
    feeds = _feeds(4)
    exe, scope = _exe(), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        for f in feeds[:2]:
            exe.run(main, feed=f, fetch_list=[loss])
        state = exe.rng_state()
        saved = {n: t.clone() for n, t in scope.vars.items()}
        tail, = exe.run_steps(main, feed_list=feeds[2:], fetch_list=[loss])
    assert state == {'lbl|x=>' + loss.name: 2, '=>': 1}
    final = {n: t.clone() for n, t in scope.vars.items()}
    if where == 'fresh_executor':
        exe, scope = _exe(), tf.Scope()
    exe.set_rng_state(state)
    for n, t in saved.items():
        scope.vars[n] = t.clone()
    with tf.scope_guard(scope):
        again = [exe.run(main, feed=f, fetch_list=[loss])[0]
                 for f in feeds[2:]]
    assert np.stack(again).tobytes() == tail.tobytes()
    for n, t in final.items():
        assert torch.equal(scope.vars[n], t), n


def test_set_rng_state_rewinds_streams_it_does_not_name():
    main, startup, loss = _model(tf, dropout=0.5)
    f = _feeds(1)[0]
    exe, scope = _exe(), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=f, fetch_list=[loss])
        exe.set_rng_state({})
        assert exe.stream_counter(['x', 'lbl'], [loss.name]) == 0
        exe.set_rng_state({'lbl|x=>' + loss.name: 5})
        assert exe.stream_counter(['x', 'lbl'], [loss.name]) == 5
        exe.run(main, feed=f, fetch_list=[loss])
        assert exe.rng_state()['lbl|x=>' + loss.name] == 6


def test_run_steps_validation_errors():
    K = 3
    main, startup, loss = _model(tf, dropout=0.0)
    feeds = _feeds(K)
    stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    exe, scope = _exe(), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        with pytest.raises(ValueError, match='needs steps=K'):
            exe.run_steps(main, feed_list=stacked, fetch_list=[loss])
        with pytest.raises(ValueError, match='leading dim'):
            exe.run_steps(main, feed_list=stacked, fetch_list=[loss],
                          steps=K + 1)
        with pytest.raises(ValueError, match='non-empty'):
            exe.run_steps(main, feed_list=[], fetch_list=[loss])
        with pytest.raises(ValueError, match='steps=2 but feed_list has 3'):
            exe.run_steps(main, feed_list=feeds, fetch_list=[loss], steps=2)
        with pytest.raises(ValueError, match='disagree on keys'):
            exe.run_steps(main, feed_list=[feeds[0], {'x': feeds[1]['x']}],
                          fetch_list=[loss])
        # nothing above ran a step: the stream starts at 0
        assert exe.stream_counter(['x', 'lbl'], [loss.name]) == 0
        out, = exe.run_steps(main, feed_list=stacked, fetch_list=[loss],
                             steps=K, return_numpy=False)
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (K, 1)


def test_compiled_program_num_iteration_per_drop_scope():
    """num_iteration_per_drop_scope=K and a list feed: run_steps K steps a
    call (5 = 2 + 2 + 1), the fetches stacked over all, bit for bit the
    sequential runs."""
    N, K = 5, 2
    main, startup, loss = _model(tf, dropout=0.4)
    feeds = _feeds(N)
    seq, seq_scope = _sequential(main, startup, loss, feeds)
    es = tf.ExecutionStrategy()
    es.num_iteration_per_drop_scope = K
    compiled = tf.CompiledProgram(main, exec_strategy=es)
    exe, scope = _exe(), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        compiled.prewarm(exe, {'x': ((BATCH, 8), 'float32'),
                               'lbl': ((BATCH, 1), 'int64')}, [loss])
        out, = exe.run(compiled, feed=feeds, fetch_list=[loss])
    assert out.shape == (N, 1)
    assert out.tobytes() == seq.tobytes()
    _same_scopes(scope, seq_scope)
    # one dict: the plain run
    exe2, scope2 = _exe(), tf.Scope()
    with tf.scope_guard(scope2):
        exe2.run(startup)
        one, = exe2.run(compiled, feed=feeds[0], fetch_list=[loss])
    assert one.tobytes() == seq[0].tobytes()


def test_compiled_program_futures_concatenate_on_the_device():
    N, K = 3, 2
    main, startup, loss = _model(tf, dropout=0.4)
    feeds = _feeds(N)
    seq, _ = _sequential(main, startup, loss, feeds)
    es = tf.ExecutionStrategy()
    es.num_iteration_per_drop_scope = K
    exe, scope = _exe(), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        fut, = exe.run_steps(tf.CompiledProgram(main, exec_strategy=es),
                             feed_list=feeds, fetch_list=[loss],
                             as_futures=True)
    assert len(fut) == N and fut.shape == (N, 1)
    assert fut.numpy().tobytes() == seq.tobytes()


def test_the_parallel_stack_raises_naming_the_roadmap():
    main, _, _ = _model(tf, dropout=0.0)
    with pytest.raises(NotImplementedError, match='ROADMAP A7'):
        tf.Executor(tf.CPUPlace(), mesh=object())
    with pytest.raises(NotImplementedError, match='ROADMAP A7'):
        tf.CompiledProgram(main).with_data_parallel(loss_name='x')
    assert tf.CompiledProgram(main).with_inference_optimize(None) is not None


def test_strategies_reject_settings_they_cannot_honour():
    """The reference's tuning knobs mean nothing to the port: setting one
    raises instead of being ignored; num_iteration_per_drop_scope stays."""
    main, _, _ = _model(tf, dropout=0.0)
    with pytest.raises(AttributeError, match='memory_optimize'):
        tf.BuildStrategy().memory_optimize = True
    es = tf.ExecutionStrategy()
    with pytest.raises(AttributeError, match='num_threads'):
        es.num_threads = 4
    es.num_iteration_per_drop_scope = 3
    assert tf.CompiledProgram(main, exec_strategy=es)._steps_per_launch == 3
    with pytest.raises(NotImplementedError, match='create_paddle_predictor'):
        tf.CompiledProgram(main).with_inference_optimize(
            tf.inference.AnalysisConfig())
