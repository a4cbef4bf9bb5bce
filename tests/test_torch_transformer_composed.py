"""The composed transformer end to end on the CPU: transformer-base at its
own defaults (`models/transformer.py::build`: composed attention with
softmax, dropout,
label smoothing 0.1) through the PT_OPT passes (on by default in both
packages), at a small size (2 layers, d_model 64).

- dropout 0: three float32 steps against the JAX package from one carried
  scope: losses, step-1 gradients, parameters and Adam moments after
  three steps, under tests/test_torch_transformer_train.py's tolerances
  (losses rtol 1e-5; gradients rtol 1e-4, atol 1e-6; parameters atol
  2.01 x the summed scheduled lr, rtol 1e-5; moments rtol 1e-3 plus 1e-4
  of the tensor's largest value; beta powers and the step counter exact);
  three bf16 AMP steps, losses rtol 1e-3.
- dropout 0.1, the port alone: PT_OPT=1 (fused groups, pinned random
  streams) and PT_OPT=0 (every op on its own) give bit for bit the same
  losses, parameters and optimizer state over three steps, float32 and
  AMP; the two packages' random draws differ, so no JAX comparison.
- the dropout op keeps 0.9 of a large draw, within 1%.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.models import transformer as jtr
import paddle_tpu_torch as tf
from paddle_tpu_torch.models import transformer as ttr
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

SMALL = dict(src_vocab=128, trg_vocab=128, max_len=16, n_layer=2, n_head=4,
             d_model=64, d_inner=128, use_flash=False)
B = 4


@pytest.fixture(autouse=True)
def fresh_port_programs(monkeypatch):
    """Fresh default programs, scope and name generator for the port (the
    root conftest does the same for the JAX package); the passes on."""
    from paddle_tpu_torch.core import executor, framework, unique_name
    monkeypatch.setenv('PT_OPT', '1')
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


def _build(fluid, tr, dropout, amp=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = tr.build(dropout=dropout, **SMALL)
    main.set_amp(amp)
    return main, startup, out


def _feed(seed):
    feed = jtr.synthetic_batch(np.random.RandomState(seed), B,
                               SMALL['max_len'], SMALL['trg_vocab'])
    feed['src_pad'][1, 11:] = 1.0
    feed['trg_pad'][2, 9:] = 1.0
    return feed


def _noam_lr(step, d_model=SMALL['d_model'], warmup=8000, scale=2.0):
    return scale * d_model ** -0.5 * min(step ** -0.5,
                                         step * warmup ** -1.5)


def _jax_and_port(amp=False):
    jmain, jstart, jout = _build(jf, jtr, 0.0, amp)
    tmain, _, tout = _build(tf, ttr, 0.0, amp)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert 'softmax' in [op.type for op in tmain.global_block().ops]
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(jstart)
    names = tf.persistable_names(tmain)
    tscope = tf.scope_from_numpy({n: np.asarray(jscope.vars[n])
                                  for n in names}, tf.Scope(), 'cpu')
    return (jmain, jout, jscope), (tmain, tout, tscope)


def test_three_f32_steps_match_the_jax_package():
    (jmain, jout, jscope), (tmain, tout, tscope) = _jax_and_port()
    params = [p.name for p in tmain.all_parameters()]
    grads = [p + '@GRAD' for p in params]
    texe, jexe = tf.Executor(tf.CPUPlace()), jf.Executor()
    feed = _feed(0)
    for step in range(3):
        fetch = [jout['loss']] + (grads if step == 0 else [])
        with jf.scope_guard(jscope):
            jres = jexe.run(jmain, feed=feed, fetch_list=fetch)
        with tf.scope_guard(tscope):
            tres = texe.run(tmain, feed=feed,
                            fetch_list=[tout['loss']] + fetch[1:])
        np.testing.assert_allclose(tres[0], jres[0], rtol=1e-5,
                                   err_msg='loss at step %d' % step)
        for n, a, b in zip(grads, tres[1:], jres[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=n)
    p_atol = 2.01 * sum(_noam_lr(t) for t in (1, 2, 3))
    for name in tf.persistable_names(tmain):
        a, b = tscope.vars[name].numpy(), np.asarray(jscope.vars[name])
        if name in params:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=p_atol,
                                       err_msg=name)
        elif '_moment' in name:
            np.testing.assert_allclose(
                a, b, rtol=1e-3, atol=1e-4 * float(np.abs(b).max()),
                err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_three_amp_steps_match_the_jax_package():
    (jmain, jout, jscope), (tmain, tout, tscope) = _jax_and_port(amp=True)
    texe, jexe = tf.Executor(tf.CPUPlace()), jf.Executor()
    feed = _feed(1)
    for step in range(3):
        with jf.scope_guard(jscope):
            jl, = jexe.run(jmain, feed=feed, fetch_list=[jout['loss']])
        with tf.scope_guard(tscope):
            tl, = texe.run(tmain, feed=feed, fetch_list=[tout['loss']])
        np.testing.assert_allclose(tl, jl, rtol=1e-3,
                                   err_msg='AMP loss at step %d' % step)


def _train_port(monkeypatch, opt, amp):
    monkeypatch.setenv('PT_OPT', opt)
    main, startup, out = _build(tf, ttr, 0.1, amp)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        exe.run(startup)
        losses = [exe.run(main, feed=_feed(2),
                          fetch_list=[out['loss']])[0][0]
                  for _ in range(3)]
    return losses, {n: t.clone() for n, t in scope.vars.items()}


@pytest.mark.parametrize('amp', [False, True], ids=['f32', 'amp'])
def test_passes_on_and_off_are_bitwise_equal_with_dropout(monkeypatch, amp):
    on, on_state = _train_port(monkeypatch, '1', amp)
    off, off_state = _train_port(monkeypatch, '0', amp)
    assert on == off
    assert np.isfinite(on).all() and len(set(on)) == 3
    assert set(on_state) == set(off_state)
    for n in on_state:
        assert torch.equal(on_state[n], off_state[n]), n


def test_dropout_keeps_nine_tenths():
    main = tf.Program()
    with tf.program_guard(main, tf.Program()), tf.unique_name.guard():
        x = tf.layers.data('x', shape=[1000], dtype='float32')
        y = tf.layers.dropout(x, 0.1,
                              dropout_implementation='upscale_in_train')
    out, = tf.Executor(tf.CPUPlace()).run(
        main, feed={'x': np.ones((1000, 1000), 'float32')}, fetch_list=[y])
    keep = (out != 0).mean()
    assert abs(keep - 0.9) < 0.009
    np.testing.assert_allclose(out[out != 0], 1 / 0.9, rtol=1e-6)
