"""The training slice end to end on the CPU: transformer-base's step
(`models/transformer.py::build`, `append_backward`, Adam with noam_decay,
flash attention, dropout 0) through both packages, and the executor's
`__backward__`, AMP policy and liveness rules on small programs.

Tolerances, each with its reason:
- losses, float32: rtol 1e-5 — both compute in float32 in other summation
  orders (XLA vs PyTorch GEMMs, the JAX composed attention at T < 512 vs
  the port's plain flash versions);
- step-1 gradients: rtol 1e-4, atol 1e-6 — the same sums through the
  backward of every layer;
- parameters after 3 steps: an Adam update moves an entry by about the
  scheduled lr at most (the bias correction makes the first update exactly
  lr * sign(g), later ones at most ~1.002 lr for these betas), so an entry
  whose gradient is float noise can legitimately move the other way:
  atol 2.01 * sum(lr) (the test computes the noam schedule), rtol 1e-5;
- moments after 3 steps: they are sums of (squared) gradients, so rtol
  1e-3 of each entry plus 1e-4 of the tensor's largest value;
- losses under bf16 AMP: rtol 1e-3 — bf16 keeps 8 bits, one rounding is
  up to 2^-8 relative, and the two frameworks round at other places; the
  mean over the tokens averages the roundings down."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.models import transformer as jtr
import paddle_tpu_torch as tf
from paddle_tpu_torch.models import transformer as ttr
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

SMALL = dict(src_vocab=128, trg_vocab=128, max_len=16, n_layer=2, n_head=4,
             d_model=64, d_inner=128, dropout=0.0, use_flash=True)
BENCH = dict(src_vocab=32000, trg_vocab=32000, max_len=256, n_layer=6,
             n_head=8, d_model=512, d_inner=2048, dropout=0.0,
             use_flash=True)
B = 4


@pytest.fixture(autouse=True)
def fresh_port_programs():
    """Fresh default programs, scope and name generator for the port (the
    root conftest does the same for the JAX package)."""
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


def _build(fluid, tr, cfg=SMALL, amp=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = tr.build(**cfg)
    main.set_amp(amp)
    return main, startup, out


def _desc(fluid, program):
    d = json.loads(json.dumps(fluid.io.program_to_desc(program)))
    for b in d['blocks']:
        for op in b['ops']:
            op.pop('source_loc')
    return d


def _feed(seed):
    feed = jtr.synthetic_batch(np.random.RandomState(seed), B,
                               SMALL['max_len'], SMALL['trg_vocab'])
    # suffix padding: k_len < T in some rows (never 0)
    feed['src_pad'][1, 11:] = 1.0
    feed['trg_pad'][2, 9:] = 1.0
    return feed


def _noam_lr(step, d_model=SMALL['d_model'], warmup=8000, scale=2.0):
    return scale * d_model ** -0.5 * min(step ** -0.5,
                                         step * warmup ** -1.5)


def _jax_and_port(amp=False):
    """Both programs, the JAX startup run, and the whole JAX scope
    (parameters and optimizer state) carried into a port scope."""
    jmain, jstart, jout = _build(jf, jtr, amp=amp)
    tmain, _, tout = _build(tf, ttr, amp=amp)
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(jstart)
    names = tf.persistable_names(tmain)
    assert set(names) == set(jscope.vars)
    tscope = tf.scope_from_numpy({n: np.asarray(jscope.vars[n])
                                  for n in names}, tf.Scope(), 'cpu')
    return (jmain, jout, jscope), (tmain, tout, tscope)


# ---------------------------------------------------------- (a) program

@pytest.mark.parametrize('cfg', [SMALL, BENCH], ids=['small', 'bench'])
def test_same_training_program_desc(cfg):
    main, startup, _ = _build(jf, jtr, cfg)
    tmain, tstartup, _ = _build(tf, ttr, cfg)
    assert _desc(tf, tmain) == _desc(jf, main)
    assert _desc(tf, tstartup) == _desc(jf, startup)
    types = [op.type for op in tmain.global_block().ops]
    assert types.count('__backward__') == 1
    n_params = len(tmain.all_parameters())
    assert types.count('adam') == n_params
    if cfg is BENCH:
        assert n_params == 158
        assert sum(int(np.prod(p.shape))
                   for p in tmain.all_parameters()) == 93287680
        assert types.count('flash_attention') == 18
        assert types.count('layer_norm') == 32


# ------------------------------------------------------- (b) f32 parity

def test_three_f32_steps_match_the_jax_package():
    (jmain, jout, jscope), (tmain, tout, tscope) = _jax_and_port()
    params = [p.name for p in tmain.all_parameters()]
    grads = [p + '@GRAD' for p in params]
    texe = tf.Executor(tf.CPUPlace())
    jexe = jf.Executor()
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
        else:   # beta powers and the LR decay counter: exact
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(tscope.vars['@LR_DECAY_COUNTER@'][0]) == 3


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


# ------------------------------------------------- (c) executor policy

@pytest.mark.parametrize('amp', [False, True])
def test_amp_policy_keeps_the_logits_bf16(amp):
    """Under AMP the `proj` mul keeps its bf16 output (amp_keep_bf16) and
    its bias add follows through the elementwise match rule, so the CE
    reads bf16 logits; the other matrix products cast back to float32."""
    _, (tmain, tout, tscope) = _jax_and_port(amp=amp)
    hidden = [op.output('Out')[0] for op in tmain.global_block().ops
              if op.type == 'mul' and op.input('Y')[0] == 'enc_0_ffn_fc1_w']
    with tf.scope_guard(tscope):
        logits, h = tf.Executor(tf.CPUPlace()).run(
            tmain, feed=_feed(2), fetch_list=[tout['logits'], hidden[0]],
            return_numpy=False)
    assert logits.dtype == (torch.bfloat16 if amp else torch.float32)
    assert h.dtype == torch.float32


def test_softmax_of_the_cross_entropy_is_computed_only_when_read(
        monkeypatch):
    calls = []
    real = torch.softmax

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(torch, 'softmax', spy)
    _, (tmain, tout, tscope) = _jax_and_port()
    calls.clear()   # shape inference at build time computes every slot
    ce = next(op for op in tmain.global_block().ops
              if op.type == 'softmax_with_cross_entropy')
    texe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(tscope):
        texe.run(tmain, feed=_feed(3), fetch_list=[tout['loss']])
        assert calls == []
        sm, logits = texe.run(tmain, feed=_feed(3),
                              fetch_list=[ce.output('Softmax')[0],
                                          tout['logits']])
    assert len(calls) == 1
    np.testing.assert_allclose(sm, torch.softmax(torch.from_numpy(logits),
                                                 -1).numpy(), rtol=1e-5,
                               atol=1e-7)


def _mlp(fluid, stop_mid=False):
    """x -> fc(16, relu) -> fc(4) -> reduce_sum -> scale(1/numel): a small
    fc + mean program with its backward and no optimizer."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data('x', shape=[8], dtype='float32')
        h = fluid.layers.fc(x, 16, act='relu')
        if stop_mid:
            h.stop_gradient = True
        y = fluid.layers.fc(h, 4)
        loss = fluid.layers.scale(fluid.layers.reduce_sum(y),
                                  scale=1.0 / (6 * 4))
        pg = fluid.append_backward(loss) if fluid is tf else \
            fluid.backward.append_backward(loss)
    return main, startup, loss, [g.name for _, g in pg]


@pytest.mark.parametrize('stop_mid', [False, True], ids=['plain',
                                                         'stop_gradient'])
def test_backward_on_a_small_program_matches_jax(stop_mid):
    jmain, jstart, jloss, grads = _mlp(jf, stop_mid)
    tmain, _, tloss, tgrads = _mlp(tf, stop_mid)
    assert grads == tgrads
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(jstart)
    tscope = tf.scope_from_numpy({n: np.asarray(v)
                                  for n, v in jscope.vars.items()},
                                 tf.Scope(), 'cpu')
    feed = {'x': np.random.RandomState(4).randn(6, 8).astype('float32')}
    with jf.scope_guard(jscope):
        jres = jf.Executor().run(jmain, feed=feed, fetch_list=[jloss] + grads)
    with tf.scope_guard(tscope):
        tres = tf.Executor(tf.CPUPlace()).run(tmain, feed=feed,
                                              fetch_list=[tloss] + grads)
    for n, a, b in zip(['loss'] + grads, tres, jres):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=n)
    first = [r for n, r in zip(grads, tres[1:]) if n.startswith('fc_0')]
    # stop_gradient on the hidden activation: the first fc gets no
    # gradient (zeros, as jax.vjp gives through lax.stop_gradient)
    assert all(np.any(g != 0) for g in first) != stop_mid


def test_forward_only_programs_still_run_under_inference_mode():
    tmain, tstart, tloss, _ = _mlp(tf)
    fwd = tf.Program()
    with tf.program_guard(fwd, tf.Program()), tf.unique_name.guard():
        x = tf.layers.data('x', shape=[8], dtype='float32')
        y = tf.layers.fc(x, 4)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        exe.run(tstart)
        assert all(t.is_inference() for t in scope.vars.values())
        out, = exe.run(fwd, feed={'x': np.ones((2, 8), 'float32')},
                       fetch_list=[y], return_numpy=False)
        assert out.is_inference()
        # a training run copies the startup's inference tensors once and
        # leaves normal tensors in the scope
        exe.run(tmain, feed={'x': np.ones((6, 8), 'float32')},
                fetch_list=[tloss])
        assert not any(t.is_inference() for t in scope.vars.values())
        assert not any(t.requires_grad for t in scope.vars.values())
