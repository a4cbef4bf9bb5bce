"""The sequence models through the port against the JAX package on the
CPU: the stacked dynamic-LSTM LM (models/stacked_lstm.py; dict 50, emb
8, hid 8, its 3 layers, Adam) and the book recommender
(models/simple.py::recommender; MovieLens's 18 categories, 7 ages, 21
jobs, 2 genders at narrow tables and dim 8, SGD), each fed ragged
LoDTensors.

Each builds the same op types as the reference's program, then takes
three steps from the JAX package's startup state carried across, with
the rewriter (PT_OPT) on and off.  Held, step by step: the loss at rtol
1e-5; every parameter's gradient at rtol 1e-5 and an atol of 1e-5 of its
largest entry (the backward sums in other orders than XLA's, and the
LSTM's 3 x T steps carry XLA's exp and tanh polynomials a few float32
units apart from libm's).  After the three updates: every parameter and
Adam moment at rtol 1e-5 and an atol of 1e-5 of the tensor's largest
value, but an Adam parameter entry whose first moment is a difference of
nearly equal terms (|m1| < 0.25 sqrt(m2): a gradient that changed sign)
or whose gradient fell below 1% of its tensor's largest, but not to 0,
at some step: Adam's step lr m1 / (sqrt(m2) + eps) normalises each entry
by its own gradient and amplifies a last-bit gradient difference there,
so those are held to the size of three steps, 3 x 2.01 lr (as
tests/test_torch_ctr_models.py holds DeepFM), and more than half of the
entries must get the tight check.
"""
import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as tf
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

RTOL = 1e-5
LSTM_LR = 0.002


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


def _lstm_feed(fluid, step):
    """8 reviews of 1-9 tokens; the third step's batch has the second's
    padded T with other lengths."""
    rng = np.random.RandomState(step if step < 2 else 1)
    lens = rng.randint(1, 10, 8)
    if step == 2:
        lens = np.roll(lens, 3)
    seqs = [rng.randint(0, 50, (n, 1)).astype('int64') for n in lens]
    return {'words': fluid.create_lod_tensor(seqs, max_len=9),
            'label': rng.randint(0, 2, (8, 1)).astype('int64')}


def _rec_feed(fluid, step):
    rng = np.random.RandomState(20 + step)
    B = 16

    def ids(n):
        return rng.randint(0, n, (B, 1)).astype('int64')

    def ragged(n, most):
        return fluid.create_lod_tensor(
            [rng.randint(0, n, (k, 1)).astype('int64')
             for k in rng.randint(1, most + 1, B)])
    return {'user_id': ids(60), 'gender_id': ids(2), 'age_id': ids(7),
            'job_id': ids(21), 'movie_id': ids(40),
            'category_id': ragged(18, 3), 'movie_title': ragged(70, 6),
            'score': (rng.rand(B, 1) * 5).astype('float32')}


MODELS = {
    'stacked_lstm': ('stacked_lstm', 'build',
                     dict(dict_dim=50, emb_dim=8, hid_dim=8), _lstm_feed),
    'recommender': ('simple', 'recommender',
                    dict(n_users=60, n_movies=40, title_vocab=70, dim=8),
                    _rec_feed),
}


def _build(fluid, name):
    import importlib
    mod, fn, kw, _ = MODELS[name]
    m = importlib.import_module('%s.models.%s' % (fluid.__name__, mod))
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = getattr(m, fn)(**kw)
    return main, startup, out


@pytest.mark.parametrize('name', sorted(MODELS))
def test_same_op_types_as_the_reference(name):
    jm, js, _ = _build(jf, name)
    tm, ts, _ = _build(tf, name)
    for a, b in ((jm, tm), (js, ts)):
        assert [op.type for op in a.global_block().ops] == \
            [op.type for op in b.global_block().ops]
    assert tf.persistable_names(tm) == sorted(
        v.name for v in jm.list_vars() if v.persistable)
    ja = {v.name: tuple(v.shape) for v in jm.list_vars()}
    assert all(ja[v.name] == tuple(v.shape) for v in tm.list_vars()
               if v.persistable)


def _close(got, want, what):
    np.testing.assert_allclose(
        got, want, rtol=RTOL,
        atol=RTOL * max(float(np.abs(want).max()), 1e-30), err_msg=what)


@pytest.mark.parametrize('pt_opt', ['0', '1'])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_three_steps_match_the_jax_package(monkeypatch, name, pt_opt):
    monkeypatch.setenv('PT_OPT', pt_opt)
    jm, js, jo = _build(jf, name)
    tm, _, to = _build(tf, name)
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(js)
    tscope = tf.scope_from_numpy(
        {n: np.asarray(jscope.vars[n]) for n in tf.persistable_names(tm)},
        tf.Scope(), 'cpu')
    texe = tf.Executor(tf.CPUPlace())
    names = tf.persistable_names(tm)
    params = [p.name for p in tm.all_parameters()]
    grads = [p + '@GRAD' for p in params]
    adam = [p for p in params if p + '_moment1_0' in names]
    small = {p: np.zeros(np.asarray(jscope.vars[p]).shape, bool)
             for p in adam}
    feed_of = MODELS[name][3]
    for step in range(3):
        with jf.scope_guard(jscope):
            want = jf.Executor().run(jm, feed=feed_of(jf, step),
                                     fetch_list=[jo['loss']] + grads)
        with tf.scope_guard(tscope):
            got = texe.run(tm, feed=feed_of(tf, step),
                           fetch_list=[to['loss']] + grads)
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL,
                                   err_msg='loss %d' % step)
        assert np.isfinite(got[0]).all()
        for g, a, b in zip(grads, got[1:], want[1:]):
            _close(a, np.asarray(b), '%s %d' % (g, step))
        for p, g in zip(params, want[1:]):
            if p in small:
                g = np.abs(np.asarray(g))
                small[p] |= (g > 0) & (g < 1e-2 * g.max())
    tight = total = 0
    for n in names:
        got, want = tscope.vars[n].numpy(), np.asarray(jscope.vars[n])
        ok = np.ones(want.shape, bool)
        if n in small:
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       atol=3 * 2.01 * LSTM_LR, err_msg=n)
            m1 = np.asarray(jscope.vars[n + '_moment1_0'])
            m2 = np.asarray(jscope.vars[n + '_moment2_0'])
            ok = ~small[n] & (np.abs(m1) >= 0.25 * np.sqrt(m2))
            tight += int(ok.sum())
            total += ok.size
        np.testing.assert_allclose(
            got[ok], want[ok], rtol=RTOL,
            atol=RTOL * max(float(np.abs(want).max()), 1e-30), err_msg=n)
    assert tight >= total / 2
