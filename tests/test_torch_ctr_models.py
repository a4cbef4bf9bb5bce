"""The CTR models (DeepFM with Adam, Wide&Deep with Adagrad), word2vec
(SGD, a softmax fc) and fit_a_line (SGD, square_error_cost) through the
port against the JAX package, and the ops they add: `concat` and the two
losses.

Ops: forward and gradient against the JAX op at rtol 1e-6 and an atol of
one unit in the last place of the tensor's largest value.  Models, at
small sizes (vocab 1000, narrow fc stacks; word2vec and fit_a_line at
their defaults): the same op types as the reference's program, then three
steps from the JAX package's startup state carried across, with the
rewriter (PT_OPT) on and off: losses at rtol 1e-5, every parameter and
accumulator at rtol 1e-5 and an atol of 1e-5 of the tensor's largest
value (the backward passes sum in other orders; test_torch_optimizers.py
NET_RTOL).  DeepFM's parameters move by Adam's steps, lr_t m1 / (sqrt(m2)
+ eps), which normalise each entry by its own gradient, so an entry whose
gradient fell below 1% of its tensor's largest, but not to 0, at some
step (a table row
that two ids' gradients nearly cancel in), or whose moment is a difference
of nearly equal terms (|m1| < 0.25 sqrt(m2): a gradient that changed
sign), amplifies a last-bit gradient difference: those entries are
held to the size of three steps, 3 x 2.01 lr (as
tests/test_torch_llama_train.py holds its Adam steps), every other one at
the bounds above, and more than half of them must get the tight check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as tf
from paddle_tpu_torch.core.registry import get_op
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

RTOL = 1e-5
# DeepFM's Adam learning rate (models/ctr.py)
ADAM_LR = 1e-3


def _close(actual, desired, rtol=1e-6, msg=''):
    np.testing.assert_allclose(
        actual, desired, rtol=rtol,
        atol=float(np.spacing(np.abs(desired).max())), err_msg=msg)


def _both(op_type, ins, attrs, out_slot='Out'):
    """(port out, jax out, port grads, jax grads) of sum(out * w) w.r.t.
    the float inputs."""
    rng = np.random.RandomState(9)
    jimpl = jreg.get_op(op_type).impl
    timpl = get_op(op_type)
    floats = [k for k, v in ins.items()
              if not isinstance(v, list) and v.dtype == np.float32]
    jout = jimpl(None, {k: ([jnp.asarray(a) for a in v]
                            if isinstance(v, list) else jnp.asarray(v))
                        for k, v in ins.items()}, attrs)[out_slot]
    w = rng.randn(*jout.shape).astype('float32')

    def jloss(*xs):
        d = dict(ins)
        d.update(dict(zip(floats, xs)))
        d = {k: ([jnp.asarray(a) for a in v] if isinstance(v, list)
                 else jnp.asarray(v)) for k, v in d.items()}
        return jnp.sum(jimpl(None, d, attrs)[out_slot] * w)
    jgrads = jax.grad(jloss, argnums=tuple(range(len(floats))))(
        *[jnp.asarray(ins[k]) for k in floats]) if floats else ()
    tins = {k: ([torch.from_numpy(a).requires_grad_(True) for a in v]
                if isinstance(v, list) else
                torch.from_numpy(v).requires_grad_(k in floats))
            for k, v in ins.items()}
    tout = timpl(None, tins, attrs)[out_slot]
    (tout * torch.from_numpy(w)).sum().backward()
    tgrads = [tins[k].grad.numpy() for k in floats]
    return tout, np.asarray(jout), tgrads, [np.asarray(g) for g in jgrads], \
        tins


@pytest.mark.parametrize('axis', [0, 1, -1])
def test_concat_matches_the_jax_op(axis):
    rng = np.random.RandomState(0)
    shapes = {0: [(2, 3), (4, 3), (1, 3)], 1: [(2, 3), (2, 5), (2, 1)],
              -1: [(2, 2, 3), (2, 2, 4)]}[axis]
    xs = [rng.randn(*s).astype('float32') for s in shapes]
    tout, jout, _, _, tins = _both('concat', {'X': xs}, {'axis': axis})
    assert np.array_equal(tout.detach().numpy(), jout)
    w = np.random.RandomState(9).randn(*jout.shape).astype('float32')
    jg = jax.grad(lambda *a: jnp.sum(jnp.concatenate(a, axis) * w),
                  argnums=tuple(range(len(xs))))(*[jnp.asarray(a)
                                                   for a in xs])
    for t, g in zip(tins['X'], jg):
        assert np.array_equal(t.grad.numpy(), np.asarray(g))


@pytest.mark.parametrize('normalize', [False, True])
@pytest.mark.parametrize('ignore', [-100, 1])
def test_sigmoid_cross_entropy_with_logits_matches_the_jax_op(normalize,
                                                               ignore):
    rng = np.random.RandomState(1)
    x = (rng.randn(64, 3) * 5).astype('float32')
    label = rng.randint(0, 2, (64, 3)).astype('float32')
    label[:5] = rng.rand(5, 3)          # soft labels too
    tout, jout, tg, jg, _ = _both(
        'sigmoid_cross_entropy_with_logits', {'X': x, 'Label': label},
        {'ignore_index': ignore, 'normalize': normalize})
    _close(tout.detach().numpy(), jout)
    for a, b in zip(tg, jg):
        _close(a, b)
    if ignore == 1:
        assert (tout.detach().numpy()[label == 1] == 0).all()


def test_square_error_cost_matches_the_jax_op():
    rng = np.random.RandomState(2)
    x, y = (rng.randn(32, 1).astype('float32') for _ in range(2))
    tout, jout, tg, jg, _ = _both('square_error_cost', {'X': x, 'Y': y}, {})
    _close(tout.detach().numpy(), jout)
    for a, b in zip(tg, jg):
        _close(a, b)


# ------------------------------------------------------------ models

def _ctr_feed(B, vocab, seed):
    rng = np.random.RandomState(seed)
    return {'dense_input': rng.randn(B, 13).astype('float32'),
            'sparse_input': rng.randint(0, vocab, (B, 26)).astype('int64'),
            'label': rng.randint(0, 2, (B, 1)).astype('int64')}


def _w2v_feed(B, seed):
    rng = np.random.RandomState(seed)
    feed = {'word_%d' % i: rng.randint(0, 2073, (B, 1)).astype('int64')
            for i in range(4)}
    feed['next_word'] = rng.randint(0, 2073, (B, 1)).astype('int64')
    return feed


def _line_feed(B, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 13).astype('float32')
    return {'x': x, 'y': (x.sum(1, keepdims=True) * 0.1).astype('float32')}


MODELS = {
    'deepfm': ('ctr', 'deepfm', dict(vocab_size=1000, fc_sizes=(32, 16)),
               lambda s: _ctr_feed(32, 1000, s)),
    'wide_deep': ('ctr', 'wide_deep', dict(vocab_size=1000,
                                           fc_sizes=(32, 16)),
                  lambda s: _ctr_feed(32, 1000, s)),
    'word2vec': ('word2vec', 'build', {}, lambda s: _w2v_feed(32, s)),
    'fit_a_line': ('simple', 'fit_a_line', {}, lambda s: _line_feed(32, s)),
}


def _build(fluid, name):
    import importlib
    mod, fn, kw, _ = MODELS[name]
    pkg = 'paddle_tpu' if fluid.__name__ == 'paddle_tpu' else \
        'paddle_tpu_torch'
    m = importlib.import_module('%s.models.%s' % (pkg, mod))
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = getattr(m, fn)(**kw)
    return main, startup, out


@pytest.mark.parametrize('name', sorted(MODELS))
def test_same_op_types_as_the_reference(name):
    import paddle_tpu as jf
    jm, js, _ = _build(jf, name)
    tm, ts, _ = _build(tf, name)
    for a, b in ((jm, tm), (js, ts)):
        assert [op.type for op in a.global_block().ops] == \
            [op.type for op in b.global_block().ops]
    assert tf.persistable_names(tm) == sorted(
        v.name for v in jm.list_vars() if v.persistable)


@pytest.mark.parametrize('pt_opt', ['0', '1'])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_three_steps_match_the_jax_package(monkeypatch, name, pt_opt):
    import paddle_tpu as jf
    monkeypatch.setenv('PT_CACHE', '0')
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
    adam = [p.name for p in tm.all_parameters()
            if p.name + '_moment1_0' in names]
    grads = [p + '@GRAD' for p in adam]
    small = {p: False for p in adam}
    losses = []
    for step in range(3):
        feed = MODELS[name][3](step)
        with jf.scope_guard(jscope):
            want = jf.Executor().run(jm, feed=feed,
                                     fetch_list=[jo['loss']] + grads)
        with tf.scope_guard(tscope):
            got, = texe.run(tm, feed=feed, fetch_list=[to['loss']])
        np.testing.assert_allclose(got, want[0], rtol=RTOL,
                                   err_msg=str(step))
        losses.append(float(got[0]))
        for p, g in zip(adam, want[1:]):
            g = np.abs(np.asarray(g))
            # a table row no id touched gets no gradient in either
            small[p] = small[p] | ((g > 0) & (g < 1e-2 * g.max()))
    assert all(np.isfinite(losses))
    tight = total = 0
    for n in names:
        got, want = tscope.vars[n].numpy(), np.asarray(jscope.vars[n])
        ok = np.ones(want.shape, bool)
        if n in small:
            # Adam (DeepFM): the step size bounds every entry
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       atol=3 * 2.01 * ADAM_LR, err_msg=n)
            m1 = np.asarray(jscope.vars[n + '_moment1_0'])
            m2 = np.asarray(jscope.vars[n + '_moment2_0'])
            ok = ~small[n] & (np.abs(m1) >= 0.25 * np.sqrt(m2))
            tight += int(ok.sum())
            total += ok.size
        np.testing.assert_allclose(
            got[ok], want[ok], rtol=RTOL,
            atol=RTOL * float(np.abs(want).max()), err_msg=n)
    assert tight >= total / 2 or not small


def test_synthetic_reader_is_the_references():
    from paddle_tpu.models import ctr as jctr
    from paddle_tpu_torch.models import ctr as tctr
    a = list(jctr.synthetic_reader(n=20, vocab_size=77, seed=3)())
    b = list(tctr.synthetic_reader(n=20, vocab_size=77, seed=3)())
    for (d1, s1, y1), (d2, s2, y2) in zip(a, b):
        assert np.array_equal(d1, d2) and np.array_equal(s1, s2) and y1 == y2
