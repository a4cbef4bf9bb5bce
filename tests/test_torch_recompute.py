"""`recompute_scope` and `recompute(fn)` through the port on the CPU
(core/framework.py, core/executor.py `_run_group`), against the JAX
package and against the port's own plain programs.

- tests/test_recompute.py's program through both packages: the same ops
  tagged, one recompute id, the JAX package's losses (weights carried
  across) with and without the scope, five SGD steps, and training;
- a dropout program under the scope whose gradients are the plain
  program's bit for bit at one seed, interpreted, with the rewriter on
  and off, and on the CUDA graph entry's path: the warm-up's recorder,
  then a capture-order run whose generators are handed out in the
  warm-up's order and seeded as a replay seeds them (core/graphs.py);
- the PT_OPT rewriter keeps each fused segment inside its group, and the
  executor runs it inside that group's checkpoint;
- `fluid.recompute(fn)` on a tensor function: its value, its gradient,
  and the forward run again in the backward;
- the slice as a whole: a two-layer narrow transformer with its forward
  under `recompute_scope()` and the explicit `one_hot -> label_smooth ->
  soft-label` loss, three Adam steps from the JAX package's weights, in
  both packages.

Tolerances: losses within 1e-5 relative (float32 in other summation
orders); the recompute against the port's plain program bit for bit (the
same ops on the same CPU in the same order); parameters after Adam steps
within 1e-5 relative plus 2.01 times the summed learning rates, the
bound tests/test_torch_transformer_train.py derives (an Adam update
moves an entry by about lr whatever the gradient's size, so an entry
whose gradient is float noise can move the other way).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.models import transformer as jtr
import paddle_tpu_torch as tf
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core import graphs, passes, registry
from paddle_tpu_torch.models import transformer as ttr
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)


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


def _scope(fluid, remat):
    return fluid.recompute_scope() if remat else contextlib.nullcontext()


# --------------------------------------- tests/test_recompute.py's program

def _build_mlp(fluid, remat):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data('x', shape=[8], dtype='float32')
        y = layers.data('y', shape=[1], dtype='float32')
        h = x
        with _scope(fluid, remat):
            for i in range(3):
                h = layers.fc(h, 16, act='relu',
                              param_attr=fluid.ParamAttr(name='w%d' % i),
                              bias_attr=False)
        pred = layers.fc(h, 1, param_attr=fluid.ParamAttr(name='wout'),
                         bias_attr=False)
        loss = layers.reduce_mean(layers.square(pred - y))
        fluid.optimizer.SGDOptimizer(0.01).minimize(loss)
    main.random_seed = 7
    return main, startup, loss


def _mlp_feed():
    rng = np.random.RandomState(0)
    xb = rng.rand(16, 8).astype('float32')
    return {'x': xb, 'y': xb.sum(1, keepdims=True)}


def test_the_same_ops_are_tagged_in_both_packages():
    tagged = {}
    for pkg in (jf, tf):
        main, _, _ = _build_mlp(pkg, True)
        ops = [op for op in main.global_block().ops
               if 'recompute_id' in op.attrs]
        assert len({op.attrs['recompute_id'] for op in ops}) == 1
        tagged[pkg.__name__] = [op.type for op in ops]
    assert tagged['paddle_tpu_torch'] == tagged['paddle_tpu']
    assert tagged['paddle_tpu'] == ['mul', 'relu'] * 3
    # names as the reference names them; an explicit name wins
    with tf.recompute_scope('blk') as _:
        from paddle_tpu_torch.core import framework
        assert framework._recompute_stack[-1] == 'blk'
    assert not framework._recompute_stack


def test_losses_match_the_jax_package_with_and_without_the_scope():
    feed = _mlp_feed()
    jstart_scope = None
    res = {}
    for remat in (False, True):
        jmain, jstart, jloss = _build_mlp(jf, remat)
        tmain, _, tloss = _build_mlp(tf, remat)
        if jstart_scope is None:
            jstart_scope = jf.Scope()
            with jf.scope_guard(jstart_scope):
                jf.Executor().run(jstart)
        init = {n: np.asarray(jstart_scope.vars[n])
                for n in tf.persistable_names(tmain)}
        jscope = jf.Scope()
        for n, v in init.items():
            jscope.vars[n] = jnp.asarray(v)
        tscope = tf.scope_from_numpy(init, tf.Scope(), 'cpu')
        jexe, texe = jf.Executor(), tf.Executor(tf.CPUPlace())
        for pkg, exe, scope, main, loss in (
                (jf, jexe, jscope, jmain, jloss),
                (tf, texe, tscope, tmain, tloss)):
            with pkg.scope_guard(scope):
                res[(pkg.__name__, remat)] = [
                    float(np.asarray(exe.run(main, feed=feed,
                                             fetch_list=[loss])[0])
                          .reshape(())) for _ in range(5)]
    for remat in (False, True):
        np.testing.assert_allclose(res[('paddle_tpu_torch', remat)],
                                   res[('paddle_tpu', remat)], rtol=1e-5)
    # the port's recompute is its plain program, bit for bit
    assert res[('paddle_tpu_torch', True)] == res[('paddle_tpu_torch', False)]
    assert res[('paddle_tpu_torch', True)][-1] < \
        res[('paddle_tpu_torch', True)][0]


def test_the_group_runs_its_forward_again_in_the_backward(monkeypatch):
    """Each mul of the group runs twice a step (forward and recompute);
    the one outside it (wout's) and the backward's none more."""
    main, startup, loss = _build_mlp(tf, True)
    exe = tf.Executor(tf.CPUPlace())
    calls = []
    mul = registry.get_op('mul')

    def counting(ctx, ins, attrs):
        calls.append(ctx.recomputing)
        return mul(ctx, ins, attrs)
    with tf.scope_guard(tf.Scope()):
        exe.run(startup)
        monkeypatch.setitem(registry._REGISTRY, 'mul', counting)
        exe.run(main, feed=_mlp_feed(), fetch_list=[loss])
    assert calls.count(False) == 4 and calls.count(True) == 3


def test_the_group_holds_no_value_past_its_last_reader(monkeypatch):
    """Inside the group, in the forward and in the recompute, each op
    starts with only the values some op at or after it still reads (and
    the persistables the scope holds anyway): the group frees what the
    plain loop frees, so it keeps no more alive than the plain program."""
    main, startup, loss = _build_mlp(tf, True)
    exe = tf.Executor(tf.CPUPlace())
    held = []
    run_op = texec._run_op

    def recording(op, i, env, ectx, *a):
        if op.attrs.get('recompute_id') is not None:
            held.append((op, i, set(env), ectx.recomputing))
        return run_op(op, i, env, ectx, *a)
    with tf.scope_guard(tf.Scope()):
        exe.run(startup)
        monkeypatch.setattr(texec, '_run_op', recording)
        exe.run(main, feed=_mlp_feed(), fetch_list=[loss])
    assert [r for *_, r in held].count(True) == 6 and len(held) == 12
    for op, i, names, _ in held:
        ops = op.block.ops
        for n in names:
            var = op.block._find_var_recursive(n)
            assert (var is not None and var.persistable) or any(
                n in ops[j].input_names() for j in range(i, len(ops))), \
                '%s held at op #%d %s past its last reader' % (n, i, op.type)


# ------------------------------------------------ dropout masks replay

def _build_dropout(remat, p=0.5):
    layers = tf.layers
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        x = layers.data('x', shape=[12], dtype='float32')
        with _scope(tf, remat):
            h = layers.fc(x, 24, act='relu',
                          param_attr=tf.ParamAttr(name='w0'),
                          bias_attr=tf.ParamAttr(name='b0'))
            h = layers.dropout(h, p, dropout_implementation='upscale_in_train')
            h = layers.scale(h, 1.5)
            h = layers.fc(h, 24, param_attr=tf.ParamAttr(name='w1'),
                          bias_attr=False)
            h = layers.dropout(h, p)
        loss = layers.reduce_mean(layers.square(h))
        tf.append_backward(loss)
    main.random_seed = startup.random_seed = 11
    return main, startup, loss


def _dropout_grads(remat, graph_path):
    main, startup, loss = _build_dropout(remat)
    fetch = [loss.name] + [n + '@GRAD' for n in ('w0', 'b0', 'w1')]
    feed = {'x': np.random.RandomState(3).randn(10, 12).astype('float32')}
    exe = tf.Executor(tf.CPUPlace())
    scope = tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
    if not graph_path:
        with tf.scope_guard(scope):
            exe.run(main, feed=feed, fetch_list=fetch)   # run counter 0
            return exe.run(main, feed=feed, fetch_list=fetch), None
    # the CUDA graph entry's path on the CPU: the warm-up interprets with
    # a recorder, the capture run takes one generator a request in the
    # warm-up's order, each seeded as `GraphEntry._replay` seeds it
    step = exe._step_of(main, tuple(fetch))
    feeds = exe._feed_tensors(main.global_block(), feed)
    warm = graphs._Resources()
    exe._interpret(step, feeds, scope, 0, warm)
    assert not warm.uploads
    rs = registry.run_seed(main.random_seed, 1)
    gens = []
    for request in warm.requests:
        g = torch.Generator()
        g.manual_seed(registry.stream_seed(rs, *request))
        gens.append((g, request))
    cap = graphs._Resources(gens, [])
    fetches, _, _ = exe._interpret(step, feeds, scope, 1, cap)
    assert len(cap.requests) == len(warm.requests)
    return [texec.to_numpy(f) for f in fetches], warm.requests


@pytest.mark.parametrize('opt', ['1', '0'], ids=['pt_opt', 'no_pt_opt'])
@pytest.mark.parametrize('path', ['interpreted', 'graph_order'])
def test_dropout_gradients_are_the_plain_programs_bit_for_bit(
        opt, path, monkeypatch):
    monkeypatch.setenv('PT_OPT', opt)
    plain, preq = _dropout_grads(False, path == 'graph_order')
    remat, rreq = _dropout_grads(True, path == 'graph_order')
    assert np.isfinite(plain[0]).all() and float(plain[0].reshape(())) > 0
    for a, b in zip(plain, remat):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # masks of p = 0.5 leave some gradient rows zero: the masks bite
    assert (plain[1] == 0).any() and (plain[1] != 0).any()
    if path == 'graph_order':
        # the recompute drew both masks again, in the forward's order
        assert len(rreq) == 2 * len(preq) and rreq[len(preq):] == preq


# --------------------------------------------- the rewriter and the groups

def test_fused_segments_stay_inside_their_group(monkeypatch):
    monkeypatch.setenv('PT_OPT', '1')
    main, startup, loss = _build_dropout(True)
    opt, _ = passes.maybe_optimize(main, [loss.name])
    fused = [op for op in opt.global_block().ops
             if op.type == 'fused_elementwise']
    assert fused
    for op in fused:
        ids = {s['attrs'].get('recompute_id') for s in op.attrs['sub_ops']}
        assert len(ids) == 1 and op.attrs.get('recompute_id') in ids
    assert any(op.attrs.get('recompute_id') for op in fused)
    seen = []
    run_group = texec._run_group

    def recording(ops, idxs, *a):
        seen.append([ops[i].type for i in idxs])
        return run_group(ops, idxs, *a)
    monkeypatch.setattr(texec, '_run_group', recording)
    exe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(tf.Scope()):
        exe.run(startup)
        exe.run(main, feed={'x': np.ones((4, 12), 'float32')},
                fetch_list=[loss])
    assert len(seen) == 1
    assert sum(t == 'fused_elementwise' for t in seen[0]) == sum(
        bool(op.attrs.get('recompute_id')) for op in fused)


def test_recompute_fn_wrapper():
    calls = []

    def f(x):
        calls.append(1)
        return torch.sin(x) ** 2
    g = tf.recompute(f)
    x = torch.tensor([0.5, -1.25], requires_grad=True)
    y = g(x)
    np.testing.assert_allclose(y.detach().numpy(), np.sin([0.5, -1.25]) ** 2,
                               atol=1e-6)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.sin(2 * np.array(
        [0.5, -1.25])), rtol=1e-6)
    assert len(calls) == 2


# ------------------------------------------------------ the slice whole

TINY = dict(src_vocab=64, trg_vocab=64, max_len=8, n_layer=2, n_head=4,
            d_model=32, d_inner=64, dropout=0.0, use_flash=True)
EPS = 0.1


def _build_slice(fluid, tr, remat):
    """The forward under one recompute scope, the explicit chain loss,
    Adam on noam_decay outside it (models/transformer.py `build`'s)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        with _scope(fluid, remat):
            out = tr.transformer(label_smooth_eps=EPS, **TINY)
        lbl, trg_pad = out['feeds'][2], out['feeds'][4]
        soft = layers.label_smooth(layers.one_hot(lbl, TINY['trg_vocab']),
                                   epsilon=EPS)
        per_tok = layers.softmax_with_cross_entropy(out['logits'], soft,
                                                    soft_label=True)
        w = layers.elementwise_sub(layers.fill_constant_batch_size_like(
            trg_pad, [-1, TINY['max_len']], 'float32', 1.0), trg_pad)
        per_tok = layers.elementwise_mul(layers.squeeze(per_tok, axes=[2]),
                                         w)
        loss = layers.elementwise_div(layers.reduce_sum(per_tok),
                                      layers.reduce_sum(w))
        lr = layers.noam_decay(TINY['d_model'], 8000)
        fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                             epsilon=1e-9).minimize(loss)
    return main, startup, loss, out['loss']


def _noam(step, d_model=TINY['d_model'], warmup=8000):
    return d_model ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)


def test_the_slice_trains_as_the_jax_package_does():
    jmain, jstart, jloss, jfused = _build_slice(jf, jtr, True)
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(jstart)
    feed = jtr.synthetic_batch(np.random.RandomState(5), 3,
                               TINY['max_len'], TINY['trg_vocab'])
    feed['trg_pad'][1, 6:] = 1.0
    results = {}
    for remat in (True, False):
        tmain, _, tloss, tfused = _build_slice(tf, ttr, remat)
        names = tf.persistable_names(tmain)
        assert set(names) == set(jscope.vars)
        tscope = tf.scope_from_numpy({n: np.asarray(jscope.vars[n])
                                      for n in names}, tf.Scope(), 'cpu')
        texe = tf.Executor(tf.CPUPlace())
        with tf.scope_guard(tscope):
            results[remat] = ([texe.run(tmain, feed=feed,
                                        fetch_list=[tloss, tfused])
                               for _ in range(3)],
                              {n: texec.to_numpy(tscope.vars[n])
                               for n in names})
    jexe = jf.Executor()
    with jf.scope_guard(jscope):
        jres = [jexe.run(jmain, feed=feed, fetch_list=[jloss, jfused])
                for _ in range(3)]
    (tres, tparams), (pres, pparams) = results[True], results[False]
    for t, p in zip(tres, pres):
        for a, b in zip(t, p):
            assert np.array_equal(a, b)
    for t, j in zip(tres, jres):
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
        # the chain equals the model's fused closed form
        np.testing.assert_allclose(t[0], t[1], rtol=1e-5)
    atol = 2.01 * sum(_noam(s) for s in (1, 2, 3))
    for n, v in tparams.items():
        assert np.array_equal(v, pparams[n]), n
        np.testing.assert_allclose(v, np.asarray(jscope.vars[n]),
                                   rtol=1e-5, atol=atol, err_msg=n)
