"""Gradient clipping (clip.py) and weight decay (regularizer.py) through
both packages on the CPU: a small fc program trained by Adam with each
clip class and each decay, set globally, per parameter, on a
`param_list` subset and in two global-norm groups; the gradients after
the clip and decay ops (each `<param>@GRAD`, rewritten in place) and the
parameters after each of two steps against the JAX package's.

Tolerances: gradients within 1e-5 relative and 1e-6 absolute (float32
sums in other orders); parameters within 1e-5 relative and 1e-5 of the
tensor's largest entry where the step is well conditioned, else within
the step's size, 2.01 lr (Adam normalises each entry by its own
gradient, so an entry whose gradient is below 1% of its tensor's largest
carries the gradients' last-bit differences amplified into its step; the
first step is exactly lr sign(g)).  Each step starts from the JAX
package's state, carried into the port's scope."""
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

LR = 1e-2


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


def _program(fluid, case):
    """x[8] -> fc(16, relu) -> fc(16, relu) -> fc(4) -> mean, Adam, with
    the clip / decay of `case`."""
    main, startup = fluid.Program(), fluid.Program()
    clip, reg = fluid.clip, fluid.regularizer
    attrs = {}
    if case == 'per_param_norm':
        attrs['w1'] = fluid.ParamAttr(
            name='w1', gradient_clip=clip.GradientClipByNorm(0.05))
    if case == 'per_param_l2':
        attrs['w1'] = fluid.ParamAttr(name='w1',
                                      regularizer=reg.L2Decay(0.1))
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data('x', shape=[8], dtype='float32')
        h = fluid.layers.fc(x, 16, act='relu',
                            param_attr=attrs.get('w1', 'w1'),
                            bias_attr='b1')
        h = fluid.layers.fc(h, 16, act='relu', param_attr='w2',
                            bias_attr='b2')
        y = fluid.layers.fc(h, 4, param_attr='w3', bias_attr='b3')
        loss = fluid.layers.scale(fluid.layers.reduce_sum(
            fluid.layers.elementwise_mul(y, y)), scale=1.0 / 64)
        if case == 'global_value':
            fluid.set_gradient_clip(clip.GradientClipByValue(0.02))
        elif case == 'global_norm':
            fluid.set_gradient_clip(clip.GradientClipByNorm(0.1))
        elif case == 'global_global_norm':
            fluid.set_gradient_clip(clip.GradientClipByGlobalNorm(0.1))
        elif case == 'subset_global_norm':
            fluid.set_gradient_clip(clip.GradientClipByGlobalNorm(0.05),
                                    param_list=['w1', 'b2', 'w3'])
        elif case == 'two_groups':
            fluid.set_gradient_clip(
                clip.GradientClipByGlobalNorm(0.05, group_name='a'),
                param_list=['w1', 'b1', 'w2'])
            fluid.set_gradient_clip(
                clip.GradientClipByGlobalNorm(0.2, group_name='b'),
                param_list=['b2', 'w3', 'b3'])
        elif case == 'clip_then_l2':
            fluid.set_gradient_clip(clip.GradientClipByGlobalNorm(0.1))
        regularization = {'global_l1': reg.L1Decay(0.01),
                          'global_l2': reg.L2Decay(0.05),
                          'clip_then_l2': reg.L2Decay(0.05)}.get(case)
        opt = fluid.optimizer.Adam(learning_rate=LR,
                                   regularization=regularization)
        opt.minimize(loss)
    return main, startup, loss


CASES = ['global_value', 'global_norm', 'global_global_norm',
         'per_param_norm', 'subset_global_norm', 'two_groups', 'global_l1',
         'global_l2', 'per_param_l2', 'clip_then_l2']


def _op_types(program):
    return [op.type for op in program.global_block().ops]


@pytest.mark.parametrize('case', CASES)
def test_clip_and_decay_match_the_jax_package(case):
    jmain, jstart, jloss = _program(jf, case)
    tmain, _, tloss = _program(tf, case)
    assert _op_types(tmain) == _op_types(jmain)
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(jstart)
    tscope = tf.Scope()
    params = [p.name for p in tmain.all_parameters()]
    grads = [p + '@GRAD' for p in params]
    rng = np.random.RandomState(0)
    texe, jexe = tf.Executor(tf.CPUPlace()), jf.Executor()
    for step in range(2):
        feed = {'x': (3 * rng.randn(16, 8)).astype('float32')}
        tf.scope_from_numpy({n: np.asarray(v) for n, v in
                             jscope.vars.items()}, tscope, 'cpu')
        with jf.scope_guard(jscope):
            jres = jexe.run(jmain, feed=feed, fetch_list=[jloss] + grads)
        with tf.scope_guard(tscope):
            tres = texe.run(tmain, feed=feed, fetch_list=[tloss] + grads)
        np.testing.assert_allclose(tres[0], jres[0], rtol=1e-5)
        for name, a, b in zip(params, tres[1:], jres[1:]):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg='%s@GRAD' % name)
            pa = tscope.vars[name].numpy()
            pb = np.asarray(jscope.vars[name])
            np.testing.assert_allclose(pa, pb, rtol=1e-5, atol=2.01 * LR,
                                       err_msg=name)
            ok = np.abs(b) >= 1e-2 * float(np.abs(b).max())
            np.testing.assert_allclose(pa[ok], pb[ok], rtol=1e-5,
                                       atol=1e-5 * float(np.abs(pb).max()),
                                       err_msg=name)


def test_the_clips_do_clip():
    """The port alone: the clipped gradients obey their clip."""
    res = {}
    for case in ('global_value', 'global_norm', 'global_global_norm',
                 'two_groups'):
        main, startup, loss = _program(tf, case)
        params = [p.name for p in main.all_parameters()]
        scope = tf.Scope()
        with tf.scope_guard(scope):
            exe = tf.Executor(tf.CPUPlace())
            exe.run(startup)
            feed = {'x': (30 * np.random.RandomState(1).randn(16, 8))
                    .astype('float32')}
            res[case] = dict(zip(params, exe.run(
                main, feed=feed, fetch_list=[p + '@GRAD' for p in params])))
    assert max(np.abs(g).max() for g in res['global_value'].values()) \
        <= 0.02
    for g in res['global_norm'].values():
        assert np.sqrt(np.square(g).sum()) <= 0.1 * (1 + 1e-5)
    total = np.sqrt(sum(np.square(g).sum()
                        for g in res['global_global_norm'].values()))
    assert abs(total - 0.1) <= 1e-6
    a = np.sqrt(sum(np.square(res['two_groups'][n]).sum()
                    for n in ('w1', 'b1', 'w2')))
    b = np.sqrt(sum(np.square(res['two_groups'][n]).sum()
                    for n in ('b2', 'w3', 'b3')))
    assert abs(a - 0.05) <= 1e-6 and abs(b - 0.2) <= 1e-6


def test_error_clip_and_clip_attrs():
    e = tf.clip.ErrorClipByValue(2.0)
    assert (e.max, e.min) == (2.0, -2.0)
    c = tf.clip.GradientClipByValue(1.0, -0.5)
    assert (c.max, c.min) == (1.0, -0.5)
    g = tf.clip.GradientClipByGlobalNorm(3, group_name='x')
    assert (g.clip_norm, g.group_name) == (3.0, 'x')
    assert tf.regularizer.L1Decay is tf.regularizer.L1DecayRegularizer
    assert tf.regularizer.L2Decay is tf.regularizer.L2DecayRegularizer


@pytest.mark.parametrize('op_type,attrs', [
    ('square', {}), ('sqrt', {}), ('sign', {}),
    ('clip', {'min': -0.3, 'max': 0.5}),
    ('clip_by_norm', {'max_norm': 0.7}),
])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_clip_ops_match_the_jax_package(op_type, attrs, dtype):
    import jax.numpy as jnp
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    x = np.random.RandomState(2).randn(5, 7).astype(np.float32)
    x[0, :2] = [0.0, -0.0]
    if dtype == 'float32':
        x[0, 2] = np.nan
    if op_type == 'sqrt':
        x = np.abs(x)
    if op_type == 'clip_by_norm':
        x[0, 2] = 1.0
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    ctx = treg.ExecCtx(torch.device('cpu'), 0, 0)
    got = treg.get_op(op_type)(ctx, {'X': tx}, attrs)['Out']
    ref = jreg.get_op(op_type).impl(None, {'X': jx}, attrs)['Out']
    assert str(got.dtype).split('.')[-1] == str(ref.dtype)
    got, ref = got.float().numpy(), np.asarray(ref).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    real = ~np.isnan(ref)
    np.testing.assert_array_equal(np.signbit(got[real]),
                                  np.signbit(ref[real]))
    rtol = 1e-6 if dtype == 'float32' else 2.0 ** -8
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


@pytest.mark.parametrize('op_type', ['sum', 'elementwise_max'])
def test_sum_and_max_promote_as_jnp(op_type):
    import jax.numpy as jnp
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    rng = np.random.RandomState(3)
    a, b = rng.randn(4, 3).astype(np.float32), rng.randn(4, 3).astype(
        np.float32)
    tins = {'X': torch.from_numpy(a).bfloat16(), 'Y': torch.from_numpy(b)}
    jins = {'X': jnp.asarray(a, jnp.bfloat16), 'Y': jnp.asarray(b)}
    if op_type == 'sum':
        tins = {'X': [tins['X'], tins['Y'], tins['X']]}
        jins = {'X': [jins['X'], jins['Y'], jins['X']]}
    ctx = treg.ExecCtx(torch.device('cpu'), 0, 0)
    got = treg.get_op(op_type)(ctx, tins, {'axis': -1})['Out']
    ref = jreg.get_op(op_type).impl(None, jins, {'axis': -1})['Out']
    assert got.dtype == torch.float32 and str(ref.dtype) == 'float32'
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
