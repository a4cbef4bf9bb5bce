"""The conv models on the CPU against the JAX package: nets.py's four
helpers, models/mnist.py, models/vgg.py (VGG-16 at 32 x 32, the
reference's default build) and a reduced SE-ResNeXt built from
models/se_resnext.py's own `conv_bn_layer`, `bottleneck_block` and
`squeeze_excitation` (cardinality 32, reduction 16, Momentum on a
piecewise schedule with L2 decay), each trained three steps in float32
and under bf16 AMP; the full SE-ResNeXt-50 program's first step at 32 x
32; and every fused group of the three models' programs planned for the
card.  Every dropout's probability is 0 in both packages' programs, so no
mask differs.

Tolerances, each with its reason:
- nets.py forward: rtol 1e-5 and 1e-6 of the largest value (float32 in
  both, summed in other orders);
- the training steps: each step starts from the JAX package's state
  carried into the port, and its bound is calibrated by each package's
  own float32 noise at that step, n = max(d(JAX, JAX'), d(port, port')),
  d the relative L2 distance over a kind's tensors (parameters, the
  optimizer's moments or velocities, batch norm's moving statistics) and
  ' the same step on the feed moved by one float32 unit at each entry
  (x (1 +- 2^-23), random signs): as much as the step amplifies a last-bit
  difference, which is what two float32 implementations summing in other
  orders differ by (tests/test_torch_resnet.py calibrates by the batch's
  order, which leaves these small batches bit for bit unchanged; Adam's
  first step turns a gradient's last bits into its update's sign, MNIST's
  parameters 8.5e-7 apart where the batch order moves nothing).
  float32: each kind within 4 n + 2^-20 (8 float32 units: an Adam moment
  carries a few roundings a step), the loss within 1e-5 relative or 4
  times its own such noise;
  AMP: each kind within the larger package's bf16 effect, e = d(AMP step,
  float32 step) from the same state, the port's effect within [1/2, 2] of
  the JAX package's (tests/test_torch_resnet.py derives these), the loss
  within 2^-8 relative or the larger package's bf16 effect on the loss
  (VGG-16's batch norms over 4 rows at 1 x 1 move it by 1%);
- the full SE-ResNeXt-50's first loss (a float32 forward of 50 layers):
  within 1e-5 relative, or 4 times its own float32 noise as above.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import mnist as jmnist, se_resnext as jse, vgg as jvgg
from paddle_tpu_torch.models import (mnist as tmnist, se_resnext as tse,
                                     vgg as tvgg)
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

B = 4


@pytest.fixture(autouse=True)
def fresh_port_programs(monkeypatch):
    """Fresh default programs, scope and name generator for the port (the
    root conftest does the same for the JAX package), and the JAX
    package's compile cache off."""
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


def _desc(fluid, program):
    d = json.loads(json.dumps(fluid.io.program_to_desc(program)))
    for b in d['blocks']:
        for op in b['ops']:
            op.pop('source_loc', None)
    return d


def _no_dropout(main):
    for op in main.global_block().ops:
        if op.type == 'dropout':
            op.attrs['dropout_prob'] = 0.0
    main._bump()


def _carry(jscope, tmain):
    return tf.scope_from_numpy(
        {n: np.asarray(jscope.vars[n]) for n in tf.persistable_names(tmain)},
        tf.Scope(), 'cpu')


# ------------------------------------------------------------- nets.py

def _nets_case(fluid, which):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if which in ('simple_img_conv_pool', 'img_conv_group'):
            x = fluid.layers.data(name='x', shape=[3, 12, 12],
                                  dtype='float32')
            if which == 'simple_img_conv_pool':
                out = fluid.nets.simple_img_conv_pool(
                    x, num_filters=6, filter_size=3, pool_size=2,
                    pool_stride=2, conv_padding=1, act='relu')
            else:
                out = fluid.nets.img_conv_group(
                    x, conv_num_filter=[4, 5], pool_size=2, pool_stride=2,
                    conv_act='relu', conv_with_batchnorm=[True, False],
                    conv_batchnorm_drop_rate=[0.3, 0.0])
        elif which == 'glu':
            x = fluid.layers.data(name='x', shape=[5, 8], dtype='float32')
            out = fluid.nets.glu(x, dim=-1)
        else:
            x = fluid.layers.data(name='x', shape=[6, 8], dtype='float32')
            out = fluid.nets.scaled_dot_product_attention(x, x, x,
                                                          num_heads=2)
    _no_dropout(main)
    return main, startup, x, out


NETS = ('simple_img_conv_pool', 'img_conv_group', 'glu',
        'scaled_dot_product_attention')


@pytest.mark.parametrize('which', NETS)
def test_nets_helper_matches_the_reference(which):
    jm, js, jx, jout = _nets_case(jf, which)
    tm, ts, tx, tout = _nets_case(tf, which)
    assert _desc(tf, tm) == _desc(jf, jm)
    assert _desc(tf, ts) == _desc(jf, js)
    jscope = jf.Scope()
    feed = {'x': np.random.RandomState(8).randn(3, *jx.shape[1:]).astype(
        'float32')}
    with jf.scope_guard(jscope):
        jf.Executor().run(js)
        want, = jf.Executor().run(jm, feed=feed, fetch_list=[jout])
    with tf.scope_guard(_carry(jscope, tm)):
        got, = tf.Executor(tf.CPUPlace()).run(tm, feed=feed,
                                              fetch_list=[tout])
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_sequence_conv_pool_is_left_out():
    """Not left out since the port has LoD: `nets.__all__` is the
    reference's, `sequence_conv_pool` included, and it builds the
    reference's ops on a ragged input."""
    assert set(tf.nets.__all__) == set(jf.nets.__all__)
    types = []
    for fluid in (jf, tf):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data('x', shape=[4], dtype='float32',
                                  lod_level=1)
            fluid.nets.sequence_conv_pool(x, num_filters=3, filter_size=3)
        types.append([op.type for op in main.global_block().ops])
    assert types[0] == types[1] == ['sequence_conv', 'elementwise_add',
                                    'sigmoid', 'sequence_pool']


# ------------------------------------------------------------ the models

def _se_reduced(fluid, se):
    """A reduced SE-ResNeXt from the model's own blocks: a 3 x 3 stem, a
    block with a conv shortcut (64 -> 128), one with the identity, one at
    stride 2 (128 -> 256), cardinality 32, reduction 16; Momentum 0.9 on a
    piecewise schedule whose boundaries fall inside the three steps, with
    L2Decay(1e-4), as se_resnext.build has it."""
    img = fluid.layers.data(name='data', shape=[3, 16, 16], dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    h = se.conv_bn_layer(img, 32, 3, act='relu')
    h = se.bottleneck_block(h, 64, 1, 32, 16)
    h = se.bottleneck_block(h, 64, 1, 32, 16)
    h = se.bottleneck_block(h, 128, 2, 32, 16)
    pool = fluid.layers.pool2d(h, pool_type='avg', global_pooling=True)
    drop = fluid.layers.dropout(pool, dropout_prob=0.5)
    pred = fluid.layers.fc(drop, 10, act='softmax')
    loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
    fluid.optimizer.Momentum(
        learning_rate=fluid.layers.piecewise_decay([1, 2], [0.1, 0.05, 0.01]),
        momentum=0.9,
        regularization=fluid.regularizer.L2Decay(1e-4)).minimize(loss)
    return {'loss': loss}


MODELS = {
    'mnist': (jmnist, tmnist, {}, 'pixel', (1, 28, 28)),
    'vgg16_32': (jvgg, tvgg, {}, 'data', (3, 32, 32)),
    'se_reduced': (jse, tse, None, 'data', (3, 16, 16)),
}


def _model(fluid, which, amp):
    jmod, tmod, kw, _, _ = MODELS[which]
    mod = jmod if fluid is jf else tmod
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = mod.build(**kw) if kw is not None else _se_reduced(fluid, mod)
    _no_dropout(main)
    main.set_amp(amp)
    return main, startup, out['loss']


def _kinds(names):
    out = {'params': [], 'moments': [], 'moving': []}
    for n in names:
        if '_moment1_' in n or '_moment2_' in n or '_velocity_' in n:
            out['moments'].append(n)
        elif n.startswith('batch_norm') and n.endswith(('.w_1', '.w_2')):
            out['moving'].append(n)
        elif '_pow_acc' in n or 'learning_rate' in n or '@' in n or \
                n.startswith('fill_constant') or n.startswith('tmp'):
            continue
        else:
            out['params'].append(n)
    return out


def _dist(a, b, names):
    x = np.concatenate([a[n].ravel() for n in names])
    y = np.concatenate([b[n].ravel() for n in names])
    return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))


_PAIRS = {}


def _pair(which, amp):
    """The _Pair of `which` at `amp`, built once for the tests that use it
    (the float32 one also by the AMP test's float32 effect)."""
    if (which, amp) not in _PAIRS:
        _PAIRS[which, amp] = _Pair(which, amp)
    return _PAIRS[which, amp]


class _Pair(object):
    """One model in both packages at one precision, and a step of each
    from a given state on a given feed -> (loss, state after)."""

    def __init__(self, which, amp):
        self.j = _model(jf, which, amp)
        self.t = _model(tf, which, amp)
        assert _desc(tf, self.t[0]) == _desc(jf, self.j[0])
        # one executor a package: a step's state comes in a new scope, and
        # the compiled step (keyed by program and feeds, not the scope) is
        # reused; no dropout draws, so the run counters change nothing
        self.jexe, self.texe = jf.Executor(), tf.Executor(tf.CPUPlace())
        self._init = None

    def init(self):
        if self._init is None:
            scope = jf.Scope()
            with jf.scope_guard(scope):
                jf.Executor().run(self.j[1])
            self._init = {n: np.asarray(v).copy()
                          for n, v in scope.vars.items()}
        return self._init

    def jax_step(self, state, feed):
        scope = jf.Scope()
        scope.vars.update({n: a.copy() for n, a in state.items()})
        with jf.scope_guard(scope):
            loss, = self.jexe.run(self.j[0], feed=feed,
                                  fetch_list=[self.j[2]])
        return float(loss[0]), {n: np.asarray(v).astype(np.float64)
                                for n, v in scope.vars.items()}

    def port_step(self, state, feed):
        scope = tf.scope_from_numpy({n: a.copy() for n, a in state.items()},
                                    tf.Scope(), 'cpu')
        with tf.scope_guard(scope):
            loss, = self.texe.run(self.t[0], feed=feed,
                                  fetch_list=[self.t[2]])
        return float(loss[0]), {n: v.double().numpy()
                                for n, v in scope.vars.items()}


def _feeds(which):
    """The feed, and the feed moved by one float32 unit (random signs)."""
    _, _, _, name, shape = MODELS[which]
    rng = np.random.RandomState(0)
    feed = {name: rng.rand(B, *shape).astype('float32'),
            'label': rng.randint(0, 10, (B, 1)).astype('int64')}
    sign = np.random.RandomState(5).choice([-1.0, 1.0], feed[name].shape)
    moved = dict(feed)
    moved[name] = (feed[name] * (1 + 2.0 ** -23 * sign)).astype('float32')
    return feed, moved


def _common(state, new):
    # the step adds the schedule's counter and the optimizer's temporaries
    return {n: v.astype(state[n].dtype) if n in state else v
            for n, v in new.items()}


@pytest.mark.parametrize('which', sorted(MODELS))
def test_three_f32_steps_match_the_jax_package(which):
    pair = _pair(which, False)
    feed, moved = _feeds(which)
    state = pair.init()
    kinds = _kinds(state)
    for step in range(3):
        jl, js = pair.jax_step(state, feed)
        tl, ts = pair.port_step(state, feed)
        jml, jms = pair.jax_step(state, moved)
        tml, tms = pair.port_step(state, moved)
        loss_noise = max(abs(jml - jl), abs(tml - tl))
        assert abs(tl - jl) <= max(1e-5 * abs(jl), 4 * loss_noise), (
            which, step, tl, jl, loss_noise)
        for kind, names in kinds.items():
            if not names:
                continue
            noise = max(_dist(jms, js, names), _dist(tms, ts, names))
            d = _dist(ts, js, names)
            assert d <= 4 * noise + 2.0 ** -20, (which, step, kind, d,
                                                  noise)
        state = _common(state, js)
    assert all(np.isfinite(v).all() for v in state.values())


@pytest.mark.parametrize('which', sorted(MODELS))
def test_three_amp_steps_match_the_jax_package(which):
    amp, f32 = _pair(which, True), _pair(which, False)
    feed, _ = _feeds(which)
    state = amp.init()
    kinds = _kinds(state)
    for step in range(3):
        jl, js = amp.jax_step(state, feed)
        tl, ts = amp.port_step(state, feed)
        jl32, js32 = f32.jax_step(state, feed)
        tl32, ts32 = f32.port_step(state, feed)
        e_loss = max(abs(jl - jl32), abs(tl - tl32))
        assert abs(tl - jl) <= max(2.0 ** -8 * abs(jl), e_loss), (
            which, step, tl, jl, e_loss)
        for kind, names in kinds.items():
            if not names:
                continue
            e_jax, e_port = _dist(js, js32, names), _dist(ts, ts32, names)
            d = _dist(ts, js, names)
            assert d <= max(e_jax, e_port), (which, step, kind, d, e_jax,
                                             e_port)
            assert e_jax / 2 <= e_port <= 2 * e_jax, (which, step, kind,
                                                      e_jax, e_port)
        state = _common(state, js)


def _build(fluid, mod, **kw):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = mod.build(**kw)
    return main, startup, out


@pytest.mark.parametrize('which,kw', [
    ('mnist', {}), ('vgg', {}),
    ('vgg', dict(data_shape=(3, 224, 224), class_dim=1000)),
    ('se_resnext', dict(data_shape=(3, 224, 224), class_dim=1000,
                        depth=50)),
    ('se_resnext', dict(data_shape=(3, 32, 32), class_dim=10, depth=101)),
    ('se_resnext', dict(data_shape=(3, 32, 32), class_dim=10, depth=152))],
    ids=['mnist', 'vgg16_32', 'vgg16_224', 'se_resnext50_224',
         'se_resnext101', 'se_resnext152'])
def test_model_program_is_the_reference_program(which, kw):
    jmod = {'mnist': jmnist, 'vgg': jvgg, 'se_resnext': jse}[which]
    tmod = {'mnist': tmnist, 'vgg': tvgg, 'se_resnext': tse}[which]
    jm, js, _ = _build(jf, jmod, **kw)
    tm, ts, _ = _build(tf, tmod, **kw)
    assert _desc(tf, tm) == _desc(jf, jm)
    assert _desc(tf, ts) == _desc(jf, js)


def _forward(program):
    """The program's ops before its `__backward__`: the training step's
    forward (batch norm on the batch's statistics) and loss."""
    block = program.global_block()
    cut = [op.type for op in block.ops].index('__backward__')
    del block.ops[cut:]
    program._bump()
    return program


def test_se_resnext50_first_step_matches_the_jax_package():
    """The full SE-ResNeXt-50 program (depth 50, cardinality 32) at 32 x
    32, 10 classes, B 8: its first step's forward and loss from one state,
    within 1e-5 relative or 4 times the loss's own float32 noise (the feed
    moved by one unit, as the training tests calibrate: at B 4 its last
    stage's batch norms over 4 values at 1 x 1 move the loss by 1e-4 for a
    last-bit change of the input)."""
    kw = dict(data_shape=(3, 32, 32), class_dim=10, depth=50)
    jm, js, jout = _build(jf, jse, **kw)
    tm, ts, tout = _build(tf, tse, **kw)
    ops = [op.type for op in tm.global_block().ops]
    assert ops.count('conv2d') == 1 + 16 * 3 + 4
    assert ops.count('sigmoid') == 16
    assert ops.count('momentum') == len([p for p in tm.all_parameters()
                                         if p.trainable])
    for m in (jm, tm):
        _no_dropout(_forward(m))
    rng = np.random.RandomState(1)
    feed = {'data': rng.rand(8, 3, 32, 32).astype('float32'),
            'label': rng.randint(0, 10, (8, 1)).astype('int64')}
    sign = np.random.RandomState(5).choice([-1.0, 1.0], feed['data'].shape)
    moved = dict(feed, data=(feed['data'] * (1 + 2.0 ** -23 * sign))
                 .astype('float32'))
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(js)
    init = {n: np.asarray(v).copy() for n, v in jscope.vars.items()}
    loss = {}
    for which, f in (('feed', feed), ('moved', moved)):
        scope = jf.Scope()
        scope.vars.update({n: a.copy() for n, a in init.items()})
        with jf.scope_guard(scope):
            loss['jax', which] = float(np.asarray(jf.Executor().run(
                jm, feed=f, fetch_list=[jout['loss']])[0])[0])
        with tf.scope_guard(tf.scope_from_numpy(
                {n: a.copy() for n, a in init.items()}, tf.Scope(), 'cpu')):
            loss['port', which] = float(tf.Executor(tf.CPUPlace()).run(
                tm, feed=f, fetch_list=[tout['loss']])[0][0])
    noise = max(abs(loss[p, 'moved'] - loss[p, 'feed'])
                for p in ('jax', 'port'))
    d = abs(loss['port', 'feed'] - loss['jax', 'feed'])
    assert d <= max(1e-5 * abs(loss['jax', 'feed']), 4 * noise), (loss, d)


@pytest.mark.parametrize('amp', [False, True], ids=['f32', 'amp'])
@pytest.mark.parametrize('which,kw,shape', [
    ('mnist', {}, (1, 28, 28)),
    ('vgg', dict(data_shape=(3, 224, 224), class_dim=1000), (3, 224, 224)),
    ('se_resnext', dict(data_shape=(3, 224, 224), class_dim=1000,
                        depth=50), (3, 224, 224))],
    ids=['mnist', 'vgg16', 'se_resnext50'])
def test_every_fused_group_plans_for_the_card(which, kw, shape, amp):
    """The executor's planning pass over each model's optimized program at
    its card configuration (meta tensors, nothing computed): every fused
    group plans, no KernelgenUnsupported, and SE-ResNeXt's groups hold the
    gate's sigmoid, the block's mul -> add -> relu and the schedule's
    less_than -> cast."""
    from paddle_tpu_torch.core import executor as ex, passes
    from paddle_tpu_torch.core.dtypes import torch_dtype
    from paddle_tpu_torch.ops import kernelgen
    tmod = {'mnist': tmnist, 'vgg': tvgg, 'se_resnext': tse}[which]
    main, _, out = _build(tf, tmod, **kw)
    main.set_amp(amp)
    opt, _ = passes.maybe_optimize(main, [out['loss'].name])
    env = {v.name: torch.empty(v.shape, dtype=torch_dtype(v.dtype),
                               device='meta')
           for v in main.list_vars() if v.persistable}
    env[out['feeds'][0].name] = torch.empty((8,) + shape, device='meta')
    env['label'] = torch.empty((8, 1), dtype=torch.int32, device='meta')
    seen, real = [], kernelgen.plan_for

    def spy(attrs, avals, amp_):
        plan = real(attrs, avals, amp_)
        seen.append(plan)
        return plan
    kernelgen.plan_for = spy
    try:
        ex._plan_kernels(opt.global_block().ops, env, amp)
    finally:
        kernelgen.plan_for = real
    fused = [op for op in opt.global_block().ops
             if op.type == 'fused_elementwise']
    assert fused and len(seen) >= len(fused)
    segs = {'+'.join(o[0]['type'] for o in st[1].ops)
            for plan in seen for st in plan.steps if st[0] == 'kernel'}
    if which == 'se_resnext':
        assert any('sigmoid' in s for s in segs)
        assert 'elementwise_mul+elementwise_add+relu' in segs
        assert any('less_than+cast' in s for s in segs)
