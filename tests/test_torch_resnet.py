"""ResNet training on the CPU against the JAX package: the ops conv2d,
pool2d, batch_norm, top_k, accuracy, cross_entropy and mean (forward, and
the gradients of conv2d, pool2d and batch_norm against `jax.vjp` of the
reference ops), the AMP flow of conv2d, and `models/resnet.py`: the
CIFAR-10 ResNet-8 and a stack of reference-shaped `bottleneck` blocks,
each trained 3 Momentum steps in float32 and under bf16 AMP.

Op tolerances, each with its reason:
- float32 forward: rtol 1e-5 and an atol of 1e-6 of the largest value
  (both packages compute in float32 in other summation orders);
  batch_norm's statistics: see `test_batch_norm_statistics_are_float32`;
- float32 gradients: within 1e-5 of the gradient's largest entry;
- top_k, accuracy: exact (indices and counts);
- conv2d under AMP: both packages cast the input and filter to bf16, sum
  the bf16 products in float32 and round the sum once to bf16 (u =
  2^-8); the two float32 sums differ in the last bits, so an output may
  round to the neighbouring bf16 value: within 2^-8 of its magnitude, plus
  1e-6 of the largest output.

Model tolerances.  Each step starts from the JAX package's state, carried
into the port's scope, so that one step's differences do not feed the
next.  A step's gradient can be ill conditioned in a network of batch
norms: the reference's float32 sums run in another order (XLA on the CPU
sums a reduction in sequence, PyTorch pairwise), and where the step
amplifies that, the two packages part by far more than float32's unit.
The test measures that amplification at each step: the same step on the
batch in another order (mathematically the same step; the batch norm's
pilot element and every sum move) gives each package's own order noise, n =
max(d(JAX, JAX permuted), d(port, port permuted)), d the relative L2
distance over a kind's tensors.
- float32: the loss within rtol 1e-5; parameters, velocities and moving
  statistics within 4 n + 1e-7 (two packages whose sums each err by about
  their own order noise differ by at most twice it; twice that again for
  headroom; 1e-7 is float32's unit where n is 0);
- AMP: each package's bf16 effect at the step, e = d(AMP step, float32
  step) from the same state; the two AMP steps round the same values to
  bf16, from float32 values that differ in the last bits, so they share
  most roundings: d(port AMP, JAX AMP) <= max(e_port, e_jax) for the
  parameters, velocities and moving statistics, and the port's AMP is an
  AMP of the same size, e_port within [e_jax / 2, 2 e_jax]; the loss (a
  float32 mean of float32 cross-entropies of bf16 activations) within
  2^-8 relative, one bf16 unit."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import resnet as jres
import paddle_tpu_torch as tf
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import resnet as tres
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

B = 8
SIDE = 16


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


# --------------------------------------------------------------- the ops

def _jax_op(op, ins, attrs):
    return jreg.get_op(op).impl(None, {k: jnp.asarray(v)
                                       for k, v in ins.items()}, attrs)


def _port_op(op, ins, attrs):
    return treg.get_op(op)(None, {k: torch.from_numpy(np.array(v))
                                  for k, v in ins.items()}, attrs)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(a, b, what=''):
    b = np.asarray(b, np.float32)
    finite = np.abs(b[np.isfinite(b)])
    np.testing.assert_allclose(
        _np(a), b, rtol=1e-5,
        atol=1e-6 * float(finite.max() if finite.size else 1.0),
        err_msg=what)


CONV_CASES = {
    'plain': ((2, 4, 9, 9), (6, 4, 3, 3), {}),
    'stride_pad': ((2, 4, 10, 9), (6, 4, 3, 3),
                   {'strides': [2, 1], 'paddings': [1, 2]}),
    'dilation': ((2, 4, 11, 11), (5, 4, 3, 3),
                 {'dilations': [2, 2], 'paddings': [2, 1]}),
    'groups': ((2, 6, 8, 8), (9, 2, 3, 3),
               {'groups': 3, 'strides': [2, 2], 'paddings': [1, 1]}),
    'bias_1x1_s2': ((3, 4, 8, 8), (8, 4, 1, 1), {'strides': [2, 2]}),
}


@pytest.mark.parametrize('case', sorted(CONV_CASES))
def test_conv2d_matches_the_reference(case):
    xs, ws, attrs = CONV_CASES[case]
    rng = np.random.RandomState(0)
    ins = {'Input': rng.randn(*xs).astype('float32'),
           'Filter': rng.randn(*ws).astype('float32') * 0.3}
    if case.startswith('bias'):
        ins['Bias'] = rng.randn(ws[0]).astype('float32')
    _close(_port_op('conv2d', ins, attrs)['Output'],
           _jax_op('conv2d', ins, attrs)['Output'], case)


POOL_CASES = {
    'max_3x3_s2_p1': ((2, 3, 9, 9), 'max', [3, 3], [2, 2], [1, 1], True,
                      False, False),
    'max_ceil': ((2, 3, 10, 10), 'max', [3, 3], [2, 2], [1, 1], True,
                 True, False),
    # the last window starts in the right padding: F.max_pool2d with
    # ceil_mode drops it, the reference keeps it
    'max_ceil_window_in_padding': ((1, 2, 5, 5), 'max', [2, 2], [2, 2],
                                   [1, 1], True, True, False),
    'avg_exclusive': ((2, 3, 9, 9), 'avg', [3, 3], [2, 2], [1, 1], True,
                      False, False),
    'avg_inclusive': ((2, 3, 9, 9), 'avg', [3, 3], [2, 2], [1, 1], False,
                      False, False),
    'avg_exclusive_ceil': ((2, 3, 10, 7), 'avg', [3, 2], [2, 2], [1, 0],
                           True, True, False),
    'avg_inclusive_ceil': ((2, 3, 10, 7), 'avg', [3, 2], [2, 2], [1, 0],
                           False, True, False),
    'global_avg': ((2, 3, 7, 7), 'avg', [7, 7], [1, 1], [0, 0], True,
                   False, True),
    'global_max': ((2, 3, 5, 6), 'max', [1, 1], [1, 1], [0, 0], True,
                   False, True),
}


def _pool_attrs(case):
    _, ptype, k, s, p, excl, ceil, glob = POOL_CASES[case]
    return {'pooling_type': ptype, 'ksize': k, 'strides': s,
            'paddings': p, 'exclusive': excl, 'ceil_mode': ceil,
            'global_pooling': glob}


@pytest.mark.parametrize('case', sorted(POOL_CASES))
def test_pool2d_matches_the_reference(case):
    x = np.random.RandomState(1).randn(*POOL_CASES[case][0]).astype(
        'float32')
    attrs = _pool_attrs(case)
    got = _port_op('pool2d', {'X': x}, attrs)['Out']
    want = _jax_op('pool2d', {'X': x}, attrs)['Out']
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, case)


def test_max_pool_ceil_keeps_the_window_that_starts_in_the_padding():
    """The reference pads explicitly and keeps the last window that starts
    in the right padding; PyTorch's ceil_mode drops it."""
    x = np.random.RandomState(2).randn(1, 2, 5, 5).astype('float32')
    attrs = _pool_attrs('max_ceil_window_in_padding')
    got = _port_op('pool2d', {'X': x}, attrs)['Out']
    torch_ceil = torch.nn.functional.max_pool2d(
        torch.from_numpy(x), 2, 2, 1, ceil_mode=True)
    assert tuple(got.shape) == (1, 2, 4, 4)
    assert tuple(torch_ceil.shape) == (1, 2, 3, 3)
    # the kept windows hold padding only: -inf, as the reference's
    assert torch.isneginf(got[:, :, 3, :]).all()


def _bn_inputs(seed, shape=(4, 5, 6, 6)):
    rng = np.random.RandomState(seed)
    C = shape[1]
    x = rng.randn(*shape).astype('float32')
    # channel 1: mean 1e3 std 1; channel 2: mean -300 std 0.01 (|mean| >>
    # std: the one-pass variance needs its pilot shift)
    x[:, 1] = x[:, 1] + 1e3
    x[:, 2] = x[:, 2] * 0.01 - 300.0
    return {'X': x, 'Scale': rng.rand(C).astype('float32') + 0.5,
            'Bias': rng.randn(C).astype('float32'),
            'Mean': rng.randn(C).astype('float32'),
            'Variance': rng.rand(C).astype('float32') + 0.5}


@pytest.mark.parametrize('mode', ['train', 'is_test', 'use_global_stats'])
def test_batch_norm_matches_the_reference(mode):
    ins = _bn_inputs(3)
    attrs = {'momentum': 0.9, 'epsilon': 1e-5,
             'is_test': mode == 'is_test',
             'use_global_stats': mode == 'use_global_stats'}
    got = _port_op('batch_norm', ins, attrs)
    want = _jax_op('batch_norm', ins, attrs)
    x = ins['X'].astype(np.float64)
    for slot in ('MeanOut', 'VarianceOut', 'SavedMean', 'SavedVariance'):
        # the statistics of a channel with mean 1e3 carry float32's unit
        # of 1e3 (6e-5); the reference's sequential sums add ~n u of it
        b = np.asarray(want[slot])
        np.testing.assert_allclose(_np(got[slot]), b, rtol=2e-5,
                                   atol=1e-6, err_msg=slot)
    y, yw = _np(got['Y']), np.asarray(want['Y'])
    if mode == 'train':
        # y = (x - mean) / std: an error of e in the statistics moves y by
        # e / std; the float64 statistics show both within that
        std = x.std(axis=(0, 2, 3))
        tol = (2e-5 * np.abs(x.mean(axis=(0, 2, 3))) / std + 1e-5)
        assert np.all(np.abs(y - yw).max(axis=(0, 2, 3)) <= tol * (
            np.abs(yw).max(axis=(0, 2, 3)) + 1)), np.abs(y - yw).max()
    else:
        _close(y, yw, 'Y')


def test_batch_norm_statistics_are_float32():
    """The port's one-pass statistics against float64 (the reference's own
    sequential float32 sums err by up to ~n u: the model tests allow for
    it)."""
    ins = _bn_inputs(5, (8, 6, 16, 16))
    out = _port_op('batch_norm', ins, {})
    x = ins['X'].astype(np.float64)
    m, v = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    u = 2.0 ** -24
    # a pairwise sum of n terms errs by about log2(n) u of the magnitudes
    n = x.size // x.shape[1]
    mag = np.abs(x).mean(axis=(0, 2, 3))
    assert np.all(np.abs(_np(out['SavedMean']) - m) <=
                  4 * np.log2(n) * u * mag)
    # the variance of d = x - pilot: terms up to (|mean - pilot| + 4 std)^2
    d = np.abs(x - x[:1, :, :1, :1]).max(axis=(0, 2, 3))
    assert np.all(np.abs(_np(out['SavedVariance']) - v) <=
                  4 * np.log2(n) * u * d * d + 1e-12)


def test_top_k_breaks_ties_lower_index_first():
    x = np.array([[1., 3., 3., 2., 3.], [5., 5., 5., 5., 5.],
                  [0., -1., 4., 4., -1.]], 'float32')
    for k in (1, 2, 3, 5):
        got = _port_op('top_k', {'X': x}, {'k': k})
        want = _jax_op('top_k', {'X': x}, {'k': k})
        np.testing.assert_array_equal(got['Out'].numpy(),
                                      np.asarray(want['Out']))
        np.testing.assert_array_equal(got['Indices'].numpy(),
                                      np.asarray(want['Indices']))
        assert got['Indices'].dtype == torch.int32


def test_accuracy_matches_the_reference():
    rng = np.random.RandomState(6)
    probs = rng.rand(10, 7).astype('float32')
    label = rng.randint(0, 7, (10, 1)).astype('int32')
    for k in (1, 3):
        idx = _port_op('top_k', {'X': probs}, {'k': k})['Indices'].numpy()
        got = _port_op('accuracy', {'Indices': idx, 'Label': label}, {})
        want = _jax_op('accuracy', {'Indices': idx, 'Label': label}, {})
        for slot in ('Accuracy', 'Correct', 'Total'):
            np.testing.assert_array_equal(got[slot].numpy(),
                                          np.asarray(want[slot]), slot)
        assert got['Correct'].dtype == got['Total'].dtype == torch.int32
        assert got['Accuracy'].dtype == torch.float32
        assert tuple(got['Accuracy'].shape) == (1,)


@pytest.mark.parametrize('case', ['hard', 'hard_ignore', 'soft'])
def test_cross_entropy_matches_the_reference(case):
    rng = np.random.RandomState(7)
    p = rng.rand(6, 5).astype('float32')
    p /= p.sum(axis=1, keepdims=True)
    p[0, 2] = 0.0          # log(0 + 1e-8)
    attrs = {}
    if case == 'soft':
        lab = rng.rand(6, 5).astype('float32')
        lab /= lab.sum(axis=1, keepdims=True)
        attrs['soft_label'] = True
    else:
        lab = rng.randint(0, 5, (6, 1)).astype('int32')
        lab[0, 0] = 2
        if case == 'hard_ignore':
            lab[1, 0] = 3
            attrs['ignore_index'] = 3
    got = _port_op('cross_entropy', {'X': p, 'Label': lab}, attrs)['Y']
    want = _jax_op('cross_entropy', {'X': p, 'Label': lab}, attrs)['Y']
    assert tuple(got.shape) == (6, 1)
    _close(got, want, case)


def test_mean_matches_the_reference():
    x = np.random.RandomState(8).randn(3, 4, 5).astype('float32')
    got = _port_op('mean', {'X': x}, {})['Out']
    assert tuple(got.shape) == (1,)
    _close(got, _jax_op('mean', {'X': x}, {})['Out'])


# -------------------------------------------------------- the gradients

GRAD_CASES = {
    'conv2d_groups': ('conv2d', {'Input': (2, 6, 9, 9),
                                 'Filter': (8, 3, 3, 3)},
                      {'strides': [2, 1], 'paddings': [1, 2],
                       'dilations': [1, 2], 'groups': 2}, 'Output'),
    'conv2d_1x1_s2': ('conv2d', {'Input': (2, 4, 8, 8),
                                 'Filter': (6, 4, 1, 1)},
                      {'strides': [2, 2]}, 'Output'),
    'pool2d_max': ('pool2d', {'X': (2, 3, 9, 9)},
                   {'pooling_type': 'max', 'ksize': [3, 3],
                    'strides': [2, 2], 'paddings': [1, 1],
                    'ceil_mode': True}, 'Out'),
    'pool2d_avg': ('pool2d', {'X': (2, 3, 9, 9)},
                   {'pooling_type': 'avg', 'ksize': [3, 3],
                    'strides': [2, 2], 'paddings': [1, 1],
                    'ceil_mode': True, 'exclusive': True}, 'Out'),
    'pool2d_global_avg': ('pool2d', {'X': (2, 3, 6, 6)},
                          {'pooling_type': 'avg', 'ksize': [6, 6],
                           'global_pooling': True}, 'Out'),
    'batch_norm': ('batch_norm', None, {'momentum': 0.9}, 'Y'),
}


@pytest.mark.parametrize('case', sorted(GRAD_CASES))
def test_gradients_match_jax_vjp(case):
    op, shapes, attrs, slot = GRAD_CASES[case]
    rng = np.random.RandomState(9)
    if shapes is None:
        ins = _bn_inputs(10)
        wrt = ['X', 'Scale', 'Bias']
    else:
        ins = {k: rng.randn(*s).astype('float32') for k, s in
               shapes.items()}
        wrt = list(shapes)
    impl = jreg.get_op(op).impl

    def f(*xs):
        full = {k: jnp.asarray(v) for k, v in ins.items()}
        full.update(zip(wrt, xs))
        return impl(None, full, attrs)[slot]
    out, vjp = jax.vjp(f, *[jnp.asarray(ins[k]) for k in wrt])
    g = rng.randn(*out.shape).astype('float32')
    want = vjp(jnp.asarray(g))
    t = {k: torch.from_numpy(v.copy()) for k, v in ins.items()}
    for k in wrt:
        t[k].requires_grad_(True)
    got = torch.autograd.grad(treg.get_op(op)(None, t, attrs)[slot],
                              [t[k] for k in wrt], torch.from_numpy(g))
    for k, a, b in zip(wrt, got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=k)


# ---------------------------------------------------------- conv2d AMP

def _conv_bn_program(fluid, amp):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name='data', shape=[4, 8, 8],
                                dtype='float32')
        conv = fluid.layers.conv2d(img, 6, 3, padding=1)
        y = fluid.layers.batch_norm(conv, act='relu')
    main.set_amp(amp)
    return main, startup, conv, y


def test_conv2d_flows_bf16_under_amp():
    """Under AMP conv2d's output stays bf16 (the reference's flow set) and
    the bias add follows it in bf16; the batch norm returns bf16 from
    float32 statistics.  Values within one bf16 rounding of the
    reference's."""
    jm, js, jconv, jy = _conv_bn_program(jf, True)
    tm, _, tconv, ty = _conv_bn_program(tf, True)
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(js)
    tscope = tf.scope_from_numpy(
        {n: np.asarray(jscope.vars[n]) for n in tf.persistable_names(tm)},
        tf.Scope(), 'cpu')
    feed = {'data': np.random.RandomState(11).randn(2, 4, 8, 8).astype(
        'float32')}
    names = [v.name for v in (jconv, jy)]
    with jf.scope_guard(jscope):
        want = jf.Executor().run(jm, feed=feed, fetch_list=names)
    with tf.scope_guard(tscope):
        got = tf.Executor(tf.CPUPlace()).run(tm, feed=feed,
                                             fetch_list=names,
                                             return_numpy=False)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert np.asarray(w).dtype.name == 'bfloat16'
    a, b = got[0].float().numpy(), np.asarray(want[0]).astype('float32')
    assert np.all(np.abs(a - b) <= 2.0 ** -8 * np.abs(b) +
                  1e-6 * np.abs(b).max())


# ------------------------------------------------------------ the models

def _bottleneck_stack(fluid, resnet):
    """Reference-shaped bottleneck blocks: 16 -> 32 channels (a shortcut
    conv), 32 -> 32 (the identity), 32 -> 64 at stride 2."""
    img = fluid.layers.data(name='data', shape=[3, SIDE, SIDE],
                            dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    h = resnet.conv_bn_layer(img, 16, 3, 1, 1)
    h = resnet.bottleneck(h, 8, 1)
    h = resnet.bottleneck(h, 8, 1)
    h = resnet.bottleneck(h, 16, 2)
    pool = fluid.layers.pool2d(h, pool_size=SIDE // 2, pool_type='avg',
                               global_pooling=True)
    pred = fluid.layers.fc(pool, 10, act='softmax')
    loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return loss


def _model(fluid, resnet, which, amp):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if which == 'cifar10_d8':
            loss = resnet.build(data_shape=(3, SIDE, SIDE), class_dim=10,
                                depth=8, data_set='cifar10')['loss']
        else:
            loss = _bottleneck_stack(fluid, resnet)
    main.set_amp(amp)
    return main, startup, loss


def _desc(fluid, program):
    d = json.loads(json.dumps(fluid.io.program_to_desc(program)))
    for b in d['blocks']:
        for op in b['ops']:
            op.pop('source_loc')
    return d


def test_resnet50_program_is_the_reference_program():
    """bench_program builds the reference's ResNet-50 step: the same desc,
    161 trainable tensors of 25.56 M entries, 53 convs and batch norms,
    one momentum op a trainable tensor, AMP on."""
    jm, js, _, jfeed = jres.bench_program(B=2, side=32, classes=1000)
    tm, ts, _, tfeed = tres.bench_program(B=2, side=32, classes=1000)
    assert _desc(tf, tm) == _desc(jf, jm)
    assert _desc(tf, ts) == _desc(jf, js)
    assert tm._amp
    for k in jfeed:
        np.testing.assert_array_equal(tfeed[k], jfeed[k])
    params = [p for p in tm.all_parameters() if p.trainable]
    assert len(params) == 161
    assert sum(int(np.prod(p.shape)) for p in params) == 25557032
    types = [op.type for op in tm.global_block().ops]
    assert types.count('conv2d') == types.count('batch_norm') == 53
    assert types.count('momentum') == 161


def test_for_test_clone_sets_batch_norm_is_test():
    main, _, _ = _model(tf, tres, 'cifar10_d8', False)
    test = main.clone(for_test=True)
    bns = [op for op in test.global_block().ops if op.type == 'batch_norm']
    assert bns and all(op.attrs['is_test'] for op in bns)
    assert not any(op.type == 'momentum' for op in test.global_block().ops)


def _kinds(names):
    out = {'params': [], 'velocities': [], 'moving': []}
    for n in names:
        if n.endswith('_velocity_0'):
            out['velocities'].append(n)
        elif n.startswith('batch_norm') and n.endswith(('.w_1', '.w_2')):
            out['moving'].append(n)
        elif 'learning_rate' not in n:
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
        self.j = _model(jf, jres, which, amp)
        self.t = _model(tf, tres, which, amp)
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


def _feeds():
    rng = np.random.RandomState(0)
    feed = {'data': rng.rand(B, 3, SIDE, SIDE).astype('float32'),
            'label': rng.randint(0, 10, (B, 1)).astype('int64')}
    perm = np.random.RandomState(5).permutation(B)
    return feed, {k: v[perm] for k, v in feed.items()}


MODELS = ['cifar10_d8', 'bottleneck_stack']


@pytest.mark.parametrize('which', MODELS)
def test_three_f32_momentum_steps_match_the_jax_package(which):
    pair = _pair(which, False)
    feed, pfeed = _feeds()
    state = pair.init()
    kinds = _kinds(state)
    for step in range(3):
        jl, js = pair.jax_step(state, feed)
        tl, ts = pair.port_step(state, feed)
        _, jps = pair.jax_step(state, pfeed)
        _, tps = pair.port_step(state, pfeed)
        np.testing.assert_allclose(tl, jl, rtol=1e-5,
                                   err_msg='loss at step %d' % step)
        for kind, names in kinds.items():
            noise = max(_dist(jps, js, names), _dist(tps, ts, names))
            d = _dist(ts, js, names)
            assert d <= 4 * noise + 1e-7, (which, step, kind, d, noise)
        state = {n: v.astype(state[n].dtype) for n, v in js.items()}
    assert all(np.isfinite(v).all() for v in state.values())


@pytest.mark.parametrize('which', MODELS)
def test_three_amp_momentum_steps_match_the_jax_package(which):
    amp, f32 = _pair(which, True), _pair(which, False)
    feed, _ = _feeds()
    state = amp.init()
    kinds = _kinds(state)
    for step in range(3):
        jl, js = amp.jax_step(state, feed)
        tl, ts = amp.port_step(state, feed)
        _, js32 = f32.jax_step(state, feed)
        _, ts32 = f32.port_step(state, feed)
        np.testing.assert_allclose(tl, jl, rtol=2.0 ** -8,
                                   err_msg='AMP loss at step %d' % step)
        for kind, names in kinds.items():
            e_jax, e_port = _dist(js, js32, names), _dist(ts, ts32, names)
            d = _dist(ts, js, names)
            assert d <= max(e_jax, e_port), (which, step, kind, d, e_jax,
                                             e_port)
            assert e_jax / 2 <= e_port <= 2 * e_jax, (which, step, kind,
                                                      e_jax, e_port)
        state = {n: v.astype(state[n].dtype) for n, v in js.items()}
