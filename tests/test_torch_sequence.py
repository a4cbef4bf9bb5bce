"""LoD and the sequence stack of the port against the JAX package on the
CPU: the LoDTensor feed (core/lod.py, layers/io.py data(lod_level),
the executor's feed, clone, FeedBucketer's sequence padding, DataFeeder,
a saved inference program fed a LoDTensor) and each op of
ops/sequence.py and `cos_sim`, forward and gradient.

Tolerances, each with its reason:
- the ops without a sum, a product or a transcendental (pooling by max,
  first and last, the masks, reverse, slice, concat, enumerate, erase,
  scatter, expand, pad, reshape): equal bit for bit, gradients too
  (but expand's, a sum over the copies);
- the rest (sum, average and sqrt pooling: XLA's reduction adds in
  another order than torch's; softmax, sequence_conv's GEMM, the
  RNNs' GEMMs and gate activations, cos_sim): rtol 1e-5 and an atol of
  1e-6 of the output's largest value, gradients too.  XLA's exp and tanh
  polynomials and its dot's summation order differ from libm's and
  torch's by a few float32 units a step; an RNN carries them through
  its T steps and back through the backward's T steps, which stays far
  inside 1e-5 at these sizes (T <= 9, D <= 8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as tf
from paddle_tpu_torch.core.registry import get_op

RTOL = 1e-5


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


def _as_j(v):
    return [jnp.asarray(a) for a in v] if isinstance(v, list) else \
        jnp.asarray(v)


def _as_t(v, grad):
    if isinstance(v, list):
        return [torch.from_numpy(a).requires_grad_(grad) for a in v]
    return torch.from_numpy(v).requires_grad_(grad)


def _floats(ins):
    return [k for k, v in ins.items() if not isinstance(v, list)
            and v.dtype == np.float32]


def _both(op_type, ins, attrs, slots):
    """The op of both packages on numpy inputs, and the gradients of
    sum_s(out_s * w_s) w.r.t. the float inputs -> (port outs, jax outs,
    port grads, jax grads)."""
    rng = np.random.RandomState(9)
    jimpl, timpl = jreg.get_op(op_type).impl, get_op(op_type)
    floats = _floats(ins)
    jout = jimpl(None, {k: _as_j(v) for k, v in ins.items()}, attrs)
    ws = {s: rng.randn(*jout[s].shape).astype('float32') for s in slots
          if jnp.issubdtype(jout[s].dtype, jnp.floating)}

    def jloss(*xs):
        d = {k: _as_j(v) for k, v in ins.items()}
        d.update(dict(zip(floats, xs)))
        o = jimpl(None, d, attrs)
        return sum(jnp.sum(o[s] * w) for s, w in ws.items())
    jg = jax.grad(jloss, argnums=tuple(range(len(floats))))(
        *[jnp.asarray(ins[k]) for k in floats]) if floats and ws else ()
    tins = {k: _as_t(v, k in floats) for k, v in ins.items()}
    tout = timpl(None, tins, attrs)
    if floats and ws:
        sum((tout[s] * torch.from_numpy(w)).sum()
            for s, w in ws.items()).backward()
    # an input read only for its shape gets no gradient: zeros, as jax
    tg = [tins[k].grad.numpy() if tins[k].grad is not None else
          np.zeros_like(ins[k]) for k in floats] if ws else []
    return ({s: tout[s].detach().numpy() for s in slots},
            {s: np.asarray(jout[s]) for s in slots}, tg,
            [np.asarray(g) for g in jg])


def _close(got, want, exact, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if exact:
        assert np.array_equal(got, want, equal_nan=True), what
    else:
        np.testing.assert_allclose(
            got, want, rtol=RTOL,
            atol=1e-6 * max(float(np.nanmax(np.abs(want))), 1e-30),
            err_msg=what)


def _check(op_type, ins, attrs, slots, exact):
    to, jo, tg, jg = _both(op_type, ins, attrs, slots)
    for s in slots:
        _close(to[s], jo[s], exact, s)
    assert len(tg) == len(jg)
    for k, a, b in zip(_floats(ins), tg, jg):
        _close(a, b, exact, 'd' + k)


def _ragged(B=5, T=7, D=3, seed=0, min_len=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, D).astype('float32')
    length = rng.randint(min_len, T + 1, B).astype('int32')
    length[0] = T
    return x, length


@pytest.mark.parametrize('ptype', ['SUM', 'AVERAGE', 'SQRT', 'MAX', 'LAST',
                                   'FIRST'])
def test_sequence_pool_matches_the_jax_op(ptype):
    x, length = _ragged()
    # ties within a row: MAX splits the gradient among them, as jnp
    x[1, 1] = x[1, 0]
    _check('sequence_pool', {'X': x, 'Length': length}, {'pooltype': ptype},
           ['Out'], exact=ptype in ('MAX', 'LAST', 'FIRST'))


@pytest.mark.parametrize('shape', [(5, 7), (5, 7, 1)])
def test_sequence_softmax_matches_the_jax_op(shape):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype('float32')
    length = np.array([7, 3, 1, 5, 6], 'int32')
    _check('sequence_softmax', {'X': x, 'Length': length}, {}, ['Out'],
           exact=False)


@pytest.mark.parametrize('start', [None, 0, -2])
@pytest.mark.parametrize('ctx_len', [3, 4])
def test_sequence_conv_matches_the_jax_op(start, ctx_len):
    x, length = _ragged(seed=2)
    w = np.random.RandomState(3).randn(ctx_len * 3, 4).astype('float32')
    attrs = {'contextLength': ctx_len}
    if start is not None:
        attrs['contextStart'] = start
    _check('sequence_conv', {'X': x, 'Filter': w, 'Length': length}, attrs,
           ['Out'], exact=False)


def _lstm_ins(D=4, B=5, T=7, peep=True, seed=4, h0=False):
    rng = np.random.RandomState(seed)
    ins = {'Input': rng.randn(B, T, 4 * D).astype('float32'),
           'Weight': (rng.randn(D, 4 * D) * 0.5).astype('float32'),
           'Bias': (rng.randn(1, (7 if peep else 4) * D) * 0.5)
           .astype('float32'),
           'Length': rng.randint(1, T + 1, B).astype('int32')}
    if h0:
        ins['H0'] = rng.randn(B, D).astype('float32')
        ins['C0'] = rng.randn(B, D).astype('float32')
    return ins


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('peep', [False, True])
def test_lstm_matches_the_jax_op(peep, reverse):
    _check('lstm', _lstm_ins(peep=peep), {'use_peepholes': peep,
                                           'is_reverse': reverse},
           ['Hidden', 'Cell'], exact=False)


@pytest.mark.parametrize('acts', [('sigmoid', 'tanh', 'tanh'),
                                  ('hard_sigmoid', 'relu', 'identity')])
def test_lstm_activations_and_initial_state_match_the_jax_op(acts):
    _check('lstm', _lstm_ins(h0=True, seed=5),
           {'gate_activation': acts[0], 'cell_activation': acts[1],
            'candidate_activation': acts[2]}, ['Hidden', 'Cell'],
           exact=False)


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('h0', [False, True])
def test_gru_matches_the_jax_op(reverse, h0):
    rng = np.random.RandomState(6)
    D, B, T = 4, 5, 7
    ins = {'Input': rng.randn(B, T, 3 * D).astype('float32'),
           'Weight': (rng.randn(D, 3 * D) * 0.5).astype('float32'),
           'Bias': (rng.randn(1, 3 * D) * 0.5).astype('float32'),
           'Length': rng.randint(1, T + 1, B).astype('int32')}
    if h0:
        ins['H0'] = rng.randn(B, D).astype('float32')
    _check('gru', ins, {'is_reverse': reverse}, ['Hidden'], exact=False)


def test_gru_unit_and_lstm_unit_match_the_jax_ops():
    rng = np.random.RandomState(7)
    D, B = 4, 5
    _check('gru_unit', {
        'Input': rng.randn(B, 3 * D).astype('float32'),
        'HiddenPrev': rng.randn(B, D).astype('float32'),
        'Weight': (rng.randn(D, 3 * D) * 0.5).astype('float32'),
        'Bias': rng.randn(1, 3 * D).astype('float32')},
        {'gate_activation': 1, 'activation': 2},
        ['Hidden', 'Gate', 'ResetHiddenPrev'], exact=False)
    _check('lstm_unit', {'X': rng.randn(B, 4 * D).astype('float32'),
                         'C_prev': rng.randn(B, D).astype('float32')},
           {'forget_bias': 0.5}, ['C', 'H'], exact=False)


def test_cos_sim_matches_the_jax_op():
    rng = np.random.RandomState(8)
    x, y = (rng.randn(6, 5).astype('float32') for _ in range(2))
    y[2] = 0.0      # a zero row: the 1e-12 keeps it finite
    _check('cos_sim', {'X': x, 'Y': y}, {}, ['Out', 'XNorm', 'YNorm'],
           exact=False)


def test_the_other_sequence_ops_match_the_jax_ops():
    x, length = _ragged(seed=10)
    rng = np.random.RandomState(11)
    ids = rng.randint(0, 4, (5, 7, 1)).astype('int32')
    cases = [
        ('sequence_reverse', {'X': x, 'Length': length}, {}, ['Y']),
        ('sequence_expand', {'X': x[:, 0], 'Y': x}, {}, ['Out']),
        ('sequence_expand_as', {'X': x[:, 0], 'Y': x}, {}, ['Out']),
        ('sequence_pad', {'X': x, 'Length': length}, {}, ['Out', 'Length']),
        ('sequence_unpad', {'X': x, 'Length': length.astype('int64')}, {},
         ['Out', 'OutLength']),
        ('sequence_mask', {'X': length}, {'maxlen': 9, 'out_dtype': 'int32'},
         ['Y']),
        ('sequence_slice', {'X': x, 'Offset': np.array([0, 1, 2, 0, 6]),
                            'Length': np.array([3, 2, 9, 0, 4]),
                            'XLength': length}, {}, ['Out', 'OutLength']),
        ('sequence_concat', {'X': [x, x[:, :3] * 2],
                             'Length': [length, np.array([1, 3, 0, 2, 3],
                                                         'int32')]}, {},
         ['Out', 'OutLength']),
        ('sequence_enumerate', {'X': ids}, {'win_size': 3, 'pad_value': 9},
         ['Out']),
        ('sequence_reshape', {'X': x[:, :6].copy(), 'Length': length},
         {'new_dim': 6}, ['Out', 'OutLength']),
        ('sequence_scatter', {'X': x[:, :, 0].copy(), 'Ids': ids,
                              'Updates': rng.randn(5, 7, 1)
                              .astype('float32')}, {}, ['Out']),
        ('sequence_erase', {'X': ids, 'Length': length},
         {'tokens': [0, 2]}, ['Out', 'OutLength']),
    ]
    for op_type, ins, attrs, slots in cases:
        to, jo, tg, jg = _both(op_type, ins, attrs, slots)
        for s in slots:
            _close(to[s], jo[s], True, '%s %s' % (op_type, s))
        for a, b in zip(tg, jg):
            _close(a, b, 'expand' not in op_type, 'd ' + op_type)


# ------------------------------------------------------------- LoD feeds

def test_lod_tensor_is_the_references():
    rows = [np.arange(3), np.arange(5) + 10, np.arange(1)]
    a = jf.create_lod_tensor(rows)
    b = tf.create_lod_tensor(rows)
    assert np.array_equal(a.padded, b.padded)
    assert np.array_equal(a.lengths, b.lengths)
    assert a.lod() == b.lod()
    packed = np.arange(6).reshape(6, 1)
    a = jf.create_lod_tensor(packed, [[2, 1], [1, 2, 3]])
    b = tf.create_lod_tensor(packed, [[2, 1], [1, 2, 3]])
    assert a.recursive_sequence_lengths() == b.recursive_sequence_lengths()
    assert np.array_equal(a.padded, b.padded)


@pytest.mark.parametrize('level', [1, 2])
def test_lod_data_declares_the_reference_vars(level):
    vs = []
    for fluid in (jf, tf):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data('w', shape=[1], dtype='int64',
                                  lod_level=level)
        vs.append(sorted((n, tuple(v.shape), v.dtype, v.lod_level)
                         for n, v in main.global_block().vars.items()))
        assert x.lod_length_name == 'w@LENGTH'
    assert vs[0] == vs[1]


def _pool_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[2], dtype='float32', lod_level=1)
        h = fluid.layers.fc(x, 3)
        out = fluid.layers.sequence_pool(h, 'sum')
    return main, startup, x, h, out


def test_a_lod_feed_and_a_dense_feed_run_through_the_executor():
    main, startup, x, h, out = _pool_program(tf)
    # fc on a lod input flattens two dims: the weight applies per token
    assert [op.attrs.get('x_num_col_dims') for op in
            main.global_block().ops if op.type == 'mul'] == [2]
    assert h.lod_level == 1 and h.lod_length_name == 'x@LENGTH'
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup)
    rng = np.random.RandomState(12)
    rows = [rng.randn(n, 2).astype('float32') for n in (3, 1, 4)]
    got, = exe.run(main, feed={'x': tf.create_lod_tensor(rows)},
                   fetch_list=[out])
    w = tf.global_scope().vars[main.all_parameters()[0].name].numpy()
    b = tf.global_scope().vars[main.all_parameters()[1].name].numpy()
    want = np.stack([(r @ w + b).sum(0) for r in rows])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # a dense array fed into the lod var counts every step
    dense = rng.randn(2, 3, 2).astype('float32')
    got, = exe.run(main, feed={'x': dense}, fetch_list=[out])
    np.testing.assert_allclose(got, (dense @ w + b).sum(1), rtol=1e-5,
                               atol=1e-6)


def test_run_steps_takes_lod_feeds():
    main, startup, _, _, out = _pool_program(tf)
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup)
    rng = np.random.RandomState(13)
    feeds = [{'x': tf.create_lod_tensor(
        [rng.randn(n, 2).astype('float32') for n in ns], max_len=4)}
        for ns in ((3, 1), (4, 2))]
    got = exe.run_steps(main, feed_list=feeds, fetch_list=[out])[0]
    for i, f in enumerate(feeds):
        want, = exe.run(main, feed=f, fetch_list=[out])
        assert np.array_equal(got[i], want)


def test_clone_keeps_the_lengths_companion():
    main, _, x, _, _ = _pool_program(tf)
    test = main.clone(for_test=True)
    assert test.global_block().var('x').lod_length_name == 'x@LENGTH'
    assert [op.inputs.get('Length') for op in test.global_block().ops
            if op.type == 'sequence_pool'] == [['x@LENGTH']]


def test_feed_bucketer_pads_the_sequence_dim_as_the_reference():
    from paddle_tpu.data_feeder import FeedBucketer as JB
    rng = np.random.RandomState(14)
    rows = [rng.randint(0, 9, (n, 1)) for n in (5, 2, 7)]
    dense = rng.randn(3, 5).astype('float32')
    outs = []
    for fluid, B in ((jf, JB), (tf, tf.FeedBucketer)):
        b = B(boundaries=[1, 2, 4, 8], seq_names=('w', 'd'))
        out, n = b.bucket_feed({'w': fluid.create_lod_tensor(rows),
                                'd': dense, 'y': np.arange(3)})
        assert n == 3
        outs.append(out)
    (a, b) = outs
    assert np.array_equal(a['w'].padded, b['w'].padded)
    assert b['w'].padded.shape == (4, 8, 1)
    # pad rows repeat the last row's length: never zero
    assert np.array_equal(a['w'].lengths, b['w'].lengths)
    assert b['w'].lengths.tolist() == [5, 2, 7, 7]
    for k in ('d', 'y'):
        assert np.array_equal(a[k], b[k])


def test_data_feeder_turns_ragged_slots_into_lod_tensors():
    feeds = []
    for fluid in (jf, tf):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            w = fluid.layers.data('w', shape=[1], dtype='int64',
                                  lod_level=1)
            y = fluid.layers.data('y', shape=[1], dtype='int64')
        feeder = fluid.DataFeeder([w, y], program=main)
        feeds.append(feeder.feed([([1, 2, 3], 0), ([4], 1), ([5, 6], 1)]))
    a, b = feeds
    assert isinstance(b['w'], tf.LoDTensor)
    assert np.array_equal(a['w'].padded, b['w'].padded)
    assert np.array_equal(a['w'].lengths, b['w'].lengths)
    assert np.array_equal(a['y'], b['y'])


def test_a_saved_lod_program_runs_in_the_predictor(tmp_path):
    from paddle_tpu_torch.models import stacked_lstm
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        out = stacked_lstm.build(dict_dim=30, emb_dim=4, hid_dim=4,
                                 is_train=False)
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup)
    rng = np.random.RandomState(15)
    feed = {'words': tf.create_lod_tensor(
        [rng.randint(0, 30, (n, 1)) for n in (4, 1, 6)])}
    want, = exe.run(main, feed=feed, fetch_list=[out['predict']])
    tf.io.save_inference_model(str(tmp_path), ['words'], [out['predict']],
                               exe, main_program=main)
    cfg = tf.inference.AnalysisConfig(str(tmp_path))
    cfg.disable_gpu()
    pred = tf.inference.Predictor(cfg)
    loaded = pred._program.global_block()
    assert loaded.var('words').lod_length_name == 'words@LENGTH'
    assert all(op.inputs.get('Length') == ['words@LENGTH']
               for op in loaded.ops if op.type == 'lstm')
    got, = pred.run(feed)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_the_lstm_weights_carry_across_in_the_reference_layout():
    """scope_from_numpy carries the [D, 4D] weight and the [1, 4D] / [1,
    7D] bias as they are: the port keeps the reference's gate layout [i,
    f, g, o] and its peephole tail, so no permutation."""
    for peep in (False, True):
        shapes = []
        for fluid in (jf, tf):
            main = fluid.Program()
            with fluid.program_guard(main, fluid.Program()), \
                    fluid.unique_name.guard():
                x = fluid.layers.data('x', shape=[8], dtype='float32',
                                      lod_level=1)
                fluid.layers.dynamic_lstm(x, 8, use_peepholes=peep)
            shapes.append([(p.name, tuple(p.shape))
                           for p in main.all_parameters()])
        assert shapes[0] == shapes[1]
        assert [s for _, s in shapes[1]] == [(2, 8), (1, 14 if peep else 8)]
    rng = np.random.RandomState(16)
    arrays = {'w': rng.randn(2, 8).astype('float32'),
              'b': rng.randn(1, 14).astype('float32')}
    scope = tf.scope_from_numpy(arrays, tf.Scope(), 'cpu')
    for k, v in arrays.items():
        assert np.array_equal(scope.vars[k].numpy(), v)
