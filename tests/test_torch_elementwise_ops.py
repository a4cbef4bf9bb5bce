"""The elementwise family of ops/math.py on the CPU against the JAX package:
mod and floordiv, the comparisons and logical ops, the unary and
activation ops, cumsum; `Variable`'s comparisons; the wrappers of
layers/ops.py; and each op's kernel rule (ops/kernelgen/rules.py) planned
for the card, bool values inside a generated kernel included.

Inputs: a fixed set of special values (NaN, +-inf, +-0, +-0.5, halves,
1e-30, +-100, the activations' thresholds) and normal values from a seed,
the binary ops on every pair of specials.  Tolerances, each with its
reason:
- exact ops (abs, ceil, floor, round, reciprocal, softsign, the
  clip-shaped activations, leaky_relu, hard_sigmoid, the shrinks,
  thresholded_relu, mod, floordiv, the comparisons and logical ops):
  equal bit for bit, the sign of a zero included, NaN where NaN;
- the transcendental ops (XLA's own exp, tanh, erf, log, sin, cos and
  pow polynomials against libm's, each within a few float32 units):
  within 2^-20 (8 units) of the reference's magnitude, plus 2^-20 of the
  O(1) term the op adds to or subtracts from a transcendental value (exp
  minus 1 in elu and selu, log1p(exp) beside max(x, 0) in softplus,
  logsigmoid and soft_relu, x - tanh(x) in tanh_shrink), where that
  difference cancels;
- everywhere: a result below float32's smallest normal compares as 0 (XLA
  on the CPU flushes subnormals);
- bfloat16 (the one-operation ops): within 2 bf16 units (2^-7) of the
  reference's magnitude: both compute in float32 and round once, from
  implementations a unit or so apart.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.core import registry as jreg
from paddle_tpu.layers import ops as jops
import paddle_tpu_torch as tf
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.layers import ops as tops
from paddle_tpu_torch.ops import kernelgen as tkg
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)


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
    tkg.clear_plan_cache()
    yield
    framework.switch_main_program(old_main)
    framework.switch_startup_program(old_startup)
    unique_name.switch(old_gen)
    executor._global_scope = old_scope


SPECIALS = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 0.5, -0.5, 1.5,
                     -2.5, 2.5, 1e-30, -1e-30, 100.0, -100.0, 6.0, -1.0,
                     1.0, 3.0, -3.0, 0.25, 0.7, -0.7], np.float32)
_N = SPECIALS.size
_RNG = np.random.RandomState(19)
NORMAL = (_RNG.randn(400) * 3).astype(np.float32)
X = np.concatenate([np.repeat(SPECIALS, _N), NORMAL])
Y = np.concatenate([np.tile(SPECIALS, _N), (_RNG.randn(400) * 3).astype(
    np.float32)])
# equal operands for the comparisons
Y[-100:] = X[-100:]
TINY = np.finfo(np.float32).tiny

EXACT_UNARY = {
    'abs': {}, 'ceil': {}, 'floor': {}, 'round': {}, 'reciprocal': {},
    'softsign': {}, 'relu6': {}, 'relu6_t3': ('relu6', {'threshold': 3.0}),
    'leaky_relu': {'alpha': 0.1}, 'brelu': {'t_min': -1.0, 't_max': 6.0},
    'brelu_zero': ('brelu', {}), 'hard_sigmoid': {},
    'thresholded_relu': {'threshold': 0.5}, 'hard_shrink': {},
    'softshrink': {'lambda': 0.7}, 'logical_not': {},
}
# op -> (attrs, the O(1) term beside the transcendental value, from x)
TRANSCENDENTAL = {
    'sigmoid': ({}, None), 'tanh': ({}, None), 'exp': ({}, None),
    'log': ({}, None), 'rsqrt': ({}, None), 'cos': ({}, None),
    'sin': ({}, None), 'erf': ({}, None), 'stanh': ({}, None),
    'pow': ({'factor': 1.7}, None), 'pow_sqrt': ({'factor': 0.5}, None),
    'pow_rsqrt': ({'factor': -0.5}, None), 'pow_cube': ({'factor': 3.0},
                                                         None),
    'pow_square': ({'factor': 2.0}, None),
    'tanh_shrink': ({}, np.abs),
    'softplus': ({}, lambda x: 1.0), 'logsigmoid': ({}, lambda x: 1.0),
    'soft_relu': ({'threshold': 20.0}, lambda x: 1.0),
    'elu': ({'alpha': 0.7}, lambda x: 0.7),
    'selu': ({}, lambda x: 1.0507009873554805 * 1.6732632423543772),
}
BINARY = ('elementwise_mod', 'elementwise_floordiv', 'less_than',
          'less_equal', 'greater_than', 'greater_equal', 'equal',
          'not_equal', 'logical_and', 'logical_or', 'logical_xor')


def _op(name):
    return name.split('_t3')[0] if name.startswith('relu6') else \
        {'brelu_zero': 'brelu', 'pow_sqrt': 'pow', 'pow_rsqrt': 'pow',
         'pow_cube': 'pow', 'pow_square': 'pow'}.get(name, name)


def _run(op, ins, attrs, dtype=None):
    jins = {k: jnp.asarray(v, dtype and jnp.bfloat16) for k, v in
            ins.items()}
    tins = {k: torch.from_numpy(np.array(v)) for k, v in ins.items()}
    if dtype:
        tins = {k: v.to(torch.bfloat16) for k, v in tins.items()}
    want = jreg.get_op(op).impl(None, jins, attrs)['Out']
    got = treg.get_op(op)(None, tins, attrs)['Out']
    if dtype:
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        return got.float().numpy(), np.asarray(want.astype(jnp.float32))
    return got.numpy(), np.asarray(want)


def _flush(a):
    return np.where(np.abs(a) < TINY, np.copysign(np.float32(0), a), a) \
        if a.dtype.kind == 'f' else a


def _assert_same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    got, want = _flush(got), _flush(want)
    if got.dtype.kind != 'f':
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    same = (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), (what, X[~same][:8], got[~same][:8], want[~same][:8])


@pytest.mark.parametrize('name', sorted(EXACT_UNARY))
def test_exact_unary_op_matches_the_reference(name):
    attrs = EXACT_UNARY[name]
    if isinstance(attrs, tuple):
        _, attrs = attrs
    got, want = _run(_op(name), {'X': X}, attrs)
    _assert_same(got, want, name)


@pytest.mark.parametrize('name', sorted(TRANSCENDENTAL))
def test_transcendental_op_matches_the_reference(name):
    attrs, term = TRANSCENDENTAL[name]
    got, want = _run(_op(name), {'X': X}, attrs)
    got, want = _flush(got), _flush(want)
    assert got.dtype == want.dtype == np.float32
    # the same non-finite values (NaN, +-inf) at the same places, and a
    # zero's sign where both are zero
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin & ~np.isnan(want)],
                          want[~fin & ~np.isnan(want)]), name
    zero = (got == 0) & (want == 0)
    assert np.array_equal(np.signbit(got[zero]), np.signbit(want[zero])), \
        name
    c = np.abs(want[fin])
    if term is not None:
        c = c + np.broadcast_to(term(np.abs(X[fin])), c.shape)
    err = np.abs(got[fin] - want[fin])
    assert (err <= 2.0 ** -20 * c).all(), (name, X[fin][err > 2.0 ** -20 * c]
                                           [:8])


@pytest.mark.parametrize('op', BINARY)
def test_binary_op_matches_the_reference(op):
    got, want = _run(op, {'X': X, 'Y': Y}, {'axis': -1})
    _assert_same(got, want, op)
    if op not in ('elementwise_mod', 'elementwise_floordiv'):
        assert got.dtype == np.bool_


@pytest.mark.parametrize('op', ['elementwise_mod', 'elementwise_floordiv'])
def test_integer_mod_and_floordiv_by_negative_and_zero_divisors(op):
    x = np.repeat(np.array([7, -7, 0, 5, -5, 6, -6, 2 ** 31 - 1], np.int32),
                  5)
    y = np.tile(np.array([0, -2, 2, 3, -3], np.int32), 8)
    got, want = _run(op, {'X': x, 'Y': y}, {})
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_compare_broadcasts_y_by_axis():
    x = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    y = np.random.RandomState(2).randn(3).astype(np.float32)
    for op in ('less_than', 'greater_equal', 'not_equal'):
        got, want = _run(op, {'X': x, 'Y': y}, {'axis': 1})
        np.testing.assert_array_equal(got, want)


BF16_OPS = ('sigmoid', 'tanh', 'exp', 'log', 'rsqrt', 'cos', 'sin', 'erf',
            'reciprocal', 'abs', 'ceil', 'floor', 'round')


@pytest.mark.parametrize('op', BF16_OPS)
def test_bfloat16_op_is_within_two_bf16_units(op):
    x = NORMAL if op not in ('log', 'rsqrt') else np.abs(NORMAL) + 0.1
    got, want = _run(op, {'X': x}, {}, dtype='bfloat16')
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want)), op


@pytest.mark.parametrize('attrs', [{}, {'axis': 0}, {'exclusive': True},
                                   {'reverse': True, 'axis': 1},
                                   {'exclusive': True, 'reverse': True}])
@pytest.mark.parametrize('dtype', ['float32', 'int32'])
def test_cumsum_matches_the_reference(attrs, dtype):
    x = (np.random.RandomState(3).randn(4, 5) * 10).astype(dtype)
    got, want = _run('cumsum', {'X': x}, attrs)
    assert got.dtype == want.dtype
    # float32 sums in sequence in both
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# ------------------------------------------------- Variable comparisons

def _compare_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[6], dtype='float32')
        y = fluid.layers.data(name='y', shape=[6], dtype='float32')
        outs = [x < y, x <= 0.5, x > y, x >= -1.0]
    return main, outs


def test_variable_comparisons_match_the_reference():
    """`<`, `<=`, `>`, `>=` append less_than, less_equal, greater_than,
    greater_equal (a scalar as a [1] fill_constant in x's dtype), with a
    bool output, as the reference's Variable does; run, the outputs are
    equal."""
    jm, jouts = _compare_program(jf)
    tm, touts = _compare_program(tf)
    jd = json.loads(json.dumps(jf.io.program_to_desc(jm)))
    td = json.loads(json.dumps(tf.io.program_to_desc(tm)))
    for d in (jd, td):
        for op in d['blocks'][0]['ops']:
            op.pop('source_loc', None)
    assert td == jd
    assert [v.dtype for v in touts] == ['bool'] * 4
    assert [op.type for op in tm.global_block().ops] == [
        'less_than', 'fill_constant', 'less_equal', 'greater_than',
        'fill_constant', 'greater_equal']
    rng = np.random.RandomState(4)
    feed = {'x': rng.randn(3, 6).astype('float32'),
            'y': rng.randn(3, 6).astype('float32')}
    feed['x'][0, :3] = [0.5, -1.0, np.nan]
    feed['y'][1] = feed['x'][1]
    want = jf.Executor().run(jm, feed=feed, fetch_list=jouts)
    got = tf.Executor(tf.CPUPlace()).run(tm, feed=feed, fetch_list=touts)
    for g, w in zip(got, want):
        assert g.dtype == np.bool_
        np.testing.assert_array_equal(g, np.asarray(w))


# --------------------------------------------------- layers/ops.py names

def test_layers_ops_has_every_reference_name():
    assert tops.__all__ == jops.__all__


@pytest.mark.parametrize('name', sorted(jops.__all__))
def test_layers_ops_wrapper_builds_the_reference_op(name):
    def build(fluid, ops):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name='x', shape=[5], dtype='float32')
            if name == 'uniform_random':
                ops.uniform_random([2, 3], min=-2.0, max=2.0, seed=3)
            elif name == 'cumsum':
                ops.cumsum(x, axis=1, exclusive=True)
            else:
                getattr(ops, name)(x)
        d = json.loads(json.dumps(fluid.io.program_to_desc(main)))
        ops_ = d['blocks'][0]['ops']
        for op in ops_:
            op.pop('source_loc', None)
        return ops_
    assert build(tf, tops) == build(jf, jops)


# ------------------------------------------------------ the kernel rules

def _sub(type, inputs, outputs, attrs=None):
    return {'type': type, 'inputs': {k: list(v) for k, v in inputs.items()},
            'outputs': {k: list(v) for k, v in outputs.items()},
            'input_is_list': {k: False for k in inputs},
            'output_is_list': {k: False for k in outputs},
            'attrs': dict(attrs or {}), 'stop_grad': []}


def _attrs(subs, args, outs):
    return {'sub_ops': subs, 'arg_names': list(args),
            'out_names': list(outs), 'fused_count': len(subs)}


RULE_OPS = sorted(set(_op(n) for n in list(EXACT_UNARY) +
                      list(TRANSCENDENTAL)) | set(BINARY))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('op', RULE_OPS)
def test_rule_plans_one_generated_kernel(op, dtype):
    """Every new rule plans for the card as one generated kernel, its
    output in the plain op's dtype (bool for the comparisons and logical
    ops, stored as one byte)."""
    ins = {'X': ['x'], 'Y': ['y']} if op in BINARY else {'X': ['x']}
    attrs = {'factor': 1.7} if op == 'pow' else {}
    fa = _attrs([_sub(op, ins, {'Out': ['o']}, attrs)],
                [v[0] for v in ins.values()], ['o'])
    plan = tkg.plan_for(fa, tuple(((3, 8), dtype) for _ in ins), False)
    assert [s[0] for s in plan.steps] == ['kernel']
    spec = plan.steps[0][1]
    want = treg.get_op(op)(None, {k: torch.zeros(3, 8, dtype=getattr(
        torch, dtype)) for k in ins}, attrs)['Out'].dtype
    assert spec.esc_aval[0][1] == str(want).split('.')[1]
    src = tkg.generated_source([spec.name])
    assert '// %s' % op in src
    if want == torch.bool:
        assert 'bool* __restrict__' in src


@pytest.mark.parametrize('op', ['elementwise_mod', 'elementwise_floordiv',
                                'less_than', 'equal', 'abs'])
def test_integer_rules_plan(op):
    ins = {'X': ['x'], 'Y': ['y']} if op != 'abs' else {'X': ['x']}
    fa = _attrs([_sub(op, ins, {'Out': ['o']})], list(
        v[0] for v in ins.values()), ['o'])
    plan = tkg.plan_for(fa, tuple(((16,), 'int32') for _ in ins), False)
    assert plan.n_kernels == 1


BOOL_CHAINS = {
    # piecewise_decay's indicator: a bool in registers, cast to float
    'less_than_cast': [
        _sub('less_than', {'X': ['x'], 'Y': ['y']}, {'Out': ['b']}),
        _sub('cast', {'X': ['b']}, {'Out': ['o']}, {'out_dtype': 'float32'})],
    'logical_chain': [
        _sub('greater_than', {'X': ['x'], 'Y': ['y']}, {'Out': ['a']}),
        _sub('not_equal', {'X': ['x'], 'Y': ['y']}, {'Out': ['b']}),
        _sub('logical_and', {'X': ['a'], 'Y': ['b']}, {'Out': ['c']}),
        _sub('logical_not', {'X': ['c']}, {'Out': ['d']}),
        _sub('cast', {'X': ['d']}, {'Out': ['i']}, {'out_dtype': 'int32'}),
        _sub('cast', {'X': ['a']}, {'Out': ['o']}, {'out_dtype': 'float32'}),
        _sub('elementwise_mul', {'X': ['o'], 'Y': ['x']}, {'Out': ['p']})],
    'float_to_bool_back': [
        _sub('elementwise_floordiv', {'X': ['x'], 'Y': ['y']},
             {'Out': ['f']}),
        _sub('cast', {'X': ['f']}, {'Out': ['b']}, {'out_dtype': 'bool'}),
        _sub('logical_xor', {'X': ['b'], 'Y': ['x']}, {'Out': ['o']})],
}


@pytest.mark.parametrize('name', sorted(BOOL_CHAINS))
def test_bool_intermediates_stay_in_one_kernel(name):
    """A chain through bool values plans as ONE kernel whose bools live in
    registers; its plain replay (the CPU's run) equals the JAX package's
    fused replay bit for bit."""
    from paddle_tpu.ops import fused as jfused
    from paddle_tpu_torch.ops import fused as tfused
    subs = BOOL_CHAINS[name]
    outs = [subs[-1]['outputs']['Out'][0]]
    if name == 'logical_chain':
        outs.append('i')
    fa = _attrs(subs, ['x', 'y'], outs)
    plan = tkg.plan_for(fa, (((_N * _N + 400,), 'float32'),) * 2, False)
    assert plan.n_kernels == 1 and [s[0] for s in plan.steps] == ['kernel']
    src = tkg.generated_source([plan.steps[0][1].name])
    assert 'bool R' in src          # a bool register

    class _Ctx(object):
        amp = False
    want = jfused.fused_elementwise(_Ctx(), {'X': [jnp.asarray(X),
                                                   jnp.asarray(Y)]},
                                    fa)['Out']
    ectx = treg.ExecCtx('cpu', 11, 0)
    ctx = ectx.for_op(0, tf.Program().global_block().append_op(
        'fused_elementwise', infer_shape=False))
    got = tfused.fused_elementwise(ctx, {'X': [torch.from_numpy(X),
                                               torch.from_numpy(Y)]},
                                   fa)['Out']
    for g, w in zip(got, want):
        _assert_same(g.numpy(), np.asarray(w), name)
