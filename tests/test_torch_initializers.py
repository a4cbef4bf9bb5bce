"""The port's initializers against the JAX package's: TruncatedNormal,
MSRA, Bilinear and NumpyArray (and the `truncated_gaussian_random` op).

The startup programs are the reference's (op types and attributes).
Torch's draws cannot equal threefry's, so the random ones are held to
their statistics: every truncated draw within mean +- 2 std, the sample
mean within 5 standard errors of `mean`, the sample std within 2% of the
truncated normal's (0.87962 std), the reference's draws alike; MSRA's
bounds and spread from its fan-in.  Bilinear and NumpyArray are exact."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tf
from paddle_tpu_torch.core.registry import ExecCtx, get_op
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

# the std of a standard normal truncated to [-2, 2]
TRUNC_STD = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi) /
                      math.erf(2 / math.sqrt(2)))


def _startup(fluid, make, shape, name='w'):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fluid.layers.create_parameter(shape, 'float32', name=name,
                                      default_initializer=make(fluid))
    return startup


def _ops(prog):
    return [(op.type, {k: v for k, v in op.attrs.items() if k != 'op_role'})
            for op in prog.global_block().ops]


def _run_port(startup, name='w'):
    scope = tf.Scope()
    with tf.scope_guard(scope):
        tf.Executor(tf.CPUPlace()).run(startup)
    return scope.vars[name].numpy()


def _run_jax(startup, name='w'):
    import paddle_tpu as jf
    scope = jf.Scope()
    with jf.scope_guard(scope):
        jf.Executor().run(startup)
    return np.asarray(scope.vars[name])


INITS = {
    'truncated_normal': lambda f: f.initializer.TruncatedNormal(
        loc=0.5, scale=2.0),
    'truncated_normal_seeded': lambda f: f.initializer.TruncatedNormal(
        scale=0.1, seed=11),
    'msra_uniform': lambda f: f.initializer.MSRA(),
    'msra_normal': lambda f: f.initializer.MSRA(uniform=False),
    'msra_fan_in': lambda f: f.initializer.MSRA(uniform=False, fan_in=50),
    'bilinear': lambda f: f.initializer.Bilinear(),
    'numpy_array': lambda f: f.initializer.NumpyArrayInitializer(
        np.arange(4 * 3 * 3 * 3, dtype='float32').reshape(4, 3, 3, 3) / 7),
}


@pytest.mark.parametrize('name', sorted(INITS))
def test_startup_program_is_the_references(name):
    import paddle_tpu as jf
    shape = [4, 3, 3, 3]
    assert _ops(_startup(tf, INITS[name], shape)) == \
        _ops(_startup(jf, INITS[name], shape))


def test_exports_are_the_references():
    import paddle_tpu as jf
    for n in ('TruncatedNormal', 'MSRA', 'Bilinear', 'NumpyArrayInitializer',
              'TruncatedNormalInitializer', 'MSRAInitializer',
              'BilinearInitializer'):
        assert n in tf.initializer.__all__
        assert getattr(tf.initializer, n).__name__ == \
            getattr(jf.initializer, n).__name__


@pytest.mark.parametrize('name', ['bilinear', 'numpy_array'])
def test_exact_initializers_equal_the_references(name):
    import paddle_tpu as jf
    shape = [4, 3, 3, 3] if name == 'numpy_array' else [3, 3, 4, 4]
    got = _run_port(_startup(tf, INITS[name], shape))
    want = _run_jax(_startup(jf, INITS[name], shape))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _truncated_stats(x, mean, std):
    n = x.size
    assert (x >= mean - 2 * std - 1e-6 * std).all()
    assert (x <= mean + 2 * std + 1e-6 * std).all()
    se = TRUNC_STD * std / math.sqrt(n)
    assert abs(x.mean() - mean) < 5 * se, (x.mean(), mean, se)
    assert abs(x.std() / (TRUNC_STD * std) - 1) < 0.02, x.std()


def test_truncated_normal_draws_hold_the_statistics():
    import paddle_tpu as jf
    shape = [256, 256]
    got = _run_port(_startup(tf, INITS['truncated_normal'], shape))
    want = _run_jax(_startup(jf, INITS['truncated_normal'], shape))
    for x in (got, want):
        _truncated_stats(x.astype('float64'), 0.5, 2.0)


def test_truncated_gaussian_random_op_by_its_attributes():
    """The op: its dtype, shape, the same draws from one seed, others from
    another, and the statistics at a bf16 dtype too."""
    op = get_op('truncated_gaussian_random')
    ctx = ExecCtx('cpu', 3, 0).for_op(0, tf.Program().global_block()
                                      .append_op('truncated_gaussian_random',
                                                 infer_shape=False))
    attrs = {'shape': [300, 200], 'mean': -1.0, 'std': 0.5, 'seed': 5,
             'dtype': 'float32'}
    a = op(ctx, {}, attrs)['Out']
    b = op(ctx, {}, attrs)['Out']
    c = op(ctx, {}, dict(attrs, seed=6))['Out']
    assert a.shape == (300, 200) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    _truncated_stats(a.double().numpy(), -1.0, 0.5)
    h = op(ctx, {}, dict(attrs, dtype='bfloat16'))['Out']
    assert h.dtype == torch.bfloat16
    _truncated_stats(h.double().numpy(), -1.0, 0.5 * 1.01)


@pytest.mark.parametrize('uniform', [True, False])
def test_msra_draws_follow_the_fan_in(uniform):
    import paddle_tpu as jf
    shape = [64, 32, 3, 3]          # fan_in 32 * 9
    make = INITS['msra_uniform' if uniform else 'msra_normal']
    fan_in = 32 * 9
    for x in (_run_port(_startup(tf, make, shape)),
              _run_jax(_startup(jf, make, shape))):
        x = x.astype('float64')
        if uniform:
            limit = math.sqrt(6.0 / fan_in)
            assert np.abs(x).max() <= limit * (1 + 1e-6)
            assert abs(x.std() / (limit / math.sqrt(3)) - 1) < 0.02
        else:
            assert abs(x.std() / math.sqrt(2.0 / fan_in) - 1) < 0.02


def test_a_fused_startup_draws_truncated_normals(monkeypatch):
    """Through the PT_OPT passes the draw is a fusable op with its rule
    (a whole-op draw), and the parameters come out as with PT_OPT=0."""
    from paddle_tpu_torch.ops import kernelgen
    assert kernelgen.KERNEL_RULES['truncated_gaussian_random'].kind == 'rng'
    outs = {}
    for opt in ('0', '1'):
        monkeypatch.setenv('PT_OPT', opt)
        outs[opt] = _run_port(_startup(tf, INITS['truncated_normal_seeded'],
                                       [300, 200]))
    assert np.array_equal(outs['0'], outs['1'])
    _truncated_stats(outs['1'].astype('float64'), 0.0, 0.1)
