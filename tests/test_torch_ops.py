"""The port's op implementations against the JAX package's, op by op, on
the same numpy inputs: the ops the llama serving program runs, plus the
startup initializers and the dtype narrowing.

Tolerance: exact for data movement (reshape, slice, ...); rtol/atol 1e-5
in float32 where both sides compute (they sum and evaluate
transcendentals in other orders), plus, for rope at large positions, the
slack that one float32 ulp of its frequencies and angles allows
(_rope_angle_slack)."""
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.dtypes import dtype_str, torch_dtype
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

TOL = dict(rtol=1e-5, atol=1e-5)
_JCTX = types.SimpleNamespace(mesh=None)


def _run_both(op, ins, attrs, slot='Out'):
    jout = jreg.get_op(op).impl(
        _JCTX, {k: jnp.asarray(v) for k, v in ins.items()}, attrs)[slot]
    tout = treg.get_op(op)(
        None, {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in ins.items()}, attrs)[slot]
    return np.asarray(jout), tout.numpy()


def _rope_angle_slack(x, theta):
    """Per element of rope's output on x [B, H, T, D] at positions 0..T-1:
    the |difference| that one float32 ulp of freq_i and one of the angle
    allow, where one ulp of the largest angle can reach atol; else 0.

    Both sides compute freq_i = theta ** (-2i / D) and ang = pos * freq_i
    in float32 in the same order, but pow, cos and sin are each library's
    own routine (XLA's against ATen's), and neither is correctly rounded:
    freq_i may come out one ulp apart.  That moves ang = fl(pos freq_i) by
    up to pos ulp(freq_i), and the product's rounding may then land one
    ulp of ang away: |d ang| <= pos ulp(freq_i) + ulp(ang).  Rotating the
    pair (x1, x2) by an angle d ang further moves each output by at most
    |d ang| sqrt(x1^2 + x2^2).  At T = 512 (ang up to 511 rad, whose ulp is
    3.05e-5) that is up to 1.5e-4, past the 1e-5 atol; an ulp of cos or
    sin themselves moves an output by ~6e-8 |x|, well inside it."""
    B, H, T, D = x.shape
    freq = (float(theta) ** (-np.arange(D // 2) * 2.0 / D)).astype('float32')
    pos = np.arange(T, dtype='float32')[:, None]
    ang = pos * freq
    r = np.sqrt(x[..., 0::2] ** 2 + x[..., 1::2] ** 2)
    if float(r.max()) * float(np.spacing(ang.max())) <= TOL['atol']:
        return np.zeros_like(x)
    d_ang = pos * np.spacing(freq) + np.spacing(ang)
    return np.repeat(r * d_ang, 2, axis=-1)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


@pytest.mark.parametrize('op,ins,attrs', [
    ('reshape', {'X': _x(0, 2, 6, 8)}, {'shape': [0, 6, 2, 4]}),
    ('reshape', {'X': _x(0, 2, 6, 8)}, {'shape': [-1, 16]}),
    ('transpose', {'X': _x(1, 2, 3, 4, 5)}, {'axis': [0, 2, 1, 3]}),
    ('squeeze', {'X': _x(2, 3, 1, 4)}, {'axes': [1]}),
    ('squeeze', {'X': _x(2, 3, 1, 4, 1)}, {'axes': [-1, 1]}),
    ('slice', {'Input': _x(3, 2, 7, 5)},
     {'axes': [1], 'starts': [6], 'ends': [7]}),
    ('slice', {'Input': _x(3, 2, 7, 5)},
     {'axes': [1, 2], 'starts': [-3, 1], 'ends': [100, -1]}),
])
def test_layout_ops_match_exactly(op, ins, attrs):
    jout, tout = _run_both(op, ins, attrs)
    assert jout.shape == tout.shape
    np.testing.assert_array_equal(tout, jout)


@pytest.mark.parametrize('op,x,y,axis', [
    ('elementwise_add', (2, 3, 4), (2, 3, 4), -1),
    ('elementwise_add', (2, 3, 4), (4,), -1),
    ('elementwise_add', (2, 3, 4), (3,), 1),
    ('elementwise_mul', (2, 3, 4), (3, 1), 1),
    ('elementwise_mul', (2, 3, 4), (2, 3, 4), -1),
])
def test_elementwise_axis_broadcast(op, x, y, axis):
    jout, tout = _run_both(op, {'X': _x(4, *x), 'Y': _x(5, *y)},
                           {'axis': axis})
    np.testing.assert_allclose(tout, jout, **TOL)


@pytest.mark.parametrize('op,ins,attrs,slot', [
    ('swish', {'X': _x(6, 4, 8)}, {'beta': 1.0}, 'Out'),
    ('swish', {'X': _x(6, 4, 8)}, {'beta': 0.5}, 'Out'),
    ('mul', {'X': _x(7, 2, 5, 16), 'Y': _x(8, 16, 12)},
     {'x_num_col_dims': 2, 'y_num_col_dims': 1}, 'Out'),
    ('matmul', {'X': _x(9, 3, 4, 5), 'Y': _x(10, 3, 6, 5)},
     {'transpose_Y': True, 'alpha': 0.5}, 'Out'),
    ('rms_norm', {'X': _x(11, 2, 5, 64), 'Scale': _x(12, 64)},
     {'epsilon': 1e-6}, 'Y'),
    ('rope', {'X': _x(13, 2, 4, 512, 64)}, {'theta': 500000.0}, 'Out'),
    ('rope', {'X': _x(14, 1, 2, 32, 16)}, {'theta': 10000.0}, 'Out'),
])
def test_compute_ops_match_jax(op, ins, attrs, slot):
    jout, tout = _run_both(op, ins, attrs, slot)
    if op != 'rope':
        np.testing.assert_allclose(tout, jout, **TOL)
        return
    err = np.abs(tout - jout)
    bound = (TOL['atol'] + TOL['rtol'] * np.abs(jout)
             + _rope_angle_slack(ins['X'], attrs['theta']))
    assert (err <= bound).all(), (float(err.max()),
                                  float((err / bound).max()))


def test_rope_positions_input():
    x = _x(15, 2, 2, 8, 16)
    pos = np.array([[3, 4, 5, 6, 7, 8, 9, 10], [0, 0, 1, 1, 2, 2, 3, 3]],
                   'int32')
    jout, tout = _run_both('rope', {'X': x, 'Positions': pos},
                           {'theta': 10000.0})
    np.testing.assert_allclose(tout, jout, **TOL)


def test_greedy_sample_tokens_match_jax_token_for_token():
    logits = _x(16, 6, 50)
    logits[0, [3, 9]] = 9.0                 # a tie: first index wins
    # a non-zero seed keys the JAX op without an executor stream; greedy
    # decoding draws nothing either way
    jout, tout = _run_both('sample_tokens', {'Logits': logits},
                           {'temperature': 0.0, 'top_k': 0, 'seed': 1})
    assert tout.dtype == jout.dtype == np.int32
    np.testing.assert_array_equal(tout, jout)
    assert tout[0] == 3


def _draw(logits, temperature, top_k, seed):
    ctx = types.SimpleNamespace(generator=lambda s: torch.Generator()
                                .manual_seed(s))
    return treg.get_op('sample_tokens')(
        ctx, {'Logits': torch.from_numpy(logits)},
        {'temperature': temperature, 'top_k': top_k, 'seed': seed})['Out']


def test_sampled_tokens_stay_in_top_k_and_repeat_per_seed():
    logits = np.tile(_x(17, 1, 40), (2000, 1))
    top5 = set(np.argsort(-logits[0])[:5].tolist())
    a = _draw(logits, 1.0, 5, seed=7).numpy()
    b = _draw(logits, 1.0, 5, seed=7).numpy()
    c = _draw(logits, 1.0, 5, seed=8).numpy()
    assert set(a.tolist()) <= top5 and len(set(a.tolist())) > 1
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    # the draw follows softmax(logits / T) restricted to the top k
    z = np.exp(logits[0] - logits[0].max())
    p = np.where(np.isin(np.arange(40), list(top5)), z, 0.0)
    p /= p.sum()
    freq = np.bincount(a, minlength=40) / len(a)
    np.testing.assert_allclose(freq, p, atol=0.05)


def test_fill_constant_and_random_initializers():
    from paddle_tpu_torch.core.registry import ExecCtx
    ctx = ExecCtx('cpu', random_seed=3, counter=0).for_op(
        0, types.SimpleNamespace(attrs={}))
    fill = treg.get_op('fill_constant')(
        ctx, {}, {'shape': [2, 3], 'value': 1.5, 'dtype': 'float32'})['Out']
    np.testing.assert_array_equal(fill.numpy(), np.full((2, 3), 1.5))
    big = treg.get_op('fill_constant')(
        ctx, {}, {'shape': [1], 'value': 2 ** 33 + 5, 'dtype': 'int64'})['Out']
    jbig = jreg.get_op('fill_constant').impl(
        _JCTX, {}, {'shape': [1], 'value': 2 ** 33 + 5, 'dtype': 'int64'})
    assert big.dtype == torch.int32
    np.testing.assert_array_equal(big.numpy(), np.asarray(jbig['Out']))
    u = treg.get_op('uniform_random')(
        ctx, {}, {'shape': [4000], 'min': -0.5, 'max': 0.5, 'seed': 0,
                  'dtype': 'float32'})['Out'].numpy()
    assert u.min() >= -0.5 and u.max() < 0.5 and abs(u.mean()) < 0.02
    n = treg.get_op('gaussian_random')(
        ctx, {}, {'shape': [4000], 'mean': 1.0, 'std': 0.02, 'seed': 11,
                  'dtype': 'float32'})['Out'].numpy()
    assert abs(n.mean() - 1.0) < 0.002 and abs(n.std() - 0.02) < 0.002
    n2 = treg.get_op('gaussian_random')(
        ctx, {}, {'shape': [4000], 'mean': 1.0, 'std': 0.02, 'seed': 11,
                  'dtype': 'float32'})['Out'].numpy()
    np.testing.assert_array_equal(n, n2)    # a seed attr fixes the draw


def test_dtype_narrowing_matches_jax_dtype():
    from paddle_tpu.core.dtypes import jax_dtype
    for name in ('float32', 'float64', 'int64', 'int32', 'bool', 'uint8'):
        assert dtype_str(torch_dtype(name)) == np.dtype(jax_dtype(name)).name
    assert torch_dtype('bfloat16') == torch.bfloat16
    assert dtype_str(np.int64) == 'int64'
    with pytest.raises(ValueError):
        dtype_str('complex32')
