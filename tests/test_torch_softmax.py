"""K5, the softmax rows: the port's plain version (what the CUDA kernel
csrc/softmax.cu is held against on the card) against the JAX package's
`softmax` op, `jax.nn.softmax(x.astype(f32)).astype(x.dtype)`, on the
same seeded inputs, and its gradient against `jax.vjp` of that op.

Tolerances: float32 rtol 1e-6 (plus 1e-9 absolute for entries that
underflow towards 0) — both take exp(x - max) / sum in float32, in other
summation orders and with other exp implementations, a few units in the
last place; bfloat16 one bf16 unit in the last place — both round an
(almost equal) float32 result once; gradients rtol 1e-5 (plus 1e-7
absolute) — y * (g - sum(g * y)) cancels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.ops import nn as tnn
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)


def _jax_softmax(x, axis, dtype):
    out = jreg.get_op('softmax').impl(None, {'X': jnp.asarray(x, dtype)},
                                      {'axis': axis})['Out']
    return np.asarray(out.astype(jnp.float32))


def _input(shape, seed, neg_inf_rows=0):
    x = (np.random.RandomState(seed).randn(*shape) * 3).astype('float32')
    if neg_inf_rows:
        x.reshape(-1, shape[-1])[:neg_inf_rows] = -np.inf
    return x


def _bf16_ulp(v):
    a = np.abs(v).astype('float64')
    e = np.floor(np.log2(np.where(a > 0, a, 1e-38)))
    return np.where(a > 0, 2.0 ** (e - 7), 2.0 ** -133)


@pytest.mark.parametrize('shape,axis', [
    ((7, 256), -1), ((5, 255), -1), ((9, 1), -1), ((2, 3, 4, 256), -1),
    ((3, 5, 7), 1), ((4, 6, 33), 0), ((130, 1500), -1)])
def test_plain_softmax_matches_jax_f32(shape, axis):
    x = _input(shape, 0)
    ref = _jax_softmax(x, axis, jnp.float32)
    out = tnn.softmax(torch.from_numpy(x), axis).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-9)
    rows = tnn.softmax_rows(torch.from_numpy(x.reshape(-1, shape[-1])))
    assert torch.equal(rows, tnn.softmax_reference(
        torch.from_numpy(x.reshape(-1, shape[-1]))))


@pytest.mark.parametrize('shape,axis', [((6, 256), -1), ((3, 255), -1),
                                        ((4, 9, 5), 1)])
def test_plain_softmax_matches_jax_bf16(shape, axis):
    x = _input(shape, 1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    x_exact = xb.float().numpy()          # the bf16 values both packages see
    ref = _jax_softmax(x_exact, axis, jnp.bfloat16)
    out = tnn.softmax(xb, axis)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref)
    assert (err <= _bf16_ulp(ref)).all(), err.max()


@pytest.mark.parametrize('cols', [1, 255, 256])
def test_all_neg_inf_rows_give_what_jax_gives(cols):
    x = _input((5, cols), 2, neg_inf_rows=2)
    ref = _jax_softmax(x, -1, jnp.float32)
    out = tnn.softmax_reference(torch.from_numpy(x)).numpy()
    assert np.isnan(ref[:2]).all() and np.isnan(out[:2]).all()
    np.testing.assert_allclose(out[2:], ref[2:], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize('shape,axis', [((4, 256), -1), ((3, 6, 5), 1)])
def test_gradient_matches_jax_vjp(shape, axis):
    x = _input(shape, 3)
    g = np.random.RandomState(4).randn(*shape).astype('float32')
    _, vjp = jax.vjp(
        lambda v: jreg.get_op('softmax').impl(None, {'X': v},
                                              {'axis': axis})['Out'],
        jnp.asarray(x))
    ref, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tnn.softmax(xt, axis)
    got, = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


def test_softmax_op_and_layer_on_the_cpu():
    """The layer emits the JAX package's op; the op on a CPU tensor runs
    the plain version."""
    import paddle_tpu_torch as tf
    main = tf.Program()
    with tf.program_guard(main, tf.Program()), tf.unique_name.guard():
        x = tf.layers.data('x', shape=[3, 8], dtype='float32')
        y = tf.layers.softmax(x, axis=1)
    op = main.global_block().ops[-1]
    assert (op.type, op.attrs['axis']) == ('softmax', 1)
    xv = _input((2, 3, 8), 5)
    out, = tf.Executor(tf.CPUPlace()).run(main, feed={'x': xv},
                                          fetch_list=[y])
    np.testing.assert_allclose(out, _jax_softmax(xv, 1, jnp.float32),
                               rtol=1e-6, atol=1e-9)
