"""Port LayerNorm (the plain version, the CPU path of csrc/layer_norm.cu's
wrapper, and its analytic backward) against the JAX package: the
`layer_norm` op (paddle_tpu/ops/nn.py) and its kernel-generator Pallas
step `_layer_norm_step` in interpret mode, forward and `jax.grad`.

Tolerance: rtol = atol = 1e-5 in float32 for Y, Mean and Variance — the
same formulas in float32, summed in other orders; gradients atol 1e-5
(rtol 1e-5) — the analytic form against JAX's AD of the one-pass ops."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu.ops.kernelgen import rules as jrules
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.ops import nn as tnn
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, shape, affine, offset=0.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) + offset).astype('float32')
    cols = shape[-1]
    ins = {'X': x}
    if affine in ('scale', 'both'):
        ins['Scale'] = (1.0 + 0.1 * rng.randn(cols)).astype('float32')
    if affine in ('bias', 'both'):
        ins['Bias'] = (0.1 * rng.randn(cols)).astype('float32')
    return ins


def _jax_op(ins, attrs):
    out = jreg.get_op('layer_norm').impl(
        None, {k: jnp.asarray(v) for k, v in ins.items()}, attrs)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_op(ins, attrs):
    out = treg.get_op('layer_norm')(
        None, {k: torch.from_numpy(v) for k, v in ins.items()}, attrs)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize('two_pass', [False, True], ids=['one_pass',
                                                         'two_pass'])
@pytest.mark.parametrize('affine', ['both', 'scale', 'bias', 'none'])
def test_forward_matches_jax_op_and_pallas_step(affine, two_pass,
                                                monkeypatch):
    monkeypatch.setenv('PT_TWO_PASS_NORM', '1' if two_pass else '0')
    ins = _inputs(0, (3, 7, 40), affine)
    attrs = {'begin_norm_axis': 2, 'epsilon': 1e-5}
    out = _port_op(ins, attrs)
    ref = _jax_op(ins, attrs)
    step = jrules._layer_norm_step(
        {k: jnp.asarray(v) for k, v in ins.items()}, attrs, None, None,
        True)
    for slot in ('Y', 'Mean', 'Variance'):
        assert out[slot].shape == ref[slot].shape and \
            out[slot].dtype == np.float32, slot
        np.testing.assert_allclose(out[slot], ref[slot], err_msg=slot, **TOL)
        np.testing.assert_allclose(out[slot], np.asarray(step[slot]),
                                   err_msg=slot, **TOL)


def test_pilot_shift_keeps_the_variance_where_the_naive_form_cancels():
    """Rows with a large common offset: E[x^2] - E[x]^2 in float32 loses
    the variance to cancellation; the one-pass statistics shifted by the
    row's first element keep it, in both packages alike."""
    ins = _inputs(1, (16, 64), 'none', offset=3e3)
    attrs = {'begin_norm_axis': 1, 'epsilon': 1e-5}
    out, ref = _port_op(ins, attrs), _jax_op(ins, attrs)
    true_var = ins['X'].astype('float64').var(axis=1)
    x = torch.from_numpy(ins['X'])
    naive = (x.square().mean(1) - x.mean(1).square()).numpy()
    assert np.abs(naive - true_var).max() > 0.1
    np.testing.assert_allclose(out['Variance'], true_var, rtol=1e-3)
    np.testing.assert_allclose(out['Variance'], ref['Variance'], **TOL)
    np.testing.assert_allclose(out['Mean'], ref['Mean'], rtol=1e-6)
    np.testing.assert_allclose(out['Y'], ref['Y'], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('affine', ['both', 'none'])
def test_gradient_matches_jax_grad_of_the_op(affine):
    """d/d(X, Scale, Bias) of sum(Y * W) through the port's autograd
    Function against jax.grad of the JAX op: the analytic LayerNorm
    gradient equals AD of the shifted one-pass form (the pilot is
    stop_gradient and cancels)."""
    ins = _inputs(2, (5, 6, 48), affine)
    w = np.random.RandomState(3).randn(5, 6, 48).astype('float32')
    attrs = {'begin_norm_axis': 2, 'epsilon': 1e-5}
    names = sorted(ins)

    def loss_jax(*vals):
        out = jreg.get_op('layer_norm').impl(None, dict(zip(names, vals)),
                                             attrs)
        return (out['Y'] * w).sum()

    jgrads = jax.grad(loss_jax, argnums=tuple(range(len(names))))(
        *[jnp.asarray(ins[n]) for n in names])
    tins = {n: torch.from_numpy(ins[n]).requires_grad_(True) for n in names}
    out = treg.get_op('layer_norm')(None, tins, attrs)
    assert out['Mean'].grad_fn is None or not out['Mean'].requires_grad
    tgrads = torch.autograd.grad((out['Y'] * torch.from_numpy(w)).sum(),
                                 [tins[n] for n in names])
    for n, a, b in zip(names, tgrads, jgrads):
        assert a.shape == tins[n].shape, n
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=n,
                                   **TOL)


def test_bf16_input_keeps_its_dtype_with_float32_statistics():
    ins = _inputs(4, (4, 32), 'both')
    x = torch.from_numpy(ins['X']).to(torch.bfloat16)
    y, m, v = tnn.layer_norm_rows(x, torch.from_numpy(ins['Scale']),
                                  torch.from_numpy(ins['Bias']), 1e-5)
    assert y.dtype == torch.bfloat16 and m.dtype == v.dtype == torch.float32
    ry, rm, rv = tnn.layer_norm_rows(x.float(),
                                     torch.from_numpy(ins['Scale']),
                                     torch.from_numpy(ins['Bias']), 1e-5)
    # one bf16 rounding of the float32 result on the same inputs
    np.testing.assert_allclose(y.float().numpy(), ry.numpy(), rtol=8e-3,
                               atol=8e-3)
    np.testing.assert_allclose(m.numpy(), rm.numpy(), **TOL)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match='rows x cols'):
        tnn._launch_layer_norm(torch.zeros(2, 3, 4), None, None, 1e-5, False)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        tnn._launch_layer_norm(torch.zeros(2, 4, dtype=torch.float16), None,
                               None, 1e-5, False)
    with pytest.raises(ValueError, match='contiguous'):
        tnn._launch_layer_norm(torch.zeros(4, 2).t(), None, None, 1e-5,
                               False)
    with pytest.raises(ValueError, match='Scale must hold'):
        tnn._launch_layer_norm(torch.zeros(2, 4), torch.ones(3), None, 1e-5,
                               False)
