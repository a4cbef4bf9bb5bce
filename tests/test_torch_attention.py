"""Port flash-attention forward (plain version, the CPU path of its kernel
wrapper) against the JAX package's Pallas kernel run in interpret mode
(`_flash_forward(..., interpret=True)`) and its composed `_ref_attention`.

Tolerance: rtol = atol = 1e-5 in float32 — both sides compute in float32,
in other summation orders (Pallas blocks of 128 keys vs one einsum)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.ops import attention as jatt
from paddle_tpu_torch.ops import attention as tatt
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, H, Hkv, Tq, Tk, D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Tq, D).astype('float32')
    k = rng.randn(B, Hkv, Tk, D).astype('float32')
    v = rng.randn(B, Hkv, Tk, D).astype('float32')
    return q, k, v


def _port(q, k, v, causal, klen):
    out, lse = tatt.flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, q.shape[-1] ** -0.5,
        torch.tensor(klen, dtype=torch.int32))
    return out.numpy(), lse.numpy()


def _jax_kernel(q, k, v, causal, klen, block=128):
    out, lse = jatt._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(klen, jnp.int32), causal, q.shape[-1] ** -0.5,
        min(block, q.shape[2]), min(block, k.shape[2]), interpret=True)
    # the TPU kernel broadcasts the LSE over 8 lanes; the port stores one
    return np.asarray(out), np.asarray(lse)[..., 0]


CASES = [
    # name, B, H, Hkv, Tq, Tk, D, causal, k_len
    ('causal_gqa', 2, 4, 2, 256, 256, 64, True, [256, 256]),
    ('noncausal_gqa', 2, 4, 2, 256, 256, 64, False, [256, 256]),
    ('causal_ragged_klen', 2, 4, 2, 256, 256, 64, True, [256, 100]),
    ('noncausal_ragged_klen', 2, 4, 2, 256, 256, 64, False, [37, 256]),
    ('decode_tq_lt_tk', 2, 4, 2, 128, 256, 64, True, [256, 180]),
    ('mha_d128', 1, 2, 2, 256, 256, 128, True, [256]),
]


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax_pallas_kernel(case):
    _, B, H, Hkv, Tq, Tk, D, causal, klen = case
    q, k, v = _inputs(0, B, H, Hkv, Tq, Tk, D)
    out, lse = _port(q, k, v, causal, klen)
    jout, jlse = _jax_kernel(q, k, v, causal, klen)
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(lse, jlse, **TOL)


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax_ref_attention(case):
    _, B, H, Hkv, Tq, Tk, D, causal, klen = case
    q, k, v = _inputs(1, B, H, Hkv, Tq, Tk, D)
    out, _ = _port(q, k, v, causal, klen)
    ref = jatt._ref_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, D ** -0.5,
                              jnp.asarray(klen, jnp.int32))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_k_len_zero_returns_zeros_like_the_kernel():
    """A batch row with k_len = 0 has no valid key: the kernels' loop runs
    zero times and returns zeros with LSE -1e30 (ops/attention.py:97 in
    the JAX package).  The composed JAX `_ref_attention` softmaxes a row
    of equal -1e30 scores instead and returns the mean of V there; the
    port's plain version follows the kernels."""
    q, k, v = _inputs(2, 2, 4, 2, 128, 128, 64)
    klen = [0, 128]
    out, lse = _port(q, k, v, True, klen)
    jout, jlse = _jax_kernel(q, k, v, True, klen)
    assert np.all(out[0] == 0.0) and np.all(jout[0] == 0.0)
    assert np.all(lse[:4] == np.float32(-1e30))
    np.testing.assert_allclose(lse, jlse, **TOL)
    np.testing.assert_allclose(out, jout, **TOL)
    ref = np.asarray(jatt._ref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 64 ** -0.5,
        jnp.asarray(klen, jnp.int32)))
    mean_v = np.repeat(v[0].mean(axis=1), 2, axis=0)        # [H, D]
    np.testing.assert_allclose(ref[0], np.broadcast_to(
        mean_v[:, None, :], ref[0].shape), rtol=1e-5, atol=1e-5)


def test_op_matches_jax_op_on_transposed_views():
    """The `flash_attention` op (registry impl) takes the non-contiguous
    head views the llama program hands it and agrees with the JAX op."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    q, k, v = _inputs(3, 2, 4, 2, 64, 64, 64)
    # [B, T, H, D] storage viewed as [B, H, T, D], as after `transpose`
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3))).permute(0, 2, 1, 3) for a in (q, k, v))
    assert not tq.is_contiguous()
    out = treg.get_op('flash_attention')(
        None, {'Q': tq, 'K': tk, 'V': tv}, {'causal': True})['Out']
    jout = jreg.get_op('flash_attention').impl(
        None, {'Q': jnp.asarray(q), 'K': jnp.asarray(k),
               'V': jnp.asarray(v)}, {'causal': True})['Out']
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_bf16_plain_accumulates_in_float32():
    """bf16 inputs: the plain version upcasts (exactly) and accumulates in
    float32, returning bf16 — within one bf16 rounding of the f32 result
    on the same (bf16-representable) inputs."""
    q, k, v = _inputs(4, 1, 2, 1, 64, 64, 64)
    bq, bk, bv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = tatt.flash_forward(bq, bk, bv, True)
    ref, ref_lse = tatt.flash_forward(bq.float(), bk.float(), bv.float(),
                                      True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=8e-3, atol=1e-3)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-6)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The launch wrapper validates before it touches the device: shapes,
    head dims and dtypes the CUDA kernel has no path for raise."""
    q = torch.zeros(1, 4, 8, 100)
    with pytest.raises(ValueError, match='head dims'):
        tatt._launch_flash(q, torch.zeros(1, 2, 8, 100),
                           torch.zeros(1, 2, 8, 100), True, 1.0, None)
    with pytest.raises(ValueError, match='multiple of Hkv'):
        tatt._launch_flash(torch.zeros(1, 3, 8, 64),
                           torch.zeros(1, 2, 8, 64),
                           torch.zeros(1, 2, 8, 64), True, 1.0, None)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        tatt._launch_flash(torch.zeros(1, 2, 8, 64, dtype=torch.float16),
                           torch.zeros(1, 2, 8, 64, dtype=torch.float16),
                           torch.zeros(1, 2, 8, 64, dtype=torch.float16),
                           True, 1.0, None)
    with pytest.raises(ValueError, match='contiguous'):
        tatt._launch_flash(torch.zeros(1, 8, 2, 64).permute(0, 2, 1, 3),
                           torch.zeros(1, 2, 8, 64),
                           torch.zeros(1, 2, 8, 64), True, 1.0, None)
