"""Port flash-attention backward (the plain version, the CPU path of its
kernel wrappers) and gradients through the port's differentiable
`flash_attention`, against the JAX package: its Pallas backward kernels
run in interpret mode on the same LSE (`_flash_backward(...,
interpret=True)`), and `jax.grad` of its composed `_ref_attention`.

Tolerance: atol 5e-4 in float32, the JAX package's own for its backward
kernels against jax.grad (tests/test_attention.py) — both sides compute in
float32 in other summation orders, and dS = P (dP - delta) cancels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jatt
from paddle_tpu_torch.ops import attention as tatt
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

ATOL = 5e-4

# the cases of tests/test_attention.py's backward-kernel parity test:
# plain, causal + k_len, GQA 8/2, Tq < Tk; D 32 there, and D 64 as the
# transformer uses; D 40 and 96, which the card runs in the tensor-core
# backward's padded instances (widths 64 and 128), GQA, causal, k_len
CASES = [
    dict(B=2, H=4, Hkv=4, Tq=128, Tk=128, D=32, causal=False, klen=False),
    dict(B=2, H=4, Hkv=4, Tq=128, Tk=128, D=32, causal=True, klen=True),
    dict(B=2, H=8, Hkv=2, Tq=128, Tk=128, D=32, causal=True, klen=False),
    dict(B=2, H=8, Hkv=2, Tq=128, Tk=256, D=32, causal=True, klen=True),
    dict(B=1, H=2, Hkv=1, Tq=64, Tk=64, D=64, causal=False, klen=True),
    dict(B=2, H=8, Hkv=2, Tq=128, Tk=128, D=40, causal=True, klen=True),
    dict(B=2, H=8, Hkv=2, Tq=64, Tk=128, D=96, causal=True, klen=True),
]
IDS = ['plain', 'causal_klen', 'gqa', 'tq_lt_tk_klen', 'd64_gqa_klen',
       'd40_gqa_causal_klen', 'd96_gqa_tq_lt_tk_klen']


def _inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    B, H, Hkv, Tq, Tk, D = (cfg[k] for k in 'B H Hkv Tq Tk D'.split())
    q = rng.randn(B, H, Tq, D).astype('float32')
    k = rng.randn(B, Hkv, Tk, D).astype('float32')
    v = rng.randn(B, Hkv, Tk, D).astype('float32')
    do = rng.randn(B, H, Tq, D).astype('float32')
    kl = (np.asarray(rng.randint(Tk // 2, Tk + 1, B), np.int32)
          if cfg['klen'] else np.full(B, Tk, np.int32))
    return q, k, v, do, kl


def _jax_backward(q, k, v, do, kl, causal, block=64):
    """The JAX Pallas forward and backward kernels in interpret mode ->
    (out, lse [B*H, Tq], dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    bq, bk = min(block, q.shape[2]), min(block, k.shape[2])
    args = [jnp.asarray(a) for a in (q, k, v)]
    out, lse = jatt._flash_forward(*args, jnp.asarray(kl), causal, scale, bq,
                                   bk, interpret=True)
    dq, dk, dv = jatt._flash_backward(*args, jnp.asarray(kl), out, lse,
                                      jnp.asarray(do), causal, scale, bq, bk,
                                      interpret=True)
    return (np.array(out), np.array(lse[..., 0]), np.array(dq),
            np.array(dk), np.array(dv))


def _port_backward(q, k, v, do, kl, out, lse, causal):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    grads = tatt.flash_backward(*t, torch.from_numpy(kl),
                                torch.from_numpy(out), torch.from_numpy(lse),
                                torch.from_numpy(do), causal)
    return [g.numpy() for g in grads]


@pytest.mark.parametrize('cfg', CASES, ids=IDS)
def test_plain_backward_matches_jax_pallas_kernels(cfg):
    q, k, v, do, kl = _inputs(cfg, 0)
    out, lse, *jgrads = _jax_backward(q, k, v, do, kl, cfg['causal'])
    grads = _port_backward(q, k, v, do, kl, out, lse, cfg['causal'])
    for a, b, n in zip(grads, jgrads, ('dq', 'dk', 'dv')):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=n)


@pytest.mark.parametrize('cfg', CASES, ids=IDS)
def test_autograd_function_matches_jax_grad_of_ref_attention(cfg):
    """torch.autograd.grad through the port's flash_attention (forward and
    backward plain versions on the CPU) against jax.grad of the JAX
    package's composed `_ref_attention`, on loss = sum(out^2)."""
    q, k, v, _, kl = _inputs(cfg, 1)
    causal, scale = cfg['causal'], cfg['D'] ** -0.5
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = tatt.flash_attention(tq, tk, tv, causal=causal,
                               k_len=torch.from_numpy(kl))
    grads = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))

    def loss_ref(q, k, v):
        return (jatt._ref_attention(q, k, v, causal, scale,
                                    jnp.asarray(kl)) ** 2).sum()

    jgrads = jax.grad(loss_ref, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b, n in zip(grads, jgrads, ('dq', 'dk', 'dv')):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0, err_msg=n)


def test_k_len_zero_rows_get_zero_gradients_like_the_kernels():
    """A batch row with k_len = 0 has LSE -1e30 and no valid key: P is 0
    there, not exp(-1e30 - -1e30) = NaN, so dq, dk and dv are 0, as the
    JAX kernels give (`_masked_p_ds`).  Compared with `_flash_backward`
    only: the JAX composed path gives the mean of V in the forward there."""
    cfg = dict(B=2, H=4, Hkv=2, Tq=64, Tk=64, D=32, causal=True, klen=False)
    q, k, v, do, _ = _inputs(cfg, 2)
    kl = np.asarray([0, 64], np.int32)
    out, lse, *jgrads = _jax_backward(q, k, v, do, kl, True)
    grads = _port_backward(q, k, v, do, kl, out, lse, True)
    for a, b, n in zip(grads, jgrads, ('dq', 'dk', 'dv')):
        assert np.all(a[0] == 0.0) and np.all(b[0] == 0.0), n
        assert np.isfinite(a).all(), n
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=n)


def test_function_saves_the_forward_residuals_and_skips_them_without_grad():
    """With no input requiring grad the op runs the forward alone (the
    serving path); with one, the autograd.Function keeps q, k, v, k_len,
    out and lse, as the JAX `_fwd`."""
    cfg = dict(B=1, H=2, Hkv=2, Tq=16, Tk=16, D=64, causal=True, klen=False)
    q, k, v, _, _ = _inputs(cfg, 3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    assert tatt.flash_attention(tq, tk, tv, causal=True).grad_fn is None
    tq.requires_grad_(True)
    out = tatt.flash_attention(tq, tk, tv, causal=True)
    assert type(out.grad_fn).__name__ == '_FlashAttentionBackward'
    assert len(out.grad_fn.saved_tensors) == 6


def test_backward_wrapper_refuses_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match='dout must be'):
        tatt._launch_flash_bwd(q, k, k, None, q, lse,
                               q.to(torch.bfloat16), True, 0.125)
    with pytest.raises(ValueError, match='lse must be'):
        tatt._launch_flash_bwd(q, k, k, None, q, lse[:1], q, True, 0.125)
    with pytest.raises(ValueError, match='head dims'):
        tatt._launch_flash_bwd(torch.zeros(1, 2, 8, 100),
                               torch.zeros(1, 2, 8, 100),
                               torch.zeros(1, 2, 8, 100), None, q, lse, q,
                               True, 0.125)


class _FakeLibrary:
    """Stands in for the kernel library: records which entry point a
    wrapper called, launches nothing."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append(name)
            return 0
        return entry


def test_tensor_core_kernels_take_the_multiples_of_8_up_to_128():
    """The backward's tensor-core kernels take exactly the multiples of 8
    from 8 to 256 in float32 and in bf16 (D other than 64, 128 and 256 in
    their padded instances): up to 128 as before, and above it the
    instances of width 256, float32 in clusters of two blocks that split
    D.  No head dim is left to the CUDA-core kernels."""
    for dtype in (torch.float32, torch.bfloat16):
        want = [D for D in range(1, 300) if D % 8 == 0 and D <= 256]
        assert [D for D in range(1, 300)
                if tatt.bwd_tensor_core(D, dtype)] == want


@pytest.mark.parametrize('D', [8, 16, 40, 64, 96, 120, 128, 136, 200, 248,
                               256])
def test_backward_routing_by_head_dim(D, monkeypatch):
    """The forward runs the tensor-core kernel (pt_flash_fwd) at every
    multiple of 8 up to 256, the backward the tensor-core kernels
    (pt_flash_bwd_*) there too, in float32 and bf16; D other than 64, 128
    and 256 in their padded instances.  No wrapper calls the CUDA-core
    kernels (pt_flash_cc_*).  The wrappers are driven with the library
    and the CUDA stream stood in for."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import build
    monkeypatch.setattr(build, 'library', lambda: _FakeLibrary())
    monkeypatch.setattr(torch.cuda, 'device', lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda dev=None: type('S', (), {'cuda_stream': 0}))
    for dtype in (torch.float32, torch.bfloat16):
        assert tatt.bwd_tensor_core(D, dtype)
        fake = _FakeLibrary()
        monkeypatch.setattr(kernels, 'library', lambda: fake)
        q = torch.zeros(1, 2, 8, D, dtype=dtype)
        kl = torch.full((1,), 8, dtype=torch.int32)
        lse = torch.zeros(2, 8)
        tatt._launch_flash(q, q, q, True, 0.1, kl)
        tatt._launch_flash_bwd(q, q, q, kl, q, lse, q, True, 0.1)
        assert fake.called == [
            'pt_flash_fwd', 'pt_flash_bwd_dq', 'pt_flash_bwd_dkv'], dtype


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
