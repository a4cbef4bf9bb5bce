"""The arithmetic of the port's float32 flash forward, emulated on the CPU,
against the port's plain version and the JAX package.

csrc/flash_fwd.cu `flash_fwd_tf32x3_kernel` runs only on the card.  It
runs every float32 product on the TF32 tensor cores as three: x y ~
x_hi y_hi + x_hi y_lo + x_lo y_hi with x_hi = tf32(x) and x_lo = tf32(x -
x_hi), each rounded to nearest (ties away: `cvt.rna.tf32.f32`).  Its
rounding is repeated here in plain PyTorch, tile by tile at the kernel's
sizes (64 query rows; 32 keys up to D = 128, 16 at width 256, where Q's
hi + lo leave no room for wider key tiles): Q, K, V and P split into
TF32 hi and lo;
S = Q_lo K_hi^T + Q_hi K_lo^T + Q_hi K_hi^T and O += P_lo V_hi + P_hi V_lo
+ P_hi V_hi, summed in float32 in that order (products of TF32 values are
exact in float32); `scale` applied to the float32 S; the online softmax in
base 2.  Head dims other than 64, 128 and 256 run the kernel's padded
instances (width 64, 128 or 256): q, k and v padded with zero columns to
that width, Q K^T over the KC = ceil(D / 32) 32-column regions that hold
the columns below D, P V over the padded width, as the kernel runs them.

The emulation must hold the card's unchanged float32 check (chip_smoke.py,
tests/test_torch_cuda_kernels.py): rtol 1e-4, atol 1e-5 against the
port's `_ref_attention`, LSE within 1e-4; and, at the same tolerance, the
JAX package's Pallas forward in interpret mode.  Two more tests document
the choice: one TF32 product (Q, K, P and V each rounded to TF32 once)
misses that check, and so does a kernel that hands the tensor cores an
unrounded float32 as hi (they read it truncated) while taking lo from the
rounded hi.  The plain version itself is held against the JAX
`_flash_kernel` by tests/test_torch_attention.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jatt
from paddle_tpu_torch.ops import attention as tatt
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

TK = 32      # keys per tile up to D = 128
WIDE_TK = 16  # keys per tile at width 256
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = -1e30
RTOL, ATOL, LSE_ATOL = 1e-4, 1e-5, 1e-4


def tf32_rna(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away
    from zero, as cvt.rna.tf32.f32: add half of the 13 dropped bits to the
    magnitude, then drop them."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """What the tensor cores read from an unrounded float32: the low 13
    bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x, mode):
    """-> (hi, lo) as the tensor cores read them.  'x3': the kernel's
    split; 'trunc': lo taken from a rounded hi, but hi handed over
    unrounded."""
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)
    return (tf32_trunc(x) if mode == 'trunc' else hi), lo


def product(a, bt, mode):
    """a @ bt as the kernel computes it from float32 a and bt."""
    if mode == 'one':
        return tf32_rna(a) @ tf32_rna(bt)
    ah, al = split(a, mode)
    bh, bl = split(bt, mode)
    acc = al @ bh
    acc = acc + ah @ bl
    return acc + ah @ bh


def emulate_forward(q, k, v, kl, causal, scale, mode='x3'):
    """flash_fwd_tf32x3_kernel on float32 q [B, H, Tq, D], k/v [B, Hkv,
    Tk, D] -> (out, lse [B*H, Tq]), in the instance of width DP (64 up to
    D = 64, 128 up to 128, else 256, in tiles of 16 keys): Q K^T over the
    first 32 KC columns, P V over DP, the columns below D returned.  Key
    tiles past a row's frontier are all masked here, which leaves m, l and
    O exactly as the kernel's skip does (alpha = 1, P = 0)."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    DP = 64 if D <= 64 else 128 if D <= 128 else 256
    nk, tk = -(-D // 32) * 32, (WIDE_TK if DP == 256 else TK)

    def pad(x):
        return torch.nn.functional.pad(x, (0, DP - D))
    qf = pad(q).reshape(B, Hkv, g, Tq, DP)[..., :nk]
    k, v = pad(k), pad(v)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    valid = tatt._valid_mask(B, Tq, Tk, causal, kl, 'cpu').expand(
        B, 1, 1, Tq, Tk)
    m = torch.full((B, Hkv, g, Tq, 1), NEG)
    l = torch.zeros((B, Hkv, g, Tq, 1))
    o = torch.zeros((B, Hkv, g, Tq, DP))
    for k0 in range(0, Tk, tk):
        kt, vt = k[:, :, None, k0:k0 + tk], v[:, :, None, k0:k0 + tk]
        x = product(qf, kt[..., :nk].transpose(-1, -2), mode) * sl2
        x = torch.where(valid[..., k0:k0 + tk], x,
                        torch.tensor(float('-inf')))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + product(p, vt, mode)
        m = m_new
    safe = torch.where(l > 0, l, torch.ones_like(l))
    out = torch.where(l > 0, o / safe, torch.zeros_like(o))[..., :D]
    lse = torch.where(l > 0, (m + torch.log2(safe)) * LN2,
                      torch.full_like(l, NEG))
    return out.reshape(B, H, Tq, D), lse.reshape(B * H, Tq)


CASES = [
    # B, H, Hkv, Tq, Tk, D, causal, k_len (None: Tk)
    (2, 4, 2, 256, 256, 128, True, None),            # served-like, GQA
    (2, 4, 4, 256, 256, 64, False, None),            # training check's
    (3, 4, 1, 150, 150, 128, True, [150, 77, 1]),    # k_len 1, ragged
    (2, 4, 4, 70, 70, 64, True, [0, 50]),            # k_len 0 rows
    (2, 4, 1, 5, 333, 128, True, [333, 100]),        # decode, Tq < Tk
    (2, 4, 2, 37, 161, 64, True, [161, 100]),        # Tq < Tk, k_len
    (1, 2, 2, 97, 161, 64, False, [130]),            # ragged, D=64
    # the padded instances: D = 16, 40 in the 64 one (KC = 1, 2), 72, 96,
    # 120 in the 128 one (KC = 3, 3, 4)
    (3, 8, 2, 37, 161, 16, True, [161, 0, 1]),       # Tq < Tk, k_len 0, 1
    (3, 8, 4, 100, 100, 40, True, [100, 1, 0]),      # GQA, ragged, k_len
    (3, 8, 2, 37, 161, 72, True, [161, 0, 1]),       # Tq < Tk, k_len 0, 1
    (2, 8, 2, 150, 150, 96, True, [150, 77]),        # GQA, causal
    (3, 4, 2, 97, 161, 120, True, [130, 0, 1]),      # ragged q, k tiles
    # the instance of width 256 (16-key tiles): D = 256 unpadded, 136, 200
    # and 248 padded (KC 5, 7, 8)
    (3, 4, 2, 150, 150, 256, True, [150, 0, 1]),     # GQA, k_len 0, 1
    (3, 8, 2, 37, 161, 136, True, [161, 0, 1]),      # Tq < Tk, k_len 0, 1
    (2, 8, 1, 97, 161, 200, True, [130, 1]),         # MQA, ragged tiles
    (2, 4, 2, 100, 100, 248, False, [100, 77]),      # GQA, ragged
]
IDS = ['served_like', 'path_d64', 'causal_klen1', 'klen0', 'decode',
       'tq_lt_tk', 'ragged_d64', 'd16_tq_lt_tk_klen01', 'd40_klen01',
       'd72_tq_lt_tk_klen01', 'd96_gqa', 'd120_ragged_klen01',
       'd256_gqa_klen01', 'd136_tq_lt_tk_klen01', 'd200_mqa_ragged',
       'd248_gqa_ragged']


def _inputs(B, H, Hkv, Tq, Tk, D, klen, seed=0):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, H, Tq, D).astype('float32'))
    k, v = (torch.from_numpy(rng.randn(B, Hkv, Tk, D).astype('float32'))
            for _ in range(2))
    kl = torch.tensor([Tk] * B if klen is None else klen, dtype=torch.int32)
    return q, k, v, kl


def _block(n):
    """The JAX kernel's grid needs tiles that divide T: the largest
    divisor of n up to 64."""
    return max(b for b in range(1, min(n, 64) + 1) if n % b == 0)


def _within(out, ref):
    """Every element within the card's float32 check."""
    return bool(((out - ref).abs() <= ATOL + RTOL * ref.abs()).all())


def test_tf32_rounding_matches_cvt_rna():
    """Ties go away from zero, carries reach the exponent, and the result
    keeps 10 mantissa bits."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 **
                      -23, 2.0 - 2 ** -23, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, 2.0, 3.0, 0.0])
    assert torch.equal(tf32_rna(x), want)
    r = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(
        'float32'))
    assert not (tf32_rna(r).view(torch.int32) & 0x1FFF).any()
    assert float(((tf32_rna(r) - r).abs() / r.abs()).max()) <= 2.0 ** -11
    hi, lo = split(r, 'x3')
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_forward_emulation_within_the_float32_check(case):
    B, H, Hkv, Tq, Tk, D, causal, klen = case
    q, k, v, kl = _inputs(B, H, Hkv, Tq, Tk, D, klen)
    scale = D ** -0.5
    out, lse = emulate_forward(q, k, v, kl, causal, scale)
    ref, ref_lse = tatt._ref_attention(q, k, v, causal, scale, kl)
    assert _within(out, ref), float((out - ref).abs().max())
    valid_rows = ref_lse > -1e29
    assert torch.equal(lse > -1e29, valid_rows)
    assert float((lse - ref_lse).abs()[valid_rows].max()) <= LSE_ATOL
    if 0 in (klen or []):
        assert not out[kl == 0].any()
    # the JAX package's Pallas forward in interpret mode, float32
    jout, jlse = jatt._flash_forward(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(kl.numpy()), causal, scale,
        _block(Tq), _block(Tk), interpret=True)
    jout = torch.from_numpy(np.array(jout))
    jlse = torch.from_numpy(np.array(jlse[..., 0]))
    has_key = kl > 0
    assert _within(out[has_key], jout[has_key]), float(
        (out - jout)[has_key].abs().max())
    assert float((lse - jlse).abs()[valid_rows].max()) <= LSE_ATOL


@pytest.mark.parametrize('mode', ['one', 'trunc'])
def test_cheaper_tf32_arithmetic_would_miss_the_float32_check(mode):
    """One TF32 product keeps ~2^-11 of each operand; an unrounded hi read
    truncated by the tensor cores, with lo taken from the rounded hi, is
    off by up to a TF32 unit.  Either misses rtol 1e-4 / atol 1e-5 on the
    served-like case that the 3xTF32 split holds (the test above)."""
    B, H, Hkv, Tq, Tk, D, causal, klen = CASES[0]
    q, k, v, kl = _inputs(B, H, Hkv, Tq, Tk, D, klen)
    scale = D ** -0.5
    ref, _ = tatt._ref_attention(q, k, v, causal, scale, kl)
    out, _ = emulate_forward(q, k, v, kl, causal, scale, mode=mode)
    assert not _within(out, ref)
