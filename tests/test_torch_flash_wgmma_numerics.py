"""The arithmetic of the port's tensor-core flash kernels, emulated on the
CPU, against the port's plain versions and the JAX package.

csrc/flash_fwd.cu `flash_fwd_wgmma_kernel` and csrc/flash_bwd.cu
`flash_bwd_dkv_wgmma_kernel` and `flash_bwd_dq_wgmma_kernel` run only on
the card.  Their rounding is repeated here in plain PyTorch, tile by tile
at the kernels' sizes (64 query rows and 64 keys; dK/dV's ring tiles of 64
query rows over the GQA group, dQ's ring tiles of 64 keys): bf16 inputs
multiplied exactly and summed in float32 (the wgmma accumulators); `scale`
applied to the float32 S; the forward's online softmax in base 2, with P
handed to P V as two bf16 terms (hi = bf16(P), lo = bf16(P - hi)); the
backward's P^T rounded to bf16 once before dV += P^T dO, and dS^T and dS
handed to dK += dS^T Q and dQ += dS K as two bf16 terms, dK and dQ scaled
once at the end.  Head dims other than 64 and 128, up to 128, run the
kernels' padded instances (width 64 or 128), and head dims 136 .. 248
their instances of width 256 (D = 256 the unpadded one; the forward's P
V and the backward's products over rows as m64n256k16 over the same
64-row tiles, the dK/dV kernel's dV and dK in blocks of their own, each
computing S^T as before): the forward's emulation pads q,
k and v with zero columns to that width, stops Q K^T at the end of the
32-column region that holds column D - 1 and runs P V over the padded
width, as the kernel does (padding itself adds exact zeros).

The emulation must hold against the port's `_ref_attention` /
`flash_backward_reference` and against the JAX package (its Pallas
kernels in interpret mode, and its composed `_ref_attention`) within the
bf16 tolerances the card check (`chip_smoke.py`, and
`tests/test_torch_cuda_kernels.py`) holds the kernels to: forward rtol
8e-3 / atol 1e-3 and LSE atol 1e-4; dQ, dK and dV rtol 8e-3 / atol 2e-3
of the largest gradient.  Against the JAX `_ref_attention` the bound also
holds that reference's own one bf16 rounding of the softmax weights.  One
more test shows why P goes in as two terms: a single bf16 rounding of P
misses the forward's atol on early causal rows, which have few keys to
average the rounding over.  And one more shows why the backward splits
dS: dS sums to zero over a row, so dQ and dK cancel, and one rounding of
dS misses the check on some inputs, at D = 128 (dQ) and at D = 16 (dK);
the split holds them, at D = 64 and 128 too (ROADMAP C7)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jatt
from paddle_tpu_torch.ops import attention as tatt
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

WK = 64      # keys per tile (both kernels)
BQ = 64      # query rows per forward tile, and per backward ring tile
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = -1e30

FWD_TOL = dict(rtol=8e-3, atol=1e-3)
LSE_ATOL = 1e-4
BWD_RTOL, BWD_AREL = 8e-3, 2e-3


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _valid(B, Tq, Tk, causal, kl):
    """[B, 1, 1, Tq, Tk] key validity, the kernels' masks."""
    return tatt._valid_mask(B, Tq, Tk, causal, kl, 'cpu').expand(
        B, 1, 1, Tq, Tk)


def padded_width(D):
    """The width of the kernels' instance that runs head dim D: 64 up to
    64, 128 up to 128, else 256 (the forward's; D other than 64, 128 and
    256 padded with zero columns)."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def _pad(x, DP):
    """x [..., D] with zero columns up to DP, as TMA lands its tiles."""
    return torch.nn.functional.pad(x, (0, DP - x.shape[-1]))


def emulate_forward(q, k, v, kl, causal, scale, split_p=True):
    """flash_fwd_wgmma_kernel on bf16 q [B, H, Tq, D], k/v [B, Hkv, Tk,
    D] -> (out bf16, lse float32 [B*H, Tq]), in the instance of width DP
    (padded_width): Q K^T over the 32-column regions that hold the columns
    below D (2 k16 steps each), P V over DP, the columns below D
    returned.  Key tiles past a row's frontier are all
    masked here, which leaves m, l and O exactly as the kernel's skip does
    (alpha = 1, P = 0)."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    DP, n16 = padded_width(D), -(-D // 32) * 32
    qf = _pad(q.float(), DP).reshape(B, Hkv, g, Tq, DP)
    kf, vf = _pad(k.float(), DP), _pad(v.float(), DP)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    valid = _valid(B, Tq, Tk, causal, kl)
    m = torch.full((B, Hkv, g, Tq, 1), NEG)
    l = torch.zeros((B, Hkv, g, Tq, 1))
    o = torch.zeros((B, Hkv, g, Tq, DP))
    for k0 in range(0, Tk, WK):
        kt, vt = kf[:, :, None, k0:k0 + WK], vf[:, :, None, k0:k0 + WK]
        x = (qf[..., :n16] @ kt[..., :n16].transpose(-1, -2)) * sl2
        x = torch.where(valid[..., k0:k0 + WK], x,
                        torch.tensor(float('-inf')))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if split_p:
            hi = _bf16(p)
            pv = hi @ vt + _bf16(p - hi) @ vt
        else:
            pv = _bf16(p) @ vt
        o = o * alpha + pv
        m = m_new
    inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, torch.ones_like(l)),
                      torch.zeros_like(l))
    lse = torch.where(l > 0, (m + torch.log2(torch.where(l > 0, l,
                                                         torch.ones_like(l))))
                      * LN2, torch.full_like(l, NEG))
    return ((o * inv)[..., :D].reshape(B, H, Tq, D).to(torch.bfloat16),
            lse.reshape(B * H, Tq))


def _ds_terms(ds, split_ds):
    """dS as the kernels hand it to dQ and dK: as hi + lo bf16 terms,
    summed in float32 as the two products' accumulators are; with
    split_ds False, rounded to bf16 once (the counterfactual)."""
    hi = _bf16(ds)
    return hi + _bf16(ds - hi) if split_ds else hi


def emulate_dkv(q, k, v, kl, out, lse, do, causal, scale, split_ds=True):
    """flash_bwd_dkv_wgmma_kernel -> (dk, dv) in bf16: S^T and dP^T in
    float32, P^T = exp2(scale log2(e) S^T - log2(e) LSE) under the masks,
    dS^T = P^T (dP^T - delta), P^T rounded to bf16 once and dS^T as
    _ds_terms, dV and dK summed in float32 over the GQA group's heads and
    the 64-row query tiles in the kernel's order."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.float().reshape(B, Hkv, g, Tq, D)
    dof = do.float().reshape(B, Hkv, g, Tq, D)
    kf, vf = k.float(), v.float()
    delta = tatt._bwd_delta(out, do).reshape(B, Hkv, g, 1, Tq)
    lse2 = lse.reshape(B, Hkv, g, 1, Tq) * LOG2E
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    valid = _valid(B, Tq, Tk, causal, kl).transpose(-1, -2)  # [B,1,1,Tk,Tq]
    dk = torch.zeros((B, Hkv, Tk, D))
    dv = torch.zeros((B, Hkv, Tk, D))
    for gi in range(g):
        for q0 in range(0, Tq, BQ):
            qt, dot = qf[:, :, gi, q0:q0 + BQ], dof[:, :, gi, q0:q0 + BQ]
            st = kf @ qt.transpose(-1, -2)                  # [B, Hkv, Tk, bq]
            dpt = vf @ dot.transpose(-1, -2)
            ok = valid[:, 0, 0, :, q0:q0 + BQ][:, None]
            p = torch.where(ok, torch.exp2(st * sl2 - lse2[:, :, gi, :,
                                                           q0:q0 + BQ]),
                            torch.zeros_like(st))
            ds = torch.where(ok, p * (dpt - delta[:, :, gi, :, q0:q0 + BQ]),
                             torch.zeros_like(st))
            dv = dv + _bf16(p) @ dot
            dk = dk + _ds_terms(ds, split_ds) @ qt
    return (dk * scale).to(torch.bfloat16), dv.to(torch.bfloat16)


FWD_CASES = [
    # B, H, Hkv, Tq, Tk, D, causal, k_len (None: Tk)
    (2, 4, 4, 256, 256, 64, False, None),            # the training shape's
    (2, 4, 2, 256, 256, 64, True, [256, 200]),       # GQA, causal, k_len
    (2, 4, 2, 200, 200, 128, True, None),            # ragged last q tile
    (2, 4, 4, 70, 70, 64, True, [0, 50]),            # k_len 0 rows
    (2, 4, 1, 37, 161, 64, True, [161, 100]),        # Tq < Tk
    (1, 2, 2, 97, 161, 128, False, [130]),           # ragged, D=128
    # the padded instances: D = 16, 40 in the 64 one, 72, 96, 120 in the
    # 128 one (a 32-column region partly past D at all but 96)
    (3, 8, 2, 37, 161, 16, True, [161, 0, 1]),       # Tq < Tk, k_len 0, 1
    (3, 8, 4, 100, 100, 40, True, [100, 1, 0]),      # GQA, ragged, k_len
    (3, 8, 2, 37, 161, 72, True, [161, 0, 1]),       # Tq < Tk, k_len 0, 1
    (2, 8, 2, 150, 150, 96, True, [150, 77]),        # GQA, causal
    (3, 4, 2, 97, 161, 120, True, [130, 0, 1]),      # ragged q, k tiles
    # the instance of width 256: D = 256 unpadded, 136, 200 and 248 padded
    # (KC 5, 7, 8; at 136 the last 64-column chunk is not loaded)
    (3, 4, 2, 150, 150, 256, True, [150, 0, 1]),     # GQA, k_len 0, 1
    (3, 8, 2, 37, 161, 136, True, [161, 0, 1]),      # Tq < Tk, k_len 0, 1
    (2, 8, 1, 97, 161, 200, True, [130, 1]),         # MQA, ragged tiles
    (2, 4, 2, 100, 100, 248, False, [100, 77]),      # GQA, ragged
]
FWD_IDS = ['path', 'gqa_causal_klen', 'causal_d128_ragged', 'klen0',
           'tq_lt_tk', 'ragged_d128', 'd16_tq_lt_tk_klen01', 'd40_klen01',
           'd72_tq_lt_tk_klen01', 'd96_gqa', 'd120_ragged_klen01',
           'd256_gqa_klen01', 'd136_tq_lt_tk_klen01', 'd200_mqa_ragged',
           'd248_gqa_ragged']


def _inputs(B, H, Hkv, Tq, Tk, D, klen, seed):
    """bf16 q, k, v, dO from a numpy seed, and int32 k_len."""
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(B, H, Tq, D).astype('float32'))
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(B, Hkv, Tk, D).astype('float32'))
            .to(torch.bfloat16) for _ in range(2))
    kl = torch.tensor([Tk] * B if klen is None else klen, dtype=torch.int32)
    return q, k, v, do, kl


def _jnp(t):
    """A bf16 torch tensor as the same bf16 values in JAX."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _block(n):
    """The JAX kernels' grids need tiles that divide T: the largest
    divisor of n up to 64."""
    return max(b for b in range(1, min(n, 64) + 1) if n % b == 0)


def _close(a, r, rtol, atol, what):
    a, r = a.float(), r.float()
    err = (a - r).abs()
    bound = atol + rtol * r.abs()
    assert bool((err <= bound).all()), (
        what, float(err.max()), float((err / bound).max()))


@pytest.mark.parametrize('case', FWD_CASES, ids=FWD_IDS)
def test_forward_emulation_within_the_card_tolerance(case):
    B, H, Hkv, Tq, Tk, D, causal, klen = case
    q, k, v, _, kl = _inputs(B, H, Hkv, Tq, Tk, D, klen, 0)
    scale = D ** -0.5
    out, lse = emulate_forward(q, k, v, kl, causal, scale)
    has_key = kl > 0
    # the port's plain version (float32 P, one rounding of O)
    ref, ref_lse = tatt._ref_attention(q, k, v, causal, scale, kl)
    _close(out, ref, what='plain', **FWD_TOL)
    valid_rows = ref_lse > -1e29
    assert torch.equal(lse > -1e29, valid_rows)
    _close(lse[valid_rows], ref_lse[valid_rows], 0.0, LSE_ATOL, 'plain lse')
    # the JAX package's Pallas forward in interpret mode (float32 P)
    jout, jlse = jatt._flash_forward(_jnp(q), _jnp(k), _jnp(v),
                                     jnp.asarray(kl.numpy()), causal, scale,
                                     _block(Tq), _block(Tk), interpret=True)
    jout = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    jlse = torch.from_numpy(np.array(jlse[..., 0]))
    _close(out, jout, what='jax flash', **FWD_TOL)
    _close(lse[valid_rows], jlse[valid_rows], 0.0, LSE_ATOL, 'jax lse')
    # the JAX composed _ref_attention rounds the softmax weights w to bf16
    # once (attention.py:47), which moves each output by up to 2^-9 sum_k
    # w_k |v_k| on its own (the weights' half-ulp): that is added to the
    # bound.  Rows with k_len 0 differ by design (the mean of V there,
    # zeros in the kernels)
    jref = jatt._ref_attention(_jnp(q), _jnp(k), _jnp(v), causal, scale,
                               jnp.asarray(kl.numpy()))
    jref = torch.from_numpy(np.array(jref.astype(jnp.float32)))
    w_absv = tatt._ref_attention(q.float(), k.float(), v.float().abs(),
                                 causal, scale, kl)[0]
    err = (out.float() - jref).abs()
    bound = (FWD_TOL['atol'] + FWD_TOL['rtol'] * jref.abs()
             + 2.0 ** -9 * w_absv)
    assert bool((err <= bound)[has_key].all()), float((err / bound).max())
    assert not out[~has_key].float().any()


def test_one_bf16_rounding_of_p_would_miss_the_card_tolerance():
    """Why the forward hands P to P V as hi + lo: rounded to bf16 once,
    P misses atol 1e-3 on the early rows of a causal tile, where a few
    keys leave the rounding unaveraged; the same inputs pass with the
    split (the test above)."""
    B, H, Hkv, Tq, Tk, D, causal, klen = FWD_CASES[1]
    q, k, v, _, kl = _inputs(B, H, Hkv, Tq, Tk, D, klen, 0)
    ref, _ = tatt._ref_attention(q, k, v, causal, D ** -0.5, kl)
    once, _ = emulate_forward(q, k, v, kl, causal, D ** -0.5, split_p=False)
    err = (once.float() - ref.float()).abs()
    bound = FWD_TOL['atol'] + FWD_TOL['rtol'] * ref.float().abs()
    assert not bool((err <= bound).all())


def emulate_dq(q, k, v, kl, out, lse, do, causal, scale, split_ds=True):
    """flash_bwd_dq_wgmma_kernel -> dq in bf16: S and dP in float32 per
    64-key ring tile, P = exp2(scale log2(e) S - log2(e) LSE) under the
    masks, dS = P (dP - delta) as _ds_terms, dQ summed in float32 over the
    key tiles in the kernel's order, scaled once at the end."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.float().reshape(B, Hkv, g, Tq, D)
    dof = do.float().reshape(B, Hkv, g, Tq, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    delta = tatt._bwd_delta(out, do).reshape(B, Hkv, g, Tq, 1)
    lse2 = lse.reshape(B, Hkv, g, Tq, 1) * LOG2E
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    valid = _valid(B, Tq, Tk, causal, kl)                   # [B,1,1,Tq,Tk]
    dq = torch.zeros((B, Hkv, g, Tq, D))
    for k0 in range(0, Tk, WK):
        kt, vt = kf[..., k0:k0 + WK, :], vf[..., k0:k0 + WK, :]
        s = qf @ kt.transpose(-1, -2)                        # [.., Tq, wk]
        dp = dof @ vt.transpose(-1, -2)
        ok = valid[..., k0:k0 + WK]
        p = torch.where(ok, torch.exp2(s * sl2 - lse2), torch.zeros_like(s))
        ds = torch.where(ok, p * (dp - delta), torch.zeros_like(s))
        dq = dq + _ds_terms(ds, split_ds) @ kt
    return (dq * scale).reshape(B, H, Tq, D).to(torch.bfloat16)


BWD_CASES = [
    # B, H, Hkv, Tq, Tk, D, causal, k_len (None: Tk), seed
    (2, 4, 4, 256, 256, 64, False, None, 1),         # the training shape's
    (2, 4, 4, 256, 256, 64, True, [256, 200], 1),    # causal, k_len
    (2, 8, 2, 128, 128, 64, True, None, 1),          # GQA 8/2
    (2, 4, 1, 37, 161, 64, True, [161, 100], 1),     # Tq < Tk, k_len
    (2, 4, 2, 150, 150, 128, False, [150, 77], 1),   # k_len, D=128
    (2, 4, 4, 70, 70, 64, True, [0, 50], 1),         # k_len 0 rows
    # the padded instances: D = 16, 40 in the 64 one, 96, 120 in the 128
    (3, 8, 2, 100, 100, 16, True, [100, 0, 1], 1),   # k_len 0, 1, GQA
    (2, 8, 4, 37, 161, 40, True, [161, 100], 1),     # Tq < Tk
    (2, 8, 2, 150, 150, 96, True, [150, 77], 1),     # GQA, causal
    (1, 4, 2, 97, 161, 120, False, [130], 1),        # ragged q, k tiles
    # the inputs on which one rounding of dS misses the check (C7: seed 3
    # for dQ at D = 128, seed 0 for dK at D = 16), at D = 64 and 128
    (2, 8, 2, 150, 150, 128, True, [150, 77], 3),
    (2, 8, 2, 150, 150, 64, True, [150, 77], 3),
    (2, 8, 2, 150, 150, 128, True, [150, 77], 0),
    (2, 8, 2, 150, 150, 64, True, [150, 77], 0),
    # the instances of width 256: D = 256 unpadded, 136 and 200 padded
    # (the dK/dV kernel's dV and dK blocks each recompute S^T in the same
    # order, so the arithmetic is the one emulated)
    (3, 4, 2, 150, 150, 256, True, [150, 0, 1], 1),  # GQA, k_len 0, 1
    (3, 4, 2, 37, 161, 136, True, [161, 0, 1], 1),   # Tq < Tk, k_len 0, 1
    (2, 8, 1, 97, 161, 200, True, [130, 1], 1),      # MQA, ragged tiles
]
BWD_IDS = ['path', 'causal_klen', 'gqa', 'tq_lt_tk', 'klen_d128', 'klen0',
           'd16_klen01', 'd40_tq_lt_tk', 'd96_gqa', 'd120_ragged',
           'c7_d128_seed3', 'c7_d64_seed3', 'c7_d128_seed0', 'c7_d64_seed0',
           'd256_gqa_klen01', 'd136_tq_lt_tk_klen01', 'd200_mqa_ragged']


# case -> what its dK/dV and dQ tests share: the inputs, the emulated
# forward's out and LSE, the plain backward and the JAX kernels' (in
# interpret mode, most of a case's time), computed once; no test writes
# them
_BWD_BASES = {}


def _bwd_base(case):
    key = repr(case)
    if key not in _BWD_BASES:
        B, H, Hkv, Tq, Tk, D, causal, klen, seed = case
        q, k, v, do, kl = _inputs(B, H, Hkv, Tq, Tk, D, klen, seed)
        scale = D ** -0.5
        # the forward's out and LSE, as the kernels see them
        out, lse = emulate_forward(q, k, v, kl, causal, scale)
        refs = tatt.flash_backward_reference(q, k, v, kl, out, lse, do,
                                             causal, scale)
        jlse = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None],
                                lse.shape + (8,))
        jgrads = jatt._flash_backward(
            _jnp(q), _jnp(k), _jnp(v), jnp.asarray(kl.numpy()), _jnp(out),
            jlse, _jnp(do), causal, scale, _block(Tq), _block(Tk),
            interpret=True)
        jgrads = [torch.from_numpy(np.array(j.astype(jnp.float32)))
                  for j in jgrads]
        _BWD_BASES[key] = ((q, k, v, do, kl), scale, out, lse, refs, jgrads)
    return _BWD_BASES[key]


@pytest.mark.parametrize('case', BWD_CASES, ids=BWD_IDS)
def test_dkv_emulation_within_the_card_tolerance(case):
    causal, klen = case[6], case[7]
    (q, k, v, do, kl), scale, out, lse, (_, rk, rv), (_, jdk, jdv) = \
        _bwd_base(case)
    dk, dv = emulate_dkv(q, k, v, kl, out, lse, do, causal, scale)
    for name, a, r, j in (('dk', dk, rk, jdk), ('dv', dv, rv, jdv)):
        for what, ref in (('plain', r.float()), ('jax', j)):
            _close(a, ref, BWD_RTOL, BWD_AREL * float(ref.abs().max()),
                   '%s %s' % (name, what))
        if 0 in (klen or []):
            assert not a[torch.tensor(klen) == 0].float().any()


@pytest.mark.parametrize('case', BWD_CASES, ids=BWD_IDS)
def test_dq_emulation_within_the_card_tolerance(case):
    causal, klen = case[6], case[7]
    (q, k, v, do, kl), scale, out, lse, (rq, _, _), (jdq, _, _) = \
        _bwd_base(case)
    dq = emulate_dq(q, k, v, kl, out, lse, do, causal, scale)
    for what, ref in (('plain', rq.float()), ('jax', jdq)):
        _close(dq, ref, BWD_RTOL, BWD_AREL * float(ref.abs().max()),
               'dq %s' % what)
    if 0 in (klen or []):
        assert not dq[torch.tensor(klen) == 0].float().any()


@pytest.mark.parametrize('D,seed,grad', [(128, 3, 'dq'), (16, 0, 'dk')])
def test_one_bf16_rounding_of_ds_can_miss_the_card_tolerance(D, seed, grad):
    """dS = P (dP - delta) sums to zero over a row, so dQ = scale dS K and
    dK = scale dS^T Q cancel: on these inputs (GQA 8/2, causal, k_len
    [150, 77]) one bf16 rounding of dS leaves dQ at D = 128, and dK at D =
    16, past the card's bf16 check (1.34x of it), and the kernels' hi + lo
    terms hold it (since the C7 repair at D = 64 and 128 too: the cases
    c7_* above)."""
    q, k, v, do, kl = _inputs(2, 8, 2, 150, 150, D, [150, 77], seed)
    scale = D ** -0.5
    out, lse = emulate_forward(q, k, v, kl, True, scale)
    refs = dict(zip(('dq', 'dk', 'dv'), tatt.flash_backward_reference(
        q, k, v, kl, out, lse, do, True, scale)))

    def grad_of(split_ds):
        if grad == 'dq':
            return emulate_dq(q, k, v, kl, out, lse, do, True, scale,
                              split_ds)
        return emulate_dkv(q, k, v, kl, out, lse, do, True, scale,
                           split_ds)[0]
    ref = refs[grad].float()
    atol = BWD_AREL * float(ref.abs().max())
    one = (grad_of(False).float() - ref).abs()
    assert not bool((one <= atol + BWD_RTOL * ref.abs()).all())
    _close(grad_of(True), ref, BWD_RTOL, atol, grad)
