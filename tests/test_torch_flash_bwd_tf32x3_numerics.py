"""The arithmetic of the port's float32 flash backward, emulated on the CPU,
against the port's plain version and the JAX package.

csrc/flash_bwd.cu `flash_bwd_dq_tf32x3_kernel` and
`flash_bwd_dkv_tf32x3_kernel` run only on the card.  They run every
float32 product on the TF32 tensor cores as three: x y ~ x_lo y_hi + x_hi
y_lo + x_hi y_hi with x_hi = tf32(x) and x_lo = tf32(x - x_hi), each
rounded to nearest (ties away: `cvt.rna.tf32.f32`).  The tensor cores
form each k8 step's products exactly and add them into a float32
accumulator truncating toward zero; that model is repeated here (float64
partial sums, rounded toward zero), tile by tile at the kernels' sizes,
with ring tiles of TT = 32 rows at D = 64 and 16 at D = 128 (`ring_rows`;
the 32-row layouts need more shared memory than a block may have there):

- dQ, a block of 64 query rows, key tiles of TT: S = Q K^T and dP = dO
  V^T (Q, K, dO, V split; the small terms in one accumulator, the big
  ones in one for S and round robin in four for dP, added in float32),
  P = exp2(S scale log2(e) - LSE log2(e)) and dS = P (dP - delta) under
  the masks (P = 0 where masked), dQ += dS K (dS and K split, one
  accumulator), dQ x scale;
- dK/dV, a block of 64 keys, ring tiles of TT query rows over the GQA
  group's heads from the causal frontier on: S^T = K Q^T and dP^T = V
  dO^T, P^T and dS^T as above, dV += P^T dO and dK += dS^T Q, dK x scale;
- both add their register sums into their output, rounded to nearest,
  at every FLUSH_ROWS-th row of the reduction (keys; query rows of a
  head), at each head's end and at the end, and start them again from
  zero (a chain of truncating adds over the training llama's 4,096 query
  rows a key misses the check: the test below);
- above D = 128 (the instances of width 256) each kernel runs as a
  cluster of two blocks that split D: block 0 reduces columns 0-127,
  block 1 the columns from 128 on, each with the D = 128 kernel's ring
  tiles and accumulators, and the two add their partial S and dP (S^T
  and dP^T) in float32, rounded to nearest (`s_product`); the products
  over rows keep their rounding, column by column.

Rows are independent within a block, so a whole tensor stands for all
blocks; tiles a kernel skips (past k_len or the causal frontier) are fully
masked here and add exact zeros.

The emulation must hold the card's unchanged float32 check (chip_smoke.py
`flash_bwd_case`, tests/test_torch_cuda_kernels.py): rtol 1e-4 and atol
1e-5 x max|grad| against the port's `flash_backward_reference`; and, at
the same tolerance, the JAX package's Pallas backward in interpret mode
(run as tests/test_torch_flash_backward.py runs it), both on the JAX
forward's out and LSE.  The float32 autograd check of the card test, with
its derived allowance where dS cancels (k_len = 1), holds it too.  Three
cheaper designs miss the first check: one TF32 product, and the three
products of S and dP in one accumulator (the kernels' first version,
which missed it on an H100 by 2.3x), at both head dims; and dK/dV in one
chain over the training llama's rows (the first D = 128 version, which
missed it on an H100).  The D = 128 cases include the training llama's
GQA 16/8 causal tiles."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jatt
from paddle_tpu_torch.ops import attention as tatt
from test_torch_cuda_kernels import _cancel_size
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

LOG2E = 1.4426950408889634
FLUSH_ROWS = 256   # rows of the reduction a chain of register sums takes
                   # before the kernels add it into their output
RTOL, AREL = 1e-4, 1e-5


def tf32_rna(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away
    from zero, as cvt.rna.tf32.f32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def rz(x):
    """float64 -> float32, toward zero: how the tensor cores round a sum."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def k8_sums(a, b):
    """a [..., M, K] @ b [..., K, N] as its K / 8 exact partial sums, one a
    k8 step (products of TF32 values are exact), float64 [K/8, ..., M, N]."""
    K = a.shape[-1]
    a8 = a.double().unflatten(-1, (K // 8, 8)).movedim(-2, 0)
    b8 = b.double().unflatten(-2, (K // 8, 8)).movedim(-3, 0)
    return a8 @ b8


def chain(acc, steps):
    """Each step added into the float32 accumulator, rounded toward zero;
    acc None: the first step overwrites it."""
    for st in steps:
        acc = rz(st if acc is None else acc.double() + st)
    return acc


def tc_product(acc, a, b, mode, nbig=1):
    """acc (+)= a @ b as the kernels run it on the TF32 tensor cores.
    'one': one TF32 product.  'x3': three a k8 step into one accumulator,
    small terms first (lo hi, hi lo, hi hi).  'split' (acc None: S and dP):
    the small terms into one accumulator, the big terms' k8 steps round
    robin into `nbig`, summed pairwise and added to the small one in
    float32, rounded to nearest."""
    if mode == 'one':
        return chain(acc, k8_sums(tf32_rna(a), tf32_rna(b)))
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    lh, hl, hh = k8_sums(al, bh), k8_sums(ah, bl), k8_sums(ah, bh)
    if mode == 'x3':
        return chain(acc, [t for kc in range(len(hh))
                           for t in (lh[kc], hl[kc], hh[kc])])
    assert acc is None
    small = chain(None, [t for kc in range(len(hh)) for t in (lh[kc],
                                                              hl[kc])])
    big = [chain(None, hh[i::nbig]) for i in range(nbig)]
    while len(big) > 1:
        big = [big[i] + big[i + 1] for i in range(0, len(big), 2)]
    return big[0] + small


def s_product(a, b, mode, nbig):
    """S or dP = a @ b over D as the kernels form it: up to D = 128 one
    tc_product; above it the two blocks of a cluster each reduce their
    half of D (columns 0-127 and 128 on) in their own accumulators, and
    the two partial sums are added in float32, rounded to nearest."""
    D = a.shape[-1]
    if D <= 128:
        return tc_product(None, a, b, mode, nbig)
    # the second block reduces its 32-column regions, the columns past D
    # TMA's zeros
    pad = -(D - 128) % 32
    a1 = torch.nn.functional.pad(a[..., 128:], (0, pad))
    b1 = torch.nn.functional.pad(b[..., 128:, :], (0, 0, 0, pad))
    return (tc_product(None, a[..., :128], b[..., :128, :], mode, nbig)
            + tc_product(None, a1, b1, mode, nbig))


# how each design forms S and dP: (mode, big accumulators of S, of dP);
# the products that accumulate (dQ, dK, dV) run 'x3', or 'one'
DESIGNS = {'x3': ('split', 1, 4),           # the kernels
           'single_acc': ('x3', 1, 1),     # their first version
           'one': ('one', 1, 1)}           # one TF32 product


def ring_rows(D):
    """Rows of a ring tile (keys for dQ, query rows for dK/dV), as
    csrc/flash_bwd.cu's ring_rows of the instance D runs: width 64 up to
    D = 64, 128 above (above 128 each block of the cluster is laid out as
    the width-128 instance)."""
    return 32 if D <= 64 else 16


def _pad_rows(t, TT):
    """A ring tile of fewer than TT rows, zero-filled to TT."""
    return torch.nn.functional.pad(t, (0, 0, 0, TT - t.shape[-2]))


def emulate_backward(q, k, v, do, kl, out, lse, causal, scale,
                     design='x3', TT=None, flush_rows=FLUSH_ROWS):
    """The two kernels on float32 q/do [B, H, Tq, D], k/v [B, Hkv, Tk, D],
    out, lse [B*H, Tq] -> (dq, dk, dv), with ring tiles of TT rows
    (default: the kernels' ring_rows(D)); flush_rows None: one chain over
    all rows, as the kernels' first D = 128 version ran."""
    B, H, Tq, D = q.shape
    TT = TT or ring_rows(D)
    FR = flush_rows or 1 << 30
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    sp_mode, s_big, dp_big = DESIGNS[design]
    acc_mode = 'one' if design == 'one' else 'x3'

    def sp(a, b, nbig):
        return s_product(a, b, sp_mode, nbig)

    qg = q.reshape(B, Hkv, g, Tq, D)
    dog = do.reshape(B, Hkv, g, Tq, D)
    delta = tatt._bwd_delta(out, do).reshape(B, Hkv, g, Tq, 1)
    lse2 = lse.reshape(B, Hkv, g, Tq, 1) * LOG2E
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    valid = tatt._valid_mask(B, Tq, Tk, causal, kl, 'cpu').expand(
        B, Hkv, g, Tq, Tk)
    zero = torch.zeros(())

    def flush(total, acc, mul=1.0):
        """The block adds a chain into its output, rounded to nearest."""
        part = acc * mul
        return part if total is None else total + part

    # dQ: key tiles of TT in order; a chain ends at every FLUSH_ROWS-th key
    dq, acc = None, torch.zeros(B, Hkv, g, Tq, D)
    nt = -(-Tk // TT)
    for t in range(nt):
        k0 = t * TT
        n = min(TT, Tk - k0)   # keys past Tk: TMA fills zeros
        kt, vt = (_pad_rows(x[:, :, None, k0:k0 + n], TT) for x in (k, v))
        vm = torch.zeros(B, Hkv, g, Tq, TT, dtype=torch.bool)
        vm[..., :n] = valid[..., k0:k0 + n]
        s = sp(qg, kt.transpose(-1, -2), s_big)
        dp = sp(dog, vt.transpose(-1, -2), dp_big)
        p = torch.where(vm, torch.exp2(s * sl2 - lse2), zero)
        ds = torch.where(vm, p * (dp - delta), zero)
        acc = tc_product(acc, ds, kt.expand(B, Hkv, g, -1, D), acc_mode)
        if (k0 + TT) % FR == 0 or t + 1 == nt:
            dq, acc = flush(dq, acc, scale), torch.zeros_like(acc)

    # dK/dV: ring tiles of TT query rows, the group's heads outer; a
    # chain ends with a head and at every FLUSH_ROWS-th query row (tiles a
    # block skips before its causal frontier add zeros to its chain)
    dk = dv = None
    dka, dva = torch.zeros(B, Hkv, Tk, D), torch.zeros(B, Hkv, Tk, D)
    for gi in range(g):
        for q0 in range(0, Tq, TT):
            n = min(TT, Tq - q0)   # rows past Tq: TMA fills zeros
            qt, dot = (_pad_rows(x[:, :, gi, q0:q0 + n], TT)
                       for x in (qg, dog))
            vm = torch.zeros(B, Hkv, Tk, TT, dtype=torch.bool)
            vm[..., :n] = valid[:, :, gi, q0:q0 + n].transpose(-1, -2)
            lt = torch.zeros(B, Hkv, 1, TT)
            lt[..., :n] = lse2[:, :, gi, q0:q0 + n].transpose(-1, -2)
            dlt = torch.zeros(B, Hkv, 1, TT)
            dlt[..., :n] = delta[:, :, gi, q0:q0 + n].transpose(-1, -2)
            st = sp(k, qt.transpose(-1, -2), s_big)
            dpt = sp(v, dot.transpose(-1, -2), dp_big)
            pt = torch.where(vm, torch.exp2(st * sl2 - lt), zero)
            dst = torch.where(vm, pt * (dpt - dlt), zero)
            dva = tc_product(dva, pt, dot, acc_mode)
            dka = tc_product(dka, dst, qt, acc_mode)
            head_end = q0 + TT >= Tq and (flush_rows or gi == g - 1)
            if (q0 + TT) % FR == 0 or head_end:
                dk, dv = flush(dk, dka, scale), flush(dv, dva)
                dka, dva = torch.zeros_like(dka), torch.zeros_like(dva)
    return dq.reshape(B, H, Tq, D), dk, dv


CASES = [
    # B, H, Hkv, Tq, Tk, D, causal, k_len (None: Tk)
    (2, 4, 4, 256, 256, 64, False, None),            # the training tiles
    (2, 4, 4, 256, 256, 64, True, [256, 200]),       # causal, k_len
    (2, 8, 2, 128, 128, 64, True, None),             # GQA 8/2
    (3, 4, 2, 150, 150, 64, False, [150, 77, 1]),    # k_len 1, ragged
    (2, 8, 2, 150, 150, 64, False, [150, 1]),        # k_len 1, GQA 8/2
    (2, 4, 4, 70, 70, 64, True, [0, 50]),            # k_len 0 rows
    (2, 4, 1, 37, 161, 64, True, [161, 100]),        # Tq < Tk, k_len
    (2, 4, 2, 50, 300, 64, False, [300, 299]),       # Tq < Tk
    (3, 4, 2, 150, 150, 128, True, [150, 77, 1]),    # D = 128
    (1, 16, 8, 128, 128, 128, True, None),           # llama's GQA 16/8
    (3, 8, 4, 70, 70, 128, True, [70, 0, 1]),        # k_len 0 and 1 rows
    (2, 8, 4, 100, 100, 128, False, [100, 1]),       # k_len 1, GQA 8/4
    (2, 4, 2, 37, 161, 128, True, [161, 100]),       # Tq < Tk, k_len
    (2, 4, 2, 50, 200, 128, False, [200, 199]),      # Tq < Tk
    (1, 4, 2, 97, 161, 128, False, [130]),           # ragged q, k tiles
    # the padded instances: D = 40 in the 64 one, 96 in the 128 one
    (3, 8, 2, 100, 100, 40, True, [100, 0, 1]),      # k_len 0, 1, GQA
    (3, 8, 4, 70, 130, 96, True, [130, 1, 77]),      # Tq < Tk, k_len 1
    # the width-256 instances, a cluster of two blocks splitting D: 256,
    # and 136 (one 32-column region in the second block), 200 and 248
    # padded; GQA and MQA, causal and not, k_len 0 and 1 rows, Tq < Tk,
    # ragged last query and key tiles
    (3, 8, 2, 150, 150, 256, True, [150, 0, 1]),     # D = 256, GQA
    (2, 8, 4, 100, 100, 256, False, [100, 1]),       # k_len 1, GQA 8/4
    (2, 8, 1, 97, 161, 256, False, [161, 130]),      # MQA, ragged
    (3, 8, 2, 37, 161, 136, True, [161, 0, 1]),      # Tq < Tk, k_len 0, 1
    (2, 8, 1, 97, 161, 200, True, [130, 1]),         # MQA, ragged, k_len
    (2, 8, 2, 150, 150, 248, False, [150, 0]),       # k_len 0, GQA
]
IDS = ['path_d64', 'causal_klen', 'gqa', 'klen1', 'klen1_gqa', 'klen0',
       'tq_lt_tk', 'tq_lt_tk_noncausal', 'd128_klen1', 'd128_gqa_causal',
       'd128_klen01', 'd128_klen1_gqa', 'd128_tq_lt_tk',
       'd128_tq_lt_tk_noncausal', 'd128_ragged', 'd40_klen01_gqa',
       'd96_tq_lt_tk_klen1', 'd256_klen01_gqa', 'd256_klen1_gqa',
       'd256_mqa_ragged', 'd136_tq_lt_tk_klen01', 'd200_mqa_ragged',
       'd248_klen0_gqa']


def _inputs(B, H, Hkv, Tq, Tk, D, klen, seed=0):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(B, H, Tq, D).astype('float32') for _ in range(2))
    k, v = (rng.randn(B, Hkv, Tk, D).astype('float32') for _ in range(2))
    kl = np.asarray([Tk] * B if klen is None else klen, np.int32)
    return q, k, v, do, kl


def _block(n):
    """The JAX kernels' grid needs tiles that divide T: the largest
    divisor of n up to 64."""
    return max(b for b in range(1, min(n, 64) + 1) if n % b == 0)


def _jax_backward(q, k, v, do, kl, causal, scale):
    """The JAX Pallas forward and backward kernels in interpret mode ->
    (out, lse [B*H, Tq], dq, dk, dv) as torch tensors."""
    bq, bk = _block(q.shape[2]), _block(k.shape[2])
    args = [jnp.asarray(a) for a in (q, k, v)]
    out, lse = jatt._flash_forward(*args, jnp.asarray(kl), causal, scale,
                                   bq, bk, interpret=True)
    grads = jatt._flash_backward(*args, jnp.asarray(kl), out, lse,
                                 jnp.asarray(do), causal, scale, bq, bk,
                                 interpret=True)
    return [torch.from_numpy(np.array(a))
            for a in (out, lse[..., 0]) + tuple(grads)]


def _within(got, ref):
    """Every element within the card's float32 check."""
    atol = AREL * float(ref.abs().max())
    return bool(((got - ref).abs() <= atol + RTOL * ref.abs()).all())


# each case's inputs, its JAX kernels' run (the Pallas interpreter, most of
# a case's time) and its plain references, and each (case, design)'s
# emulation, computed once for the tests that share them; no test writes
# them
_BASES, _RUNS = {}, {}


def _base(case):
    key = repr(case)
    if key not in _BASES:
        B, H, Hkv, Tq, Tk, D, causal, klen = case
        q, k, v, do, kl = _inputs(B, H, Hkv, Tq, Tk, D, klen)
        out, lse, *jgrads = _jax_backward(q, k, v, do, kl, causal,
                                          D ** -0.5)
        t = [torch.from_numpy(a) for a in (q, k, v, do, kl)]
        refs = tatt.flash_backward_reference(t[0], t[1], t[2], t[4], out,
                                             lse, t[3], causal, D ** -0.5)
        _BASES[key] = (t, out, lse, refs, jgrads)
    return _BASES[key]


def _run(case, design='x3'):
    key = (repr(case), design)
    if key not in _RUNS:
        t, out, lse, refs, jgrads = _base(case)
        grads = emulate_backward(*t, out, lse, case[6], case[5] ** -0.5,
                                 design)
        _RUNS[key] = (t, out, lse, grads, refs, jgrads)
    return _RUNS[key]


def test_tf32_split_keeps_float32():
    """hi + lo keeps x to 2^-22; hi alone to 2^-11."""
    r = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(
        'float32'))
    hi = tf32_rna(r)
    lo = tf32_rna(r - hi)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((hi - r).abs() / r.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_backward_emulation_within_the_float32_check(case):
    t, out, lse, grads, refs, jgrads = _run(case)
    if case[5] > 128:
        # above D = 128 dP rounds more, and the float32 references keep
        # their own rounding of dS where a k_len = 1 row cancels it (the
        # plain version misses the check against the exact gradients on
        # d136_tq_lt_tk_klen01, 1.19x): the width-256 cases are held to
        # the plain version evaluated in float64, as the card test holds
        # every float32 kernel, and to the JAX kernels with the autograd
        # check's allowance for the rounding of the cancelling terms
        q, k, v, do, kl = t
        causal, scale = case[6], case[5] ** -0.5
        exact = tatt.flash_backward_reference(
            *(x.double() for x in (q, k, v)), kl, out.double(),
            lse.double(), do.double(), causal, scale)
        cancel = _cancel_size(q, k, v, kl, out, lse, do, causal, scale)
        eps = torch.finfo(torch.float32).eps
        for got, ex, jref, c, n in zip(grads, exact, jgrads, cancel,
                                       ('dq', 'dk', 'dv')):
            assert _within(got.double(), ex), n
            bound = RTOL * jref.abs() + AREL * float(jref.abs().max()) + \
                4 * eps * c
            assert bool(((got - jref).abs() <= bound).all()), n
    else:
        for got, ref, jref, n in zip(grads, refs, jgrads,
                                     ('dq', 'dk', 'dv')):
            assert _within(got, ref), (n, float((got - ref).abs().max()))
            assert _within(got, jref), (n, float((got - jref).abs().max()))
    klen = case[-1]
    if klen is not None and 0 in klen:   # no valid key: zero gradients
        zero = t[4] == 0
        assert not any(g[zero].any() for g in grads)


AUTOGRAD_IDS = ['klen1', 'klen1_gqa', 'd128_klen1', 'd128_klen1_gqa',
                'd96_tq_lt_tk_klen1', 'd256_klen1_gqa']


@pytest.mark.parametrize('case', [CASES[IDS.index(i)] for i in AUTOGRAD_IDS],
                         ids=AUTOGRAD_IDS)
def test_emulation_within_the_autograd_check_where_ds_cancels(case):
    """The card test's independent float32 check (autograd through the
    plain forward), with its derived allowance of 4 eps x the size of the
    terms that cancel in dS = P (dP - delta): a row with k_len = 1 has dP
    = delta exactly, and 3xTF32 stays inside that allowance."""
    t, out, lse, grads, _, _ = _run(case)
    q, k, v, do, kl = t
    causal, scale = case[6], case[5] ** -0.5
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    ref_out, _ = tatt._ref_attention(*leaves, causal, scale, kl)
    auto = torch.autograd.grad(ref_out, leaves, do)
    cancel = _cancel_size(q, k, v, kl, out, lse, do, causal, scale)
    eps = torch.finfo(torch.float32).eps
    for a, r, c, n in zip(grads, auto, cancel, ('dq', 'dk', 'dv')):
        bound = 1e-4 * r.abs() + 1e-5 * float(r.abs().max()) + 4 * eps * c
        assert bool(((a - r).abs() <= bound).all()), (
            n, float(((a - r).abs() / bound).max()))


@pytest.mark.parametrize('D,DP', [(96, 128), (40, 64), (200, 256),
                                  (136, 256)])
def test_padding_to_the_instance_width_changes_no_bit(D, DP):
    """The kernels run D = 96 in the instance of width 128 (40 in the 64
    one, 136 and 200 in the 256 one, whose second block reduces columns
    128 .. D-1), TMA reading columns D .. DP-1 as zeros, with the products
    over D stopped at the k8 step that holds column D - 1.  Emulated over
    all DP columns instead, the zero columns add exact zeros to each
    truncating chain: S and dP (each of their accumulators, and above 128
    each block's partial sums), and the gradients' first D columns, are
    bit for bit those of the unpadded emulation, the columns past D are
    zero, and the result holds the float32 check."""
    B, H, Hkv, Tq, Tk = 2, 8, 2, 70, 100
    q, k, v, do, kl = (torch.from_numpy(a) for a in _inputs(
        B, H, Hkv, Tq, Tk, D, [100, 1], seed=3))
    scale = D ** -0.5
    pad = [torch.nn.functional.pad(t, (0, DP - D)) for t in (q, k, v, do)]
    qg = q.reshape(B, Hkv, H // Hkv, Tq, D)
    pqg = pad[0].reshape(B, Hkv, H // Hkv, Tq, DP)
    for a, b, pa, pb in ((qg, k, pqg, pad[1]),
                         (do.reshape(qg.shape), v,
                          pad[3].reshape(pqg.shape), pad[2])):
        for nbig in (1, 4):
            assert torch.equal(
                s_product(a, b[:, :, None].transpose(-1, -2), 'split',
                          nbig),
                s_product(pa, pb[:, :, None].transpose(-1, -2), 'split',
                          nbig))
    out, lse = tatt._ref_attention(q, k, v, True, scale, kl)
    grads = emulate_backward(q, k, v, do, kl, out, lse, True, scale,
                             TT=ring_rows(DP))
    padded = emulate_backward(*pad[:3], pad[3], kl,
                              torch.nn.functional.pad(out, (0, DP - D)),
                              lse, True, scale, TT=ring_rows(DP))
    refs = tatt.flash_backward_reference(q, k, v, kl, out, lse, do, True,
                                         scale)
    for g, p, r, n in zip(grads, padded, refs, ('dq', 'dk', 'dv')):
        assert torch.equal(p[..., :D], g), n
        assert not p[..., D:].any(), n
        assert _within(g, r), (n, float((g - r).abs().max()))


@pytest.mark.parametrize('name', ['path_d64', 'd128_gqa_causal',
                                  'd256_klen01_gqa'])
def test_one_tf32_product_would_miss_the_float32_check(name):
    """One TF32 product keeps ~2^-11 of each operand: the gradients miss
    rtol 1e-4 / atol 1e-5 x max|grad| that the 3xTF32 split holds."""
    _, _, _, grads, refs, _ = _run(CASES[IDS.index(name)], design='one')
    assert not any(_within(g, r) for g, r in zip(grads, refs))


@pytest.mark.parametrize('name', ['klen1_gqa', 'd128_klen1_gqa'])
def test_one_accumulator_for_s_and_dp_would_miss_the_float32_check(name):
    """The kernels' first version added all three products of S and dP
    into one accumulator: truncated at the big terms' scale, the small
    terms' low bits are lost, and dK of a GQA group whose batch row has one
    valid key (every dS there is rounding; 600 of them sum into it) misses
    the check (on an H100 by 2.3x), which the kernels' own
    accumulators hold (the test above, the same cases)."""
    case = CASES[IDS.index(name)]
    _, _, _, grads, refs, _ = _run(case, design='single_acc')
    assert not _within(grads[1], refs[1])


@pytest.mark.parametrize('flush_rows', [FLUSH_ROWS, None],
                         ids=['kernels', 'one_chain'])
def test_dkv_chain_over_the_llama_rows_needs_the_flush(flush_rows):
    """A key of the training llama sums over 2 heads x 2048 query rows.
    In one chain of truncating adds (3 a k8 step: 1,536) dK and dV drift
    toward zero past the float32 check (the kernels' first D = 128
    version missed it on an H100); chains of FLUSH_ROWS rows, added into
    the output rounded to nearest, hold it.  A llama key block's rows at
    their width, against the port's plain version (non-causal, so every
    key sees all rows)."""
    B, H, Hkv, Tq, Tk, D = 1, 2, 1, 2048, 64, 128
    q, k, v, do, kl = (torch.from_numpy(a) for a in _inputs(
        B, H, Hkv, Tq, Tk, D, None))
    scale = D ** -0.5
    out, lse = tatt._ref_attention(q, k, v, False, scale, kl)
    grads = emulate_backward(q, k, v, do, kl, out, lse, False, scale,
                             flush_rows=flush_rows)
    refs = tatt.flash_backward_reference(q, k, v, kl, out, lse, do, False,
                                         scale)
    held = [_within(got, ref) for got, ref in zip(grads, refs)]
    assert held == ([True] * 3 if flush_rows else [True, False, False]), held


def test_float32_plain_misses_the_check_where_a_gqa_group_cancels():
    """At a batch row with k_len = 1, dS = P (dP - delta) is all rounding,
    and dK of its key sums g x Tq such terms (8 x 150 here).  Held to the
    exact gradients (the plain version evaluated in float64 on the same
    inputs), the plain version's own float32 rounding misses the float32
    check there, and the kernels' arithmetic holds it: the card test holds
    the float32 kernels to the float64 evaluation for that reason."""
    grads, plain, exact = _where_a_group_cancels(128)
    assert not _within(plain[1].double(), exact[1])
    assert all(_within(g.double(), e) for g, e in zip(grads, exact))


def test_float32_plain_misses_the_check_where_a_group_cancels_at_d256():
    """The same inputs at D = 256, where each block of the cluster reduces
    half of D and the two add their partial S and dP.  dP's rounding grows
    with D: the plain version misses the check against the exact gradients
    (1.39x on these inputs), and the kernels' arithmetic lands just past
    its edge (1.05x), nearer the exact gradients than the plain version;
    dQ and dV hold it.  At this size the check is float32's own noise for
    such rows (the card's cases, 600 cancelling rows at most, hold it)."""
    grads, plain, exact = _where_a_group_cancels(256)

    def ratio(got, ref):
        atol = AREL * float(ref.abs().max())
        return float(((got.double() - ref).abs()
                      / (atol + RTOL * ref.abs())).max())
    assert ratio(plain[1], exact[1]) > 1.0
    assert ratio(grads[1], exact[1]) < ratio(plain[1], exact[1])
    assert _within(grads[0].double(), exact[0])
    assert _within(grads[2].double(), exact[2])


def _where_a_group_cancels(D):
    """(emulated kernels, float32 plain, float64 plain) gradients at an
    MQA group of 8 x 150 rows whose batch row has k_len = 1."""
    B, H, Hkv, Tq, Tk = 2, 8, 1, 150, 150
    q, k, v, do, kl = (torch.from_numpy(a) for a in _inputs(
        B, H, Hkv, Tq, Tk, D, [1, 150], seed=5))
    scale = D ** -0.5
    out, lse = tatt._ref_attention(q, k, v, False, scale, kl)
    exact = tatt.flash_backward_reference(
        *(t.double() for t in (q, k, v)), kl, out.double(), lse.double(),
        do.double(), False, scale)
    plain = tatt.flash_backward_reference(q, k, v, kl, out, lse, do, False,
                                          scale)
    return (emulate_backward(q, k, v, do, kl, out, lse, False, scale),
            plain, exact)
