"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device (the decision is taken
inside the fixture, never at import).  On the card, where the JAX package
and its test conftest are not installed, run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py

This file imports neither jax nor paddle_tpu."""
import re

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.ops import attention as att
from paddle_tpu_torch.ops import fused as tfused
from paddle_tpu_torch.ops import gather as ga
from paddle_tpu_torch.ops import kernelgen
from paddle_tpu_torch.ops import nn as tnn
from paddle_tpu_torch.ops import optimizer_ops as oo

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run on the card only')
    return torch.device('cuda')


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device='cuda').to(dtype)


@pytest.mark.parametrize('dtype,D,causal,Tq,Tk,klen', [
    (torch.float32, 64, True, 130, 130, [130, 3]),
    (torch.float32, 128, False, 65, 200, [200, 150]),
    (torch.bfloat16, 128, True, 7, 300, [300, 0]),
    (torch.bfloat16, 64, False, 256, 256, [256, 256]),
    # the tensor-core (wgmma) kernel's ragged cases: k_len 0 rows; GQA,
    # causal, D=128 with a last query tile of 200 - 192 = 8 rows
    (torch.bfloat16, 64, True, 70, 70, [0, 50]),
    (torch.bfloat16, 128, True, 200, 200, [200, 200]),
    # the float32 (3xTF32 wgmma) kernel's: k_len 0 and 1 rows, a ragged
    # last query tile and key tile (Tq 97, Tk 161), decode Tq < Tk, D=128
    # causal with a last query tile of 8 rows
    (torch.float32, 64, True, 70, 70, [0, 50]),
    (torch.float32, 128, True, 150, 150, [150, 1]),
    (torch.float32, 64, False, 97, 161, [130, 161]),
    (torch.float32, 128, True, 5, 333, [333, 100]),
    (torch.float32, 128, True, 200, 200, [200, 200]),
    # the instance of width 256: D = 256 unpadded and 200 padded, k_len 0
    # and 1 rows, ragged last query and key tiles, Tq < Tk
    (torch.float32, 256, True, 150, 150, [150, 0]),
    (torch.bfloat16, 256, True, 97, 161, [161, 1]),
    (torch.float32, 200, False, 97, 161, [130, 1]),
    (torch.bfloat16, 200, True, 37, 161, [161, 0]),
])
def test_flash_kernel_matches_plain(cuda, dtype, D, causal, Tq, Tk, klen):
    g = torch.Generator(device='cuda').manual_seed(0)
    q = _randn(g, 2, 4, Tq, D, dtype=dtype)
    k = _randn(g, 2, 2, Tk, D, dtype=dtype)
    v = _randn(g, 2, 2, Tk, D, dtype=dtype)
    kl = torch.tensor(klen, dtype=torch.int32, device='cuda')
    before = kernels.launches['flash_attention_fwd']
    out, lse = att.flash_forward(q, k, v, causal, None, kl)
    torch.cuda.synchronize()
    assert kernels.launches['flash_attention_fwd'] == before + 1
    ref, ref_lse = att._ref_attention(q, k, v, causal, D ** -0.5, kl)
    # f32: other summation orders; bf16: one bf16 rounding of ~equal f32
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=8e-3, atol=1e-3)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)


def test_float32_flash_at_the_served_shape_runs_the_tf32x3_kernel(cuda):
    """llama_1b's attention (B=4, H=16, Hkv=8, T=2048, D=128, causal,
    float32) within the float32 check, through flash_fwd_tf32x3_kernel and
    no other flash kernel."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device='cuda').manual_seed(3)
    q = _randn(g, 4, 16, 2048, 128)
    k = _randn(g, 4, 8, 2048, 128)
    v = _randn(g, 4, 8, 2048, 128)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = att.flash_forward(q, k, v, True)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if 'flash' in e.key]
    assert len(names) == 1 and 'flash_fwd_tf32x3_kernel' in names[0], names
    ref, ref_lse = att._ref_attention(q, k, v, True, 128 ** -0.5)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)


def test_flash_wrapper_raises_on_cuda_instead_of_falling_back(cuda):
    q = torch.zeros(1, 2, 8, 100, device='cuda')
    with pytest.raises(ValueError, match='head dims'):
        att.flash_forward(q, q, q, True)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_d256_forward_raises_when_its_launch_fails(cuda, dtype):
    """A D = 256 forward whose launch the entry point refuses (q two
    elements off the 16-byte alignment TMA needs: no tensor map) raises,
    and counts no launch: no fallback to another kernel or the plain
    version."""
    n = 2 * 16 * 256
    q = torch.zeros(n + 8, dtype=dtype, device='cuda')[2:n + 2].view(
        1, 2, 16, 256)
    k = torch.zeros(1, 2, 16, 256, dtype=dtype, device='cuda')
    before = kernels.launches['flash_attention_fwd']
    with pytest.raises(RuntimeError, match='flash_attention_fwd kernel '
                       'launch failed'):
        att.flash_forward(q, k, k, True)
    assert kernels.launches['flash_attention_fwd'] == before


@pytest.mark.parametrize('dtype,D,ids_dtype,misalign', [
    (torch.float32, 2048, torch.int32, 0),
    (torch.bfloat16, 100, torch.int64, 0),
    (torch.float16, 99, torch.int32, 0),
    # 16-byte rows in segments of 128 words: 4 whole, then 4 + 1 word
    (torch.float32, 2048, torch.int64, 0),
    (torch.float32, 2052, torch.int32, 0),
    # the scalar branch: float32 rows of 99 words; a table that starts
    # off a 16-byte boundary (float32 and bf16 rows of whole 16-byte words)
    (torch.float32, 99, torch.int64, 0),
    (torch.float32, 512, torch.int32, 1),
    (torch.bfloat16, 512, torch.int64, 1),
])
def test_gather_kernel_matches_plain(cuda, dtype, D, ids_dtype, misalign):
    g = torch.Generator(device='cuda').manual_seed(1)
    V = 500
    w = _randn(g, V * D + misalign, dtype=dtype)[misalign:].view(V, D)
    assert (w.data_ptr() % 16 != 0) == bool(misalign)
    ids = torch.randint(-V, V, (3, 77), generator=g, device='cuda')
    ids[0, :3] = torch.tensor([V, -V - 1, 10 ** 6])
    ids = ids.to(ids_dtype)
    before = kernels.launches['embedding_gather']
    out = ga.embedding_gather(w, ids)
    torch.cuda.synchronize()
    assert kernels.launches['embedding_gather'] == before + 1
    ref = ga.embedding_gather_reference(w, ids)
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(out[0, :3]).all()


def _profiled(fn, pattern):
    """fn() under torch.profiler -> (its result, the names of the kernels
    matching `pattern` in the trace, the runs it took).  The profiler drops
    a trace's kernel events now and then: a trace that names none is taken
    again, running fn again, up to 3 runs."""
    for runs in (1, 2, 3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            res = fn()
            torch.cuda.synchronize()
        names = {m.group(0) for m in (re.search(pattern, e.key)
                                      for e in prof.key_averages()) if m}
        if names:
            break
    return res, names, runs


@pytest.mark.parametrize('dtype,D,causal,Tq,Tk,Hkv,klen', [
    (torch.bfloat16, 64, False, 256, 256, 8, [256, 256]),
    (torch.bfloat16, 64, True, 256, 256, 8, [256, 200]),
    (torch.float32, 64, True, 128, 128, 2, [128, 128]),
    (torch.float32, 128, False, 150, 150, 4, [150, 1]),
    (torch.bfloat16, 128, True, 37, 161, 1, [161, 0]),
    # the tensor-core (wgmma) dK/dV kernel's ragged cases: GQA 8/2, Tq < Tk
    # with a partial k_len, a partial k_len at D=128
    (torch.bfloat16, 64, True, 128, 128, 2, [128, 128]),
    (torch.bfloat16, 64, True, 37, 161, 1, [161, 100]),
    (torch.bfloat16, 128, False, 150, 150, 2, [150, 77]),
    # the tensor-core (wgmma) dQ kernel's: GQA 8/2, causal, D=128 with a
    # last query tile of 200 - 192 = 8 rows; a k_len 0 row; Tq < Tk
    # without the causal mask
    (torch.bfloat16, 128, True, 200, 200, 2, [200, 200]),
    (torch.bfloat16, 64, True, 70, 70, 4, [0, 50]),
    (torch.bfloat16, 64, False, 50, 300, 2, [300, 299]),
    # the float32 (3xTF32 wgmma, D = 64) kernels': a partial k_len on the
    # training shape's tiles, k_len 0 and 1 rows, Tq < Tk with and without
    # the causal mask, ragged query and key tiles
    (torch.float32, 64, True, 256, 256, 8, [256, 200]),
    (torch.float32, 64, True, 70, 70, 4, [0, 50]),
    (torch.float32, 64, False, 150, 150, 2, [150, 1]),
    (torch.float32, 64, True, 37, 161, 1, [161, 100]),
    (torch.float32, 64, False, 50, 300, 2, [300, 299]),
    # float32 at D = 96 runs the 3xTF32 kernels' padded 128 instance
    (torch.float32, 96, True, 129, 129, 2, [129, 90]),
])
def test_flash_backward_kernels_match_plain(cuda, dtype, D, causal, Tq, Tk,
                                            Hkv, klen):
    _check_backward_kernels(dtype, D, causal, Tq, Tk, 8, Hkv, klen)


# the float32 (3xTF32 wgmma, D = 128) kernels' ragged edges: the training
# llama's GQA 16/8 causal tiles, k_len 0 and 1 rows, Tq < Tk with and
# without the causal mask, partial last query and key tiles (Tq 97, Tk 161)
@pytest.mark.parametrize('causal,Tq,Tk,H,Hkv,klen', [
    (True, 256, 256, 16, 8, [256, 256]),
    (True, 150, 150, 8, 4, [0, 150]),
    (False, 150, 150, 8, 2, [1, 150]),
    (True, 37, 161, 8, 2, [161, 100]),
    (False, 50, 300, 8, 4, [300, 299]),
    (False, 97, 161, 8, 4, [161, 130]),
    (True, 97, 161, 16, 8, [161, 161]),
])
def test_float32_d128_backward_kernels_match_plain(cuda, causal, Tq, Tk, H,
                                                   Hkv, klen):
    _check_backward_kernels(torch.float32, 128, causal, Tq, Tk, H, Hkv, klen)


# the other head dims up to 128 on the tensor-core backward, padded into
# the instance of width 64 (D < 64) or 128: the smallest D, a float32 tile
# with a 32-column region wholly past D (D <= 32 in the 64 instance, 64 <
# D <= 96 in the 128 one), bf16 at D % 16 == 8 (the last k16 step half
# zeros: 8, 40, 72, 120); ragged Tq / Tk, k_len 0 and 1 rows in a GQA
# group, Tq < Tk with and without the causal mask
_PADDED_SHAPES = {
    'gqa_klen01': (True, 150, 150, 8, 2, [150, 0, 1]),
    'tq_lt_tk_klen1': (True, 37, 161, 8, 4, [161, 100, 1]),
    'ragged_noncausal': (False, 97, 161, 4, 4, [130, 161]),
}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('D,shape', [
    (D, name) for D in (16, 40, 96, 120) for name in _PADDED_SHAPES] + [
    (8, 'gqa_klen01'), (32, 'gqa_klen01'), (72, 'gqa_klen01')])
def test_padded_backward_kernels_match_plain(cuda, dtype, D, shape):
    _check_backward_kernels(dtype, D, *_PADDED_SHAPES[shape])


def _bwd_width(D):
    """The width of the tensor-core backward's instance that runs head dim
    D (csrc/hopper_mma.cuh with_bwd_instance): 64, 128 or 256."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


# the head dims above 128 on the tensor-core backward's instances of
# width 256: D = 256 unpadded, 136 (bf16: the last 64-column chunk wholly
# past D, not loaded; float32: one 32-column region in the cluster's
# second block), 200 and 248 padded; causal and not, GQA and MQA, k_len 0
# and 1 rows, Tq < Tk, ragged last query and key tiles; against the plain
# backward in float64
_WIDE_SHAPES = {
    'gqa_klen01': (True, 150, 150, 8, 2, [150, 0, 1]),
    'mqa_tq_lt_tk': (True, 37, 161, 8, 1, [161, 100, 1]),
    'noncausal_mqa': (False, 97, 161, 8, 1, [130, 0, 161]),
    'noncausal_gqa': (False, 150, 130, 16, 4, [130, 1]),
}


@pytest.mark.parametrize('D,shape', [
    (D, name) for D in (256, 136, 200, 248) for name in _WIDE_SHAPES])
def test_wide_bf16_backward_kernels_match_plain(cuda, D, shape):
    _check_backward_kernels(torch.bfloat16, D, *_WIDE_SHAPES[shape],
                            exact64=True)


@pytest.mark.parametrize('D,shape', [
    (D, name) for D in (256, 136, 200, 248) for name in _WIDE_SHAPES])
def test_wide_float32_backward_kernels_match_plain(cuda, D, shape):
    """float32 there: 3xTF32 in clusters of two blocks, each reducing S
    and dP over its half of D and adding the other's partial sums, held
    to the unchanged float32 check against the float64 plain backward."""
    _check_backward_kernels(torch.float32, D, *_WIDE_SHAPES[shape])


# causal Tq < Tk and Tq = Tk with a k_len 0 batch row and a partial one:
# blocks that skip leading tiles, blocks with no tile at all, blocks cut
# short by k_len
_SKIP_SHAPES = {
    'tq_lt_tk_klen0': (True, 37, 300, 8, 2, [300, 0, 150]),
    'causal_klen0': (True, 200, 200, 8, 1, [200, 0, 77]),
}


@pytest.mark.parametrize('D,shape', [(D, name) for D in (256, 136)
                                     for name in _SKIP_SHAPES])
def test_wide_float32_clusters_agree_on_the_tiles_they_skip(cuda, D, shape):
    """The two blocks of a float32 cluster at width 256 must walk the same
    tiles: a block that skips a tile, or has none, while its peer waits
    for its partial sums would wait forever (the barrier waits trap after
    seconds).  The shapes where blocks skip, run in a child process under
    a time limit, so that a disagreement fails this test instead of
    hanging a training step; the child holds the gradients to the float32
    check as the other cases do."""
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    code = ('import sys, torch; sys.path[:0] = [%r, %r]; '
            'import test_torch_cuda_kernels as t; '
            't._check_backward_kernels(torch.float32, %d, *%r)'
            % (here, os.path.dirname(here), D, _SKIP_SHAPES[shape]))
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]


@pytest.mark.parametrize('D', [136, 256])
def test_wide_backward_raises_when_its_launch_fails(cuda, D):
    """A backward at D > 128 whose launch the entry point refuses (q two
    elements off the 16-byte alignment TMA needs: no tensor map) raises
    and counts no launch, in bf16 and in float32 (whose instances of
    width 256 launch clusters of two blocks): no fallback to another
    kernel or the plain version."""
    g = torch.Generator(device='cuda').manual_seed(3)
    B, H, T = 1, 2, 16
    n = B * H * T * D
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(n + 8, dtype=dtype, device='cuda')[2:n + 2].view(
            B, H, T, D)
        k = _randn(g, B, H, T, D, dtype=dtype)
        out, lse = att.flash_forward(k, k, k, True)
        before = dict(kernels.launches)
        with pytest.raises(RuntimeError, match='flash_attention_bwd_dq '
                           'kernel launch failed'):
            att.flash_backward(q, k, k, None, out, lse, out, True)
        for name in ('flash_attention_bwd_dq', 'flash_attention_bwd_dkv'):
            assert kernels.launches[name] == before[name], dtype
        with pytest.raises(RuntimeError, match='flash_attention_bwd_dkv '
                           'kernel launch failed'):
            att._launch_bwd_dkv(q, k, k, torch.full((B,), T,
                                                    dtype=torch.int32,
                                                    device='cuda'),
                                lse, att._bwd_delta(out, out), out, True,
                                D ** -0.5)
        assert kernels.launches['flash_attention_bwd_dkv'] == \
            before['flash_attention_bwd_dkv'], dtype


def _check_backward_kernels(dtype, D, causal, Tq, Tk, H, Hkv, klen,
                            exact64=False):
    """The port's backward against the plain one (float32 kernels, and
    with `exact64` any dtype, against it in float64), the kernels and the
    tensor-core instance it ran read from the profiler."""
    g = torch.Generator(device='cuda').manual_seed(2)
    B = len(klen)
    q = _randn(g, B, H, Tq, D, dtype=dtype)
    do = _randn(g, B, H, Tq, D, dtype=dtype)
    k = _randn(g, B, Hkv, Tk, D, dtype=dtype)
    v = _randn(g, B, Hkv, Tk, D, dtype=dtype)
    kl = torch.tensor(klen, dtype=torch.int32, device='cuda')
    out, lse = att.flash_forward(q, k, v, causal, None, kl)
    before = dict(kernels.launches)
    grads, full, runs = _profiled(
        lambda: att.flash_backward(q, k, v, kl, out, lse, do, causal),
        r'flash_bwd_\w+?_kernel(<[^>(]*>)?')
    names = {n.split('<')[0] for n in full}
    for name in ('flash_attention_bwd_dq', 'flash_attention_bwd_dkv'):
        assert kernels.launches[name] == before[name] + runs
    # the design each dtype and D runs: bf16 on wgmma, float32 as 3xTF32
    # wgmma, at every D up to 256 (other D than 64, 128 and 256 padded;
    # float32 at width 256 in clusters of two blocks splitting D), never
    # the CUDA-core kernels (csrc/flash_cc.cu)
    assert att.bwd_tensor_core(D, dtype)
    design = 'wgmma' if dtype == torch.bfloat16 else 'tf32x3'
    assert names == {'flash_bwd_dq_%s_kernel' % design,
                     'flash_bwd_dkv_%s_kernel' % design}, names
    inst = '<%d, %s' % (_bwd_width(D), str(D != _bwd_width(D)).lower())
    if dtype == torch.bfloat16:
        assert full == {n + inst + '>' for n in names}, full
    elif D > 128:
        # and the 32-column regions the products over D reduce, KC 5-8
        assert full == {n + inst + ', %d>' % -(-D // 32) for n in names}, \
            full
    refs = att.flash_backward_reference(q, k, v, kl, out, lse, do, causal,
                                        D ** -0.5)
    # f32: other summation orders, and dS = P (dP - delta) cancels, so the
    # bound is relative to the largest gradient; bf16: one rounding.  The
    # float32 kernels are held to the plain version evaluated in float64
    # on the same inputs (the exact gradients): at a row with k_len = 1 in
    # a GQA group, dK sums g x Tq products of a dS that is all rounding,
    # and the plain version's own float32 rounding misses this check
    # there (tests/test_torch_flash_bwd_tf32x3_numerics.py), so only the
    # CUDA-core kernels, which round as the plain version does, could
    # match it
    exact = refs if dtype != torch.float32 and not exact64 else \
        att.flash_backward_reference(
            *(t.double() for t in (q, k, v)), kl, out.double(),
            lse.double(), do.double(), causal, D ** -0.5)
    rtol, arel = (1e-4, 1e-5) if dtype == torch.float32 else (8e-3, 2e-3)
    for a, r in zip(grads, exact):
        assert a.dtype == dtype
        torch.testing.assert_close(a.double(), r.double(), rtol=rtol,
                                   atol=arel * float(r.abs().max()))
    if 0 in klen:   # batch rows with no valid key: zero gradients
        zero = torch.tensor(klen, device='cuda') == 0
        assert not any(t[zero].any() for t in grads)
    if dtype == torch.float32:
        # an independent check: autograd through the plain forward (the
        # kernels follow cuBLAS's summation order, and may match the plain
        # backward bit for bit).  Where dS = P (dP - delta) cancels (a row
        # with k_len = 1 has dP = delta exactly), each of the two plain
        # computations keeps its own float32 rounding of dP and delta, so
        # they differ there by up to a few eps x the size of the
        # cancelling terms, carried through dQ = scale dS K and dK = scale
        # dS^T Q, whatever the kernel does: the bound adds 4 eps x that
        # size to the relative and max-relative terms, and the plain
        # backward is held to it as the kernel is.
        # (batch rows with k_len = 0, checked to be zero above, are left
        # out: autograd through the plain forward's torch.where gives NaN
        # there, from exp(s - m) with m = -1e30 in the branch not taken)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        ref_out, _ = att._ref_attention(*leaves, causal, D ** -0.5, kl)
        auto = torch.autograd.grad(ref_out, leaves, do)
        cancel = _cancel_size(q, k, v, kl, out, lse, do, causal, D ** -0.5)
        eps = torch.finfo(torch.float32).eps
        has_key = kl > 0
        for who, got in (('kernel', grads), ('plain', refs)):
            for a, r, c, n in zip(got, auto, cancel, ('dq', 'dk', 'dv')):
                a, r, c = a[has_key], r[has_key], c[has_key]
                err = (a - r).abs()
                bound = (1e-4 * r.abs() + 1e-5 * float(r.abs().max())
                         + 4 * eps * c)
                assert bool((err <= bound).all()), (
                    who, n, float(err.max()), float((err / bound).max()))


def _cancel_size(q, k, v, kl, out, lse, do, causal, scale):
    """Per element of (dq, dk, dv): the size of the terms that cancel in
    dS = P (dP - delta), P |dO| |V|^T + P rowsum|dO O|, carried through
    dQ = scale dS K and dK = scale dS^T Q; zero for dV, which sums P dO
    and cancels nothing of the kind."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Tq, D)
    dog = do.reshape(B, Hkv, g, Tq, D)
    s = torch.einsum('bhgqd,bhkd->bhgqk', qg * scale, k)
    valid = att._valid_mask(B, Tq, Tk, causal, kl, q.device)
    p = torch.where(valid, torch.exp(s - lse.reshape(B, Hkv, g, Tq, 1)),
                    torch.zeros_like(s))
    size = p * (torch.einsum('bhgqd,bhkd->bhgqk', dog.abs(), v.abs())
                + (dog * out.reshape(B, Hkv, g, Tq, D)).abs().sum(
                    -1, keepdim=True))
    dq = scale * torch.einsum('bhgqk,bhkd->bhgqd', size, k.abs())
    dk = scale * torch.einsum('bhgqk,bhgqd->bhkd', size, qg.abs())
    return dq.reshape(B, H, Tq, D), dk, torch.zeros_like(v)


# the head dims other than 64 and 128: up to 128 the tensor-core forward
# and backward in their padded instances (D = 16 and 32 in the one of
# width 64, 96 in the one of width 128), and at D = 136 and 256 the
# tensor-core instances of width 256; causal and not, ragged k_len with a
# k_len 0 row, GQA, Tq < Tk.  The CUDA-core backward of csrc/flash_cc.cu,
# on no path, is driven directly above 128 (as chip_smoke.py's
# _cc_bwd_launch times it)
@pytest.mark.parametrize('dtype,D,causal,Tq,Tk,Hkv,klen', [
    (torch.float32, 16, True, 100, 100, 2, [100, 37]),
    (torch.bfloat16, 16, False, 70, 133, 4, [133, 0]),
    (torch.float32, 32, False, 65, 65, 1, [65, 64]),
    (torch.bfloat16, 32, True, 37, 161, 2, [161, 100]),
    (torch.float32, 96, True, 129, 129, 2, [0, 90]),
    (torch.bfloat16, 96, False, 64, 200, 8, [200, 1]),
    (torch.float32, 256, True, 70, 70, 2, [70, 33]),
    (torch.bfloat16, 136, False, 70, 90, 2, [90, 45]),
    (torch.bfloat16, 256, True, 70, 70, 2, [70, 33]),
])
def test_cuda_core_flash_kernels_match_plain(cuda, dtype, D, causal, Tq, Tk,
                                             Hkv, klen):
    g = torch.Generator(device='cuda').manual_seed(5)
    q = _randn(g, 2, 8, Tq, D, dtype=dtype)
    do = _randn(g, 2, 8, Tq, D, dtype=dtype)
    k = _randn(g, 2, Hkv, Tk, D, dtype=dtype)
    v = _randn(g, 2, Hkv, Tk, D, dtype=dtype)
    kl = torch.tensor(klen, dtype=torch.int32, device='cuda')
    def both():
        out, lse = att.flash_forward(q, k, v, causal, None, kl)
        return out, lse, att.flash_backward(q, k, v, kl, out, lse, do, causal)
    before = dict(kernels.launches)
    (out, lse, grads), names, runs = _profiled(both, r'flash_\w+?_kernel')
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        assert kernels.launches[name] == before[name] + runs
    fwd = 'wgmma' if dtype == torch.bfloat16 else 'tf32x3'
    bwd = fwd if att.bwd_tensor_core(D, dtype) else 'cc'
    assert names == {'flash_fwd_%s_kernel' % fwd,
                     'flash_bwd_dq_%s_kernel' % bwd,
                     'flash_bwd_dkv_%s_kernel' % bwd}, names
    ref, ref_lse = att._ref_attention(q, k, v, causal, D ** -0.5, kl)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=8e-3, atol=1e-3)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    refs = att.flash_backward_reference(q, k, v, kl, out, lse, do, causal,
                                        D ** -0.5)
    rtol, arel = (1e-4, 1e-5) if dtype == torch.float32 else (8e-3, 2e-3)
    for a, r in zip(grads, refs):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), r.float(), rtol=rtol,
                                   atol=arel * float(r.float().abs().max()))
    if 0 in klen:
        zero = torch.tensor(klen, device='cuda') == 0
        assert not out[zero].any()
        assert not any(t[zero].any() for t in grads)
    if D > 128:
        # the CUDA-core backward itself, driven directly (the port routes
        # these head dims to the tensor-core instances of width 256)
        cc = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        lib = kernels.library()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kl.data_ptr(),
                lse.data_ptr(), att._bwd_delta(out, do).data_ptr(),
                do.data_ptr())
        tail = (2, 8, Hkv, Tq, Tk, D, att._DTYPE_CODE[dtype], int(causal),
                D ** -0.5, torch.cuda.current_stream().cuda_stream)
        kernels.check(lib.pt_flash_cc_bwd_dq(*args, cc[0].data_ptr(), *tail),
                      'pt_flash_cc_bwd_dq')
        kernels.check(lib.pt_flash_cc_bwd_dkv(*args, cc[1].data_ptr(),
                                              cc[2].data_ptr(), *tail),
                      'pt_flash_cc_bwd_dkv')
        torch.cuda.synchronize()
        for a, r in zip(cc, refs):
            torch.testing.assert_close(
                a.float(), r.float(), rtol=rtol,
                atol=arel * float(r.float().abs().max()))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('D', [16, 40, 96, 120])
def test_padded_backward_stores_stop_at_the_true_head_dim(cuda, dtype, D):
    """The padded instances write dQ, dK and dV at the true row stride D
    and no column past it: computed into views at the head of larger
    buffers filled with a sentinel, each equals the wrapper's result bit
    for bit, and the sentinel past it is untouched (a store at the padded
    stride, or past column D, would land there)."""
    g = torch.Generator(device='cuda').manual_seed(7)
    B, H, Hkv, Tq, Tk = 2, 8, 2, 150, 130
    q, do = (_randn(g, B, H, Tq, D, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, B, Hkv, Tk, D, dtype=dtype) for _ in range(2))
    kl = torch.tensor([Tk, 77], dtype=torch.int32, device='cuda')
    scale = D ** -0.5
    out, lse = att.flash_forward(q, k, v, True, scale, kl)
    want = att.flash_backward(q, k, v, kl, out, lse, do, True, scale)
    delta = att._bwd_delta(out, do)
    sentinel = 1024.0   # exact in bf16 and float32, far from any gradient

    def view(like):
        # room for every row at the padded width 128, and more
        buf = torch.full((like.numel() // D * 128 + 4096,), sentinel,
                         dtype=dtype, device='cuda')
        return buf, buf[:like.numel()].view(like.shape)
    (bq, dq), (bk, dk), (bv, dv) = view(q), view(k), view(v)
    lib = kernels.library()
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kl.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), do.data_ptr())
    code = att._DTYPE_CODE[dtype]
    kernels.check(lib.pt_flash_bwd_dq(*args, dq.data_ptr(), B, H, Hkv, Tq,
                                      Tk, D, code, 1, scale, stream),
                  'pt_flash_bwd_dq')
    kernels.check(lib.pt_flash_bwd_dkv(*args, dk.data_ptr(), dv.data_ptr(),
                                       B, H, Hkv, Tq, Tk, D, code, 1, scale,
                                       stream), 'pt_flash_bwd_dkv')
    torch.cuda.synchronize()
    for buf, got, ref, n in ((bq, dq, want[0], 'dq'), (bk, dk, want[1], 'dk'),
                             (bv, dv, want[2], 'dv')):
        assert torch.equal(got, ref), n
        assert bool((buf[got.numel():] == sentinel).all()), n


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('D', [16, 40, 96, 120, 136, 248])
def test_padded_forward_stores_stop_at_the_true_head_dim(cuda, dtype, D):
    """The padded forward instances write the output at the true row
    stride D and no column past it: computed into views at the head of
    larger buffers filled with a sentinel, the output and the LSE equal
    the wrapper's bit for bit, and the sentinel past them is untouched."""
    g = torch.Generator(device='cuda').manual_seed(7)
    B, H, Hkv, Tq, Tk = 2, 8, 2, 150, 130
    q = _randn(g, B, H, Tq, D, dtype=dtype)
    k, v = (_randn(g, B, Hkv, Tk, D, dtype=dtype) for _ in range(2))
    kl = torch.tensor([Tk, 77], dtype=torch.int32, device='cuda')
    scale = D ** -0.5
    want = att.flash_forward(q, k, v, True, scale, kl)
    sentinel = 1024.0   # exact in bf16 and float32, far from any output

    def view(like):
        # room for every row at the padded width 256, and more
        buf = torch.full((like.numel() // like.shape[-1] * 256 + 4096,),
                         sentinel, dtype=like.dtype, device='cuda')
        return buf, buf[:like.numel()].view(like.shape)
    (bo, out), (bl, lse) = view(want[0]), view(want[1])
    kernels.check(kernels.library().pt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kl.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, Hkv, Tq, Tk, D,
        att._DTYPE_CODE[dtype], 1, scale,
        torch.cuda.current_stream().cuda_stream), 'pt_flash_fwd')
    torch.cuda.synchronize()
    for buf, got, ref, n in ((bo, out, want[0], 'out'),
                             (bl, lse, want[1], 'lse')):
        assert torch.equal(got, ref), n
        assert bool((buf[got.numel():] == sentinel).all()), n


@pytest.mark.parametrize('seed', [0, 3])
@pytest.mark.parametrize('D', [64, 128])
def test_bf16_backward_on_the_inputs_one_ds_rounding_misses(cuda, D, seed):
    """ROADMAP C7: on these inputs (numpy seeds 0 and 3, GQA 8/2, causal,
    k_len [150, 77]) one bf16 rounding of dS, which sums to zero over a
    row, leaves dQ or dK past the bf16 check on the CPU emulation
    (tests/test_torch_flash_wgmma_numerics.py); the kernels hand dS to dQ
    and dK as hi + lo bf16 terms at every D, so the gradients hold the
    check against the plain backward evaluated in float64."""
    rng = np.random.RandomState(seed)
    B, H, Hkv, T = 2, 8, 2, 150

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype('float32')).to(
            device='cuda', dtype=torch.bfloat16)
    q, do = randn(B, H, T, D), randn(B, H, T, D)
    k, v = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
    kl = torch.tensor([150, 77], dtype=torch.int32, device='cuda')
    out, lse = att.flash_forward(q, k, v, True, None, kl)
    grads = att.flash_backward(q, k, v, kl, out, lse, do, True)
    exact = att.flash_backward_reference(
        *(t.double() for t in (q, k, v)), kl, out.double(), lse.double(),
        do.double(), True, D ** -0.5)
    for a, r, n in zip(grads, exact, ('dq', 'dk', 'dv')):
        assert a.dtype == torch.bfloat16, n
        torch.testing.assert_close(a.double(), r, rtol=8e-3,
                                   atol=2e-3 * float(r.abs().max()))


def test_head_dim_off_the_tiling_takes_the_composed_route_on_the_card(cuda):
    g = torch.Generator(device='cuda').manual_seed(6)
    q = _randn(g, 2, 4, 40, 12).requires_grad_(True)
    k = _randn(g, 2, 2, 40, 12).requires_grad_(True)
    before = dict(kernels.launches)
    out = att.flash_attention(q, k, k, causal=True)
    out.sum().backward()
    assert kernels.launches['flash_attention_composed'] == \
        before['flash_attention_composed'] + 1
    assert kernels.launches['flash_attention_fwd'] == \
        before['flash_attention_fwd']
    ref = att.composed_attention(q.detach().cpu(), k.detach().cpu(),
                                 k.detach().cpu(), True, 12 ** -0.5)
    torch.testing.assert_close(out.detach().cpu(), ref, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize('p_dt,g_dt,m_dt,w_dt', [
    # the bf16 build's first step (bf16 state, the clip's float32 grads),
    # its later steps (float32 state, bf16 beta powers), no clip (all bf16)
    (torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.bfloat16),
])
def test_adam_bf16_instance_matches_plain(cuda, p_dt, g_dt, m_dt, w_dt):
    """The bf16 instance rounds where jnp rounds: the plain version's
    results, in its dtypes, equal to the last bit but for a float32
    parameter step (one division's rounding)."""
    g = torch.Generator(device='cuda').manual_seed(8)
    shapes = [(1,), (7,), (oo._CHUNK + 3,), (300, 257)]
    params = [(0.05 * _randn(g, *s)).to(p_dt) for s in shapes]
    m1s = [(1e-3 * _randn(g, *s)).to(m_dt) for s in shapes]
    m2s = [(1e-3 * _randn(g, *s)).square().to(m_dt) for s in shapes]
    b1ps = [torch.full((1,), 0.9, device='cuda').to(w_dt) for _ in shapes]
    b2ps = [torch.full((1,), 0.95, device='cuda').to(w_dt) for _ in shapes]
    lrs = [torch.full((1,), 1e-3, device='cuda')] * len(shapes)
    grads = [(1e-2 * _randn(g, *s)).to(g_dt) for s in shapes]
    ref = [[t.clone() for t in col] for col in (params, m1s, m2s, b1ps,
                                                  b2ps)]
    before = kernels.launches['adam_multi_bf16']
    got = oo.adam_multi(params, grads, m1s, m2s, b1ps, b2ps, lrs, 0.9,
                        0.95, 1e-8)
    want = oo.adam_reference(ref[0], grads, ref[1], ref[2], ref[3], ref[4],
                             lrs, 0.9, 0.95, 1e-8)
    torch.cuda.synchronize()
    assert kernels.launches['adam_multi_bf16'] == before + 1
    for col, wcol in zip(got, want):
        for a, r in zip(col, wcol):
            assert a.dtype == r.dtype
            torch.testing.assert_close(a, r, rtol=2e-6, atol=1e-12)
    for a, r in zip(b1ps + b2ps, ref[3] + ref[4]):
        assert a.dtype == w_dt and torch.equal(a, r)


@pytest.mark.parametrize('rows,cols,dtype,affine,two_pass,offset', [
    (8192, 512, torch.float32, True, False, 0.0),
    (300, 1000, torch.float32, True, False, 0.0),
    (257, 512, torch.bfloat16, False, False, 0.0),
    (64, 512, torch.float32, True, False, 1e4),
    (100, 77, torch.float32, True, True, 0.0),
])
def test_layer_norm_kernel_matches_plain(cuda, rows, cols, dtype, affine,
                                         two_pass, offset):
    g = torch.Generator(device='cuda').manual_seed(3)
    x = (_randn(g, rows, cols) + offset).to(dtype)
    scale = 1.0 + 0.1 * _randn(g, cols) if affine else None
    bias = 0.1 * _randn(g, cols) if affine else None
    before = kernels.launches['layer_norm']
    y, m, v = tnn.layer_norm_rows(x, scale, bias, 1e-5, two_pass)
    torch.cuda.synchronize()
    assert kernels.launches['layer_norm'] == before + 1
    ry, rm, rv = tnn.layer_norm_reference(x, scale, bias, 1e-5, two_pass)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=8e-3, atol=8e-3)
    torch.testing.assert_close(y.float(), ry.float(), **tol)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v, rv, rtol=1e-4, atol=1e-6)


def test_adam_multi_kernel_matches_plain_over_three_steps(cuda):
    g = torch.Generator(device='cuda').manual_seed(4)
    shapes = [(1,), (7,), (oo._CHUNK + 1,), (3, 33333), (512, 2048)]
    params = [0.05 * _randn(g, *s) for s in shapes]
    m1s = [1e-3 * _randn(g, *s) for s in shapes]
    m2s = [(1e-3 * _randn(g, *s)).square() for s in shapes]
    b1ps = [torch.full((1,), 0.9, device='cuda') for _ in shapes]
    b2ps = [torch.full((1,), 0.997, device='cuda') for _ in shapes]
    lrs = [torch.full((1,), 1e-3, device='cuda')] * len(shapes)
    state = [params, m1s, m2s, b1ps, b2ps]
    ref = [[t.clone() for t in col] for col in state]
    cache = {}
    before = kernels.launches['adam_multi']
    for _ in range(3):
        grads = [1e-2 * _randn(g, *s) for s in shapes]
        oo.adam_multi(params, grads, m1s, m2s, b1ps, b2ps, lrs, 0.9, 0.997,
                      1e-9, cache=cache)
        oo.adam_reference(ref[0], grads, ref[1], ref[2], ref[3], ref[4],
                          lrs, 0.9, 0.997, 1e-9)
    torch.cuda.synchronize()
    assert kernels.launches['adam_multi'] == before + 3
    # the state pointers held (in place): one state table for 3 steps
    assert cache['adam_multi_tables'] == 1
    # IEEE operations in the reference's order: equal up to the last bit
    for col, rcol in zip(state, ref):
        for a, r in zip(col, rcol):
            torch.testing.assert_close(a, r, rtol=2e-6, atol=1e-12)
    torch.testing.assert_close(b1ps[0], torch.full_like(b1ps[0], 0.9 ** 4))


@pytest.mark.parametrize('nesterov', [False, True])
def test_momentum_multi_kernel_is_bitwise_the_plain_version(cuda, nesterov):
    g = torch.Generator(device='cuda').manual_seed(6)
    # a chunk and one more, ragged sizes, and tensors whose 16-byte
    # alignment fails (views one element into a buffer)
    shapes = [(1,), (7,), (oo._MOMENTUM_CHUNK + 1,), (3, 3333), (64, 1024)]
    params = [0.05 * _randn(g, *s) for s in shapes]
    vels = [1e-3 * _randn(g, *s) for s in shapes]
    params.append(0.05 * _randn(g, 4098)[1:])   # 4 bytes off 16
    vels.append(1e-3 * _randn(g, 4097))
    lrs = [torch.full((1,), 0.1, device='cuda')] * len(params)
    ref = [[t.clone() for t in params], [t.clone() for t in vels]]
    cache = {}
    before = kernels.launches['momentum_multi']
    for _ in range(3):
        grads = [1e-2 * _randn(g, *p.shape) for p in params]
        oo.momentum_multi(params, grads, vels, lrs, 0.9, nesterov,
                          cache=cache)
        oo.momentum_reference(ref[0], grads, ref[1], lrs, 0.9, nesterov)
    torch.cuda.synchronize()
    assert kernels.launches['momentum_multi'] == before + 3
    assert cache['momentum_multi_tables'] == 1
    # the reference's roundings, no FMA contraction: bit for bit
    for a, r in zip(params + vels, ref[0] + ref[1]):
        assert torch.equal(a, r)


def test_momentum_multi_raises_on_what_the_kernel_does_not_take(cuda):
    # no instance takes float16, or a bf16 learning rate; the message
    # names the dtypes
    p = torch.zeros(8, device='cuda', dtype=torch.float16)
    lr = torch.full((1,), 0.1, device='cuda')
    with pytest.raises(ValueError, match='float32.*float16'):
        oo.momentum_multi([p], [p.clone()], [p.clone()], [lr], 0.9, False)
    b = torch.zeros(8, device='cuda', dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='bfloat16'):
        oo.momentum_multi([b], [b.clone()], [b.clone()],
                          [lr.to(torch.bfloat16)], 0.9, False)
    q = torch.zeros(4, 4, device='cuda')
    with pytest.raises(ValueError, match='contiguous'):
        oo.momentum_multi([q.t()], [q], [q.clone()], [lr], 0.9, False)


# the instances of csrc/optim_multi.cu: (op type, attrs)
OPTIM_CASES = {
    'sgd': ('sgd', {}),
    'adagrad': ('adagrad', {'epsilon': 1e-6}),
    'decayed_adagrad': ('decayed_adagrad', {'decay': 0.95, 'epsilon': 1e-6}),
    'adamax': ('adamax', {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}),
    'adadelta': ('adadelta', {'rho': 0.95, 'epsilon': 1e-6}),
    'rmsprop': ('rmsprop', {'decay': 0.95, 'epsilon': 1e-6,
                            'momentum': 0.9}),
    'rmsprop_centered': ('rmsprop', {'decay': 0.95, 'epsilon': 1e-6,
                                     'momentum': 0.9, 'centered': True}),
    'ftrl': ('ftrl', {'l1': 1e-4, 'l2': 1e-3}),
    'ftrl_pow': ('ftrl', {'l1': 1e-4, 'l2': 1e-3, 'lr_power': -0.6}),
}


@pytest.mark.parametrize('case', sorted(OPTIM_CASES))
def test_optim_multi_kernel_is_the_plain_version(cuda, case):
    """Three steps of each instance against optim_reference on copies:
    bit for bit (the reference's roundings, no FMA contraction), and the
    pow instance within ftrl_pow_bound, each step from the same inputs;
    ragged sizes and a tensor 4 bytes off 16-byte alignment."""
    op_type, attrs = OPTIM_CASES[case]
    key = oo.optim_key(op_type, attrs)
    shapes = [(1,), (7,), (oo._OPTIM_CHUNK + 1,), (3, 3333), (64, 1024),
              (4097,)]
    g = torch.Generator(device='cuda').manual_seed(8)
    params, arrays, scalars = chip_smoke.optim_state(op_type, key, shapes, g)
    # the last param 4 bytes off 16-byte alignment
    buf = torch.empty(4098, device='cuda')
    buf[1:].copy_(params[-1])
    params[-1] = buf[1:]
    lrs = None if op_type == 'adadelta' else \
        [torch.full((1,), 0.1, device='cuda')] * len(params)
    cache = {}
    name = oo._kind(op_type, key) + '_multi'
    before = kernels.launches[name]
    for _ in range(3):
        grads = [1e-2 * _randn(g, *p.shape) for p in params]
        ref = ([p.clone() for p in params], [[t.clone() for t in col]
                                              for col in arrays])
        ins = [t.clone() for t in params], [[t.clone() for t in col]
                                             for col in arrays]
        oo.optim_multi(op_type, params, grads, arrays, scalars, lrs, key,
                       cache=cache)
        oo.optim_reference(op_type, ref[0], grads, ref[1], scalars, lrs, key)
        torch.cuda.synchronize()
        if case == 'ftrl_pow':
            for i, (a, r) in enumerate(zip(params, ref[0])):
                bp, bz = oo.ftrl_pow_bound(ins[0][i], grads[i],
                                           ins[1][0][i], ins[1][1][i],
                                           lrs[i], key)
                assert ((a.double() - r.double()).abs() <= bp).all()
                assert ((arrays[1][i].double() - ref[1][1][i].double())
                        .abs() <= bz).all()
                assert torch.equal(arrays[0][i], ref[1][0][i])
        else:
            for a, r in zip(params + [t for c in arrays for t in c],
                            ref[0] + [t for c in ref[1] for t in c]):
                assert torch.equal(a, r)
        # carry the plain version's state, so each step starts equal
        for a, r in zip(params + [t for c in arrays for t in c],
                        ref[0] + [t for c in ref[1] for t in c]):
            a.copy_(r)
    assert kernels.launches[name] == before + 3
    assert cache[name + '_tables'] == 1


def test_optim_multi_raises_on_what_the_kernel_does_not_take(cuda):
    # no instance takes float16; the message names the dtypes
    p = torch.zeros(8, device='cuda', dtype=torch.float16)
    lr = torch.full((1,), 0.1, device='cuda')
    with pytest.raises(ValueError, match='float32.*float16'):
        oo.adagrad_multi([p], [p.clone()], [[p.clone()]], None, [lr],
                         (1e-6,))
    q = torch.zeros(4, 4, device='cuda')
    with pytest.raises(ValueError, match='contiguous'):
        oo.sgd_multi([q.t()], [q], [], None, [lr], ())
    with pytest.raises(ValueError, match='one device'):
        oo.sgd_multi([q], [q.cpu()], [], None, [lr], ())


# the bf16 instances' dtype mixes: (param, grad, state); the learning
# rate float32.  A bf16 param's first step (all bf16), its second (the
# param float32, the state bf16), and a float32 param under a bf16 grad.
BF16_MIXES = [(torch.bfloat16, torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.float32, torch.bfloat16),
              (torch.float32, torch.bfloat16, torch.float32)]


def _bf16_shapes():
    # a chunk and one more, and ragged sizes
    return [(1,), (7,), (oo._OPTIM_CHUNK + 1,), (3, 3333), (64, 1024)]


@pytest.mark.parametrize('nesterov', [False, True])
@pytest.mark.parametrize('mix', range(len(BF16_MIXES)))
def test_momentum_bf16_instance_is_bitwise_the_plain_version(cuda, mix,
                                                             nesterov):
    """C11 on the card: momentum_bf16_kernel against momentum_reference on
    copies, the outputs in jnp's promoted dtypes (the param float32),
    bit for bit."""
    p_dt, g_dt, v_dt = BF16_MIXES[mix]
    g = torch.Generator(device='cuda').manual_seed(6)
    shapes = _bf16_shapes()
    params = [(0.05 * _randn(g, *s)).to(p_dt) for s in shapes]
    vels = [(1e-3 * _randn(g, *s)).to(v_dt) for s in shapes]
    grads = [(1e-2 * _randn(g, *s)).to(g_dt) for s in shapes]
    lrs = [torch.full((1,), 0.1, device='cuda')] * len(shapes)
    ref = [[t.clone() for t in params], [t.clone() for t in vels]]
    before = kernels.launches['momentum_multi_bf16']
    got = oo.momentum_multi(params, grads, vels, lrs, 0.9, nesterov)
    want = oo.momentum_reference(ref[0], grads, ref[1], lrs, 0.9, nesterov)
    torch.cuda.synchronize()
    assert kernels.launches['momentum_multi_bf16'] == before + 1
    assert all(t.dtype == torch.float32 for t in got[0])
    for col, wcol in zip(got, want):
        for a, r in zip(col, wcol):
            assert a.dtype == r.dtype and torch.equal(a, r)


@pytest.mark.parametrize('mix', range(len(BF16_MIXES)))
@pytest.mark.parametrize('case', sorted(OPTIM_CASES))
def test_optim_bf16_instance_is_the_plain_version(cuda, case, mix):
    """C11 on the card: each instance's optim_bf16_kernel against
    optim_reference on copies, the outputs in jnp's promoted dtypes, bit
    for bit; the pow instance's param and linear accumulator within
    ftrl_pow_bound.  adamax's Beta1Pow in the state's dtype."""
    p_dt, g_dt, s_dt = BF16_MIXES[mix]
    op_type, attrs = OPTIM_CASES[case]
    key = oo.optim_key(op_type, attrs)
    g = torch.Generator(device='cuda').manual_seed(8)
    params, arrays, scalars = chip_smoke.optim_state(op_type, key,
                                                     _bf16_shapes(), g)
    params = [t.to(p_dt) for t in params]
    arrays = [[t.to(s_dt) for t in col] for col in arrays]
    scalars = scalars and [t.to(s_dt) for t in scalars]
    grads = [(1e-2 * _randn(g, *p.shape)).to(g_dt) for p in params]
    lrs = None if op_type == 'adadelta' else \
        [torch.full((1,), 0.1, device='cuda')] * len(params)
    ins = [t.clone() for t in params], [[t.clone() for t in c]
                                        for c in arrays]
    # sgd has no state: its mix without a bf16 param or grad is the
    # float32 instance's
    bf = any(t.dtype == torch.bfloat16 for t in params + grads +
             [t for c in arrays for t in c] + (scalars or []))
    name = oo._kind(op_type, key) + ('_multi_bf16' if bf else '_multi')
    before = kernels.launches[name]
    got = oo.optim_multi(op_type, params, grads, arrays, scalars, lrs, key)
    want = oo.optim_reference(op_type, [t.clone() for t in ins[0]], grads,
                              [[t.clone() for t in c] for c in ins[1]],
                              scalars, lrs, key)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    outs = got[0] + [t for c in got[1] for t in c]
    refs = want[0] + [t for c in want[1] for t in c]
    assert [t.dtype for t in outs] == [t.dtype for t in refs]
    if case != 'ftrl_pow':
        # NaN where NaN: centered rmsprop's root of a bf16 mean square
        # that rounding took below its mean grad squared
        for a, r in zip(outs, refs):
            assert ((a == r) | (a.isnan() & r.isnan())).all()
        return
    for i in range(len(params)):
        bp, bz = oo.ftrl_pow_bound(ins[0][i], grads[i], ins[1][0][i],
                                   ins[1][1][i], lrs[i], key)
        assert ((got[0][i].double() - want[0][i].double()).abs()
                <= bp).all()
        assert ((got[1][1][i].double() - want[1][1][i].double()).abs()
                <= bz).all()
        assert torch.equal(got[1][0][i], want[1][0][i])


def _se_like_segment(sizes, dtypes):
    """One generated segment like SE-ResNeXt-50's L2Decay: per parameter
    p_k of sizes[k] and dtypes[k], d_k = scale(p_k, 1e-4) and
    g2_k = g_k + d_k; parameters of one size share a group."""
    subs, args, outs = [], [], []
    for k in range(len(sizes)):
        subs += [
            {'type': 'scale', 'inputs': {'X': ['p%d' % k]},
             'outputs': {'Out': ['d%d' % k]}, 'input_is_list': {'X': False},
             'output_is_list': {'Out': False}, 'stop_grad': [],
             'attrs': {'scale': 1e-4, 'bias': 0.0,
                       'bias_after_scale': True}},
            {'type': 'elementwise_add',
             'inputs': {'X': ['g%d' % k], 'Y': ['d%d' % k]},
             'outputs': {'Out': ['o%d' % k]},
             'input_is_list': {'X': False, 'Y': False},
             'output_is_list': {'Out': False}, 'stop_grad': [],
             'attrs': {'axis': -1}}]
        args += ['p%d' % k, 'g%d' % k]
        outs.append('o%d' % k)
    attrs = {'sub_ops': subs, 'arg_names': args, 'out_names': outs,
             'fused_count': len(subs)}
    avals = tuple(((n,), d) for n, d in zip(sizes, dtypes) for _ in (0, 1))
    plan = kernelgen.plan_for(attrs, avals, False)
    specs = [st[1] for st in plan.steps if st[0] == 'kernel']
    assert len(specs) == 1
    return specs[0]


@pytest.mark.parametrize('misalign', [False, True])
def test_multi_group_segment_is_its_replay(cuda, misalign):
    """A segment of groups of many sizes (SE-ResNeXt-50's decay: 64-entry
    batch-norm scales to 2.4 M-entry conv weights, none but some dividing
    by 4 or 8), float32 and bf16, each group on its own tiles: bit for
    bit its plain replay; with one input 4 bytes off 16-byte alignment,
    only its group leaves the vector path."""
    sizes = [64, 64, 1000, 1003, 2048, 4099, 36864, 36864, 262144,
             2359296, 7, 4100, 33333]
    dtypes = ['float32'] * 10 + ['bfloat16'] * 3
    spec = _se_like_segment(sizes, dtypes)
    g = torch.Generator(device='cuda').manual_seed(9)
    ents = [(torch.rand(shape, generator=g, device='cuda') + 0.5).to(
        getattr(torch, dt)) for shape, dt in spec.entry_avals]
    if misalign:
        buf = torch.empty(ents[3].numel() + 1, device='cuda',
                          dtype=ents[3].dtype)
        buf[1:].copy_(ents[3])
        ents[3] = buf[1:]
    before = kernels.launches['kernelgen_segment']
    outs = kernelgen._launch(spec, ents)
    refs = spec.replay(ents)
    torch.cuda.synchronize()
    assert kernels.launches['kernelgen_segment'] == before + 1
    for o, r in zip(outs, refs):
        assert o.dtype == r.dtype and torch.equal(o, r.reshape(o.shape))
    ptrs = [t.data_ptr() for t in ents] + [o.data_ptr() for o in outs]
    vec = kernelgen.vector_groups(spec, ptrs)
    off = [gi for gi, grp in enumerate(spec.layout.groups)
           if 3 in grp['ptrs']]
    assert vec == [not (misalign and gi in off)
                   for gi in range(len(vec))]


def test_float32_conv2d_is_float32_when_cudnn_may_use_tf32(cuda):
    """The conv op turns cuDNN's TF32 off around its forward and backward.
    With allow_tf32 = True its output and both gradients stay within
    float32's error of a sum of K terms against float64: each addition
    rounds its partial sum (of up to the result's magnitude M) by 2^-24,
    so 8 sqrt(K) 2^-24 M, with K = 576 for the output and the input's
    gradient and N H W = 6272 for the filter's.  TF32 rounds each input
    to 10 bits: F.conv2d under the same flag misses the output's bound,
    as a control."""
    g = torch.Generator(device='cuda').manual_seed(7)
    x = _randn(g, 8, 64, 28, 28)
    w = 0.05 * _randn(g, 64, 64, 3, 3)
    conv = torch.nn.functional.conv2d
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = tnn.conv2d_nchw(xr, wr, 1, 1)
        gx, gw = torch.autograd.grad(y, [xr, wr], torch.ones_like(y))
        assert torch.backends.cudnn.allow_tf32
        y_tf32 = conv(x, w, None, 1, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = old
    x64, w64 = x.double().requires_grad_(True), w.double().requires_grad_(True)
    y64 = conv(x64, w64, None, 1, 1)
    want = (y64,) + torch.autograd.grad(y64, [x64, w64], torch.ones_like(y64))

    def tol(ref, K):
        return 8 * K ** 0.5 * 2.0 ** -24 * float(ref.abs().max())
    for got, ref, K in zip((y, gx, gw), want, (576, 576, 6272)):
        err = float((got.double() - ref).abs().max())
        assert err <= tol(ref, K), (K, err, tol(ref, K))
    assert float((y_tf32.double() - y64).abs().max()) > tol(y64, 576)


@pytest.mark.parametrize('rows,cols,dtype,neg_inf_rows', [
    (65536, 256, torch.float32, 0),
    (300, 1000, torch.float32, 3),
    (7, 3000, torch.float32, 1),
    (257, 255, torch.bfloat16, 0),
    (33, 1, torch.float32, 0),
    # the 16-byte vector branch beside the scalar one: a column count that
    # is not a multiple of 4 (scalar), bf16 rows of 8-value vectors, a
    # row count that leaves a block's last rows empty
    (1000, 258, torch.float32, 2),
    (4099, 256, torch.bfloat16, 1),
    (37, 64, torch.float32, 1),
])
def test_softmax_kernel_matches_plain(cuda, rows, cols, dtype, neg_inf_rows):
    g = torch.Generator(device='cuda').manual_seed(5)
    x = (3 * _randn(g, rows, cols)).to(dtype)
    x[:neg_inf_rows] = float('-inf')
    before = kernels.launches['softmax']
    y = tnn.softmax_rows(x)
    torch.cuda.synchronize()
    assert kernels.launches['softmax'] == before + 1
    ref = tnn.softmax_reference(x)
    # f32: the same operations, the row sums in other orders; bf16: one
    # rounding of (almost) equal float32 results
    tol = dict(rtol=1e-5, atol=1e-7) if dtype == torch.float32 else \
        dict(rtol=8e-3, atol=1e-3)
    torch.testing.assert_close(y.float(), ref.float(), equal_nan=True, **tol)
    assert torch.isnan(y[:neg_inf_rows]).all()


def test_softmax_kernel_takes_rows_off_16_bytes(cuda):
    """A contiguous view that starts 4 bytes into its storage goes to the
    scalar branch (the vector branch needs 16-byte aligned rows)."""
    g = torch.Generator(device='cuda').manual_seed(6)
    x = (3 * _randn(g, 1 + 300 * 256))[1:].view(300, 256)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    y = tnn.softmax_rows(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, tnn.softmax_reference(x), rtol=1e-5,
                               atol=1e-7)


def _sub(type, inputs, outputs, attrs=None):
    return {'type': type, 'inputs': inputs, 'outputs': outputs,
            'input_is_list': {k: False for k in inputs},
            'output_is_list': {k: False for k in outputs},
            'attrs': dict(attrs or {}), 'stop_grad': []}


# fused groups of the training program's kinds, on the card: (sub-ops,
# argument shapes, outputs, AMP)
SEGMENTS = {
    'bias_relu_dropout': ([
        _sub('elementwise_add', {'X': ['x'], 'Y': ['b']}, {'Out': ['h']},
             {'axis': 2, 'rng_stream': 1}),
        _sub('relu', {'X': ['h']}, {'Out': ['r']}, {'rng_stream': 2}),
        _sub('dropout', {'X': ['r']}, {'Out': ['o'], 'Mask': ['m']},
             {'dropout_prob': 0.1, 'rng_stream': 3,
              'dropout_implementation': 'upscale_in_train'})],
        {'x': (8, 33, 2048), 'b': (2048,)}, ['o'], False),
    'mask_softmax_dropout': ([
        _sub('elementwise_add', {'X': ['s'], 'Y': ['m']}, {'Out': ['a']},
             {'axis': -1}),
        _sub('softmax', {'X': ['a']}, {'Out': ['p']}, {'axis': -1}),
        _sub('dropout', {'X': ['p']}, {'Out': ['o'], 'Mask': ['k']},
             {'dropout_prob': 0.1, 'rng_stream': 9,
              'dropout_implementation': 'upscale_in_train'})],
        {'s': (4, 8, 64, 64), 'm': (4, 1, 1, 64)}, ['o'], False),
    'residual_bf16_amp': ([
        _sub('elementwise_add', {'X': ['x'], 'Y': ['b']}, {'Out': ['h']},
             {'axis': -1}),
        _sub('scale', {'X': ['h']}, {'Out': ['o']},
             {'scale': 0.125, 'bias': 1.0})],
        {'x': (5, 7, 9), 'b': (9,)}, ['o', 'h'], True),
    # the gradient clip's elementwise ops: square, sqrt, max, clip, sign
    'clip_chain': ([
        _sub('square', {'X': ['x']}, {'Out': ['s']}),
        _sub('sqrt', {'X': ['s']}, {'Out': ['r']}),
        _sub('elementwise_max', {'X': ['r'], 'Y': ['c']}, {'Out': ['m']},
             {'axis': -1}),
        _sub('clip', {'X': ['x']}, {'Out': ['k']}, {'min': -0.3,
                                                   'max': 0.5}),
        _sub('sign', {'X': ['k']}, {'Out': ['n']}),
        _sub('elementwise_mul', {'X': ['n'], 'Y': ['m']}, {'Out': ['o']},
             {'axis': -1})],
        {'x': (6, 33, 129), 'c': (129,)}, ['o', 'm'], False),
    # SE-ResNeXt's gate and its scaled residual under AMP: the fc's bias
    # add + sigmoid in float32, then mul(axis=0) of the bf16 block output
    # by the gate, the bf16 shortcut added, relu (AMP: the names in bf16)
    'se_gate_residual_amp': ([
        _sub('elementwise_add', {'X': ['f'], 'Y': ['b']}, {'Out': ['a']},
             {'axis': 1}),
        _sub('sigmoid', {'X': ['a']}, {'Out': ['g']}),
        _sub('elementwise_mul', {'X': ['x'], 'Y': ['g']}, {'Out': ['s']},
             {'axis': 0}),
        _sub('elementwise_add', {'X': ['r'], 'Y': ['s']}, {'Out': ['h']},
             {'axis': -1}),
        _sub('relu', {'X': ['h']}, {'Out': ['o']})],
        {'f': (4, 64), 'b': (64,), 'x': (4, 64, 7, 7), 'r': (4, 64, 7, 7)},
        ['o', 'g'], ('x', 'r')),
    # piecewise_decay's chain on the step counter: bools in registers
    'piecewise_schedule': ([
        _sub('increment', {'X': ['n']}, {'Out': ['n']}, {'step': 1.0}),
        _sub('cast', {'X': ['n']}, {'Out': ['t']}, {'out_dtype': 'float32'}),
        _sub('fill_constant', {}, {'Out': ['b0']},
             {'shape': [1], 'value': 3.0, 'dtype': 'float32'}),
        _sub('less_than', {'X': ['t'], 'Y': ['b0']}, {'Out': ['l0']}),
        _sub('cast', {'X': ['l0']}, {'Out': ['i0']},
             {'out_dtype': 'float32'}),
        _sub('scale', {'X': ['i0']}, {'Out': ['p0']}, {'scale': 0.1}),
        _sub('fill_constant', {}, {'Out': ['b1']},
             {'shape': [1], 'value': 6.0, 'dtype': 'float32'}),
        _sub('less_than', {'X': ['t'], 'Y': ['b1']}, {'Out': ['l1']}),
        _sub('cast', {'X': ['l1']}, {'Out': ['i1']},
             {'out_dtype': 'float32'}),
        _sub('elementwise_sub', {'X': ['i1'], 'Y': ['i0']}, {'Out': ['w']},
             {'axis': -1}),
        _sub('scale', {'X': ['w']}, {'Out': ['p1']}, {'scale': 0.01}),
        _sub('elementwise_add', {'X': ['p0'], 'Y': ['p1']}, {'Out': ['o']},
             {'axis': -1})],
        {'n': (1,)}, ['o', 'n', 'l1'], False),
}


@pytest.mark.parametrize('name', sorted(SEGMENTS))
def test_generated_segments_match_plain(cuda, name):
    """run_fused (generated kernels, K5, draws) against the plain replay
    of the same group on the card: the kernels round every operation as
    PyTorch's eager kernels do, so equal bit for bit; the gradients
    through the segments' autograd Functions too."""
    subs, shapes, outs, amp = SEGMENTS[name]
    attrs = {'sub_ops': subs, 'arg_names': list(shapes), 'out_names': outs}
    g = torch.Generator(device='cuda').manual_seed(6)
    # float inputs from a normal draw, the step counter an int32 in [0, 8)
    xs = [_randn(g, *s) if n != 'n' else
          torch.randint(0, 8, s, generator=g, device='cuda',
                        dtype=torch.int32) for n, s in shapes.items()]
    if amp:
        bf16 = amp if isinstance(amp, tuple) else list(shapes)[:1]
        xs = [x.to(torch.bfloat16) if n in bf16 else x
              for n, x in zip(shapes, xs)]
        amp = True
    leaves = [x.clone().requires_grad_(x.is_floating_point()) for x in xs]
    ectx = treg.ExecCtx('cuda', 7, 0, amp=amp)
    ctx = ectx.for_op(0, treg._SubOpShim('fused_elementwise', {}))
    before = kernels.launches['kernelgen_segment']
    got = kernelgen.run_fused(ctx, leaves, attrs, amp)
    torch.cuda.synchronize()
    plan = kernelgen.plan_of(attrs)
    assert kernels.launches['kernelgen_segment'] == before + plan.n_kernels
    ref_leaves = [x.clone().requires_grad_(x.is_floating_point())
                  for x in xs]
    ref = tfused.replay(ctx, ref_leaves, attrs, amp)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert torch.equal(a, r)
    if not any(r.requires_grad for r in ref):
        return
    got, ref = zip(*[(a, r) for a, r in zip(got, ref) if r.requires_grad])
    w = [torch.randn(r.shape, generator=g, device='cuda').to(r.dtype)
         for r in ref]
    ga_ = torch.autograd.grad(got, leaves, w, allow_unused=True)
    gr_ = torch.autograd.grad(ref, ref_leaves, w, allow_unused=True)
    for a, r in zip(ga_, gr_):
        assert (a is None) == (r is None)
        if a is not None:
            torch.testing.assert_close(a, r, rtol=1e-6, atol=1e-7)


def test_composed_transformer_passes_on_and_off_on_the_card(cuda,
                                                            monkeypatch):
    """2 layers at small width, dropout 0.1: PT_OPT=1 (generated kernels)
    and PT_OPT=0 (eager ops) within 1e-6 relative over 3 steps."""
    import paddle_tpu_torch as tf
    from paddle_tpu_torch.models import transformer as ttr
    losses = {}
    for opt in ('1', '0'):
        monkeypatch.setenv('PT_OPT', opt)
        main, startup = tf.Program(), tf.Program()
        main.random_seed = startup.random_seed = 3
        with tf.program_guard(main, startup), tf.unique_name.guard():
            out = ttr.build(src_vocab=128, trg_vocab=128, max_len=16,
                            n_layer=2, n_head=4, d_model=64, d_inner=128)
        scope, exe = tf.Scope(), tf.Executor()
        feed = ttr.synthetic_batch(np.random.RandomState(0), 4, 16, 128)
        with tf.scope_guard(scope):
            exe.run(startup)
            losses[opt] = [float(exe.run(main, feed=feed,
                                         fetch_list=[out['loss']])[0][0])
                           for _ in range(3)]
    np.testing.assert_allclose(losses['1'], losses['0'], rtol=1e-6)


# ------------------------------------------- bf16 serving, generation

def _bf16_llama_dir(tmp_path):
    """A llama decode program with head dim 128 (the flash kernels' width),
    2 layers, saved from the CPU."""
    import paddle_tpu_torch as tf
    from paddle_tpu_torch.models import llama
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 5
    with tf.program_guard(main, startup), tf.unique_name.guard():
        out = llama.generation_program('tiny', d_model=256, n_head=2,
                                       n_kv_head=1, d_ffn=512, max_len=256)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        exe.run(startup)
        tf.io.save_inference_model(str(tmp_path), ['tokens'],
                                   [out['logits'], out['next_token']], exe,
                                   main)
    return out['config']


def test_bf16_predictor_runs_the_wgmma_flash_kernel(cuda, tmp_path):
    """enable_bf16 on the card: bf16 parameters, one flash launch a layer,
    all of it K1's bf16 tensor-core kernel, and logits within the bf16
    bound of tests/test_torch_inference_bf16.py (4 sqrt(2 R / 3) 2^-8
    max|logit|, R = 12 L + 2) of the CPU's bf16 Predictor."""
    import paddle_tpu_torch as tf
    from torch.profiler import ProfilerActivity, profile
    cfg = _bf16_llama_dir(tmp_path)
    preds = {}
    for dev in ('cuda', 'cpu'):
        conf = tf.inference.AnalysisConfig(str(tmp_path))
        conf.enable_bf16()
        if dev == 'cpu':
            conf.disable_gpu()
        preds[dev] = tf.inference.Predictor(conf)
    assert all(v.dtype == torch.bfloat16 and v.device.type == 'cuda'
               for v in preds['cuda']._scope.vars.values())
    rng = np.random.RandomState(0)
    feed = {'tokens': rng.randint(0, cfg['vocab'],
                                  (2, cfg['max_len'], 1)).astype('int64')}
    preds['cuda'].run(feed)                     # builds its segments
    before = kernels.launches['flash_attention_fwd']
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits, tok = preds['cuda'].run(feed)
        torch.cuda.synchronize()
    assert kernels.launches['flash_attention_fwd'] == before + cfg['n_layer']
    names = {e.key for e in prof.key_averages() if 'flash' in e.key}
    assert names and all('flash_fwd_wgmma_kernel' in n for n in names), \
        names
    ref, ref_tok = preds['cpu'].run(feed)
    assert str(logits.dtype) == str(ref.dtype) == 'bfloat16'
    assert tok.dtype == ref_tok.dtype == np.int32
    got, ref = logits.astype(np.float32), ref.astype(np.float32)
    M = float(np.abs(ref).max())
    tol = 4 * np.sqrt(2 * (12 * cfg['n_layer'] + 2) / 3.0) * 2 ** -8 * M
    assert float(np.abs(got - ref).max()) <= tol


def test_decode_window_on_the_card_matches_the_cpu_port(cuda):
    """One prefill and one decode window of the paged runtime on the card
    against the same on the CPU: prefill logits within 1e-4 of
    max|logit| (float32, other summation orders), the greedy tokens equal,
    and the token embedding through K4 (one launch a chunk and a step; on
    the card through the CUDA graphs `warmup` built, whose warm-up runs
    launch K4 too)."""
    from paddle_tpu_torch.serving import generation as gen
    cfg = dict(vocab=512, d_model=256, n_layer=2, n_head=2, n_kv_head=1,
               d_ffn=512, theta=10000.0, max_len=256)
    w = gen.random_weights(cfg, seed=1)
    prompt = np.random.RandomState(2).randint(0, 512, 40)
    res = {}
    for dev in ('cuda', 'cpu'):
        rt = gen.DecodeRuntime(w, cfg, slots=2, prefill_chunk=16,
                               device=dev)
        rt.warmup(8)
        slot = rt.alloc_slot()
        assert rt.try_begin(slot, prompt, 8) == 0
        before = kernels.launches['embedding_gather']
        for off in range(0, 40, 16):
            first, logits = rt.prefill(slot, prompt[off:off + 16], off,
                                       gen.SamplingParams())
        act = np.asarray([True, False])
        toks = rt.decode_window(8, act, np.zeros(2, np.int64),
                                np.zeros(2, np.float32),
                                np.zeros(2, np.int64))
        res[dev] = (first, logits, toks[0])
        if dev == 'cuda':
            assert kernels.launches['embedding_gather'] == before + 3 + 8
    (gf, gl, gt), (cf, cl, ct) = res['cuda'], res['cpu']
    tol = 1e-4 * float(np.abs(cl).max())
    assert float(np.abs(gl - cl).max()) <= tol
    # token for token while the CPU's dense reference clears the margin
    stream_g, stream_c = [gf] + list(gt), [cf] + list(ct)
    for t in range(len(stream_c)):
        _, _, lref = gen.dense_reference(w, cfg, list(prompt) +
                                         stream_c[:t])
        top2 = np.sort(lref)[-2:]
        if top2[1] - top2[0] <= 4 * tol:
            break
        assert stream_g[t] == stream_c[t], (t, stream_g, stream_c)
    assert t >= 4


@pytest.mark.parametrize('case', sorted(chip_smoke.RULE_CASES))
def test_rule_segment_matches_plain_on_special_values(cuda, case):
    """One generated segment of each elementwise, comparison, logical and
    activation rule against its plain op on NaN, +-inf, +-0 and the other
    RULE_SPECIALS (every pair for the binary ops) and normal values:
    chip_smoke.rule_case's check (the sign of a zero kept, NaN where NaN,
    1e-6 relative where a libdevice function may round otherwise in
    torch's build), at 2^14 values."""
    spec = chip_smoke.rule_specs(1 << 14)[case]
    row = chip_smoke.rule_case(case, spec, n=1 << 14)
    assert row['mismatches'] == 0


# ---------------------------------------------------------------- C12

@pytest.mark.parametrize('case', sorted(chip_smoke.C12_RULE_CASES))
def test_c12_bf16_rule_segment_is_its_plain_op_bit_for_bit(cuda, case):
    """Each kernel rule whose Python constants meet a bf16 tensor: its
    bf16 segment on every bf16 bit pattern (subnormals, +-0, +-inf, NaNs,
    each constant's neighbours) against the plain op, the same bits
    (chip_smoke.rule_case_bf16), at 2^17 values."""
    spec = chip_smoke.rule_specs_bf16(1 << 17)[case]
    row = chip_smoke.rule_case_bf16(case, spec, n=1 << 17)
    assert row['mismatches'] == 0


# ------------------------------------------------------ the sequence ops

def test_lstm_on_the_card_matches_the_cpu(cuda):
    """The lstm op (a loop of torch ops over T: cuBLAS GEMMs, elementwise
    kernels) on the card against the CPU, forward and gradients, with
    peepholes and reversed: within 1e-5 of the largest value."""
    from paddle_tpu_torch.ops import sequence  # noqa: F401 - registers
    gen = torch.Generator(device='cpu').manual_seed(3)
    D, B, T = 16, 5, 9
    ins = {'Input': torch.randn(B, T, 4 * D, generator=gen),
           'Weight': torch.randn(D, 4 * D, generator=gen) * 0.3,
           'Bias': torch.randn(1, 7 * D, generator=gen) * 0.3,
           'Length': torch.tensor([9, 1, 4, 7, 9], dtype=torch.int32)}
    attrs = {'use_peepholes': True, 'is_reverse': True}
    w = torch.randn(B, T, D, generator=gen)
    res = {}
    for dev in ('cpu', 'cuda'):
        xs = {k: v.detach().clone().to(dev).requires_grad_(
            v.is_floating_point()) for k, v in ins.items()}
        out = treg.get_op('lstm')(None, xs, attrs)
        (out['Hidden'] * w.to(dev)).sum().backward()
        res[dev] = [out['Hidden'], out['Cell']] + [
            xs[k].grad for k in ('Input', 'Weight', 'Bias')]
    for a, b in zip(res['cuda'], res['cpu']):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_one_graph_serves_batches_of_other_lengths(cuda):
    """A small stacked-LSTM LM on the card: the CUDA graph captured for
    one T bucket replays batches whose lengths differ (the lengths are a
    feed copied in before each replay), each step equal to the
    interpreter's (use_program_cache=False) from the same state."""
    import paddle_tpu_torch as fluid
    main, startup, out, feeder, bucketer = chip_smoke.sl_program(
        dict_dim=100, emb_dim=16, hid_dim=16)
    rng = np.random.RandomState(5)
    feeds = [chip_smoke.sl_feed(feeder, bucketer, chip_smoke.review_rows(
        rng, 8, (20, 24), 100)) for _ in range(4)]
    assert len({f['words'].padded.shape[1] for f in feeds}) == 1
    res = {}
    for graphed in (True, False):
        scope, exe = fluid.Scope(), fluid.Executor()
        with fluid.scope_guard(scope):
            exe.run(startup)
            res[graphed] = [exe.run(main, feed=f, fetch_list=[out['loss']],
                                    use_program_cache=graphed)[0]
                            for f in feeds]
    for a, b in zip(res[True], res[False]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
