#!/usr/bin/env python3
"""Serve llama_1b (float32 and bf16, and as a streaming generation server)
and train transformer-base through paddle_tpu_torch on one NVIDIA GPU, and
hold each hand-written CUDA kernel against its plain PyTorch version.

    python3 chip_smoke.py                      # all phases, one card
    python3 chip_smoke.py --phases card,kernels
    python3 chip_smoke.py --phases card,kernels,training_composed
    python3 chip_smoke.py --phases serving_bf16,generation,generation_gpu_vs_cpu
    python3 chip_smoke.py --phases card,training,nan_trip

Every program runs through the PT_OPT passes (on by default): their fused
groups run as generated CUDA kernels (paddle_tpu_torch/ops/kernelgen),
compiled by one nvcc call per program at its first run.  Executor.run and
Predictor.run replay each launch signature as a captured CUDA graph from
its second run (paddle_tpu_torch/core/graphs.py); use_program_cache=False
is the interpreter, which the graph phases time beside it.

Phases, each printing JSON lines:
  card        nvidia-smi name and power limit; build the kernels (nvcc,
              sm_90a, one process per source) from paddle_tpu_torch/csrc
              and time the build
  kernels     every kernel on the card against its plain version at its
              main path's shapes (timed: kernel / plain / library ms and the
              bound) and at ragged ones: flash-attention forward and the
              embedding gather at the served shapes (the gather also with
              L2 flushed before each call, beside F.embedding timed the
              same way); the flash backward
              (dQ, dK/dV), LayerNorm and the multi-tensor Adam at the
              training step's shapes; softmax rows (K5) at the composed
              attention's scores and ragged shapes; every generated segment
              of the three main paths (the served program at each bucket,
              the flash and the composed training steps) against its
              plain replay, all built by one nvcc call
  serving     llama_1b (full width, 16 layers, random weights from a seed)
              built through the port's layers, saved with
              save_inference_model, loaded by Predictor behind
              ServingEngine.from_predictor with FeedBucketer([1, 2, 4]);
              seeded requests of 1-2 rows x 2048 tokens; launch counts
              read around the served requests; then torch.profiler over
              one 4-row batch (device time by kernel group, idle share),
              whose 16 flash forwards must all be the 3xTF32 kernel
  serving_bf16
              the same model, feeds and buckets through a Predictor with
              AnalysisConfig.enable_bf16 (bf16 parameters): every request
              ok, served rows within the bf16 bound of pred.run alone and
              of the float32 Predictor's logits on the same feeds, and two
              faults made in a third bf16 Predictor's parameters (the
              last layer's attention dropped; fp8 precision) outside it;
              one profiled 4-row batch, whose 16 flash forwards must all be
              the bf16 wgmma kernel
              (serving and serving_bf16 both end with serve_modes: the
              4-row batch through the interpreter and through its CUDA
              graph in turns, eager, graph, graph, eager; median ms,
              tokens/s, device busy and idle share, peak memory; the
              served rows bit for bit equal)
  generation  llama_1b (full width and depth, float32, TF32 off, weights
              from its program's startup) through make_streaming_runtime
              (8 slots, prefill chunks of 256) and GenerationEngine
              (decode windows of 4): 8 concurrent requests of 128-1024
              prompt tokens and 64 new tokens, greedy and seeded top-k;
              TTFT and ITL p50 / p99, decode tokens/s, window ms, KV pool
              bytes and peak memory; every stream terminal once, K4 one
              launch a prefill chunk and a decode step, no plain version on
              the card; two greedy streams against dense_reference on the
              card, a seeded and a greedy stream of the batch bitwise
              equal to the same request run alone, a seeded stream bitwise
              at windows of 1 and 4; one profiled window of 8 decoding
              slots (device time by aten op group, idle share); the
              plain cached_attention against one
              SDPA call with the same mask at the decode and prefill
              shapes (timed only)
  gpu_vs_cpu  llama_1b width, 2 layers, max_len 512: one saved model through
              the port's Predictor on the card and on the CPU
  generation_gpu_vs_cpu
              llama_1b width, 2 layers: a 64-token prompt and 16 greedy
              tokens through the paged runtime on the card and on the CPU
  training    transformer-base as bench.py builds it (full width, 6+6
              layers, vocab 32000, B=32, T=256, bf16 AMP, flash attention,
              dropout 0, random init from a seed) trained by
              Executor.run: 3 warm-up and 10 timed steps (step ms, tokens/s,
              losses, which must be finite), kernel launches per step read
              around the timed steps, then torch.profiler over one step,
              whose 18 bf16 flash forwards, 18 dQ and 18 dK/dV launches
              must all be the tensor-core (wgmma) kernels; then
              graph_modes: the interpreter (use_program_cache=False), the
              graph, run_steps(K=8) and Executor(check_nan=True,
              nan_poll=8), in turns (ABCDDCBA), each with median step
              ms, tokens/s, launches per step (equal in every mode),
              peak memory, a profiled window's device busy and idle share,
              and the captures' seconds; then bitwise_paths: 3 steps from
              one scope state and one set of run counters through the
              interpreter, the graph and run_steps must agree bit for bit
              in the losses and every scope tensor
  training_f32
              the same step in float32 (AMP off, the reference's default
              precision; float32 GEMMs in full float32): the same counts,
              and its 18 flash forwards, 18 dQ and 18 dK/dV launches must
              all be the 3xTF32 tensor-core kernels
  train_gpu_vs_cpu
              the same model at full width cut to 2 layers, B=4, T=256,
              float32: 2 steps from the same weights on the card and on the
              CPU; losses and parameters after the updates must agree
  training_composed
              transformer-base at its own defaults (composed attention,
              dropout 0.1, label smoothing 0.1; full width and depth, vocab
              32000, B=32, T=256, bf16 AMP): 3 warm-up and 10 timed steps;
              launches per step (18 softmax, no flash, the planned
              generated segments, 32 LayerNorms, 2 gathers, 1 Adam), no
              plain version called on the card, the generated build's nvcc
              time, torch.profiler over one step; graph_modes and
              bitwise_paths as in training (dropout 0.1: the masks too)
  train_composed_gpu_vs_cpu
              that model at full width cut to 2 layers, B=4, float32,
              dropout 0: 2 steps on the card and on the CPU must agree
  composed_opt_on_off
              that model at full width cut to 2 layers, B=32, bf16 AMP,
              dropout 0.1: 3 steps with PT_OPT=1 (generated kernels) and
              with PT_OPT=0 (one eager op at a time) from the same seed;
              losses within 1e-6 relative, and whether bit for bit
  nan_trip    check_nan through the graph: that model at full width, 2
              layers, float32, dropout 0; after three clean steps a NaN
              in one target pad entry must raise naming the loss at
              nan_poll=1, and with nan_window_steps=8 at nan_poll=8
The phases run in that order, except that the four that also compute on
the CPU (gpu_vs_cpu, generation_gpu_vs_cpu, train_gpu_vs_cpu,
train_composed_gpu_vs_cpu) run last.  No phase is cut in depth for time.
The line before the last is the nvidia-smi line; the line before that
lists every kernel, with its launches per step on its training path (the
composed one for K5, its generated segments, K4, K6 and Adam; the flash
one for K1-K3 and its own segments), per served run for the serving-only
ones, and `launches_by_path` (per served run for serving and
serving_bf16, per decode step for generation, per step for each training
path); K1, K2 and K3 also list their two instances, bf16 on tensor cores
(the flash step; K1 also the bf16 served run) and float32 (3xTF32 on
tensor cores; launches per served run for K1, per float32 step for K2
and K3), each timed; with every phase run, a kernel or instance launched
on none of its paths fails the script.  The last line
is {"ok": true, "device": ...}.  Any failed check raises, so the script exits non-zero and prints no
result; it refuses to run without a CUDA device.  Float32 matrix products
and convolutions run in full float32 (TF32 off), set below.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, 'chiprun_out')
PHASES = ('card', 'kernels', 'serving', 'serving_bf16', 'generation',
          'gpu_vs_cpu', 'generation_gpu_vs_cpu', 'training', 'training_f32',
          'train_gpu_vs_cpu', 'training_composed',
          'train_composed_gpu_vs_cpu', 'composed_opt_on_off', 'nan_trip')
SEED = 1234
SERVED_FETCHES = ('last_logits', 'next_token')
BUCKETS = (1, 2, 4)
ALL_FETCHES = ('logits', 'last_logits', 'next_token')

# the training configuration bench.py headlines (transformer-base)
BENCH_CFG = dict(src_vocab=32000, trg_vocab=32000, max_len=256, n_layer=6,
                 n_head=8, d_model=512, d_inner=2048, dropout=0.0,
                 use_flash=True)
# transformer-base at models/transformer.py::build's own defaults
COMPOSED_CFG = dict(BENCH_CFG, dropout=0.1, use_flash=False)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type;
# 'tf32x3' is a float32 product as three TF32 tensor-core products (the
# float32 flash forward's design), 495 TFLOP/s / 3
HBM_BPS = 3.35e12
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12, 'tf32x3': 495e12 / 3}
# bytes written between launches to push a kernel's inputs and outputs out
# of the 50 MB L2
FLUSH_BYTES = 128 << 20


def emit(**obj):
    print(json.dumps(obj, sort_keys=False), flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, stdout=subprocess.PIPE,
        universal_newlines=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters):
    """Mean device ms per call on the card: CUDA events around `iters`
    calls after a warm-up.  The stream first runs a spin kernel long enough
    for the host to queue all the calls behind it, so the events time the
    calls back to back on the device, not the host's launch overhead
    (tens of microseconds a call, which would bound a small kernel)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    # ~2e9 cycles a second: cover the host's queueing of every call
    torch.cuda._sleep(int(min(2.0 * host_s * iters + 1e-3, 0.5) * 2e9))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def time_ms_flushed(fn, iters):
    """Mean device ms per call with the L2 flushed before each call (a
    FLUSH_BYTES write, outside the timed interval): CUDA events around each
    call, all queued behind a spin kernel as in time_ms."""
    import torch
    junk = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device='cuda')
    for _ in range(2):
        junk.zero_()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    junk.zero_()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(min(2.0 * host_s * iters + 1e-3, 0.5) * 2e9))
    for e0, e1 in ev:
        junk.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in ev) / iters


# ------------------------------------------------------------- phase 1

def phase_card():
    from paddle_tpu_torch.kernels import build
    smi = smi_line()
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    build_s = time.perf_counter() - t0
    log = build.build_log()
    if log:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, 'kernel_build.log'), 'w') as f:
            f.write(log)
    ptxas = [ln.strip() for ln in log.splitlines()
             if 'registers' in ln or 'spill' in ln]
    emit(phase='card', nvidia_smi=smi, library=os.path.relpath(path, ROOT),
         build_s=round(build_s, 2), ptxas=ptxas,
         flash_fwd_occupancy=flash_fwd_occupancy(build.library()),
         flash_bwd_occupancy=flash_bwd_occupancy(build.library()))
    return smi


def flash_fwd_occupancy(lib):
    """The flash forward's shared memory a block and blocks an SM, by
    instance, as the CUDA runtime reports them."""
    import ctypes
    res = {}
    for dtype, code in (('float32', 0), ('bfloat16', 1)):
        for D in (64, 128):
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            rc = lib.pt_flash_fwd_occupancy(D, code, ctypes.byref(smem),
                                            ctypes.byref(blocks))
            require(rc == 0, 'pt_flash_fwd_occupancy(%d, %s): %d'
                    % (D, dtype, rc))
            res['%s_d%d' % (dtype, D)] = dict(smem_bytes=smem.value,
                                              blocks_per_sm=blocks.value)
    return res


def flash_bwd_occupancy(lib):
    """The flash backward's shared memory a block and blocks an SM, for
    the dQ and the dK/dV kernel of each instance, as the CUDA runtime
    reports them."""
    import ctypes
    res = {}
    for kind, kname in ((0, 'dq'), (1, 'dkv')):
        for dtype, code in (('float32', 0), ('bfloat16', 1)):
            for D in (64, 128):
                smem, blocks = ctypes.c_int(), ctypes.c_int()
                rc = lib.pt_flash_bwd_occupancy(D, code, kind,
                                                ctypes.byref(smem),
                                                ctypes.byref(blocks))
                require(rc == 0, 'pt_flash_bwd_occupancy(%d, %s, %s): %d'
                        % (D, dtype, kname, rc))
                res['%s_%s_d%d' % (kname, dtype, D)] = dict(
                    smem_bytes=smem.value, blocks_per_sm=blocks.value)
    return res


# ------------------------------------------------------------- phase 2

def flash_case(name, B, H, Hkv, Tq, Tk, D, causal, dtype, klen=None,
               timed=False):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import attention as att
    g = torch.Generator(device='cuda').manual_seed(SEED)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, Tq, D, generator=g, device='cuda').to(dt)
    k = torch.randn(B, Hkv, Tk, D, generator=g, device='cuda').to(dt)
    v = torch.randn(B, Hkv, Tk, D, generator=g, device='cuda').to(dt)
    kl = [Tk] * B if klen is None else list(klen)
    kl_t = torch.tensor(kl, dtype=torch.int32, device='cuda')
    scale = D ** -0.5
    out, lse = att.flash_forward(q, k, v, causal, scale, kl_t)
    ref, ref_lse = att._ref_attention(q, k, v, causal, scale, kl_t)
    torch.cuda.synchronize()
    # float32: both sum in float32 in other orders; bfloat16: both round an
    # (almost equal) float32 result to bf16, so they may differ by one
    # bf16 unit in the last place, 2^-8 relative
    rtol, atol = (1e-4, 1e-5) if dtype == 'float32' else (8e-3, 1e-3)
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    valid_rows = ref_lse > -1e29
    lse_err = float((lse - ref_lse).abs()[valid_rows].max()) \
        if bool(valid_rows.any()) else 0.0
    lse_ok = bool(torch.equal(lse > -1e29, valid_rows)) and lse_err <= 1e-4
    res = dict(phase='kernels', kernel='flash_attention_fwd', case=name,
               B=B, H=H, Hkv=Hkv, Tq=Tq, Tk=Tk, D=D, causal=causal,
               dtype=dtype, k_len=kl, max_abs_err=err, rtol=rtol, atol=atol,
               lse_max_abs_err=lse_err, lse_atol=1e-4)
    if 0 in kl:
        zero_rows = out[torch.tensor(kl) == 0].float().abs().max()
        res['k_len0_rows_max_abs'] = float(zero_rows)
        ok = ok and float(zero_rows) == 0.0
    if timed:
        # the work these inputs need: 4*D FLOPs per valid (query, key)
        # pair; each input read once, each output written once
        itemsize = q.element_size()
        qpos = np.arange(Tq)
        pairs = 0
        for b in range(B):
            vis = (np.minimum(kl[b], qpos + (Tk - Tq) + 1) if causal
                   else np.full(Tq, kl[b]))
            pairs += int(np.clip(vis, 0, Tk).sum()) * H
        flops = 4.0 * D * pairs
        nbytes = ((2 * B * H * Tq + 2 * B * Hkv * Tk) * D * itemsize
                  + 4 * B * H * Tq + 4 * B)
        t_bytes = nbytes / HBM_BPS * 1e3
        # float32 runs as 3xTF32 on the tensor cores: that rate bounds it;
        # the CUDA cores' float32 rate is printed beside it
        t_ops = flops / PEAK_FLOPS[
            'tf32x3' if dtype == 'float32' else dtype] * 1e3
        if dtype == 'float32':
            res['bound_cuda_cores_ms'] = max(
                t_bytes, flops / PEAK_FLOPS['float32'] * 1e3)
        res.update(
            ms=time_ms(lambda: att.flash_forward(q, k, v, causal, scale,
                                                 kl_t), 10),
            plain_ms=time_ms(lambda: att._ref_attention(q, k, v, causal,
                                                        scale, kl_t), 3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), 10),
            bound_ms=max(t_bytes, t_ops),
            bound_by='bytes' if t_bytes > t_ops else 'operations',
            flops=flops, bytes=nbytes)
        res['tflops'] = flops / res['ms'] / 1e9
        res['bound_share'] = res['bound_ms'] / res['ms']
    emit(**res)
    require(ok and lse_ok, 'flash_attention_fwd disagrees with its plain '
            'version in case %s: %s' % (name, res))
    return res


def gather_case(name, V, D, N, dtype, special=False, ids64=False,
                timed=False):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import gather as ga
    g = torch.Generator(device='cuda').manual_seed(SEED)
    w = torch.randn(V, D, generator=g, device='cuda').to(getattr(torch,
                                                                 dtype))
    ids = torch.randint(0, V, (N,), generator=g, device='cuda')
    if special:
        # negative ids wrap once; ids still out of range give NaN rows
        ids[:6] = torch.tensor([-1, -V, V, V + 5, -V - 1, 2 ** 30])
    ids = ids.to(torch.int64 if ids64 else torch.int32)
    out = ga.embedding_gather(w, ids)
    ref = ga.embedding_gather_reference(w, ids)
    torch.cuda.synchronize()
    nan_same = bool(torch.equal(torch.isnan(out), torch.isnan(ref)))
    diff = (out.float() - ref.float()).abs().nan_to_num(0.0)
    err = float(diff.max())
    res = dict(phase='kernels', kernel='embedding_gather', case=name, V=V,
               D=D, N=N, dtype=dtype, ids_dtype=str(ids.dtype),
               nan_rows=int(torch.isnan(out[:, 0]).sum()), max_abs_err=err,
               atol=0.0)
    if timed:
        # warm: the same ids again and again, so rows and output that fit
        # in L2 stay there; flushed: L2 emptied before each call
        nbytes = 2 * N * D * w.element_size() + N * ids.element_size()
        res.update(
            ms=time_ms(lambda: ga.embedding_gather(w, ids), 50),
            plain_ms=time_ms(lambda: ga.embedding_gather_reference(w, ids),
                             20),
            library_ms=time_ms(lambda: F.embedding(ids, w), 50),
            flushed_ms=time_ms_flushed(lambda: ga.embedding_gather(w, ids),
                                       20),
            library_flushed_ms=time_ms_flushed(lambda: F.embedding(ids, w),
                                               20),
            bound_ms=nbytes / HBM_BPS * 1e3, bound_by='bytes', bytes=nbytes)
        # what the card reaches on these bytes without a gather: a plain
        # contiguous copy of a tensor the size of the output
        src, dst = ref.clone(), torch.empty_like(ref)
        res.update(copy_ms=time_ms(lambda: dst.copy_(src), 50),
                   copy_flushed_ms=time_ms_flushed(lambda: dst.copy_(src),
                                                   20))
        res['gbps'] = nbytes / res['ms'] / 1e6
        res['bound_share'] = res['bound_ms'] / res['ms']
        res['flushed_bound_share'] = res['bound_ms'] / res['flushed_ms']
        res['copy_bound_share'] = res['bound_ms'] / res['copy_ms']
    emit(**res)
    require(nan_same and err == 0.0, 'embedding_gather disagrees with its '
            'plain version in case %s: %s' % (name, res))
    return res


def _close(out, ref, rtol, atol):
    """(max |out - ref|, all within atol + rtol |ref|), in float32."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def _bound(flops, nbytes, dtype):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


def _valid_pairs(B, H, Tq, Tk, causal, kl):
    qpos = np.arange(Tq)
    pairs = 0
    for b in range(B):
        vis = (np.minimum(kl[b], qpos + (Tk - Tq) + 1) if causal
               else np.full(Tq, kl[b]))
        pairs += int(np.clip(vis, 0, Tk).sum()) * H
    return pairs


def _bwd_rate(dtype, D):
    """The PEAK_FLOPS key of the flash backward's design at (dtype, D):
    float32 runs as 3xTF32 at D = 64 and on CUDA cores at D = 128."""
    if dtype != 'float32':
        return dtype
    return 'tf32x3' if D == 64 else 'float32'


def flash_bwd_case(name, B, H, Hkv, Tq, Tk, D, causal, dtype, klen=None,
                   timed=False):
    """dQ and dK/dV kernels against flash_backward_reference on the same
    q, k, v, dO and the kernel forward's out and LSE."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import attention as att
    g = torch.Generator(device='cuda').manual_seed(SEED + 7)
    dt = getattr(torch, dtype)
    q, do = (torch.randn(B, H, Tq, D, generator=g, device='cuda').to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, Hkv, Tk, D, generator=g, device='cuda').to(dt)
            for _ in range(2))
    kl = [Tk] * B if klen is None else list(klen)
    kl_t = torch.tensor(kl, dtype=torch.int32, device='cuda')
    scale = D ** -0.5
    out, lse = att.flash_forward(q, k, v, causal, scale, kl_t)
    dq, dk, dv = att.flash_backward(q, k, v, kl_t, out, lse, do, causal,
                                    scale)
    rq, rk, rv = att.flash_backward_reference(q, k, v, kl_t, out, lse, do,
                                              causal, scale)
    torch.cuda.synchronize()
    # float32: both sum in float32 in other orders, and dS = P (dP - delta)
    # cancels, so the bound is relative to the largest gradient; bfloat16:
    # both round an (almost equal) float32 result to bf16 once
    rtol, arel = (1e-4, 1e-5) if dtype == 'float32' else (8e-3, 2e-3)
    res = {}
    for kname, outs, refs in (('flash_attention_bwd_dq', (dq,), (rq,)),
                              ('flash_attention_bwd_dkv', (dk, dv),
                               (rk, rv))):
        errs = [_close(o, r, rtol, arel * float(r.float().abs().max()))
                for o, r in zip(outs, refs)]
        row = dict(phase='kernels', kernel=kname, case=name, B=B, H=H,
                   Hkv=Hkv, Tq=Tq, Tk=Tk, D=D, causal=causal, dtype=dtype,
                   k_len=kl, max_abs_err=max(e for e, _ in errs), rtol=rtol,
                   atol_of_max=arel)
        if 0 in kl:
            zero = torch.tensor(kl, device='cuda') == 0
            row['k_len0_max_abs'] = max(float(t[zero].float().abs().max())
                                        for t in outs)
            errs.append((row['k_len0_max_abs'],
                         row['k_len0_max_abs'] == 0.0))
        ok = all(o for _, o in errs)
        res[kname] = (row, ok)
    if timed:
        itemsize = q.element_size()
        pairs = _valid_pairs(B, H, Tq, Tk, causal, kl)
        in_bytes = ((2 * B * H * Tq + 2 * B * Hkv * Tk) * D * itemsize
                    + 8 * B * H * Tq + 4 * B)
        delta = att._bwd_delta(out, do)
        plain_ms = time_ms(lambda: att.flash_backward_reference(
            q, k, v, kl_t, out, lse, do, causal, scale), 3)
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        # the library yardstick: PyTorch's SDPA forward+backward minus its
        # forward, bf16 (key padding and GQA given as they are here)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qs, ks, vs,
                                                  is_causal=causal,
                                                  enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), do)
        lib_ms = None
        if klen is None:
            lib_ms = time_ms(sdpa_fwd_bwd, 10) - time_ms(sdpa_fwd, 10)
        for kname, fn, flops_per, out_bytes in (
                ('flash_attention_bwd_dq',
                 lambda: att._launch_bwd_dq(q, k, v, kl_t, lse, delta, do,
                                            causal, scale), 6,
                 B * H * Tq * D * itemsize),
                ('flash_attention_bwd_dkv',
                 lambda: att._launch_bwd_dkv(q, k, v, kl_t, lse, delta, do,
                                             causal, scale), 8,
                 2 * B * Hkv * Tk * D * itemsize)):
            flops = float(flops_per * D * pairs)
            nbytes = in_bytes + out_bytes
            # float32 at D = 64 runs as 3xTF32 on the tensor cores: that
            # rate bounds it; the CUDA cores' float32 rate is printed beside
            bound_ms, bound_by = _bound(flops, nbytes, _bwd_rate(dtype, D))
            row = res[kname][0]
            if dtype == 'float32':
                row['bound_cuda_cores_ms'] = _bound(flops, nbytes,
                                                    'float32')[0]
            row.update(ms=time_ms(fn, 10), plain_ms=plain_ms,
                       plain_is='the whole plain backward (dq, dk, dv)',
                       library_ms=lib_ms,
                       library_is='SDPA fwd+bwd minus fwd (dq, dk, dv)',
                       bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                       bytes=nbytes)
            row['tflops'] = flops / row['ms'] / 1e9
    for kname, (row, ok) in res.items():
        emit(**row)
        require(ok, '%s disagrees with its plain version in case %s: %s'
                % (kname, name, row))
    return {k: r for k, (r, _) in res.items()}


def layer_norm_case(name, rows, cols, dtype, affine=True, two_pass=False,
                    offset=0.0, timed=False):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import nn as tnn
    g = torch.Generator(device='cuda').manual_seed(SEED + 3)
    x = (torch.randn(rows, cols, generator=g, device='cuda')
         + offset).to(getattr(torch, dtype))
    scale = bias = None
    if affine:
        scale = 1.0 + 0.1 * torch.randn(cols, generator=g, device='cuda')
        bias = 0.1 * torch.randn(cols, generator=g, device='cuda')
    eps = 1e-5
    y, m, v = tnn.layer_norm_rows(x, scale, bias, eps, two_pass)
    ry, rm, rv = tnn.layer_norm_reference(x, scale, bias, eps, two_pass)
    torch.cuda.synchronize()
    # float32 sums in other orders; bf16 Y: one rounding of ~equal floats
    rtol, atol = (1e-5, 1e-5) if dtype == 'float32' else (8e-3, 8e-3)
    e_y, ok_y = _close(y, ry, rtol, atol)
    e_m, ok_m = _close(m, rm, 1e-5, 1e-5)
    e_v, ok_v = _close(v, rv, 1e-4, 1e-6)
    row = dict(phase='kernels', kernel='layer_norm', case=name, rows=rows,
               cols=cols, dtype=dtype, affine=affine, two_pass=two_pass,
               offset=offset, max_abs_err=e_y, mean_err=e_m, var_err=e_v,
               rtol=rtol, atol=atol)
    if timed:
        nbytes = 2 * rows * cols * x.element_size() + 8 * rows + 8 * cols
        bound_ms, bound_by = _bound(0.0, nbytes, dtype)
        row.update(
            ms=time_ms(lambda: tnn.layer_norm_rows(x, scale, bias, eps,
                                                   two_pass), 50),
            plain_ms=time_ms(lambda: tnn.layer_norm_reference(
                x, scale, bias, eps, two_pass), 20),
            library_ms=time_ms(lambda: F.layer_norm(x, (cols,), scale, bias,
                                                    eps), 50),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
        row['gbps'] = nbytes / row['ms'] / 1e6
    emit(**row)
    require(ok_y and ok_m and ok_v, 'layer_norm disagrees with its plain '
            'version in case %s: %s' % (name, row))
    return row


def transformer_param_shapes():
    """The 158 parameter shapes of the training program at the bench
    configuration, from the port's layers (no weights are made)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        tr.build(**BENCH_CFG)
    return [tuple(p.shape) for p in main.all_parameters()]


def adam_case(name, shapes, steps=3, timed=False):
    """adam_multi over the tensors of `shapes` against adam_reference on
    copies, `steps` steps with an LR tensor on the device."""
    import torch
    from paddle_tpu_torch.ops import optimizer_ops as oo
    g = torch.Generator(device='cuda').manual_seed(SEED + 5)
    n = len(shapes)

    def rand(shape, s=1.0):
        return s * torch.randn(shape, generator=g, device='cuda')
    params = [rand(s, 0.05) for s in shapes]
    m1s = [rand(s, 1e-3) for s in shapes]
    m2s = [rand(s, 1e-3).square() for s in shapes]
    b1, b2, eps = 0.9, 0.997, 1e-9
    b1ps = [torch.full((1,), b1 ** 3, device='cuda') for _ in range(n)]
    b2ps = [torch.full((1,), b2 ** 3, device='cuda') for _ in range(n)]
    lr = [torch.full((1,), 1e-3, device='cuda')] * n
    state = [params, m1s, m2s, b1ps, b2ps]
    ref = [[t.clone() for t in col] for col in state]
    cache = {}
    for _ in range(steps):
        grads = [rand(s, 1e-2) for s in shapes]
        oo.adam_multi(params, grads, m1s, m2s, b1ps, b2ps, lr, b1, b2, eps,
                      cache=cache)
        oo.adam_reference(ref[0], grads, ref[1], ref[2], ref[3], ref[4], lr,
                          b1, b2, eps)
    torch.cuda.synchronize()
    # the kernel rounds each operation in the reference's order (IEEE
    # multiply, add, divide and square root, no FMA contraction): equal up
    # to the last bit of PyTorch's own elementwise kernels
    errs = [_close(torch.cat([t.reshape(-1) for t in a]),
                   torch.cat([t.reshape(-1) for t in r]), 2e-6, 1e-12)
            for a, r in zip(state, ref)]
    pows_ok = bool(torch.allclose(b1ps[0], torch.full_like(
        b1ps[0], b1 ** (3 + steps)), rtol=1e-6))
    row = dict(phase='kernels', kernel='adam_multi', case=name, tensors=n,
               elements=int(sum(int(np.prod(s)) for s in shapes)),
               steps=steps, max_abs_err=max(e for e, _ in errs),
               rtol=2e-6, atol=1e-12, pows_advanced=pows_ok)
    if timed:
        grads = [rand(s, 1e-2) for s in shapes]
        elems = row['elements']
        nbytes = 28 * elems + 16 * n
        bound_ms, bound_by = _bound(0.0, nbytes, 'float32')
        lib_params = [p.clone().requires_grad_(True) for p in params]
        for p, gr in zip(lib_params, grads):
            p.grad = gr
        lib = torch.optim.Adam(lib_params, lr=1e-3, betas=(b1, b2), eps=eps,
                               fused=True)
        row.update(
            ms=time_ms(lambda: oo.adam_multi(params, grads, m1s, m2s, b1ps,
                                             b2ps, lr, b1, b2, eps,
                                             cache=cache), 20),
            plain_ms=time_ms(lambda: oo.adam_reference(
                ref[0], grads, ref[1], ref[2], ref[3], ref[4], lr, b1, b2,
                eps), 5),
            library_ms=time_ms(lib.step, 20),
            library_is='torch.optim.Adam(fused=True).step(), eps placed '
                       'otherwise: a timing yardstick only',
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
            table_builds=cache.get('adam_multi_tables'))
        row['gbps'] = nbytes / row['ms'] / 1e6
    emit(**row)
    require(all(o for _, o in errs) and pows_ok, 'adam_multi disagrees '
            'with adam_reference in case %s: %s' % (name, row))
    return row


def softmax_case(name, rows, cols, dtype, neg_inf_rows=0, timed=False):
    """K5 against softmax_reference on the same rows; timed at the
    composed attention's scores (65,536 rows of 256, float32)."""
    import torch
    from paddle_tpu_torch.ops import nn as tnn
    g = torch.Generator(device='cuda').manual_seed(SEED + 9)
    x = (3 * torch.randn(rows, cols, generator=g, device='cuda')).to(
        getattr(torch, dtype))
    x[:neg_inf_rows] = float('-inf')
    y = tnn.softmax_rows(x)
    ref = tnn.softmax_reference(x)
    torch.cuda.synchronize()
    # float32: the same operations, the row sums in other orders; bf16:
    # one rounding of (almost) equal float32 results
    rtol, atol = (1e-5, 1e-7) if dtype == 'float32' else (8e-3, 1e-3)
    nan_same = bool(torch.equal(torch.isnan(y), torch.isnan(ref)))
    err, ok = _close(y.nan_to_num(0.0), ref.nan_to_num(0.0), rtol, atol)
    row = dict(phase='kernels', kernel='softmax', case=name, rows=rows,
               cols=cols, dtype=dtype, neg_inf_rows=neg_inf_rows,
               max_abs_err=err, rtol=rtol, atol=atol, nan_rows_equal=nan_same)
    if timed:
        nbytes = 2 * rows * cols * x.element_size()
        # max, subtract, exp, sum and divide: 5 operations an element
        bound_ms, bound_by = _bound(5.0 * rows * cols, nbytes, 'float32')
        row.update(
            ms=time_ms(lambda: tnn.softmax_rows(x), 50),
            plain_ms=time_ms(lambda: tnn.softmax_reference(x), 20),
            library_ms=time_ms(lambda: torch.softmax(x, -1), 50),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
        row['gbps'] = nbytes / row['ms'] / 1e6
    emit(**row)
    require(ok and nan_same, 'softmax disagrees with its plain version in '
            'case %s: %s' % (name, row))
    return row


def _meta_env(main, feed, bf16=False):
    """Meta tensors for a program's persistables and a feed: enough for
    the executor's planning pass, with no weights made; with `bf16` the
    float32 persistables are bf16, as a Predictor with enable_bf16 holds
    them."""
    import torch
    from paddle_tpu_torch.core.dtypes import torch_dtype

    def dt(v):
        d = torch_dtype(v.dtype)
        return torch.bfloat16 if bf16 and d == torch.float32 else d
    env = {v.name: torch.empty(v.shape, dtype=dt(v), device='meta')
           for v in main.list_vars() if v.persistable}
    block = main.global_block()
    for name, a in feed.items():
        env[name] = torch.empty(a.shape, device='meta',
                                dtype=torch_dtype(block.var(name).dtype))
    return env


def _planned_specs(main, feed, fetch_names, amp, bf16=False):
    """The generated segments `main` runs at `feed`'s shapes, from the
    executor's planning pass on meta tensors: name -> (spec, sub-op
    types).  `bf16`: with bf16 parameters (enable_bf16)."""
    from paddle_tpu_torch.core import executor as ex, passes
    from paddle_tpu_torch.ops import kernelgen
    opt, _ = passes.maybe_optimize(main, fetch_names)
    seen, real = [], kernelgen.plan_for

    def spy(attrs, avals, amp_):
        plan = real(attrs, avals, amp_)
        seen.append(plan)
        return plan
    kernelgen.plan_for = spy
    try:
        ex._plan_kernels(opt.global_block().ops,
                         _meta_env(main, feed, bf16), amp)
    finally:
        kernelgen.plan_for = real
    specs = {}
    for plan in seen:
        for kind, *rest in plan.steps:
            if kind == 'kernel':
                spec = rest[0]
                specs.setdefault(spec.name, (spec, '+'.join(
                    op[0]['type'] for op in spec.ops)))
    return specs


def path_segments():
    """Every generated segment the main paths run: the composed and the
    flash training steps (B=32, T=256, bf16 AMP), the flash step in
    float32, and the served llama_1b decode program at each bucket (1, 2,
    4 rows x 2048 tokens) in float32 and with bf16 parameters: name ->
    (spec, sub-op types, paths)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models import transformer as tr
    found = []
    feed = tr.synthetic_batch(np.random.RandomState(0), 32,
                              COMPOSED_CFG['max_len'],
                              COMPOSED_CFG['trg_vocab'])
    for path, cfg, amp in (('training_composed', COMPOSED_CFG, True),
                           ('training', BENCH_CFG, True),
                           ('training_f32', BENCH_CFG, False)):
        main, _, out = _train_program(fluid, tr, amp=amp, **cfg)
        found.append((path, _planned_specs(main, feed, [out['loss'].name],
                                           amp)))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = llama.generation_program('llama_1b', mode='decode',
                                       temperature=0.0)
    T = out['config']['max_len']
    for rows in BUCKETS:
        feed = {'tokens': np.zeros((rows, T, 1), 'int64')}
        for path, bf16 in (('serving', False), ('serving_bf16', True)):
            found.append((path, _planned_specs(
                main, feed, [out[k].name for k in SERVED_FETCHES], False,
                bf16)))
    specs = {}
    for path, got in found:
        for name, (spec, ops) in got.items():
            paths = specs.setdefault(name, (spec, ops, []))[2]
            if path not in paths:
                paths.append(path)
    return specs


def segment_case(spec, ops, paths, timed=True):
    """One generated segment against its plain replay (the sub-ops' eager
    PyTorch impls) on the same positive random inputs."""
    import torch
    from paddle_tpu_torch.core.dtypes import torch_dtype
    from paddle_tpu_torch.ops import kernelgen
    g = torch.Generator(device='cuda').manual_seed(SEED + 11)
    ents = []
    for shape, dt in spec.entry_avals:
        if dt == 'int32':
            ents.append(torch.randint(1, 100, shape, generator=g,
                                      device='cuda', dtype=torch.int32))
        else:
            ents.append((torch.rand(shape, generator=g, device='cuda')
                         + 0.5).to(torch_dtype(dt)))
    with torch.no_grad():
        outs = kernelgen._launch(spec, ents)
        refs = spec.replay(ents)
        torch.cuda.synchronize()
        # every operation rounds as PyTorch's eager kernel does: equal,
        # up to exp / pow implementations (1e-6 relative)
        errs = [_close(o, r, 1e-6, 0.0) for o, r in zip(outs, refs)]
        row = dict(phase='kernels', kernel='kernelgen_segment',
                   name=spec.name, ops=ops, paths=paths, groups=spec.groups,
                   inputs=[list(s) for s, _ in spec.entry_avals],
                   outputs=[list(s) for s, _ in spec.esc_aval],
                   max_abs_err=max(e for e, _ in errs), rtol=1e-6, atol=0.0)
        if timed:
            nbytes = sum(int(np.prod(s)) * torch.empty(
                (), dtype=torch_dtype(d)).element_size()
                for s, d in list(spec.entry_avals) + list(spec.esc_aval))
            bound_ms, bound_by = _bound(0.0, nbytes, 'float32')
            row.update(ms=time_ms(lambda: kernelgen._launch(spec, ents), 50),
                       plain_ms=time_ms(lambda: spec.replay(ents), 20),
                       library_ms=None, bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes)
            row['gbps'] = nbytes / row['ms'] / 1e6
    emit(**row)
    require(all(o for _, o in errs), 'generated segment %s disagrees with '
            'its plain replay: %s' % (spec.name, row))
    return row


def phase_kernels():
    """-> {'rows': kernel name -> its timed row at its main path's shape,
    'instances': K1-K3 by dtype -> the timed row of that instance}.
    K1, K2 and K3 have two instances: bf16 on tensor cores (the training
    path) and float32 (serving, for K1; the float32 training path): all
    three as 3xTF32 on tensor cores (K2 and K3 on CUDA cores at D =
    128)."""
    served = {}
    inst = {'flash_attention_fwd': {}, 'flash_attention_bwd_dq': {},
            'flash_attention_bwd_dkv': {}}
    # the served shapes (llama_1b, 4 rows x 2048 tokens): timed
    inst['flash_attention_fwd']['float32'] = flash_case(
        'served_f32', 4, 16, 8, 2048, 2048, 128, True, 'float32',
        timed=True)
    flash_case('served_bf16', 4, 16, 8, 2048, 2048, 128, True, 'bfloat16',
               timed=True)
    flash_case('noncausal_gqa_d64', 2, 4, 2, 200, 200, 64, False, 'float32')
    flash_case('causal_klen', 3, 4, 1, 300, 300, 128, True, 'float32',
               klen=[300, 77, 1])
    flash_case('decode_tq_lt_tk', 2, 8, 2, 5, 333, 128, True, 'bfloat16',
               klen=[333, 100])
    flash_case('decode_tq_lt_tk_f32', 2, 8, 2, 5, 333, 128, True, 'float32',
               klen=[333, 100])
    flash_case('ragged_f32_d64', 1, 2, 2, 97, 161, 64, False, 'float32',
               klen=[130])
    flash_case('ragged_bf16_d64', 1, 2, 2, 97, 161, 64, False, 'bfloat16',
               klen=[130])
    flash_case('klen0', 2, 4, 4, 70, 70, 64, True, 'float32', klen=[0, 50])
    flash_case('klen0_bf16', 2, 4, 4, 70, 70, 64, True, 'bfloat16',
               klen=[0, 50])
    # Tq = 200: the last query tile is ragged
    flash_case('gqa_causal_bf16_d128', 2, 8, 2, 200, 200, 128, True,
               'bfloat16')
    served['embedding_gather'] = gather_case(
        'served_f32', 32000, 2048, 8192, 'float32', timed=True)
    # the bf16 served lookup, and the generation embedding: a prefill
    # chunk and a decode step of 8 slots, float32
    gather_case('served_bf16', 32000, 2048, 8192, 'bfloat16', timed=True)
    gather_case('gen_prefill_chunk_f32', 32000, 2048, 256, 'float32',
                timed=True)
    gather_case('gen_decode_step_f32', 32000, 2048, 8, 'float32',
                timed=True)
    gather_case('wrap_nan_f32_ids64', 32000, 2048, 4096, 'float32',
                special=True, ids64=True)
    gather_case('wrap_nan_bf16', 32000, 2048, 4096, 'bfloat16',
                special=True)
    gather_case('scalar_path_f32_d99', 1000, 99, 777, 'float32',
                special=True)
    gather_case('scalar_path_bf16_d100', 1000, 100, 777, 'bfloat16',
                special=True)
    # the training path's shapes (transformer-base, B=32, T=256, bf16
    # attention under AMP, a float32 [32000, 512] table): timed; then
    # ragged cases.  The kernels line keeps the served rows of the two
    # kernels serving and training share.
    served['flash_attention_fwd'] = inst['flash_attention_fwd'][
        'bfloat16'] = flash_case('path_bf16', 32, 8, 8, 256, 256, 64, False,
                                 'bfloat16', timed=True)
    flash_case('path_bf16_causal', 32, 8, 8, 256, 256, 64, True, 'bfloat16',
               timed=True)
    gather_case('path_f32', 32000, 512, 8192, 'float32', timed=True)
    bwd = flash_bwd_case('path_bf16', 32, 8, 8, 256, 256, 64, False,
                         'bfloat16', timed=True)
    served.update(bwd)
    for kname in ('flash_attention_bwd_dq', 'flash_attention_bwd_dkv'):
        inst[kname]['bfloat16'] = bwd[kname]
    flash_bwd_case('path_bf16_causal', 32, 8, 8, 256, 256, 64, True,
                   'bfloat16', timed=True)
    # the float32 instances at the training path's shape (the float32
    # step, training_f32, runs them)
    bwd_f32 = flash_bwd_case('path_f32', 32, 8, 8, 256, 256, 64, False,
                             'float32', timed=True)
    for kname in ('flash_attention_bwd_dq', 'flash_attention_bwd_dkv'):
        inst[kname]['float32'] = bwd_f32[kname]
    flash_bwd_case('gqa_f32_d64', 2, 8, 2, 128, 128, 64, True, 'float32')
    flash_bwd_case('gqa_bf16_d64', 2, 8, 2, 128, 128, 64, True, 'bfloat16')
    flash_bwd_case('tq_lt_tk_bf16', 2, 4, 1, 37, 161, 64, True, 'bfloat16',
                   klen=[161, 100])
    flash_bwd_case('klen_bf16_d128', 3, 4, 2, 150, 150, 128, False,
                   'bfloat16', klen=[150, 77, 1])
    flash_bwd_case('klen_f32_d128', 3, 4, 2, 150, 150, 128, False, 'float32',
                   klen=[150, 77, 1])
    flash_bwd_case('klen0_bf16', 2, 4, 4, 70, 70, 64, True, 'bfloat16',
                   klen=[0, 50])
    flash_bwd_case('tq_lt_tk_f32', 2, 4, 1, 37, 161, 64, True, 'float32',
                   klen=[161, 100])
    flash_bwd_case('ragged_bf16_d128', 1, 2, 2, 97, 161, 128, False,
                   'bfloat16', klen=[130])
    served['layer_norm'] = layer_norm_case('path_f32', 8192, 512, 'float32',
                                           timed=True)
    layer_norm_case('ragged_cols_f32', 300, 1000, 'float32')
    layer_norm_case('bf16_no_affine', 257, 512, 'bfloat16', affine=False)
    layer_norm_case('pilot_offset_f32', 64, 512, 'float32', offset=1e4)
    layer_norm_case('two_pass_f32', 100, 77, 'float32', two_pass=True)
    served['adam_multi'] = adam_case('transformer_158', 
                                     transformer_param_shapes(), timed=True)
    adam_case('ragged', [(1,), (7,), (32769,), (3, 33333), (5, 4)])
    # the composed attention's scores: [32, 8, 256, 256] float32
    served['softmax'] = softmax_case('path_f32', 65536, 256, 'float32',
                                     timed=True)
    softmax_case('register_branch_1000', 300, 1000, 'float32',
                 neg_inf_rows=3)
    softmax_case('block_branch_3000', 7, 3000, 'float32', neg_inf_rows=1)
    softmax_case('bf16_255', 257, 255, 'bfloat16')
    softmax_case('cols_1', 33, 1, 'float32')
    # the 16-byte vector branch in bf16 (a block's last rows empty), and a
    # float32 column count off the 4-value vectors (the scalar branch)
    softmax_case('vec_bf16_256', 4099, 256, 'bfloat16', neg_inf_rows=1)
    softmax_case('scalar_f32_258', 1000, 258, 'float32', neg_inf_rows=2)
    from paddle_tpu_torch.ops import kernelgen
    t0 = time.perf_counter()
    specs = path_segments()
    kernelgen.ensure_built()
    log = kernelgen.build_stats['log']
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'kernelgen_build.log'), 'w') as f:
        f.write(log)
    emit(phase='kernels', step='kernelgen_build', functions=len(specs),
         plan_and_build_s=time.perf_counter() - t0,
         nvcc_s=kernelgen.build_stats['nvcc_s'],
         ptxas=sorted({ln.split(':', 1)[-1].strip() for ln in log.splitlines()
                       if 'registers' in ln or 'spill' in ln}))
    for name, (spec, ops, paths) in sorted(specs.items()):
        served[name] = segment_case(spec, ops, paths)
    return {'rows': served, 'instances': inst}


# ------------------------------------------------------------- phase 3

def _build_and_save(fluid, llama, dirname, fetches, **overrides):
    """Build the decode program through the port's layers, run its startup
    on the card and save it with the `generation_program` outputs named in
    `fetches` as targets; returns the program's config."""
    import torch
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = llama.generation_program('llama_1b', mode='decode',
                                       temperature=0.0, **overrides)
    scope = fluid.Scope()
    exe = fluid.Executor()
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        exe.run(startup)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fluid.io.save_inference_model(
            dirname, ['tokens'],
            [out[k] for k in fetches], exe, main)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    t2 = time.perf_counter()
    del scope
    torch.cuda.empty_cache()
    return out['config'], n_params, t1 - t0, t2 - t1


def _model_dir():
    """A scratch model directory inside the checkout's (git-ignored) build
    directory, removed afterwards."""
    from paddle_tpu_torch.kernels import build
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    return tempfile.TemporaryDirectory(prefix='model_', dir=build.BUILD_DIR)


def _tokens(rng, rows, T, V):
    return rng.randint(0, V, (rows, T, 1)).astype('int64')


def _agree(a, b, what):
    """Logits within tolerance, greedy tokens equal wherever the top-two
    gap exceeds it.  Tolerance: 1e-4 of the largest |logit| — float32
    sums over 2048..5504 terms taken in other orders (other GEMM tilings
    per batch size, CPU vs GPU libraries, the kernel vs the plain
    attention) differ by ~1e-6 relative; the margin covers depth."""
    tol = 1e-4 * float(np.abs(b).max())
    err = float(np.abs(a - b).max())
    require(err <= tol, '%s: logits differ by %g > %g' % (what, err, tol))
    clear = _clear(b, tol)
    same = np.argmax(a, -1) == np.argmax(b, -1)
    require(bool(same[clear].all()), '%s: greedy tokens differ where the '
            'top-two gap exceeds the tolerance' % what)
    return err, tol, int(clear.sum()), int(clear.size)


def _clear(logits, tol):
    """Positions whose top-two logit gap exceeds twice the tolerance: there
    the greedy token cannot flip within it."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 2 * tol


def _interpreted(pred):
    """Predictor.run through the interpreter: the same program, scope and
    fetches, with use_program_cache=False (no CUDA graph)."""
    from paddle_tpu_torch.inference import _fetch_numpy

    def run(feed):
        with pred._run_lock:
            out = pred._exe.run(pred._program, feed=feed,
                                fetch_list=pred._fetch_names,
                                scope=pred._scope, return_numpy=False,
                                use_program_cache=False)
        return [_fetch_numpy(o) for o in out]
    return run


def profile_batch(pred, feed, n_layer, phase='serving',
                  design='fwd_tf32x3'):
    """Where one dispatched batch spends its time: torch.profiler over one
    interpreted Predictor.run (device time by kernel, grouped; the flash
    kernels by design), beside the host wall time of three unprofiled
    runs; every flash forward of the batch must be `design`.  serve_modes
    times and profiles the graph replays."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run = _interpreted(pred)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(feed)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(feed)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    groups = {}
    top = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): an aten op's device
        # total repeats the time of the kernels it launched
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if not us:
            continue
        name = e.key
        low = name.lower()
        group = ('flash_attention_fwd' if 'flash_fwd' in name else
                 'embedding_gather' if 'gather_rows' in name else
                 'kernelgen_segment' if 'kg_' in name else
                 'memcpy' if 'memcpy' in low else
                 'matmul' if any(s in low for s in ('gemm', 'cutlass',
                                                    'sm90_', 'xmma',
                                                    'nvjet')) else
                 'other')
        groups[group] = groups.get(group, 0.0) + us / 1e3
        top.append((us / 1e3, name[:80], e.count))
    top.sort(reverse=True)
    busy = sum(groups.values())
    flash = _flash_by_design(prof.key_averages())
    emit(phase=phase, step='profile',
         rows=int(feed['tokens'].shape[0]),
         run_wall_ms=[w * 1e3 for w in walls],
         profiled_wall_ms=prof_wall * 1e3, device_ms_by_group=groups,
         device_busy_ms=busy,
         device_idle_share=(1 - busy / (prof_wall * 1e3)) if busy else None,
         flash_by_design=flash,
         top_kernels=[dict(ms=t, name=n, count=c) for t, n, c in top[:12]])
    # one batch: a flash forward a layer, all of the dtype's design
    require(set(flash) == {design} and flash[design][1] == n_layer,
            'the served batch ran flash kernels %s, not %d %s'
            % (flash, n_layer, design))


def serve_modes(phase, smi, pred, feed, n_layer, design):
    """The 4-row batch through Predictor.run in turns (eager, graph, graph,
    eager): `eager` the interpreter (use_program_cache=False), `graph` a
    replay of its signature's CUDA graph.  3 runs a reading; median batch
    ms, prompt tokens/s, peak memory; one profiled run each (device busy,
    idle share, the flash kernels by design, the device launches of the
    hand-written and generated kernels beside the counted ones);
    the served rows must agree bit for bit."""
    import torch
    T = feed['tokens'].shape[1]
    rows = feed['tokens'].shape[0]
    runs = {'eager': _interpreted(pred), 'graph': pred.run}
    outs = {m: fn(feed) for m, fn in runs.items()}   # the graph is warm
    readings = {m: [] for m in runs}
    for mode in ('eager', 'graph', 'graph', 'eager'):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            runs[mode](feed)
            ms.append((time.perf_counter() - t0) * 1e3)
        readings[mode].append(dict(batch_ms=ms, **_peak_memory()))
    out = {}
    for mode, rs in readings.items():
        med = [float(np.median(r['batch_ms'])) for r in rs]
        (wall, busy, flash, seen, groups), counted, tries = \
            _profiled_launches(lambda: runs[mode](feed))
        out[mode] = dict(median_batch_ms=med,
                         prompt_tokens_per_s=[rows * T / (m / 1e3)
                                              for m in med],
                         readings=rs, profiled_wall_ms=wall,
                         device_busy_ms=busy,
                         device_idle_share=(1 - busy / wall) if busy
                         else None, profiled_device_events=seen,
                         flash_by_design=flash, device_launches=groups,
                         counted_device_launches=counted,
                         profile_tries=tries)
    same = all(a.tobytes() == b.tobytes()
               for a, b in zip(outs['eager'], outs['graph']))
    entries = [e for e in pred._exe._graphs.entries.values()
               if e.capture_s is not None]
    emit(phase=phase, step='serve_modes', rows=rows, modes=out,
         rows_bitwise_equal=same, graphs=len(entries),
         capture_s=[e.capture_s for e in entries], card=smi)
    require(same, 'served rows: the graph replay and the interpreter differ')
    # the device launches are not held to the counted ones here: after
    # the float32 served phase the profiler shows no gather_rows event in
    # the bf16 batch's windows, interpreted and replayed alike, though the
    # wrapper launched it (PERF.md §7)
    seen_flash = out['graph']['flash_by_design']
    require(not seen_flash or (set(seen_flash) == {design} and
                               seen_flash[design][1] == n_layer),
            'the replayed batch ran flash kernels %s, not %d %s'
            % (seen_flash, n_layer, design))


# bf16 bound: a logit passes R = 12 L + 2 bf16 roundings (unit roundoff
# u = 2^-8; tests/test_torch_inference_bf16.py lists them); as independent
# draws uniform in +-u the logits of two bf16 runs differ with standard
# deviation sqrt(2 R / 3) u max|logit|, and a bf16 run and a float32 one
# (only one side rounds) with sqrt(R / 3) u max|logit|.  The checks allow
# one such deviation, set from readings on llama_1b (L = 16, 0.0314
# max|logit| against float32): sound bf16 runs differ from float32 by
# 0.0113-0.0136 max|logit| and the faults of `bf16_controls` by
# 0.116-0.265 (PERF.md), and every fault must fail the check
def bf16_tol(M, n_layer, runs=2):
    return np.sqrt(runs * (12 * n_layer + 2) / 3.0) * 2.0 ** -8 * M


def _round_significand(x, bits):
    """x rounded to `bits` significant bits (fp8 e4m3 keeps 4), in x's
    dtype; the exponent range is x's own."""
    import torch
    m, e = torch.frexp(x.float())
    return torch.ldexp(torch.round(m * 2.0 ** bits) / 2.0 ** bits,
                       e).to(x.dtype)


def bf16_controls(pred, feeds, refs, n_layer):
    """Faults the bf16 check must catch, made in place in a bf16
    Predictor's parameters and undone after: the last layer's attention
    dropped (its output projection zeroed) and every parameter at fp8
    (e4m3) precision.  Each is held to the float32 logits `refs` of
    `feeds` under the bf16-vs-float32 bound; returns its readings."""
    import torch
    params = pred._scope.vars
    att = 'layer_%d_att_o_w' % (n_layer - 1)
    with torch.inference_mode():
        saved = {n: v.clone() for n, v in params.items()}

    def drop_attention():
        params[att].zero_()

    def fp8_precision():
        for v in params.values():
            if v.is_floating_point():
                v.copy_(_round_significand(v, 4))
    out = {}
    for name, fault in (('attention_dropped', drop_attention),
                        ('fp8_precision', fp8_precision)):
        with torch.inference_mode():
            fault()
        errs = []
        for f, ref in zip(feeds, refs):
            a = np.asarray(pred.run(f)[0], np.float32)
            M = float(np.abs(ref).max())
            errs.append(dict(max_abs_err=float(np.abs(a - ref).max()),
                             tol=bf16_tol(M, n_layer, runs=1), max_logit=M))
        with torch.inference_mode():
            for n, v in params.items():
                v.copy_(saved[n])
        out[name] = errs
    torch.cuda.synchronize()
    caught = [e['max_abs_err'] > e['tol'] for v in out.values() for e in v]
    require(all(caught), 'a bf16 fault passes the bf16 bound: %s' % out)
    return out


def _agree_bf16(a, b, n_layer, what, runs=2):
    """bf16 logits `a` within the bf16 bound of `b` (bf16, runs=2, or
    float32, runs=1); greedy tokens equal wherever the top-two gap exceeds
    twice the bound."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    tol = bf16_tol(float(np.abs(b).max()), n_layer, runs)
    err = float(np.abs(a - b).max())
    require(err <= tol, '%s: logits differ by %g > %g' % (what, err, tol))
    clear = _clear(b, tol)
    same = np.argmax(a, -1) == np.argmax(b, -1)
    require(bool(same[clear].all()), '%s: greedy tokens differ where the '
            'top-two gap exceeds the tolerance' % what)
    return err, tol, int(clear.sum()), int(clear.size)


def phase_serving(smi):
    """llama_1b served in float32, the reference's default."""
    return _serve('serving', smi, bf16=False)


def phase_serving_bf16(smi):
    """llama_1b served with AnalysisConfig.enable_bf16: bf16 parameters,
    bf16 GEMMs and K1's bf16 wgmma kernel; logits held to the bf16 bound
    of the float32 Predictor's on the same feeds."""
    return _serve('serving_bf16', smi, bf16=True)


def _serve(phase, smi, bf16):
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels, serving
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernelgen
    f32 = ctl = None
    with _model_dir() as d:
        # what a serving client reads: the last position's logits and the
        # greedy next token (not the [B, T, V] logits of every position)
        cfg, n_params, startup_s, save_s = _build_and_save(
            fluid, llama, d, SERVED_FETCHES)
        T, V = cfg['max_len'], cfg['vocab']
        t0 = time.perf_counter()
        conf = fluid.inference.AnalysisConfig(d)
        if bf16:
            conf.enable_bf16()
        pred = fluid.inference.Predictor(conf)
        load_s = time.perf_counter() - t0
        if bf16:
            f32 = fluid.inference.Predictor(d)
            ctl = fluid.inference.Predictor(conf)
    dtypes = sorted({str(v.dtype) for v in pred._scope.vars.values()})
    emit(phase=phase, step='model', config='llama_1b',
         n_layer=cfg['n_layer'], params=n_params,
         param_bytes=(2 if bf16 else 4) * n_params, param_dtypes=dtypes,
         startup_s=startup_s, save_s=save_s, load_s=load_s,
         fetches=pred.get_output_names())
    require(dtypes == (['torch.bfloat16'] if bf16 else ['torch.float32']),
            'parameter dtypes %s' % dtypes)
    rng = np.random.RandomState(SEED)
    # dispatched as buckets 1 (the first request alone), 4 (2 + 2), 4 (1 +
    # 1 + 2) and 2, so every bucket's generated kernels run
    rows = [1, 2, 2, 1, 1, 2, 2]
    feeds = [{'tokens': _tokens(rng, r, T, V)} for r in rows]
    # warm the device (cuBLAS handles, allocator) and build the generated
    # kernels of every bucket's shape (their shapes are compiled in; the
    # kernels phase, when it ran, built them already) outside the counted
    # run
    nvcc0 = kernelgen.build_stats['nvcc_s']
    for rows_ in BUCKETS:
        pred.run({'tokens': _tokens(np.random.RandomState(SEED + rows_),
                                    rows_, T, V)})
    torch.cuda.synchronize()
    emit(phase=phase, step='warm', buckets=list(BUCKETS),
         kernelgen_nvcc_s=kernelgen.build_stats['nvcc_s'] - nvcc0)
    eng = serving.ServingEngine.from_predictor(
        pred, bucketer=fluid.FeedBucketer(list(BUCKETS)),
        config=serving.ServingConfig(max_queue=16, max_batch_rows=4))
    kernels.reset_launches()
    kernelgen.launches.clear()
    t0 = time.perf_counter()
    with eng:
        futs = [eng.submit(feeds[0])]
        # the rest queue up while the first request runs, so the
        # dispatcher coalesces them into 4-row batches
        deadline = time.time() + 30
        while eng.health()['queue_depth'] and time.time() < deadline:
            time.sleep(0.001)
        futs += [eng.submit(f) for f in feeds[1:]]
        results = [f.result(600) for f in futs]
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    seg = dict(kernelgen.launches)
    c = eng.counters
    batches = c.get('serving.batches')
    dispatched = c.histogram('serving.dispatched_rows')
    batch_ms = c.histogram('serving.batch_ms')
    statuses = [r.status for r in results]
    require(all(r.ok for r in results), 'requests not ok: %s (first '
            'error: %r)' % (statuses, next((r.error for r in results
                                             if not r.ok), None)))
    require(c.get('serving.deadlocks') == 0, 'serving.deadlocks != 0')
    require(dispatched['max'] == 4, 'no dispatched batch had 4 rows: %s'
            % dispatched)
    require(launches['flash_attention_fwd'] == cfg['n_layer'] * batches,
            'flash launches %d != %d layers x %d batches'
            % (launches['flash_attention_fwd'], cfg['n_layer'], batches))
    require(launches['embedding_gather'] == batches,
            'gather launches %d != %d batches'
            % (launches['embedding_gather'], batches))
    checks, vs_f32, f32_logits = [], [], []
    for f, r in zip(feeds, results):
        last, tok = r.outputs
        n = f['tokens'].shape[0]
        require(last.shape == (n, V) and tok.shape == (n,),
                'bad output shapes')
        require(str(last.dtype) == ('bfloat16' if bf16 else 'float32'),
                'fetched logits of dtype %s' % last.dtype)
        last = np.asarray(last, np.float32)
        require(bool(np.isfinite(last).all()), 'non-finite logits')
        require(bool(((tok >= 0) & (tok < V)).all()), 'token out of range')
        require(bool((tok == np.argmax(last, -1)).all()),
                'greedy token is not the argmax of the last logits')
        a_last, a_tok = pred.run(f)
        a_last = np.asarray(a_last, np.float32)
        if bf16:
            # batched against alone: two bf16 runs (other GEMM shapes)
            checks.append(_agree_bf16(last, a_last, cfg['n_layer'],
                                      'served vs alone'))
            f32_logits.append(f32.run(f)[0])
            vs_f32.append(_agree_bf16(last, f32_logits[-1], cfg['n_layer'],
                                      'bf16 vs float32', runs=1))
        else:
            checks.append(_agree(last, a_last, 'served vs alone'))
        require(bool((a_tok == tok)[_clear(a_last, checks[-1][1])].all()),
                'served vs alone: next tokens differ')
    real_rows = sum(rows)
    res = dict(phase=phase, step='served', requests=len(results),
               statuses=statuses, batches=batches, rows=real_rows,
               dispatched_rows=dispatched, launches=launches,
               segment_launches=seg, wall_s=wall, batch_ms=batch_ms,
               tokens_per_s=real_rows * T / wall,
               alone_vs_batched=[dict(max_abs_err=e, tol=t, clear_rows=cl,
                                      rows=n) for e, t, cl, n in checks],
               card=smi)
    if bf16:
        res['bf16_vs_float32'] = [dict(max_abs_err=e, tol=t, clear_rows=cl,
                                       rows=n) for e, t, cl, n in vs_f32]
        res['controls'] = bf16_controls(ctl, feeds[:3], f32_logits[:3],
                                        cfg['n_layer'])
    emit(**res)
    four = {'tokens': np.concatenate([f['tokens'] for f in feeds[1:3]])}
    design = 'fwd_wgmma' if bf16 else 'fwd_tf32x3'
    profile_batch(pred, four, cfg['n_layer'], phase, design)
    serve_modes(phase, smi, pred, four, cfg['n_layer'], design)
    del pred, eng, f32, ctl
    torch.cuda.empty_cache()
    launches.update(seg)
    return launches


# ------------------------------------------------------------- phase 4

def phase_gpu_vs_cpu():
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import llama
    with _model_dir() as d:
        cfg, n_params, _, _ = _build_and_save(fluid, llama, d,
                                              ALL_FETCHES, n_layer=2,
                                              max_len=512)
        gpu = fluid.inference.Predictor(d)
        conf = fluid.inference.AnalysisConfig(d)
        conf.disable_gpu()
        cpu = fluid.inference.Predictor(conf)
    rng = np.random.RandomState(SEED + 1)
    feed = {'tokens': _tokens(rng, 2, cfg['max_len'], cfg['vocab'])}
    t0 = time.perf_counter()
    g_logits, g_last, g_tok = gpu.run(feed)
    t1 = time.perf_counter()
    c_logits, c_last, c_tok = cpu.run(feed)
    t2 = time.perf_counter()
    err, tol, clear, n = _agree(g_logits, c_logits, 'gpu vs cpu')
    require(bool((g_tok == c_tok)[_clear(c_last, tol)].all()),
            'gpu vs cpu: next tokens differ')
    emit(phase='gpu_vs_cpu', config='llama_1b', n_layer=cfg['n_layer'],
         max_len=cfg['max_len'], params=n_params, max_abs_err=err, tol=tol,
         clear_positions=clear, positions=n, gpu_tokens=g_tok.tolist(),
         cpu_tokens=c_tok.tolist(), gpu_s=t1 - t0, cpu_s=t2 - t1)
    del gpu, cpu
    torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 4b

# the streaming decode server: 8 slots, prefill chunks of 256 tokens (a
# 1024-token prompt prefills in 4 rounds, interleaved with decode windows;
# the reference's default of 8 would take 128), decode windows of 4
GEN_SLOTS, GEN_CHUNK, GEN_WINDOW, GEN_MAX_NEW = 8, 256, 4, 64
GEN_PROMPTS = (128, 1024, 256, 768, 384, 512, 640, 896)


def _llama_scope(fluid, llama, **overrides):
    """llama_1b's weights (full width; `overrides` may cut depth) from its
    program's startup on the card, random from SEED."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = llama.generation_program('llama_1b', mode='prefill',
                                       **overrides)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor().run(startup)
    return scope, out['config']


def _stream_vs_dense(gen, w, cfg, prompt, stream, what):
    """Token for token against `dense_reference` (on the weights' device)
    while its top-two gap exceeds 4x the float32 tolerance (1e-4 of the
    largest |logit|: the paged runtime and the dense reference sum in
    other orders); returns the tokens compared."""
    n = 0
    for t in range(len(stream)):
        _, _, lref = gen.dense_reference(w, cfg, list(prompt) +
                                         list(stream[:t]))
        tol = 1e-4 * float(np.abs(lref).max())
        top2 = np.sort(lref)[-2:]
        if top2[1] - top2[0] <= 4 * tol:
            break
        require(int(stream[t]) == int(np.argmax(lref)),
                '%s: token %d is %d, the dense reference says %d'
                % (what, t, stream[t], int(np.argmax(lref))))
        n += 1
    return n


def _op_group(key):
    """A decode window's aten op -> where its device time goes."""
    if key in ('aten::mm', 'aten::addmm'):
        return 'gemm_weights'
    if key == 'aten::bmm':
        return 'attention_products'
    if key in ('aten::_softmax', 'aten::softmax'):
        return 'attention_softmax'
    if key in ('aten::index', 'aten::index_select'):
        return 'logical_row_gathers'
    if key in ('aten::copy_', 'aten::clone', 'aten::contiguous',
               'aten::_reshape_alias', 'aten::reshape'):
        return 'copies'
    if key in ('aten::index_put_', 'aten::_index_put_impl_'):
        return 'kv_writes'
    if key in ('aten::sort', 'aten::argmax', 'aten::gather'):
        return 'sampling'
    return 'elementwise_and_other'


def profile_decode_window(rt, active, phase='generation'):
    """torch.profiler over one decode window: device time by kernel and by
    the aten op that launched it, device busy and idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    S = rt.slots
    zi, zf = np.zeros(S, np.int64), np.zeros(S, np.float32)
    rt.decode_window(GEN_WINDOW, active, zi, zf, zi)      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.decode_window(GEN_WINDOW, active, zi, zf, zi)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, by_op, top, launched = 0.0, {}, [], 0
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if not ms:
            continue
        if e.device_type == DeviceType.CUDA:
            busy += ms
            launched += e.count
            top.append((ms, e.key[:80], e.count))
        else:
            g = _op_group(e.key)
            by_op[g] = by_op.get(g, 0.0) + ms
    top.sort(reverse=True)
    res = dict(phase=phase, step='decode_window_profile', steps=GEN_WINDOW,
               active_slots=int(np.sum(active)),
               key_positions=[int(x) for x in rt.host_len],
               profiled_wall_ms=wall_ms, device_busy_ms=busy,
               device_idle_share=1 - busy / wall_ms if busy else None,
               device_ms_by_op_group=by_op,
               device_events_per_step=launched / GEN_WINDOW,
               top_kernels=[dict(ms=t, name=n, count=c)
                            for t, n, c in top[:12]])
    emit(**res)
    require(busy > 0, 'the profiler saw no device time')
    return res


def cached_attention_case(name, S, Tq, Tk, offset, H=16, Hkv=8, D=128):
    """The plain cached_attention (float32) against one SDPA call with the
    same positional mask, timed only: the decision on a decode-attention
    kernel waits on it."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import attention as att
    g = torch.Generator(device='cuda').manual_seed(SEED + 5)
    q = torch.randn(S, H, Tq, D, generator=g, device='cuda')
    k = torch.randn(S, Hkv, Tk, D, generator=g, device='cuda')
    v = torch.randn(S, Hkv, Tk, D, generator=g, device='cuda')
    # each slot at its own length: slot s sees keys [0, offset - 3 s + t]
    qpos = (offset + torch.arange(Tq, device='cuda')[None, :]
            - 3 * torch.arange(S, device='cuda')[:, None]).clamp(0, Tk - 1)
    mask = (torch.arange(Tk, device='cuda')[None, None, :]
            <= qpos[:, :, None])[:, None]
    out = att.cached_attention(q, k, v, qpos)
    ref = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         enable_gqa=True)
    torch.cuda.synchronize()
    pairs = int(mask.sum()) * H
    nbytes = 4 * (2 * S * H * Tq * D + 2 * S * Hkv * Tk * D) + 8 * S * Tq
    bound_ms, bound_by = _bound(4.0 * D * pairs, nbytes, 'float32')
    res = dict(phase='generation', step='cached_attention', case=name, S=S,
               H=H, Hkv=Hkv, Tq=Tq, Tk=Tk, D=D, dtype='float32',
               max_abs_err_vs_sdpa=float((out - ref).abs().max()),
               ms=time_ms(lambda: att.cached_attention(q, k, v, qpos), 20),
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, enable_gqa=True), 20),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=4.0 * D * pairs)
    emit(**res)
    require(res['max_abs_err_vs_sdpa'] <= 1e-4, 'cached_attention and SDPA '
            'disagree in case %s: %s' % (name, res))
    return res


def phase_generation(smi):
    """Streaming generation of llama_1b (full width and depth, float32,
    TF32 off) through GenerationEngine over make_streaming_runtime."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels, serving
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import generation as gen
    t0 = time.perf_counter()
    scope, cfg = _llama_scope(fluid, llama)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt = llama.make_streaming_runtime(scope, 'llama_1b', slots=GEN_SLOTS,
                                      prefill_chunk=GEN_CHUNK)
    del scope
    setup_s = time.perf_counter() - t0
    V = cfg['vocab']
    rng = np.random.RandomState(SEED + 7)
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in GEN_PROMPTS]
    # greedy and seeded top-k, alternating
    sampling = [(0.0, 0, 0) if i % 2 == 0 else (0.8, 40, 100 + i)
                for i in range(len(prompts))]
    # warm the device (cuBLAS handles, the allocator) outside the counts
    rt.generate(prompts[0][:64], 8)
    rt.reset()
    torch.cuda.synchronize()
    eng = gen.GenerationEngine(
        rt, config=serving.ServingConfig(max_queue=16),
        gen_config=gen.GenerationConfig(decode_window=GEN_WINDOW))
    kernels.reset_launches()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        with eng:
            streams = [eng.generate(p, max_new=GEN_MAX_NEW, temperature=t,
                                    top_k=k, seed=s)
                       for p, (t, k, s) in zip(prompts, sampling)]
            results = [st.result(900) for st in streams]
        wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    c = eng.counters
    statuses = [r.status for r in results]
    require(all(r.ok and r.reason == 'max_tokens' for r in results),
            'streams not ok: %s' % statuses)
    outs = [np.asarray(r.outputs[0]) for r in results]
    require(all(o.shape == (GEN_MAX_NEW,) and ((o >= 0) & (o < V)).all()
                for o in outs), 'bad generated ids')
    require(all(st.tokens_so_far() == list(o)
                for st, o in zip(streams, outs)), 'streamed tokens differ '
            'from the terminal reply')
    done = sum(c.get('serving.' + k) for k in (
        'completed', 'shed', 'deadline_exceeded', 'errors', 'rejected'))
    require(done == c.get('serving.submitted') == len(prompts) and
            c.get('serving.deadlocks') == 0, 'terminal replies %d of %d'
            % (done, c.get('serving.submitted')))
    chunks = c.get('generation.prefill_chunks')
    windows = c.get('generation.decode_windows')
    require(chunks == sum(-(-n // GEN_CHUNK) for n in GEN_PROMPTS),
            'prefill chunks %d' % chunks)
    # K4 embeds every prefill chunk and every decode step; nothing else
    per_step = (launches['embedding_gather'] - chunks) / (windows *
                                                          GEN_WINDOW)
    require(per_step == 1, 'gather launches %d != %d chunks + %d steps'
            % (launches['embedding_gather'], chunks, windows * GEN_WINDOW))
    require(not plain.counts, 'plain versions ran on the card: %s'
            % plain.counts)
    win = c.histogram('generation.decode_window_ms')
    pre = c.histogram('generation.prefill_chunk_ms')
    decode_tokens = c.get('generation.tokens') - len(prompts)
    res = dict(
        phase='generation', step='served', config='llama_1b',
        n_layer=cfg['n_layer'], dtype='float32', tf32=False,
        slots=GEN_SLOTS, prefill_chunk=GEN_CHUNK, decode_window=GEN_WINDOW,
        page_len=rt.cache.page_len,
        prompts=list(GEN_PROMPTS), max_new=GEN_MAX_NEW, sampling=sampling,
        statuses=statuses, wall_s=wall, setup_s=setup_s,
        ttft_ms_p50=c.quantile('serving.ttft_ms', 0.5),
        ttft_ms_p99=c.quantile('serving.ttft_ms', 0.99),
        itl_ms_p50=c.quantile('serving.itl_ms', 0.5),
        itl_ms_p99=c.quantile('serving.itl_ms', 0.99),
        decode_window_ms=win, decode_window_ms_p50=c.quantile(
            'generation.decode_window_ms', 0.5),
        prefill_chunk_ms=pre, prefill_chunks=chunks, decode_windows=windows,
        mixed_rounds=c.get('generation.mixed_dispatches'),
        decode_tokens_per_s=decode_tokens / (win['sum'] / 1e3),
        output_tokens_per_s=c.get('generation.tokens') / wall,
        prompt_tokens_per_s=sum(GEN_PROMPTS) / (pre['sum'] / 1e3),
        kv_pool_bytes=rt.cache.bytes(), kv_pages=rt.cache.pages,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, card=smi)
    emit(**res)
    # two greedy streams against the page-free dense reference, on the card
    compared = [_stream_vs_dense(gen, rt.w, cfg, prompts[i], outs[i],
                                 'greedy stream %d' % i) for i in (0, 2)]
    # a stream of the batch against the same request alone (the longest
    # prompt, seeded, and the shortest, greedy): bitwise
    alone = {}
    for i in (1, 0):
        rt.reset()
        alone[i] = rt.generate(prompts[i], GEN_MAX_NEW,
                               gen.SamplingParams(*sampling[i]),
                               steps_per_window=GEN_WINDOW)
    # a seeded stream at windows of 1 and 4: bitwise
    sp = gen.SamplingParams(0.8, 40, 7)
    one = rt.generate(prompts[1][:250], 24, sp, steps_per_window=1)
    four = rt.generate(prompts[1][:250], 24, sp, steps_per_window=4)
    batch_equal = {i: alone[i] == [int(t) for t in outs[i]] for i in alone}
    emit(phase='generation', step='checks', greedy_vs_dense_compared=compared,
         alone_equals_batched=batch_equal, seeded_k1=one, seeded_k4=four,
         seeded_equal=one == four)
    require(min(compared) >= 8, 'greedy streams held to the dense reference '
            'for only %s tokens' % compared)
    require(all(batch_equal.values()), 'a stream run alone differs from the '
            'same request in the batch: %s' % batch_equal)
    require(one == four, 'a seeded stream differs between windows of 1 and 4')
    # one decode window with all 8 slots decoding, profiled
    rt.reset()
    zero = gen.SamplingParams()
    for p in prompts:
        slot = rt.alloc_slot()
        # pages for the four windows profiled below
        require(rt.try_begin(slot, p, 4 * GEN_WINDOW) == 0, 'no pages')
        for off in range(0, p.size, GEN_CHUNK):
            rt.prefill(slot, p[off:off + GEN_CHUNK], off, zero)
    profile_decode_window(rt, np.ones(GEN_SLOTS, bool))
    for case in (('decode_tk128', 8, 1, 128, 127),
                 ('decode_tk512', 8, 1, 512, 511),
                 ('decode_tk1152', 8, 1, 1152, 1151),
                 ('decode_tk2048', 8, 1, 2048, 2047),
                 ('prefill_chunk256_tk1024', 1, 256, 1024, 768)):
        cached_attention_case(*case)
    del rt, eng
    torch.cuda.empty_cache()
    return {'embedding_gather': per_step}


def phase_generation_gpu_vs_cpu():
    """llama_1b width cut to 2 layers (random_weights from SEED): a 64-token
    prompt and 16 greedy tokens through the paged runtime on the card and
    on the CPU."""
    import torch
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import generation as gen
    cfg = dict(llama.CONFIGS['llama_1b'], n_layer=2)
    w = gen.random_weights(cfg, seed=SEED)
    prompt = np.random.RandomState(SEED + 9).randint(0, cfg['vocab'], 64)
    res = {}
    for dev in ('cuda', 'cpu'):
        t0 = time.perf_counter()
        rt = gen.DecodeRuntime(w, cfg, slots=1, prefill_chunk=64,
                               device=dev)
        slot = rt.alloc_slot()
        require(rt.try_begin(slot, prompt, 16) == 0, 'no pages')
        first, logits = rt.prefill(slot, prompt, 0, gen.SamplingParams())
        toks = rt.decode_window(15, np.ones(1, bool), np.zeros(1, np.int64),
                                np.zeros(1, np.float32),
                                np.zeros(1, np.int64))[0]
        res[dev] = ([int(first)] + [int(t) for t in toks], logits,
                    time.perf_counter() - t0)
        del rt
    torch.cuda.empty_cache()
    (g_stream, g_logits, g_s), (c_stream, c_logits, c_s) = \
        res['cuda'], res['cpu']
    tol = 1e-4 * float(np.abs(c_logits).max())
    err = float(np.abs(g_logits - c_logits).max())
    # the CPU stream held to the dense reference while the margin clears;
    # the card's stream must equal it there
    compared = _stream_vs_dense(gen, w, cfg, prompt, c_stream, 'cpu stream')
    same = g_stream[:compared] == c_stream[:compared]
    emit(phase='generation_gpu_vs_cpu', config='llama_1b width, 2 layers',
         dtype='float32', tf32=False, prompt_tokens=64, new_tokens=16,
         prefill_max_abs_err=err, tol=tol, gpu_stream=g_stream,
         cpu_stream=c_stream, compared=compared, equal_where_clear=same,
         equal=g_stream == c_stream, gpu_s=g_s, cpu_s=c_s)
    require(err <= tol, 'gpu vs cpu: prefill logits differ by %g > %g'
            % (err, tol))
    require(compared >= 8 and same, 'gpu vs cpu: streams differ where the '
            'margin clears (%d compared)' % compared)


# ------------------------------------------------------------- phase 5

# launches per training step on the bench configuration: 18 attention
# calls (6 encoder self, 6 decoder causal self, 6 cross) forward and
# backward, 2 embedding gathers, 32 LayerNorms (2 per encoder layer, 3 per
# decoder layer, 2 final), one multi-tensor Adam call for 158 parameters
TRAIN_LAUNCHES = {'flash_attention_fwd': 18, 'flash_attention_bwd_dq': 18,
                  'flash_attention_bwd_dkv': 18, 'embedding_gather': 2,
                  'layer_norm': 32, 'adam_multi': 1}


def _train_program(fluid, tr, amp, **overrides):
    cfg = dict(BENCH_CFG, **overrides)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = tr.build(**cfg)
    main.set_amp(amp)
    return main, startup, out


def _group(name):
    low = name.lower()
    if 'flash_bwd_dq' in name:    # flash_bwd_dq_[wgmma_]kernel
        return 'flash_attention_bwd_dq'
    if 'flash_bwd_dkv' in name:   # flash_bwd_dkv_[wgmma_]kernel
        return 'flash_attention_bwd_dkv'
    if 'flash_fwd' in name:       # flash_fwd_[wgmma_]kernel
        return 'flash_attention_fwd'
    if 'layer_norm_kernel' in name:
        return 'layer_norm'
    if 'softmax_kernel' in name:
        return 'softmax'
    if 'kg_' in name:
        return 'kernelgen_segment'
    if 'adam_kernel' in name or 'adam_pows_kernel' in name:
        return 'adam_multi'
    if 'gather_rows' in name:
        return 'embedding_gather'
    if 'memcpy' in low or 'memset' in low:
        return 'copies'
    if any(t in low for t in ('gemm', 'cutlass', 'sm90_', 'xmma', 'cublas',
                              'nvjet')):
        return 'gemm'
    return 'elementwise_and_other'


def _flash_design(name):
    """The flash kernel a profiler key names, by design: 'fwd_wgmma',
    'bwd_dq_wgmma' and 'bwd_dkv_wgmma' (bf16, tensor cores), 'fwd_tf32x3',
    'bwd_dq_tf32x3' and 'bwd_dkv_tf32x3' (float32 as 3xTF32, tensor cores,
    D = 64 for the backward), 'bwd_dq_f32' and 'bwd_dkv_f32' (float32 at
    D = 128, CUDA cores); None for any other kernel."""
    for stem, short in (('flash_fwd', 'fwd'), ('flash_bwd_dkv', 'bwd_dkv'),
                        ('flash_bwd_dq', 'bwd_dq')):
        if stem in name:
            return short + ('_wgmma' if 'wgmma' in name else
                            '_tf32x3' if 'tf32x3' in name else '_f32')
    return None


def _flash_by_design(averages):
    """{design: [device ms, launches]} of the flash kernels in a profile's
    key_averages()."""
    from torch.autograd import DeviceType
    flash = {}
    for e in averages:
        if e.device_type != DeviceType.CUDA or not e.self_device_time_total:
            continue
        design = _flash_design(e.key)
        if design:
            acc = flash.setdefault(design, [0.0, 0])
            acc[0] += e.self_device_time_total / 1e3
            acc[1] += e.count
    return flash


def profile_step(exe, main, feed, fetch, phase='training'):
    """torch.profiler over one interpreted training step
    (use_program_cache=False): device time by kernel group (device-side
    events only) and the device's idle share of the step; returns the
    flash kernels' {design: [device ms, launches]}.  graph_modes profiles
    the graph replays."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch, use_program_cache=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.self_device_time_total:
            continue
        ms = e.self_device_time_total / 1e3
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + ms
        top.append((ms, e.key[:80], e.count))
    flash = _flash_by_design(prof.key_averages())
    top.sort(reverse=True)
    busy = sum(groups.values())
    emit(phase=phase, step='profile', profiled_wall_ms=wall_ms,
         device_ms_by_group=groups, device_busy_ms=busy,
         device_idle_share=(1 - busy / wall_ms) if busy else None,
         flash_by_design=flash,
         top_kernels=[dict(ms=t, name=n, count=c) for t, n, c in top[:15]])
    require(busy > 0, 'the profiler saw no device time')
    return flash


# the kernel groups (_group) of the hand-written and generated kernels: a
# profile counts their device launches beside the wrappers' counts
KERNEL_GROUPS = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv', 'layer_norm', 'softmax',
                 'kernelgen_segment', 'adam_multi', 'embedding_gather')


def _profiled(fn):
    """torch.profiler over fn(): (host wall ms, device busy ms, the flash
    kernels by design, device kernels seen, {KERNEL_GROUPS group: device
    launches}); a CUDA graph's kernels show as device events of their
    own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, seen, groups = 0.0, 0, {}
    averages = prof.key_averages()
    for e in averages:
        if e.device_type != DeviceType.CUDA:
            continue
        g = _group(e.key)
        if g in KERNEL_GROUPS:
            groups[g] = groups.get(g, 0) + e.count
        if e.self_device_time_total:
            busy += e.self_device_time_total / 1e3
            seen += e.count
    return wall_ms, busy, _flash_by_design(averages), seen, groups


# device kernels one counted launch runs: adam_multi's update and its
# beta-power kernel; every other wrapper launches one
DEVICE_KERNELS = {'adam_multi': 2}
PROFILE_TRIES = 3


def _profiled_launches(fn):
    """_profiled(fn) with the wrappers' counts over the same window, as
    device kernels (DEVICE_KERNELS) of each KERNEL_GROUPS group; a CUDA
    graph's replay adds what its capture counted.  The profiler drops
    kernel events now and then (card runs saw 90 of a window's 92
    generated-segment launches, and 141 of 144 flash forwards in a
    run_steps window), so a window whose device launches differ from the
    counted ones is profiled again, at most PROFILE_TRIES times in all.
    -> (_profiled's tuple, counted, tries)."""
    from paddle_tpu_torch import kernels
    for tries in range(1, PROFILE_TRIES + 1):
        before = dict(kernels.launches)
        res = _profiled(fn)
        counted = {k: (v - before.get(k, 0)) * DEVICE_KERNELS.get(k, 1)
                   for k, v in kernels.launches.items()
                   if k in KERNEL_GROUPS and v != before.get(k, 0)}
        if res[4] == counted:
            break
    return res, counted, tries


def _seen_on_device(what, device, counted):
    """Every kernel group the wrappers counted in a window shows on the
    device, and none more than counted (the profiler may drop an event,
    never add one)."""
    for g in set(device) | set(counted):
        require(0 < device.get(g, 0) <= counted.get(g, 0),
                '%s: %s device launches of %s, %s counted'
                % (what, device.get(g, 0), g, counted.get(g, 0)))


def _peak_memory():
    """Peak device memory since the last reset, in GB: `peak_mem_gb`
    counts live tensors only, which leaves out the blocks a CUDA graph's
    private pool keeps for its intermediates between replays;
    `peak_reserved_gb` counts every block the allocator holds (emptied of
    unused cached blocks before the reading), the graph pools included."""
    import torch
    return dict(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)


K_STEPS = 8      # run_steps' K, as bench.py headlines it
MODE_STEPS = 10  # steps a reading of run, the graph and check_nan


def graph_modes(phase, smi, exe, main, feed, fetch, tokens, flash_want):
    """The step through four paths, in turns (ABCDDCBA): `eager` is
    Executor.run with use_program_cache=False (the interpreter), `graph`
    Executor.run (a replay of the signature's CUDA graph), `run_steps`
    run_steps(K=8), two launches with return_numpy=False and one sync,
    then two with return_numpy=True, and `check_nan` an
    Executor(check_nan=True, nan_poll=8) on the same scope.  Per mode:
    median step ms, tokens/s, launches per step, peak memory; one
    profiled window (two steps, one run_steps call) for device busy and
    idle share; the capture seconds of each signature.  Launches per step
    must agree across the modes as the wrappers count them (a replay adds
    what its capture counted); on the device, each mode's profiled window
    must show exactly the flash kernels of `flash_want` ({design:
    launches a step}) and every kernel group the wrappers counted in it
    (`_profiled_launches`, `_seen_on_device`)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import kernelgen
    stacked = {k: np.stack([v] * K_STEPS) for k, v in feed.items()}
    nan_exe = fluid.Executor(check_nan=True, nan_poll=8)
    for _ in range(2):          # its own signature: warm-up, capture
        nan_exe.run(main, feed=feed, fetch_list=fetch)
    losses = []

    def steps(ex, **kw):
        ms = []
        for _ in range(MODE_STEPS):
            t0 = time.perf_counter()
            losses.append(float(ex.run(main, feed=feed, fetch_list=fetch,
                                       **kw)[0][0]))
            ms.append((time.perf_counter() - t0) * 1e3)
        return dict(step_ms=ms, steps=MODE_STEPS, wall_ms=sum(ms))

    def run_steps():
        t0 = time.perf_counter()
        outs = [exe.run_steps(main, feed_list=stacked, steps=K_STEPS,
                              fetch_list=fetch, return_numpy=False)[0]
                for _ in range(2)]
        torch.cuda.synchronize()
        dev_ms = (time.perf_counter() - t0) * 1e3
        losses.extend(float(v) for o in outs for v in o.reshape(-1).cpu())
        t0 = time.perf_counter()
        for _ in range(2):
            out = exe.run_steps(main, feed_list=stacked, steps=K_STEPS,
                                fetch_list=fetch)[0]
            losses.extend(float(v) for v in out.reshape(-1))
        np_ms = (time.perf_counter() - t0) * 1e3
        per = dev_ms / (2 * K_STEPS)
        return dict(step_ms=[per], steps=4 * K_STEPS, wall_ms=dev_ms + np_ms,
                    step_ms_return_numpy=np_ms / (2 * K_STEPS))

    runs = {'eager': lambda: steps(exe, use_program_cache=False),
            'graph': lambda: steps(exe), 'run_steps': run_steps,
            'check_nan': lambda: steps(nan_exe)}
    readings = {m: [] for m in runs}
    for mode in ('eager', 'graph', 'run_steps', 'check_nan', 'check_nan',
                 'run_steps', 'graph', 'eager'):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = (dict(kernels.launches), dict(kernelgen.launches))
        r = runs[mode]()
        torch.cuda.synchronize()
        n = r.pop('steps')
        r['launches_per_step'] = {
            k: (v - before[0].get(k, 0)) / n
            for k, v in kernels.launches.items() if v - before[0].get(k, 0)}
        r['segment_launches_per_step'] = sum(
            v - before[1].get(k, 0) for k, v in kernelgen.launches.items()
            ) / n
        r.update(_peak_memory())
        readings[mode].append(r)
    windows = {
        'eager': lambda: [exe.run(main, feed=feed, fetch_list=fetch,
                                  use_program_cache=False)
                          for _ in range(2)],
        'graph': lambda: [exe.run(main, feed=feed, fetch_list=fetch)
                          for _ in range(2)],
        'run_steps': lambda: exe.run_steps(main, feed_list=stacked,
                                           steps=K_STEPS, fetch_list=fetch,
                                           return_numpy=False),
        'check_nan': lambda: [nan_exe.run(main, feed=feed, fetch_list=fetch)
                              for _ in range(2)]}
    out = {}
    for mode, rs in readings.items():
        med = [float(np.median(r['step_ms'])) for r in rs]
        (wall, busy, flash, seen, groups), counted, tries = \
            _profiled_launches(windows[mode])
        n = K_STEPS if mode == 'run_steps' else 2
        out[mode] = dict(
            median_step_ms=med, tokens_per_s=[tokens / (m / 1e3)
                                              for m in med],
            readings=rs, profiled_wall_ms=wall, device_busy_ms=busy,
            device_idle_share=(1 - busy / wall) if busy else None,
            profiled_steps=n, profiled_device_events=seen,
            flash_by_design=flash, profile_tries=tries,
            device_launches_per_step={g: c / n for g, c in groups.items()},
            counted_device_launches_per_step={g: c / n
                                              for g, c in counted.items()})
    captures = {'run': [e.capture_s for e in exe._graphs.entries.values()
                        if e.capture_s is not None],
                'check_nan': [e.capture_s for e in
                              nan_exe._graphs.entries.values()
                              if e.capture_s is not None]}
    emit(phase=phase, step='graph_modes', k=K_STEPS, modes=out,
         capture_s=captures, card=smi)
    require(all(np.isfinite(losses)), 'non-finite loss in graph_modes')
    ref = readings['eager'][0]['launches_per_step']
    for mode, rs in readings.items():
        for r in rs:
            require(r['launches_per_step'] == ref,
                    '%s: launches per step %s, the interpreter %s'
                    % (mode, r['launches_per_step'], ref))
    for mode, o in out.items():
        n = o['profiled_steps']
        got = {k: c for k, (_, c) in o['flash_by_design'].items()}
        want = {k: v * n for k, v in flash_want.items()}
        require(got == want, '%s: flash kernels in the profiled window of '
                '%d steps: %s, expected %s' % (mode, n, got, want))
        _seen_on_device(mode, o['device_launches_per_step'],
                        o['counted_device_launches_per_step'])
    nan_exe.poll_nan()
    return out


def bitwise_paths(phase, exe, main, scope, feed, fetch, n=3):
    """From one scope state and one set of run counters, n steps through
    the interpreter, through the graph and through run_steps(n): the
    losses and every scope tensor must agree bit for bit."""
    snap = {k: t.clone() for k, t in scope.vars.items()}
    state = exe.rng_state()
    res = {}
    for mode in ('eager', 'graph', 'run_steps'):
        for k, t in snap.items():
            scope.vars[k].copy_(t)
        exe.set_rng_state(state)
        if mode == 'run_steps':
            losses = exe.run_steps(main, feed_list=[feed] * n,
                                   fetch_list=fetch)[0]
        else:
            losses = np.stack([exe.run(
                main, feed=feed, fetch_list=fetch,
                use_program_cache=mode == 'graph')[0] for _ in range(n)])
        res[mode] = (losses.reshape(n), {k: t.clone()
                                         for k, t in scope.vars.items()})
    import torch
    eager = res['eager']
    differ = {m: sorted(k for k, t in eager[1].items()
                        if not torch.equal(res[m][1][k], t))
              for m in ('graph', 'run_steps')}
    same_losses = {m: res[m][0].tobytes() == eager[0].tobytes()
                   for m in differ}
    emit(phase=phase, step='bitwise', steps=n, tensors=len(snap),
         losses={m: r[0].tolist() for m, r in res.items()},
         losses_equal=same_losses, tensors_differing=differ)
    require(all(same_losses.values()) and not any(differ.values()),
            'graph / run_steps against the interpreter: losses equal %s, '
            'tensors differing %s' % (same_losses, differ))
    del snap, res


# the flash kernels of one training step, by design (profile_step): bf16
# under AMP on the bf16 tensor-core kernels, float32 on the 3xTF32 ones;
# neither runs a CUDA-core flash kernel
TRAIN_FLASH = {
    True: {'fwd_wgmma': 18, 'bwd_dq_wgmma': 18, 'bwd_dkv_wgmma': 18},
    False: {'fwd_tf32x3': 18, 'bwd_dq_tf32x3': 18, 'bwd_dkv_tf32x3': 18}}


def phase_training(smi):
    """transformer-base (bench.py's step) trained through the port's
    Executor on the card: AMP on, random init from a seed."""
    return _train_flash('training', smi, amp=True)


def phase_training_f32(smi):
    """The same step in float32, the reference's default precision (no
    set_amp): its flash forward, dQ and dK/dV run as 3xTF32 on the tensor
    cores; the other float32 matrix products stay full float32 (TF32 off,
    set in main)."""
    return _train_flash('training_f32', smi, amp=False)


def _train_flash(phase, smi, amp):
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import transformer as tr
    from paddle_tpu_torch.ops import kernelgen
    main, startup, out = _train_program(fluid, tr, amp=amp)
    params = main.all_parameters()
    n_params = sum(int(np.prod(p.shape)) for p in params)
    mm_params = sum(int(np.prod(p.shape)) for p in params
                    if len(p.shape) == 2 and not p.name.endswith('_emb'))
    B, T = 32, BENCH_CFG['max_len']
    feed = tr.synthetic_batch(np.random.RandomState(0), B, T,
                              BENCH_CFG['trg_vocab'])
    tokens = float(np.sum(1.0 - feed['trg_pad']))
    # model math: 6 FLOPs per matrix-product weight per token (forward and
    # backward, both token streams), plus attention: 4*D per (query, key)
    # pair forward and twice that backward, 18 attention calls
    dh = BENCH_CFG['d_model'] // BENCH_CFG['n_head']
    attn = 3 * 18 * 4 * dh * B * BENCH_CFG['n_head'] * T * T
    model_flops = 6.0 * mm_params * B * T + attn
    scope, exe = fluid.Scope(), fluid.Executor()
    fetch = [out['loss']]
    with fluid.scope_guard(scope):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            warm.append(float(exe.run(main, feed=feed,
                                      fetch_list=fetch)[0][0]))
            warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        kernels.reset_launches()
        kernelgen.launches.clear()
        losses, step_ms = [], []
        t_all = time.perf_counter()
        for _ in range(10):
            t0 = time.perf_counter()
            loss = exe.run(main, feed=feed, fetch_list=fetch)[0]
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss[0]))
        wall = time.perf_counter() - t_all
        launches = dict(kernels.launches)
        seg = dict(kernelgen.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per_step = {k: v / 10 for k, v in launches.items()}
        planned = planned_segments(main, [out['loss'].name])
        med = float(np.median(step_ms))
        emit(phase=phase, step='steps', config='transformer-base',
             cfg=BENCH_CFG, amp=amp, B=B, T=T, params=n_params,
             param_tensors=len(params), startup_s=startup_s,
             warmup_losses=warm, last_warmup_step_s=warm_s, losses=losses,
             step_ms=step_ms, median_step_ms=med, wall_s=wall,
             tokens_per_step=tokens, tokens_per_s=tokens * 10 / wall,
             model_tflop_per_step=model_flops / 1e12,
             model_tflops=model_flops / med / 1e9, peak_mem_gb=peak_gb,
             launches_per_step=per_step, planned_segments_per_step=planned,
             segment_launches_per_step={k: v / 10 for k, v in seg.items()},
             adam_table_builds=exe._kernel_cache.get('adam_multi_tables'),
             card=smi)
        require(all(np.isfinite(losses + warm)), 'non-finite training loss')
        for k, n in TRAIN_LAUNCHES.items():
            require(per_step.get(k) == n, '%s: %s launches per step, expected '
                    '%d' % (k, per_step.get(k), n))
        require(per_step.get('kernelgen_segment') == planned > 0,
                'generated segments: %s launches per step, %d planned'
                % (per_step.get('kernelgen_segment'), planned))
        flash = profile_step(exe, main, feed, fetch, phase=phase)
        # the step's flash forward, dQ and dK/dV run on the tensor-core
        # designs of its dtype only: 18 launches each, none of the
        # CUDA-core kernels
        want = TRAIN_FLASH[amp]
        got = {k: c for k, (_, c) in flash.items()}
        require(got == want, 'flash kernels in the profiled step: %s, '
                'expected %s' % (got, want))
        graph_modes(phase, smi, exe, main, feed, fetch, tokens, want)
        bitwise_paths(phase, exe, main, scope, feed, fetch)
    del scope, exe
    torch.cuda.empty_cache()
    launches.update(seg)
    return launches


def phase_train_gpu_vs_cpu():
    """Two float32 training steps of the full-width transformer, cut to 2
    layers, B=4, T=256, from the same weights on the card and on the CPU."""
    _gpu_vs_cpu('train_gpu_vs_cpu', dict(BENCH_CFG, n_layer=2))


def _gpu_vs_cpu(phase, cfg):
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    main, startup, out = _train_program(fluid, tr, amp=False, **cfg)
    feed = tr.synthetic_batch(np.random.RandomState(1), 4, 256, 32000)
    feed['trg_pad'][1, 200:] = 1.0    # ragged rows: k_len < T
    feed['src_pad'][2, 150:] = 1.0
    gpu, cpu = fluid.Scope(), fluid.Scope()
    gexe, cexe = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(gpu):
        gexe.run(startup)
    fluid.scope_from_numpy({n: t.cpu().numpy() for n, t in gpu.vars.items()},
                           cpu, 'cpu')
    watch = ['src_emb', 'enc_0_att_qkv_w', 'dec_1_xatt_kv_w',
             'dec_post_ln_w', 'proj_w', 'proj_b']
    res = {}
    for name, scope, exe in (('gpu', gpu, gexe), ('cpu', cpu, cexe)):
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            losses = [float(exe.run(main, feed=feed,
                                    fetch_list=[out['loss']])[0][0])
                      for _ in range(2)]
        res[name] = (losses, {w: scope.vars[w].cpu().numpy()
                              for w in watch},
                     time.perf_counter() - t0)
    # losses: float32 sums in other orders on the two devices (~1e-7
    # relative through 2 layers).  Parameters: an Adam update is at most
    # about the scheduled lr in size (the bias correction makes the first
    # exactly lr * sign(g), the second at most 1.002 lr), so an entry
    # whose gradient is float noise may move the other way on the other
    # device: allow 2.01 * sum(lr) plus 1e-6 relative.
    lrs = [2.0 * 512 ** -0.5 * min(t ** -0.5, t * 8000 ** -1.5)
           for t in (1, 2)]
    p_atol = 2.01 * sum(lrs)
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(res['gpu'][0], res['cpu'][0]))
    p_err = {w: float(np.abs(res['gpu'][1][w] - res['cpu'][1][w]).max())
             for w in watch}
    p_ok = all(np.allclose(res['gpu'][1][w], res['cpu'][1][w], rtol=1e-6,
                           atol=p_atol) for w in watch)
    emit(phase=phase, config='transformer-base width, 2 layers',
         use_flash=cfg['use_flash'], B=4, T=256, dtype='float32', tf32=False,
         gpu_losses=res['gpu'][0], cpu_losses=res['cpu'][0],
         loss_rel_err=loss_err, loss_rtol=1e-5, param_max_abs_err=p_err,
         param_atol=p_atol, param_rtol=1e-6, gpu_s=res['gpu'][2],
         cpu_s=res['cpu'][2])
    require(all(np.isfinite(res['gpu'][0])), 'non-finite GPU loss')
    require(loss_err <= 1e-5, 'gpu vs cpu: losses differ by %g' % loss_err)
    require(p_ok, 'gpu vs cpu: parameters differ after 2 steps: %s' % p_err)
    del gpu, cpu
    torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 7

# launches per step of the composed training path: 18 softmax rows (6
# encoder self, 6 decoder self, 6 cross attention), no flash kernel, 2
# gathers, 32 LayerNorms, one Adam call; the generated segments as planned
COMPOSED_LAUNCHES = {'softmax': 18, 'flash_attention_fwd': 0,
                     'flash_attention_bwd_dq': 0,
                     'flash_attention_bwd_dkv': 0, 'embedding_gather': 2,
                     'layer_norm': 32, 'adam_multi': 1}


class PlainCalls(object):
    """Counts calls of the kernels' plain versions with a CUDA tensor
    among their arguments, while installed."""
    TARGETS = (('paddle_tpu_torch.ops.nn', 'softmax_reference'),
               ('paddle_tpu_torch.ops.nn', 'layer_norm_reference'),
               ('paddle_tpu_torch.ops.fused', 'replay'),
               ('paddle_tpu_torch.ops.optimizer_ops', 'adam_reference'),
               ('paddle_tpu_torch.ops.gather', 'embedding_gather_reference'),
               ('paddle_tpu_torch.ops.attention', '_ref_attention'),
               ('paddle_tpu_torch.ops.attention',
                'flash_backward_reference'))

    def __init__(self):
        self.counts = {}
        self._saved = []

    def __enter__(self):
        import importlib
        import torch

        def on_cuda(args):
            for a in args:
                if isinstance(a, (list, tuple)) and on_cuda(a):
                    return True
                if isinstance(a, torch.Tensor) and a.is_cuda:
                    return True
            return False

        for mod_name, fn_name in self.TARGETS:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, fn_name)

            def wrapper(*a, _real=real, _name=fn_name, **k):
                if on_cuda(list(a) + list(k.values())):
                    self.counts[_name] = self.counts.get(_name, 0) + 1
                return _real(*a, **k)
            self._saved.append((mod, fn_name, real))
            setattr(mod, fn_name, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, real in self._saved:
            setattr(mod, fn_name, real)


def planned_segments(main, fetch_names):
    """Generated-segment launches one run of `main` makes, from the plans
    its fused ops used in their last run."""
    from paddle_tpu_torch.core import passes
    from paddle_tpu_torch.ops import kernelgen
    opt, _ = passes.maybe_optimize(main, fetch_names)
    n = 0
    for op in opt.global_block().ops:
        if op.type == 'fused_elementwise':
            n += kernelgen.plan_of(op.attrs).n_kernels
    return n


def phase_training_composed(smi):
    """transformer-base at its own defaults trained through the passes and
    the generated kernels on the card: AMP on, random init from a seed."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import transformer as tr
    from paddle_tpu_torch.ops import kernelgen
    main, startup, out = _train_program(fluid, tr, amp=True, **COMPOSED_CFG)
    B, T = 32, COMPOSED_CFG['max_len']
    feed = tr.synthetic_batch(np.random.RandomState(0), B, T,
                              COMPOSED_CFG['trg_vocab'])
    tokens = float(np.sum(1.0 - feed['trg_pad']))
    scope, exe = fluid.Scope(), fluid.Executor()
    fetch = [out['loss']]
    nvcc0, builds0 = kernelgen.build_stats['nvcc_s'], \
        kernelgen.build_stats['builds']
    with fluid.scope_guard(scope):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        # installed from the first run of main to the last: the
        # interpreted warm-up and the captures run Python, a replay none
        with PlainCalls() as plain:
            warm, warm_s = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                warm.append(float(exe.run(main, feed=feed,
                                          fetch_list=fetch)[0][0]))
                warm_s.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            kernels.reset_launches()
            kernelgen.launches.clear()
            losses, step_ms = [], []
            t_all = time.perf_counter()
            for _ in range(10):
                t0 = time.perf_counter()
                loss = exe.run(main, feed=feed, fetch_list=fetch)[0]
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss[0]))
            wall = time.perf_counter() - t_all
            launches = dict(kernels.launches)
            seg = dict(kernelgen.launches)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            per_step = {k: v / 10 for k, v in launches.items()}
            planned = planned_segments(main, [out['loss'].name])
            med = float(np.median(step_ms))
            emit(phase='training_composed', step='steps',
                 config='transformer-base defaults', cfg=COMPOSED_CFG,
                 amp=True,
                 pt_opt=os.environ.get('PT_OPT', '1'), B=B, T=T,
                 startup_s=startup_s, warmup_losses=warm,
                 warmup_step_s=warm_s,
                 losses=losses, step_ms=step_ms, median_step_ms=med,
                 wall_s=wall, tokens_per_step=tokens,
                 tokens_per_s=tokens * 10 / wall, peak_mem_gb=peak_gb,
                 launches_per_step=per_step,
                 planned_segments_per_step=planned,
                 segment_functions=len(seg),
                 segment_launches_per_step={k: v / 10
                                            for k, v in seg.items()},
                 plain_calls_on_cuda=plain.counts,
                 kernelgen_builds=kernelgen.build_stats['builds'] - builds0,
                 kernelgen_nvcc_s=kernelgen.build_stats['nvcc_s'] - nvcc0,
                 adam_table_builds=exe._kernel_cache.get(
                     'adam_multi_tables'),
                 card=smi)
            require(all(np.isfinite(losses + warm)),
                    'non-finite training loss')
            for k, n in COMPOSED_LAUNCHES.items():
                require(per_step.get(k) == n, '%s: %s launches per step, '
                        'expected %d' % (k, per_step.get(k), n))
            require(per_step['kernelgen_segment'] == planned > 0,
                    'generated segments: %s launches per step, %d planned'
                    % (per_step['kernelgen_segment'], planned))
            require(not plain.counts, 'plain versions ran on the card: %s'
                    % plain.counts)
            profile_step(exe, main, feed, fetch,
                         phase='training_composed')
            graph_modes('training_composed', smi, exe, main, feed, fetch,
                        tokens, {})
            bitwise_paths('training_composed', exe, main, scope, feed,
                          fetch)
        require(not plain.counts, 'plain versions ran on the card in '
                'the profile, graph_modes or bitwise_paths: %s'
                % plain.counts)
    del scope, exe
    torch.cuda.empty_cache()
    launches.update({k: v for k, v in seg.items()})
    return launches


def phase_train_composed_gpu_vs_cpu():
    """Two float32 steps of the composed transformer at full width, cut
    to 2 layers, B=4, dropout 0, from the same weights on the card and on
    the CPU (the CPU runs the fused groups' plain replay)."""
    _gpu_vs_cpu('train_composed_gpu_vs_cpu',
                dict(COMPOSED_CFG, dropout=0.0, n_layer=2))


def phase_composed_opt_on_off():
    """PT_OPT=1 (generated kernels) against PT_OPT=0 (one eager op at a
    time) on the card, dropout 0.1, from the same seed."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    cfg = dict(COMPOSED_CFG, n_layer=2)
    feed = tr.synthetic_batch(np.random.RandomState(2), 32, 256, 32000)
    watch = ['src_emb', 'enc_0_att_qkv_w', 'dec_1_xatt_kv_w',
             'dec_post_ln_w', 'proj_w', 'proj_b']
    res = {}
    saved = os.environ.get('PT_OPT')
    try:
        for opt in ('1', '0'):
            os.environ['PT_OPT'] = opt
            main, startup, out = _train_program(fluid, tr, amp=True, **cfg)
            scope, exe = fluid.Scope(), fluid.Executor()
            with fluid.scope_guard(scope):
                exe.run(startup)
                init = {w: scope.vars[w].clone() for w in watch}
                losses = [float(exe.run(main, feed=feed,
                                        fetch_list=[out['loss']])[0][0])
                          for _ in range(3)]
            res[opt] = (losses, init, {w: scope.vars[w].clone()
                                       for w in watch})
            del scope, exe
    finally:
        if saved is None:
            os.environ.pop('PT_OPT', None)
        else:
            os.environ['PT_OPT'] = saved
    on, off = res['1'], res['0']
    rel = max(abs(a - b) / abs(b) for a, b in zip(on[0], off[0]))
    same_init = all(torch.equal(on[1][w], off[1][w]) for w in watch)
    bitwise = on[0] == off[0] and all(torch.equal(on[2][w], off[2][w])
                                      for w in watch)
    emit(phase='composed_opt_on_off', cfg=cfg, amp=True, B=32, T=256,
         losses_opt_on=on[0], losses_opt_off=off[0], loss_rel_err=rel,
         loss_rtol=1e-6, startup_equal=same_init, bitwise=bitwise)
    require(all(np.isfinite(on[0])), 'non-finite loss with the passes on')
    require(rel <= 1e-6, 'PT_OPT=1 vs 0: losses differ by %g' % rel)
    torch.cuda.empty_cache()


def phase_nan_trip(smi):
    """check_nan on the card through the graph: transformer-base at full
    width cut to 2 layers, composed attention (the pads reach only the
    loss weights and the additive masks), B=4, T=256, float32; after
    three clean steps (warm-up, capture, replay) one NaN in a target pad
    entry.  nan_poll=1 must raise naming the loss at that step; nan_poll=8
    must raise with nan_window_steps=8 at the poll."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    main, startup, out = _train_program(
        fluid, tr, amp=False, **dict(COMPOSED_CFG, dropout=0.0, n_layer=2))
    feed = tr.synthetic_batch(np.random.RandomState(3), 4, 256, 32000)
    bad = dict(feed, trg_pad=feed['trg_pad'].copy())
    bad['trg_pad'][0, -1] = np.nan
    fetch = [out['loss']]
    res = {}
    for poll in (1, 8):
        scope, exe = fluid.Scope(), fluid.Executor(check_nan=True,
                                                   nan_poll=poll)
        with fluid.scope_guard(scope):
            exe.run(startup)
            exe.poll_nan()
            clean = [float(exe.run(main, feed=feed, fetch_list=fetch)[0][0])
                     for _ in range(3)]
            err, bad_steps = None, 0
            try:
                for _ in range(poll):
                    bad_steps += 1
                    exe.run(main, feed=bad, fetch_list=fetch)
            except RuntimeError as e:
                err = e
        captured = sum(e.graph is not None
                       for e in exe._graphs.entries.values())
        res[poll] = dict(clean_losses=clean, bad_steps=bad_steps,
                         raised=err is not None,
                         names_loss=out['loss'].name in str(err),
                         message=str(err)[:300] if err else None,
                         nan_window_steps=getattr(err, 'nan_window_steps',
                                                  None),
                         graphs_captured=captured)
        del scope, exe
    emit(phase='nan_trip', config='transformer-base width, 2 layers, '
         'composed, float32', B=4, T=256, by_nan_poll=res, card=smi)
    one, eight = res[1], res[8]
    require(all(np.isfinite(one['clean_losses'] + eight['clean_losses'])),
            'non-finite loss before the poisoned feed')
    require(one['raised'] and one['bad_steps'] == 1 and
            one['message'].startswith('check_nan') and one['names_loss'],
            'nan_poll=1: no raise naming %s at the poisoned step: %s'
            % (out['loss'].name, one))
    require(eight['raised'] and eight['bad_steps'] == 5 and
            eight['nan_window_steps'] == 8,
            'nan_poll=8: no raise with a window of 8: %s' % eight)
    require(one['graphs_captured'] >= 1 and eight['graphs_captured'] >= 1,
            'the check ran without a captured graph')
    torch.cuda.empty_cache()


# ------------------------------------------------------------- main

_REPLACES = {
    'flash_attention_fwd': ('paddle_tpu_torch/csrc/flash_fwd.cu',
                            'paddle_tpu/ops/attention.py:52'),
    'embedding_gather': ('paddle_tpu_torch/csrc/gather.cu',
                         'paddle_tpu/ops/gather.py:34'),
    'flash_attention_bwd_dq': ('paddle_tpu_torch/csrc/flash_bwd.cu',
                               'paddle_tpu/ops/attention.py:125'),
    'flash_attention_bwd_dkv': ('paddle_tpu_torch/csrc/flash_bwd.cu',
                                'paddle_tpu/ops/attention.py:167'),
    'layer_norm': ('paddle_tpu_torch/csrc/layer_norm.cu',
                   'paddle_tpu/ops/kernelgen/rules.py:336'),
    'adam_multi': ('paddle_tpu_torch/csrc/adam.cu',
                   'paddle_tpu/ops/kernelgen/builder.py:795'),
    'softmax': ('paddle_tpu_torch/csrc/softmax.cu',
                'paddle_tpu/ops/kernelgen/rules.py:291'),
}
# the two instances of K1-K3: each dtype's design
_DESIGNS = {
    ('flash_attention_fwd', 'bfloat16'): 'wgmma, tensor cores',
    ('flash_attention_fwd', 'float32'): '3xTF32 wgmma, tensor cores',
    ('flash_attention_bwd_dq', 'bfloat16'): 'wgmma, tensor cores',
    ('flash_attention_bwd_dq', 'float32'):
        '3xTF32 wgmma, tensor cores (D = 64; CUDA cores at D = 128)',
    ('flash_attention_bwd_dkv', 'bfloat16'): 'wgmma, tensor cores',
    ('flash_attention_bwd_dkv', 'float32'):
        '3xTF32 wgmma, tensor cores (D = 64; CUDA cores at D = 128)',
}
# every generated segment: the generator's source, the TPU generator
SEGMENT_SOURCE = ('paddle_tpu_torch/ops/kernelgen/builder.py',
                  'paddle_tpu/ops/kernelgen/builder.py:795')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--phases', default=','.join(PHASES),
                    help='comma-separated subset of %s' % (PHASES,))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(',') if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error('unknown phases %s' % sorted(unknown))

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device — this script runs on the card',
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch  # noqa: F401 - fails outside the repository
    from paddle_tpu_torch import kernels as kernels_py

    emit(phase='env', python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())
    took = {}

    def run(name, fn, *a):
        """fn(*a) when phase `name` was asked for, else {}; timed."""
        if name not in phases:
            return {}
        t0 = time.perf_counter()
        res = fn(*a)
        took[name] = time.perf_counter() - t0
        return res

    smi = run('card', phase_card) or smi_line()
    kern = run('kernels', phase_kernels) or {'rows': {}, 'instances': {}}
    # the timed phases first, the ones that also compute on the CPU last:
    # CPU work left behind slows the host that issues the timed steps
    served_launches = run('serving', phase_serving, smi)
    served_bf16 = run('serving_bf16', phase_serving_bf16, smi)
    generated = run('generation', phase_generation, smi)
    trained = run('training', phase_training, smi)
    trained_f32 = run('training_f32', phase_training_f32, smi)
    composed = run('training_composed', phase_training_composed, smi)
    run('composed_opt_on_off', phase_composed_opt_on_off)
    run('nan_trip', phase_nan_trip, smi)
    run('gpu_vs_cpu', phase_gpu_vs_cpu)
    run('generation_gpu_vs_cpu', phase_generation_gpu_vs_cpu)
    run('train_gpu_vs_cpu', phase_train_gpu_vs_cpu)
    run('train_composed_gpu_vs_cpu', phase_train_composed_gpu_vs_cpu)
    emit(phase='script', seconds_by_phase=took)

    def per_step(steps):
        return {k: v // 10 if v % 10 == 0 else v / 10
                for k, v in steps.items() if v}
    # launches by path: per served run (serving, serving_bf16), per decode
    # step (generation: K4), per step of each training path
    by_path = {'serving': served_launches, 'serving_bf16': served_bf16,
               'generation': generated, 'training': per_step(trained),
               'training_f32': per_step(trained_f32),
               'training_composed': per_step(composed)}
    # the main path's launches: per step of the composed training path for
    # the kernels it runs, per step of the flash training path for K1-K3
    # and its own generated segments, per served run for the serving-only
    # ones (the float32 step adds only its own segments: its flash kernels
    # are the float32 instances, below)
    launches = dict(served_launches)
    launches.update({k: v for k, v in served_bf16.items()
                     if k not in kernels_py.launches})
    launches.update({k: v for k, v in by_path['training_f32'].items()
                     if k not in kernels_py.launches})
    for path in ('training', 'training_composed'):
        launches.update(by_path[path])
    # the float32 instances of K1-K3: K1 per served run (serving), K2 and
    # K3 per step of the float32 flash training path
    f32_steps = by_path['training_f32']
    f32_launches = {'flash_attention_fwd': served_launches.get(
        'flash_attention_fwd'), 'flash_attention_bwd_dq': f32_steps.get(
        'flash_attention_bwd_dq'), 'flash_attention_bwd_dkv': f32_steps.get(
        'flash_attention_bwd_dkv')}
    # the paths that run each instance's dtype
    dtype_paths = {'bfloat16': ('training', 'serving_bf16'),
                   'float32': ('serving', 'training_f32')}

    def path_counts(name, paths=tuple(by_path)):
        return {p: by_path[p][name] for p in paths
                if by_path[p].get(name)}

    rows = []
    for name, res in kern['rows'].items():
        src, replaces = _REPLACES.get(name, SEGMENT_SOURCE)
        row = dict(
            name=name, route='cuda', source=src, replaces=replaces,
            launches=launches.get(name), max_abs_err=res['max_abs_err'],
            ms=res['ms'], plain_ms=res['plain_ms'],
            bound_ms=res['bound_ms'], bound_by=res['bound_by'],
            library_ms=res['library_ms'],
            launches_by_path=path_counts(name))
        if name not in _REPLACES:
            row.update(ops=res['ops'], paths=res['paths'])
        if name in kern['instances']:
            row['instances'] = [dict(
                dtype=dt, design=_DESIGNS[name, dt],
                case=r['case'], launches=(launches.get(name)
                                          if dt == 'bfloat16'
                                          else f32_launches[name]),
                launches_by_path=path_counts(name, dtype_paths[dt]),
                max_abs_err=r['max_abs_err'], ms=r['ms'],
                plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                bound_by=r['bound_by'], library_ms=r['library_ms'])
                for dt, r in sorted(kern['instances'][name].items())]
        rows.append(row)
    if 'kernels' in phases and set(by_path) <= set(phases):
        idle = [r['name'] for r in rows if not r['launches_by_path']] + [
            '%s/%s' % (r['name'], i['dtype']) for r in rows
            for i in r.get('instances', ()) if not i['launches_by_path']]
        require(not idle, 'kernels never launched on any of their paths: '
                '%s' % idle)
    print(json.dumps({'kernels': rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
