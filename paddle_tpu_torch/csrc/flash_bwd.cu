// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV on tensor
// cores (wgmma) for bf16, on CUDA cores for float32.
//
// Replaces paddle_tpu/ops/attention.py:125 _flash_dq_kernel (K2) and
// :167 _flash_dkv_kernel_resident / :220 _flash_dkv_kernel (K3), which the
// JAX package launches from _flash_backward (:401, pallas_call at :441 and
// :503).  Both kernels rebuild the softmax tile P = exp(S - LSE) from the
// forward's float32 logsumexp (read as csrc/flash_fwd.cu stores it, [B*H,
// Tq], not the TPU's 8-lane layout), with S = (scale q) k^T, under the
// forward's masks: k_pos < k_len, and when causal k_pos <= q_pos +
// (Tk - Tq).  Masked entries get P = 0 explicitly, as _masked_p_ds does,
// so a row with LSE -1e30 (no valid key) gets zero gradients instead of
// exp(-1e30 - -1e30) = NaN.  dS = P (dO V^T - delta) with delta =
// rowsum(dO O) computed by the wrapper in float32.
//
//   dQ  = scale * sum_k dS K                  (one block per (b*H, q tile))
//   dV  = sum_q P^T dO,  dK = scale * sum_q dS^T Q
//                                             (one block per (b*Hkv, k tile))
//
// dQ comes out in q's dtype; dK and dV accumulate in float32 registers over
// the g query heads of the GQA group and every q tile, and are written once
// in k's dtype.  No atomics: a block owns its output tile, so the result is
// deterministic.  This replaces the TPU's sequential "init at gi == 0, add
// after" grid, which has no counterpart among parallel blocks.
//
// What bounds it on this card: at the transformer training shape (B=32,
// H=8, T=256, D=64, bf16 under AMP) dQ does 3 and dK/dV 4 products of
// 2*D FLOPs per valid (query, key) pair (~6.4 and ~8.6 GFLOP without the
// causal mask) against 42 and 51 MB of traffic (Q, K, V, dO, LSE and delta
// read once, the gradients written once): on the bf16 tensor cores that
// is 6.5 and 8.7 us of work against 12.7 and 15.2 us of bytes, so both
// are bound by bytes; on CUDA cores (float32 FMAs, 67 TFLOP/s) they are
// bound by arithmetic.
//
// dQ, bf16, flash_bwd_dq_wgmma_kernel<D>: one warpgroup of 128 threads per
// (b*H, 64-row query tile), heaviest causal tiles first.  Q and dO stay
// resident in shared memory (one TMA copy each); LSE and delta of the
// tile's rows are plain loads by warp 0 (a TMA box does not take rows that
// start off a 16-byte boundary) and then sit in registers, two rows a
// thread.  K/V tiles of 64 keys flow through a 2-stage ring under mbarriers
// (full: the bytes arrived; empty: all 128 threads are done with the
// stage) from key 0 to the tile's end, min(k_len, causal frontier); later
// tiles are never loaded.  S = Q K^T and dP = dO V^T are wgmma with every
// operand K-major (64 query rows x 64 keys, reduced over D); P and dS are
// formed on the float32 fragments in registers, dS rounded to bf16 there
// once (as dK/dV rounds dS^T), and dQ += dS K runs with A = dS from
// registers and B = K MN-major (tnspB = 1; N = D, both 64-column chunk
// regions at D=128).  dQ x scale once in the epilogue, written in bf16 up
// to row Tq.  One D-wide float32 accumulator (D/2 registers a thread) beside
// the S and dP fragments (32 each): ptxas gives 122 registers at D=64 and
// 154 at D=128, no spills; with 50 KB of shared memory at D=64, four blocks
// (16 warps) fit an SM.  Not yet used: warp specialisation, setmaxnreg,
// overlapping one tile's elementwise work with the next tile's products, a
// persistent grid.
//
// dK/dV, bf16, flash_bwd_dkv_wgmma_kernel<D>: one warpgroup of 128 threads per
// (b*Hkv, 64-key tile).  K and V stay resident in shared memory (one TMA copy
// each); Q/dO tiles of WQ query rows (TMA) with their LSE and delta (loaded by
// warp 0) flow through a 2-stage ring under mbarriers, over the g query heads
// of the GQA group and the q tiles from the causal frontier on.  The products
// run transposed, so that the keys are the 64-row M dimension: S^T = K Q^T and
// dP^T = V dO^T by wgmma with every operand K-major in shared memory; P^T and
// dS^T are formed on the float32 fragments in registers, rounded to bf16 there,
// and dV += P^T dO and dK += dS^T Q run with A from registers and B = dO or Q
// MN-major (tnspB = 1); dK x scale once in the epilogue.  The two D-wide
// float32 accumulators take D registers a thread (128 at D=128) besides S^T and
// dP^T (WQ each): ptxas gives 181 registers at D=64 and 242 at D=128, no
// spills, so the 64-row ring tile stays at D=128, and two blocks (8 warps) fit
// an SM at D=64.  Not yet used: warp specialisation, setmaxnreg, two consumer
// warpgroups sharing K/V, overlapping one ring tile's elementwise work with the
// next tile's products, a persistent grid.
//
// float32, flash_bwd_dq_kernel<D> and flash_bwd_dkv_kernel<D> (the CUDA-core
// design): tiles of 64 query rows and 32 keys are staged as float32 in shared
// memory and reused by all 128 threads; each thread keeps a 4x4 patch of S and
// dP, and an 8 x D/16 (dQ) or two 4 x D/16 (dK, dV) patches of its
// accumulators in registers.  Padded strides keep the column walks free of
// bank conflicts.  Key tiles past k_len and query tiles before the causal
// frontier are skipped whole.  The tiles need up to 116 KB of shared memory at
// D=128, above the 48 KB static limit, so they are dynamic and the launch
// raises the limit first.
#include "hopper_mma.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 32;    // keys per tile
constexpr int NT = 128;   // threads per block

// Q (pre-scaled), dO, LSE and delta of query rows q0..q0+BQ into shared
// memory; rows past Tq are zero
template <int D>
__device__ __forceinline__ void load_q_tile(const float* qp, const float* dop,
                                            const float* lsep,
                                            const float* dlp, int q0, int Tq,
                                            float scale, float* Qs,
                                            float* dOs, float* lse_s,
                                            float* dl_s) {
  constexpr int QS = D + 1;
  for (int e = threadIdx.x; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, qi = q0 + r;
    const bool in = qi < Tq;
    Qs[r * QS + c] = in ? qp[(size_t)qi * D + c] * scale : 0.f;
    dOs[r * QS + c] = in ? dop[(size_t)qi * D + c] : 0.f;
  }
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const bool in = q0 + r < Tq;
    lse_s[r] = in ? lsep[q0 + r] : 0.f;
    dl_s[r] = in ? dlp[q0 + r] : 0.f;
  }
}

// K and V of keys k0..k0+BK into shared memory; keys past Tk are zero
template <int D>
__device__ __forceinline__ void load_k_tile(const float* kp, const float* vp,
                                            int k0, int Tk, float* Ks,
                                            float* Vs) {
  constexpr int KS = D + 1;
  for (int e = threadIdx.x; e < BK * D; e += NT) {
    const int r = e / D, c = e % D, ki = k0 + r;
    const bool in = ki < Tk;
    Ks[r * KS + c] = in ? kp[(size_t)ki * D + c] : 0.f;
    Vs[r * KS + c] = in ? vp[(size_t)ki * D + c] : 0.f;
  }
}

// P and dS of the (BQ x BK) tile at (q0, k0): each thread computes a 4x4
// patch (query rows sr*4+i, keys sc+8j) of S = Qs Ks^T and dP = dOs Vs^T,
// in the forward's summation order, and stores P (when Ps is given) and dS
// with a row stride of BK+1
template <int D>
__device__ __forceinline__ void p_ds_tile(const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs,
                                          const float* lse_s,
                                          const float* dl_s, int q0, int k0,
                                          int Tq, int kl, int causal,
                                          int offset, float* Ps,
                                          float* dSs) {
  constexpr int QS = D + 1, KS = D + 1, SS = BK + 1;
  const int sr = threadIdx.x / 8, sc = threadIdx.x % 8;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = Qs[(sr * 4 + i) * QS + d];
      da[i] = dOs[(sr * 4 + i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = Ks[(sc + 8 * j) * KS + d];
      vb[j] = Vs[(sc + 8 * j) * KS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = sr * 4 + i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = sc + 8 * j, ki = k0 + c;
      const bool valid =
          ki < kl && qi < Tq && (!causal || ki <= qi + offset);
      const float p = valid ? expf(s[i][j] - lse_s[r]) : 0.f;
      if (Ps) Ps[r * SS + c] = p;
      dSs[r * SS + c] = p * (dp[i][j] - dl_s[r]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * BQ * (D + 1)    // Q (scaled), dO
         + 2 * BK * (D + 1)  // K, V
         + BQ * (BK + 1)     // dS
         + 2 * BQ;           // LSE, delta
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ klen,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    int H, int Hkv, int Tq, int Tk, int causal, float scale) {
  constexpr int QS = D + 1, KS = D + 1, SS = BK + 1;
  constexpr int CPT = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * QS;
  float* Ks = dOs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* dSs = Vs + BK * KS;
  float* lse_s = dSs + BQ * SS;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;

  load_q_tile<D>(q + (size_t)bh * Tq * D, dout + (size_t)bh * Tq * D,
                    lse + (size_t)bh * Tq, delta + (size_t)bh * Tq, q0, Tq,
                    scale, Qs, dOs, lse_s, dl_s);
  const float* kp = k + (size_t)kvh * Tk * D;
  const float* vp = v + (size_t)kvh * Tk * D;

  // keys any row of this tile may see, as in the forward
  int kend = kl;
  if (causal) kend = min(kend, max(0, min(q0 + BQ, Tq) + offset));
  const int ntiles = (kend + BK - 1) / BK;

  const int pr = tid / 16, pc = tid % 16;  // dQ patch: rows pr*8+i, cols pc+16j
  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K and dS reads are done
    load_k_tile<D>(kp, vp, k0, Tk, Ks, Vs);
    __syncthreads();
    p_ds_tile<D>(Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, Tq, kl, causal,
                 offset, nullptr, dSs);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[8], kv[CPT];
#pragma unroll
      for (int i = 0; i < 8; ++i) dsv[i] = dSs[(pr * 8 + i) * SS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[kk * KS + pc + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + pr * 8 + i;
    if (qi >= Tq) continue;
    float* op = dq + ((size_t)bh * Tq + qi) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) op[pc + 16 * j] = acc[i][j] * scale;
  }
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 2 * BK * (D + 1)    // K, V
         + 2 * BQ * (D + 1)  // Q (scaled), dO
         + 2 * BQ * (BK + 1) // P, dS
         + 2 * BQ;           // LSE, delta
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ klen,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ dout, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                     int causal, float scale) {
  constexpr int QS = D + 1, KS = D + 1, SS = BK + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * KS;
  float* Qs = Vs + BK * KS;
  float* dOs = Qs + BQ * QS;
  float* Ps = dOs + BQ * QS;
  float* dSs = Ps + BQ * SS;
  float* lse_s = dSs + BQ * SS;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int b = bkv / Hkv, hk = bkv % Hkv, g = H / Hkv;
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;

  const int pr = tid / 16, pc = tid % 16;  // dK/dV patch: keys pr*4+i, cols pc+16j
  float ak[4][CPT], av[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) ak[i][j] = av[i][j] = 0.f;

  if (k0 < kl) {  // else every key of the tile is masked: zero gradients
    load_k_tile<D>(k + (size_t)bkv * Tk * D,
                          v + (size_t)bkv * Tk * D, k0, Tk, Ks, Vs);
    // first query that sees this tile's first key (end-aligned causal)
    const int q_first = causal ? max(0, k0 - offset) : 0;
    for (int gi = 0; gi < g; ++gi) {
      const int bh = b * H + hk * g + gi;
      for (int q0 = (q_first / BQ) * BQ; q0 < Tq; q0 += BQ) {
        __syncthreads();  // the previous tile's Q/dO/P/dS reads are done
        load_q_tile<D>(q + (size_t)bh * Tq * D,
                              dout + (size_t)bh * Tq * D,
                              lse + (size_t)bh * Tq, delta + (size_t)bh * Tq,
                              q0, Tq, scale, Qs, dOs, lse_s, dl_s);
        __syncthreads();
        p_ds_tile<D>(Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, Tq, kl, causal,
                     offset, Ps, dSs);
        __syncthreads();
#pragma unroll 4
        for (int r = 0; r < BQ; ++r) {
          float pv[4], dsv[4], dov[CPT], qv[CPT];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pv[i] = Ps[r * SS + pr * 4 + i];
            dsv[i] = dSs[r * SS + pr * 4 + i];
          }
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            dov[j] = dOs[r * QS + pc + 16 * j];
            qv[j] = Qs[r * QS + pc + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
              av[i][j] = fmaf(pv[i], dov[j], av[i][j]);
              ak[i][j] = fmaf(dsv[i], qv[j], ak[i][j]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + pr * 4 + i;
    if (ki >= Tk) continue;
    const size_t row = ((size_t)bkv * Tk + ki) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      dk[row + pc + 16 * j] = ak[i][j];
      dv[row + pc + 16 * j] = av[i][j];
    }
  }
}

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* klen, const void* lse, const void* delta,
                  const void* dout, void* dq, int B, int H, int Hkv, int Tq,
                  int Tk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)klen,
      (const float*)lse, (const float*)delta, (const float*)dout,
      (float*)dq, H, Hkv, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* klen, const void* lse, const void* delta,
                   const void* dout, void* dk, void* dv, int B, int H,
                   int Hkv, int Tq, int Tk, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * Hkv, (Tk + BK - 1) / BK);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)klen,
      (const float*)lse, (const float*)delta, (const float*)dout,
      (float*)dk, (float*)dv, H, Hkv, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int WK = 64;       // keys per tile: a dK/dV block's (the wgmma M
                             // dimension), a dQ ring tile's
constexpr int WQ = 64;       // query rows per tile: a dQ block's (M), a
                             // dK/dV ring tile's
constexpr int STAGES = 2;    // ring depth (Q/dO for dK/dV, K/V for dQ)
constexpr float LOG2E = 1.4426950408889634f;

// one [rows x 64] bf16 region of a tile in the 128-byte swizzle
template <int ROWS>
using Chunk = bf16[ROWS * 64];

// ---------------------------------------------------------------- dK/dV

template <int D>
struct DkvSmem {
  Chunk<WK> k[D / 64];
  Chunk<WK> v[D / 64];
  Chunk<WQ> q[STAGES][D / 64];
  Chunk<WQ> dout[STAGES][D / 64];
  float lse[STAGES][WQ];
  float delta[STAGES][WQ];
  uint64_t kvbar, full[STAGES], empty[STAGES];
};

// the ring tile `it` of a block: query head gi of the GQA group and query
// tile qt0 + it % nq
struct RingPos {
  int bh, q0;
};

__device__ __forceinline__ RingPos ring_pos(int it, int b, int H, int hk,
                                            int g, int qt0, int nq) {
  return {b * H + hk * g + it / nq, (qt0 + it % nq) * WQ};
}

// warp 0: Q and dO of ring tile `pos` into stage s by TMA (lane 0), LSE
// and delta by plain loads (rows past Tq read 0; a ring tile's rows start
// at any float of the flat [B*H*Tq] vectors, which a TMA box does not
// take); every lane arrives on the stage's full barrier after its stores
template <int D>
__device__ __forceinline__ void load_ring(DkvSmem<D>& sm,
                                          const CUtensorMap* tq,
                                          const CUtensorMap* tdo,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          RingPos pos, int Tq, int s) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    hopper::mbar_expect_tx(&sm.full[s], 2 * WQ * D * sizeof(bf16));
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      hopper::tma_load_3d(sm.q[s][c], tq, &sm.full[s], 64 * c, pos.q0,
                          pos.bh);
      hopper::tma_load_3d(sm.dout[s][c], tdo, &sm.full[s], 64 * c, pos.q0,
                          pos.bh);
    }
  }
  const size_t row0 = (size_t)pos.bh * Tq + pos.q0;
  for (int r = lane; r < WQ; r += 32) {
    const bool in = pos.q0 + r < Tq;
    sm.lse[s][r] = in ? lse[row0 + r] : 0.f;
    sm.delta[s][r] = in ? delta[row0 + r] : 0.f;
  }
  hopper::mbar_arrive(&sm.full[s]);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ klen,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int H, int Hkv, int Tq, int Tk, int causal,
                           float scale) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(align_1024(smem_raw));

  const int tid = threadIdx.x;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * WK;
  const int b = bkv / Hkv, hk = bkv % Hkv, g = H / Hkv;
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;
  // the first query tile that sees this tile's first key (end-aligned
  // causal); no work when every key of the tile is past k_len
  const int qt0 = causal ? max(0, k0 - offset) / WQ : 0;
  const int nq = (Tq + WQ - 1) / WQ - qt0;
  const int total = (k0 < kl && nq > 0) ? g * nq : 0;

  if (tid < 32) {  // warp 0 produces: barriers, K/V, the first stages
    if (tid == 0) {
      mbar_init(&sm.kvbar, 1);
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&sm.full[s], 1 + 32);  // TMA bytes + warp 0's stores
        mbar_init(&sm.empty[s], NT);
      }
      mbar_fence_init();
      if (total > 0) {
        mbar_expect_tx(&sm.kvbar, 2 * WK * D * sizeof(bf16));
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(sm.k[c], &tk, &sm.kvbar, 64 * c, k0, bkv);
          tma_load_3d(sm.v[c], &tv, &sm.kvbar, 64 * c, k0, bkv);
        }
      }
    }
    __syncwarp();
    for (int s = 0; s < STAGES && s < total; ++s)
      load_ring(sm, &tq, &tdo, lse, delta,
                ring_pos(s, b, H, hk, g, qt0, nq), Tq, s);
  }
  __syncthreads();

  const float sl2 = scale * LOG2E;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  if (total > 0) mbar_wait(&sm.kvbar, 0);
  for (int it = 0; it < total; ++it) {
    const int s = it % STAGES, ph = (it / STAGES) & 1;
    const int q0 = ring_pos(it, b, H, hk, g, qt0, nq).q0;
    mbar_wait(&sm.full[s], ph);

    // S^T = K Q^T and dP^T = V dO^T: keys are the 64 rows, queries the
    // WQ columns; all operands K-major (D contiguous)
    float st[WQ / 2], dpt[WQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int c = kc / 4, off = (kc % 4) * 16;
      wgmma_ss<0>(st, make_desc(sm.k[c] + off, 16, 1024),
                  make_desc(sm.q[s][c] + off, 16, 1024), kc > 0);
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int c = kc / 4, off = (kc % 4) * 16;
      wgmma_ss<0>(dpt, make_desc(sm.v[c] + off, 16, 1024),
                  make_desc(sm.dout[s][c] + off, 16, 1024), kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(scale S^T - LSE[col]) and dS^T = P^T (dP^T - delta[col])
    // under the masks, P = 0 where masked (a row with LSE -1e30 has no
    // valid key); interior tiles skip the mask
    const bool interior = k0 + WK <= kl && q0 + WQ <= Tq &&
                          (!causal || k0 + WK - 1 <= q0 + offset);
#pragma unroll
    for (int i = 0; i < WQ / 2; ++i) {
      const int qc = acc_col(i);
      bool valid = true;
      if (!interior) {
        const int ki = k0 + acc_row(i), qi = q0 + qc;
        valid = ki < kl && qi < Tq && (!causal || ki <= qi + offset);
      }
      const float p =
          valid ? exp2f(st[i] * sl2 - sm.lse[s][qc] * LOG2E) : 0.f;
      dpt[i] = valid ? p * (dpt[i] - sm.delta[s][qc]) : 0.f;
      st[i] = p;
    }
    uint32_t pa[WQ / 16][4], dsa[WQ / 16][4];
    acc_to_a(st, pa);
    acc_to_a(dpt, dsa);

    // dV += P^T dO and dK += dS^T Q: B = dO or Q, the query rows being
    // the reduction (MN-major, tnspB = 1)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WQ / 16; ++kk)
      wgmma_rs<1>(dva, pa[kk],
                  make_desc(sm.dout[s][0] + kk * 16 * 64, WQ * 128, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < WQ / 16; ++kk)
      wgmma_rs<1>(dka, dsa[kk],
                  make_desc(sm.q[s][0] + kk * 16 * 64, WQ * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);

    mbar_arrive(&sm.empty[s]);
    if (tid < 32 && it + STAGES < total) {  // warp 0 refills the stage
      mbar_wait(&sm.empty[s], ph);
      load_ring(sm, &tq, &tdo, lse, delta,
                ring_pos(it + STAGES, b, H, hk, g, qt0, nq), Tq, s);
    }
  }

  // dK x scale once; each is written once, in k's dtype
  const int cq = 2 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ki = k0 + acc_row(0) + 8 * h;
    if (ki >= Tk) continue;
    const size_t row = ((size_t)bkv * Tk + ki) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * j + cq) =
          __floats2bfloat162_rn(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * j + cq) =
          __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* klen, const void* lse, const void* delta,
                    const void* dout, void* dk, void* dv, int B, int H,
                    int Hkv, int Tq, int Tk, int causal, float scale,
                    cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc = hopper::map_bf16_3d(&mq, q, B * H, Tq, D, WQ);
  if (rc == 0) rc = hopper::map_bf16_3d(&mdo, dout, B * H, Tq, D, WQ);
  if (rc == 0) rc = hopper::map_bf16_3d(&mk, k, B * Hkv, Tk, D, WK);
  if (rc == 0) rc = hopper::map_bf16_3d(&mv, v, B * Hkv, Tk, D, WK);
  if (rc != 0) return rc;
  const size_t smem = sizeof(DkvSmem<D>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * Hkv, (Tk + WK - 1) / WK);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, NT, smem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta,
      (const int*)klen, (bf16*)dk, (bf16*)dv, H, Hkv, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- dQ

template <int D>
struct DqSmem {
  Chunk<WQ> q[D / 64];
  Chunk<WQ> dout[D / 64];
  Chunk<WK> k[STAGES][D / 64];
  Chunk<WK> v[STAGES][D / 64];
  float lse[WQ];
  float delta[WQ];
  uint64_t qbar, full[STAGES], empty[STAGES];
};

// thread 0: K/V tile t of head kvh into stage s
template <int D>
__device__ __forceinline__ void load_kv(DqSmem<D>& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int kvh, int t,
                                        int s) {
  hopper::mbar_expect_tx(&sm.full[s], 2 * WK * D * sizeof(bf16));
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    hopper::tma_load_3d(sm.k[s][c], tk, &sm.full[s], 64 * c, t * WK, kvh);
    hopper::tma_load_3d(sm.v[s][c], tv, &sm.full[s], 64 * c, t * WK, kvh);
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ klen, bf16* __restrict__ dq,
                          int H, int Hkv, int Tq, int Tk, int causal,
                          float scale) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(align_1024(smem_raw));

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WQ;  // heaviest tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;
  // keys any row of this tile may see, as in the forward
  int kend = kl;
  if (causal) kend = min(kend, max(0, min(q0 + WQ, Tq) + offset));
  const int ntiles = (kend + WK - 1) / WK;

  if (tid < 32) {  // warp 0: barriers, Q/dO, the first K/V stages, LSE/delta
    if (tid == 0) {
      mbar_init(&sm.qbar, 1);
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&sm.full[s], 1);
        mbar_init(&sm.empty[s], NT);
      }
      mbar_fence_init();
      if (ntiles > 0) {
        mbar_expect_tx(&sm.qbar, 2 * WQ * D * sizeof(bf16));
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(sm.q[c], &tq, &sm.qbar, 64 * c, q0, bh);
          tma_load_3d(sm.dout[c], &tdo, &sm.qbar, 64 * c, q0, bh);
        }
        for (int s = 0; s < STAGES && s < ntiles; ++s)
          load_kv(sm, &tk, &tv, kvh, s, s);
      }
    }
    // rows past Tq read 0
    const size_t row0 = (size_t)bh * Tq + q0;
    for (int r = tid; r < WQ; r += 32) {
      const bool in = q0 + r < Tq;
      sm.lse[r] = in ? lse[row0 + r] : 0.f;
      sm.delta[r] = in ? delta[row0 + r] : 0.f;
    }
  }
  __syncthreads();

  // this thread's two rows of the tile: acc_row(i) is r0 + 8 ((i >> 1) & 1)
  const int r0 = acc_row(0);
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = sm.lse[r0 + 8 * h] * LOG2E;
    dl[h] = sm.delta[r0 + 8 * h];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (ntiles > 0) mbar_wait(&sm.qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES, ph = (t / STAGES) & 1;
    const int k0 = t * WK;
    mbar_wait(&sm.full[s], ph);

    // S = Q K^T and dP = dO V^T: query rows x keys, all operands K-major
    float sacc[WK / 2], dp[WK / 2];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int c = kc / 4, off = (kc % 4) * 16;
      wgmma_ss<0>(sacc, make_desc(sm.q[c] + off, 16, 1024),
                  make_desc(sm.k[s][c] + off, 16, 1024), kc > 0);
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int c = kc / 4, off = (kc % 4) * 16;
      wgmma_ss<0>(dp, make_desc(sm.dout[c] + off, 16, 1024),
                  make_desc(sm.v[s][c] + off, 16, 1024), kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(dp);

    // P = exp(scale S - LSE) and dS = P (dP - delta) under the masks, P = 0
    // where masked (a row with LSE -1e30 has no valid key; rows past Tq
    // read zeros and are never stored); interior tiles skip the mask
    const bool interior = k0 + WK <= kl && q0 + WQ <= Tq &&
                          (!causal || k0 + WK - 1 <= q0 + offset);
#pragma unroll
    for (int i = 0; i < WK / 2; ++i) {
      const int h = (i >> 1) & 1;
      bool valid = true;
      if (!interior) {
        const int ki = k0 + acc_col(i), qi = q0 + acc_row(i);
        valid = ki < kl && qi < Tq && (!causal || ki <= qi + offset);
      }
      const float p = valid ? exp2f(sacc[i] * sl2 - lse2[h]) : 0.f;
      dp[i] = valid ? p * (dp[i] - dl[h]) : 0.f;
    }
    uint32_t dsa[WK / 16][4];
    acc_to_a(dp, dsa);

    // dQ += dS K: B = K, the keys being the reduction (MN-major, tnspB = 1)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      wgmma_rs<1>(acc, dsa[kk],
                  make_desc(sm.k[s][0] + kk * 16 * 64, WK * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    mbar_arrive(&sm.empty[s]);
    if (tid == 0 && t + STAGES < ntiles) {
      mbar_wait(&sm.empty[s], ph);
      load_kv(sm, &tk, &tv, kvh, t + STAGES, s);
    }
  }

  // dQ x scale once, in q's dtype; TMA bounds its reads at Tq, not these
  // stores
  const int cq = 2 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r0 + 8 * h;
    if (qi >= Tq) continue;
    bf16* op = dq + ((size_t)bh * Tq + qi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale,
                                acc[4 * j + 2 * h + 1] * scale);
  }
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* klen, const void* lse, const void* delta,
                   const void* dout, void* dq, int B, int H, int Hkv, int Tq,
                   int Tk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc = hopper::map_bf16_3d(&mq, q, B * H, Tq, D, WQ);
  if (rc == 0) rc = hopper::map_bf16_3d(&mdo, dout, B * H, Tq, D, WQ);
  if (rc == 0) rc = hopper::map_bf16_3d(&mk, k, B * Hkv, Tk, D, WK);
  if (rc == 0) rc = hopper::map_bf16_3d(&mv, v, B * Hkv, Tk, D, WK);
  if (rc != 0) return rc;
  const size_t smem = sizeof(DqSmem<D>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + WQ - 1) / WQ);
  flash_bwd_dq_wgmma_kernel<D><<<grid, NT, smem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta,
      (const int*)klen, (bf16*)dq, H, Hkv, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

bool args_ok(int B, int H, int Hkv, int Tq, int Tk) {
  return B >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && Tq >= 1 && Tk >= 1;
}

}  // namespace

// q/dout/dq [B*H, Tq, D], k/v/dk/dv [B*Hkv, Tk, D], klen int32 [B], lse and
// delta float32 [B*H, Tq]; dtype 0 = float32, 1 = bfloat16.  Each returns
// the CUDA error of its launch (0 on success), -1 for arguments the kernel
// does not take, or -2 when the CUDA driver gives no TMA tensor map.
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* klen, const void* lse,
                               const void* delta, const void* dout, void* dq,
                               int B, int H, int Hkv, int Tq, int Tk, int D,
                               int dtype, int causal, float scale,
                               void* stream) {
  if (!args_ok(B, H, Hkv, Tq, Tk)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch_dq_f32<64>(q, k, v, klen, lse, delta, dout, dq, B, H, Hkv,
                             Tq, Tk, causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch_dq_f32<128>(q, k, v, klen, lse, delta, dout, dq, B, H,
                              Hkv, Tq, Tk, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch_dq_bf16<64>(q, k, v, klen, lse, delta, dout, dq, B, H, Hkv,
                              Tq, Tk, causal, scale, s);
  if (dtype == 1 && D == 128)
    return launch_dq_bf16<128>(q, k, v, klen, lse, delta, dout, dq, B, H,
                               Hkv, Tq, Tk, causal, scale, s);
  return -1;
}

extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* klen, const void* lse,
                                const void* delta, const void* dout,
                                void* dk, void* dv, int B, int H, int Hkv,
                                int Tq, int Tk, int D, int dtype, int causal,
                                float scale, void* stream) {
  if (!args_ok(B, H, Hkv, Tq, Tk)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch_dkv_f32<64>(q, k, v, klen, lse, delta, dout, dk, dv, B, H,
                              Hkv, Tq, Tk, causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch_dkv_f32<128>(q, k, v, klen, lse, delta, dout, dk, dv, B, H,
                               Hkv, Tq, Tk, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch_dkv_bf16<64>(q, k, v, klen, lse, delta, dout, dk, dv, B,
                               H, Hkv, Tq, Tk, causal, scale, s);
  if (dtype == 1 && D == 128)
    return launch_dkv_bf16<128>(q, k, v, klen, lse, delta, dout, dk, dv, B,
                                H, Hkv, Tq, Tk, causal, scale, s);
  return -1;
}
