// Flash attention on CUDA cores: forward (out, LSE), dQ and dK/dV, bf16
// and float32, any D % 8 == 0 up to 256.  No path of the port runs these
// kernels: every D % 8 == 0 up to 256 runs the tensor-core forward of
// csrc/flash_fwd.cu and the tensor-core backward of csrc/flash_bwd.cu
// (padded to 64, 128 or 256; the float32 backward above 128 in clusters
// of two blocks that split D).  They stay built for timing only:
// chip_smoke.py times them (the earlier design) beside the tensor-core
// kernels that replaced them, the forward at D = 96 and 256, the backward
// at D = 96, at the training llama's D = 128 and at D = 256, and the card
// tests check them against the plain version.
//
// The JAX package tiles every D % 8 == 0 in Pallas (paddle_tpu/ops/
// attention.py:304-307): _flash_kernel (:52, K1), _flash_dq_kernel (:125,
// K2) and _flash_dkv_kernel (:220, K3) take any such D.
// Each kernel here is templated on a padded width DP in {32, 64, 128, 256}
// and takes the true D at run time: the tiles hold DP columns, columns >= D
// are loaded as zeros (so they add nothing to Q K^T or dO V^T) and never
// stored.  They keep the masks of K1-K3: k_pos < k_len, the causal mask
// end-aligned at Tk - Tq, GQA by row map (query head h reads KV head
// h / (H / Hkv) of its batch row, no copies), and a row with no valid key
// gets a zero output, LSE -1e30 and zero gradients.
//
// Design (correct before fast): a block of 128 threads per (b*H, 64-row
// query tile) for the forward and dQ, per (b*Hkv, 32-key tile) for dK/dV,
// the tiles staged as float32 in shared memory (bf16 converted on load,
// which is exact) with padded strides.  Every product is a float32 FMA on
// the CUDA cores, so bf16 inputs give float32 sums of exact products, as
// the plain version computes them; outputs are rounded once to the input
// dtype.  S and dP are 4x4 patches a thread (rows sr*4+i, keys sc+8j); the
// forward keeps its online-softmax row statistics replicated over the 8
// threads of a row and reduces a tile's row max and sum with warp
// shuffles.  Whole key tiles past k_len or the causal frontier, and query
// tiles before it, are skipped.  dQ keeps an 8 x DP/16 patch of its
// accumulator a thread, dK/dV two 4 x DP/16 patches; the tiles need 116 KB
// of shared memory at DP = 128, above the 48 KB static limit, so they are
// dynamic and each launch raises the limit first: one block (4 warps) an
// SM, so a tile's loads are latency-bound, and K with V (Q with dO) are
// loaded in one loop to keep two loads in flight (one loop each ran dK/dV
// 26% slower at llama_1b's shape).
//
// What bounds it: operations, float32 FMAs at 67 TFLOP/s.  Per valid
// (query, key) pair the forward does 4 D FLOPs (Q K^T, P V), dQ 6 D (S, dP,
// dS K) and dK/dV 8 D (S, dP, P^T dO, dS^T Q); the kernels do them over
// the padded width DP (D/DP of the work is useful: 3/4 at D = 96).  Not
// yet used: tensor cores, double buffering, a persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 32;   // keys per tile
constexpr int NT = 128;  // threads per block
constexpr float NEG = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float ld(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// rows r0..r0+ROWS of a [T, D] slab into shared memory as float32 x mul,
// with row stride DP+1; rows past T and columns past D are zero
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_rows(const T* src, int r0, int Tn, int D,
                                          float mul, float* dst) {
  for (int e = threadIdx.x; e < ROWS * DP; e += NT) {
    const int r = e / DP, c = e % DP, ri = r0 + r;
    dst[r * (DP + 1) + c] =
        (ri < Tn && c < D) ? ld(src, (size_t)ri * D + c) * mul : 0.f;
  }
}

// the same rows of two slabs (K and V, or Q and dO) in one loop, the
// first times mul: two loads in flight where one loop each would have one
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_rows2(const T* a, const T* b, int r0,
                                           int Tn, int D, float mul,
                                           float* da, float* db) {
  for (int e = threadIdx.x; e < ROWS * DP; e += NT) {
    const int r = e / DP, c = e % DP, ri = r0 + r;
    const bool in = ri < Tn && c < D;
    const size_t i = (size_t)ri * D + c;
    da[r * (DP + 1) + c] = in ? ld(a, i) * mul : 0.f;
    db[r * (DP + 1) + c] = in ? ld(b, i) : 0.f;
  }
}

// ---------------------------------------------------------------- forward

template <int DP>
constexpr size_t fwd_smem_floats() {
  return BQ * (DP + 1)        // Q (scaled)
         + 2 * BK * (DP + 1)  // K, V
         + BQ * (BK + 1)      // P
         + 3 * BQ;            // alpha, l, m
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_fwd_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ klen,
                    T* __restrict__ out, float* __restrict__ lse, int H,
                    int Hkv, int Tq, int Tk, int D, int causal, float scale) {
  constexpr int QS = DP + 1, SS = BK + 1, CPT = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * QS;
  float* alpha_s = Ps + BQ * SS;
  float* l_s = alpha_s + BQ;
  float* m_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;

  load_rows<T, DP, BQ>(q + (size_t)bh * Tq * D, q0, Tq, D, scale, Qs);
  const T* kp = k + (size_t)kvh * Tk * D;
  const T* vp = v + (size_t)kvh * Tk * D;
  int kend = kl;
  if (causal) kend = min(kend, max(0, min(q0 + BQ, Tq) + offset));
  const int ntiles = (kend + BK - 1) / BK;

  const int sr = tid / 8, sc = tid % 8;    // S patch: rows sr*4+i, keys sc+8j
  const int pr = tid / 16, pc = tid % 16;  // O patch: rows pr*8+i, cols pc+16j
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG;
    l_run[i] = 0.f;
  }
  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P reads are done
    load_rows2<T, DP, BK>(kp, vp, k0, Tk, D, 1.f, Ks, Vs);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    // over the padded width: columns >= D are zeros and add nothing, and
    // the constant bound unrolls as a fixed-width kernel's does
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(sr * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(sc + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sr * 4 + i, qi = q0 + r;
      bool valid[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + sc + 8 * j;
        valid[j] = ki < kl && qi < Tq && (!causal || ki <= qi + offset);
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads of a row are lanes that differ in their low 3 bits
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * SS + sc + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
      if (sc == 0) alpha_s[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = alpha_s[pr * 8 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[8], vv[CPT];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = Ps[(pr * 8 + i) * SS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = Vs[kk * QS + pc + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  if (sc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l_s[sr * 4 + i] = l_run[i];
      m_s[sr * 4 + i] = m_run[i];
    }
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < Tq) {
    const float l = l_s[tid];
    lse[(size_t)bh * Tq + q0 + tid] = l > 0.f ? m_s[tid] + logf(l) : NEG;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = pr * 8 + i, qi = q0 + r;
    if (qi >= Tq) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const size_t row = ((size_t)bh * Tq + qi) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = pc + 16 * j;
      if (c < D) st(out, row + c, acc[i][j] * inv);
    }
  }
}

// --------------------------------------------------------------- backward

// Q (pre-scaled), dO, LSE and delta of query rows q0..q0+BQ
template <typename T, int DP>
__device__ __forceinline__ void load_q_tile(const T* qp, const T* dop,
                                            const float* lsep,
                                            const float* dlp, int q0, int Tq,
                                            int D, float scale, float* Qs,
                                            float* dOs, float* lse_s,
                                            float* dl_s) {
  load_rows2<T, DP, BQ>(qp, dop, q0, Tq, D, scale, Qs, dOs);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const bool in = q0 + r < Tq;
    lse_s[r] = in ? lsep[q0 + r] : 0.f;
    dl_s[r] = in ? dlp[q0 + r] : 0.f;
  }
}

// P and dS of the (BQ x BK) tile at (q0, k0), as flash_bwd.cu's p_ds_tile
template <int DP>
__device__ __forceinline__ void p_ds_tile(const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs,
                                          const float* lse_s,
                                          const float* dl_s, int q0, int k0,
                                          int Tq, int kl, int causal,
                                          int offset, float* Ps, float* dSs) {
  constexpr int QS = DP + 1, SS = BK + 1;
  const int sr = threadIdx.x / 8, sc = threadIdx.x % 8;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  // over the padded width, as the forward's S
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = Qs[(sr * 4 + i) * QS + d];
      da[i] = dOs[(sr * 4 + i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = Ks[(sc + 8 * j) * QS + d];
      vb[j] = Vs[(sc + 8 * j) * QS + d];
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

template <int DP>
constexpr size_t dq_smem_floats() {
  return 2 * BQ * (DP + 1)    // Q (scaled), dO
         + 2 * BK * (DP + 1)  // K, V
         + BQ * (BK + 1)      // dS
         + 2 * BQ;            // LSE, delta
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ klen,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const T* __restrict__ dout, T* __restrict__ dq, int H,
                       int Hkv, int Tq, int Tk, int D, int causal,
                       float scale) {
  constexpr int QS = DP + 1, SS = BK + 1, CPT = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * QS;
  float* Ks = dOs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* dSs = Vs + BK * QS;
  float* lse_s = dSs + BQ * SS;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;

  load_q_tile<T, DP>(q + (size_t)bh * Tq * D, dout + (size_t)bh * Tq * D,
                     lse + (size_t)bh * Tq, delta + (size_t)bh * Tq, q0, Tq,
                     D, scale, Qs, dOs, lse_s, dl_s);
  const T* kp = k + (size_t)kvh * Tk * D;
  const T* vp = v + (size_t)kvh * Tk * D;
  int kend = kl;
  if (causal) kend = min(kend, max(0, min(q0 + BQ, Tq) + offset));
  const int ntiles = (kend + BK - 1) / BK;

  const int pr = tid / 16, pc = tid % 16;
  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_rows2<T, DP, BK>(kp, vp, k0, Tk, D, 1.f, Ks, Vs);
    __syncthreads();
    p_ds_tile<DP>(Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, Tq, kl, causal,
                  offset, nullptr, dSs);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[8], kv[CPT];
#pragma unroll
      for (int i = 0; i < 8; ++i) dsv[i] = dSs[(pr * 8 + i) * SS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[kk * QS + pc + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + pr * 8 + i;
    if (qi >= Tq) continue;
    const size_t row = ((size_t)bh * Tq + qi) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = pc + 16 * j;
      if (c < D) st(dq, row + c, acc[i][j] * scale);
    }
  }
}

template <int DP>
constexpr size_t dkv_smem_floats() {
  return 2 * BK * (DP + 1)    // K, V
         + 2 * BQ * (DP + 1)  // Q (scaled), dO
         + 2 * BQ * (BK + 1)  // P, dS
         + 2 * BQ;            // LSE, delta
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ klen,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const T* __restrict__ dout, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                        int D, int causal, float scale) {
  constexpr int QS = DP + 1, SS = BK + 1, CPT = DP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * QS;
  float* Qs = Vs + BK * QS;
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

  const int pr = tid / 16, pc = tid % 16;  // keys pr*4+i (pr < 8), cols pc+16j
  float ak[4][CPT], av[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) ak[i][j] = av[i][j] = 0.f;

  if (k0 < kl) {  // else every key of the tile is masked: zero gradients
    load_rows2<T, DP, BK>(k + (size_t)bkv * Tk * D, v + (size_t)bkv * Tk * D,
                          k0, Tk, D, 1.f, Ks, Vs);
    const int q_first = causal ? max(0, k0 - offset) : 0;
    for (int gi = 0; gi < g; ++gi) {
      const int bh = b * H + hk * g + gi;
      for (int q0 = (q_first / BQ) * BQ; q0 < Tq; q0 += BQ) {
        __syncthreads();
        load_q_tile<T, DP>(q + (size_t)bh * Tq * D,
                           dout + (size_t)bh * Tq * D, lse + (size_t)bh * Tq,
                           delta + (size_t)bh * Tq, q0, Tq, D, scale, Qs,
                           dOs, lse_s, dl_s);
        __syncthreads();
        p_ds_tile<DP>(Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, Tq, kl, causal,
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
      const int c = pc + 16 * j;
      if (c < D) {
        st(dk, row + c, ak[i][j]);
        st(dv, row + c, av[i][j]);
      }
    }
  }
}

// ----------------------------------------------------------------- launch

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP>
int fwd(const void* q, const void* k, const void* v, const void* klen,
        void* out, void* lse, int B, int H, int Hkv, int Tq, int Tk, int D,
        int causal, float scale, cudaStream_t s) {
  const size_t smem = fwd_smem_floats<DP>() * sizeof(float);
  int rc = prepare(flash_fwd_cc_kernel<T, DP>, smem);
  if (rc) return rc;
  flash_fwd_cc_kernel<T, DP><<<dim3(B * H, (Tq + BQ - 1) / BQ), NT, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)klen, (T*)out,
      (float*)lse, H, Hkv, Tq, Tk, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int dq(const void* q, const void* k, const void* v, const void* klen,
       const void* lse, const void* delta, const void* dout, void* dqp,
       int B, int H, int Hkv, int Tq, int Tk, int D, int causal, float scale,
       cudaStream_t s) {
  const size_t smem = dq_smem_floats<DP>() * sizeof(float);
  int rc = prepare(flash_bwd_dq_cc_kernel<T, DP>, smem);
  if (rc) return rc;
  flash_bwd_dq_cc_kernel<T, DP>
      <<<dim3(B * H, (Tq + BQ - 1) / BQ), NT, smem, s>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)klen,
          (const float*)lse, (const float*)delta, (const T*)dout, (T*)dqp, H,
          Hkv, Tq, Tk, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int dkv(const void* q, const void* k, const void* v, const void* klen,
        const void* lse, const void* delta, const void* dout, void* dkp,
        void* dvp, int B, int H, int Hkv, int Tq, int Tk, int D, int causal,
        float scale, cudaStream_t s) {
  const size_t smem = dkv_smem_floats<DP>() * sizeof(float);
  int rc = prepare(flash_bwd_dkv_cc_kernel<T, DP>, smem);
  if (rc) return rc;
  flash_bwd_dkv_cc_kernel<T, DP>
      <<<dim3(B * Hkv, (Tk + BK - 1) / BK), NT, smem, s>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)klen,
          (const float*)lse, (const float*)delta, (const T*)dout, (T*)dkp,
          (T*)dvp, H, Hkv, Tq, Tk, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int occupancy(Kernel kernel, size_t smem, int* smem_out, int* blocks) {
  *smem_out = (int)smem;
  int rc = prepare(kernel, smem);
  if (rc) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            NT, smem);
}

template <typename T, int DP>
int bwd_occupancy(int kind, int* smem, int* blocks) {
  return kind == 0 ? occupancy(flash_bwd_dq_cc_kernel<T, DP>,
                               dq_smem_floats<DP>() * sizeof(float), smem,
                               blocks)
                   : occupancy(flash_bwd_dkv_cc_kernel<T, DP>,
                               dkv_smem_floats<DP>() * sizeof(float), smem,
                               blocks);
}

// the padded width of a head dim, or 0 when these kernels do not take it
int padded(int D) {
  if (D < 8 || D % 8 != 0 || D > 256) return 0;
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

bool args_ok(int B, int H, int Hkv, int Tq, int Tk, int D, int dtype) {
  return B >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && Tq >= 1 &&
         Tk >= 1 && padded(D) != 0 && (dtype == 0 || dtype == 1);
}

}  // namespace

#define PT_CC_DISPATCH(FN, ...)                                        \
  switch (padded(D) * 2 + dtype) {                                     \
    case 64: return FN<float, 32>(__VA_ARGS__);                        \
    case 65: return FN<bf16, 32>(__VA_ARGS__);                         \
    case 128: return FN<float, 64>(__VA_ARGS__);                       \
    case 129: return FN<bf16, 64>(__VA_ARGS__);                        \
    case 256: return FN<float, 128>(__VA_ARGS__);                      \
    case 257: return FN<bf16, 128>(__VA_ARGS__);                       \
    case 512: return FN<float, 256>(__VA_ARGS__);                      \
    case 513: return FN<bf16, 256>(__VA_ARGS__);                       \
    default: return -1;                                                \
  }

// Shapes and layouts as pt_flash_fwd / pt_flash_bwd_dq / pt_flash_bwd_dkv
// (csrc/flash_fwd.cu, csrc/flash_bwd.cu); D any multiple of 8 up to 256;
// dtype 0 = float32, 1 = bfloat16.  Each returns the CUDA error of its
// launch (0 on success) or -1 for arguments the kernels do not take.
extern "C" int pt_flash_cc_fwd(const void* q, const void* k, const void* v,
                               const void* klen, void* out, void* lse, int B,
                               int H, int Hkv, int Tq, int Tk, int D,
                               int dtype, int causal, float scale,
                               void* stream) {
  if (!args_ok(B, H, Hkv, Tq, Tk, D, dtype)) return -1;
  PT_CC_DISPATCH(fwd, q, k, v, klen, out, lse, B, H, Hkv, Tq, Tk, D, causal,
                 scale, (cudaStream_t)stream)
}

extern "C" int pt_flash_cc_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* klen,
                                  const void* lse, const void* delta,
                                  const void* dout, void* dqp, int B, int H,
                                  int Hkv, int Tq, int Tk, int D, int dtype,
                                  int causal, float scale, void* stream) {
  if (!args_ok(B, H, Hkv, Tq, Tk, D, dtype)) return -1;
  PT_CC_DISPATCH(dq, q, k, v, klen, lse, delta, dout, dqp, B, H, Hkv, Tq, Tk,
                 D, causal, scale, (cudaStream_t)stream)
}

extern "C" int pt_flash_cc_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* klen,
                                   const void* lse, const void* delta,
                                   const void* dout, void* dkp, void* dvp,
                                   int B, int H, int Hkv, int Tq, int Tk,
                                   int D, int dtype, int causal, float scale,
                                   void* stream) {
  if (!args_ok(B, H, Hkv, Tq, Tk, D, dtype)) return -1;
  PT_CC_DISPATCH(dkv, q, k, v, klen, lse, delta, dout, dkp, dvp, B, H, Hkv,
                 Tq, Tk, D, causal, scale, (cudaStream_t)stream)
}

// The shared memory a backward launch asks for at head dim D and dtype, for
// the dQ kernel (kind 0) or the dK/dV kernel (kind 1), and how many such
// blocks an SM holds, as the CUDA runtime reports them; 0 on success.
extern "C" int pt_flash_cc_occupancy(int D, int dtype, int kind, int* smem,
                                     int* blocks) {
  if (padded(D) == 0 || (dtype != 0 && dtype != 1) ||
      (kind != 0 && kind != 1))
    return -1;
  PT_CC_DISPATCH(bwd_occupancy, kind, smem, blocks)
}
