// Flash-attention forward for Hopper (sm_90a): bf16 on tensor cores
// (wgmma), float32 on CUDA cores.
//
// Replaces paddle_tpu/ops/attention.py:52 _flash_kernel, which the JAX
// package launches from _flash_forward (:356, pallas_call at :390).  It
// computes the same function: S = (Q K^T) scale; the running max, sum and
// accumulator are float32; GQA maps query row bh to K/V row
// (bh / H) * Hkv + (bh % H) / (H / Hkv) with no copies of K/V heads; each
// batch row has its own valid key length k_len; the causal mask is
// end-aligned at Tk - Tq (a decode query sees the whole prefix); whole key
// tiles past k_len or the causal frontier are skipped; ragged Tq and Tk
// are masked here, not padded by the caller.  The output is in q's dtype,
// the per-row logsumexp in float32 (natural log) as [B*H, Tq] (the 8-lane
// broadcast of the TPU layout is dropped).  A row with no valid key
// returns zeros and logsumexp -1e30, as the JAX kernel's empty loop does.
//
// What bounds it on this card: the transformer training step (B=32, H=8,
// T=256, D=64, bf16 under AMP) moves ~34 MB for ~4.3 GFLOP, so it is bound
// by bytes (10 us at 3.35 TB/s) once the products run on the bf16 tensor
// cores (4.3 us at 989 TFLOP/s); the served llama_1b shape (B=4, H=16,
// Hkv=8, T=2048, D=128, causal) does ~69 GFLOP on ~200 MB and is bound by
// operations: bf16 tensor cores, or float32 FMAs on CUDA cores (67 TFLOP/s)
// for float32 inputs.
//
// bf16, flash_fwd_wgmma_kernel<D> (D = 64, 128): one warpgroup of 128
// threads per (64-row query tile, b*h).  Thread 0 issues TMA copies: the Q
// tile once, K/V tiles of 64 keys into a 2-stage ring under mbarriers
// (full: the bytes arrived; empty: all 128 threads are done with the
// stage), so the next tile's copy runs under this tile's products.
// S = Q K^T is wgmma with both operands K-major in shared memory; scale
// and the masks apply to the float32 accumulator fragment in registers;
// the online softmax reduces each row over the 4 threads that hold it
// (exp2 with log2(e) folded into the scale); O += P V is wgmma with A = P
// from registers and B = V MN-major (tnspB = 1).  P goes in as two bf16
// terms, hi = bf16(P) and lo = bf16(P - hi), one product each: a single
// bf16 rounding of P leaves rows with few valid keys (early causal rows)
// unaveraged, and there misses the float32 reference by more than the
// bf16 check's atol of 1e-3 (tests/test_torch_flash_wgmma_numerics.py
// shows it on the emulated arithmetic); hi + lo keeps P to ~2^-17 for a
// third more tensor-core work.  Interior tiles skip the mask.  ptxas
// gives 106 registers at D=64 and 153 at D=128, no spills.  Not yet used:
// warp specialisation (a producer warp and two consumer warpgroups),
// setmaxnreg, overlapping the softmax of one tile with the next tile's
// Q K^T, a persistent grid, and a TMA store of O.
//
// float32, flash_fwd_kernel<D> (the CUDA-core design): one block of 128 threads
// per (64-row query tile, b*h); K/V tiles of 32 keys are staged in shared
// memory as float32 and reused by all 64 query rows, and each thread keeps a
// 4x4 patch of S and an 8 x D/16 patch of the output accumulator in registers
// (2 and 4 FMAs per shared-memory load).  Padded shared-memory strides keep the
// column walks free of bank conflicts.  Query tiles are issued heaviest first,
// so causal blocks finish together.  The tiles need 75 KB of shared memory at
// D=128, above the 48 KB static limit, so they are dynamic and the launch
// raises the kernel's limit first.  A tensor-core float32 design (TF32 or a
// 3xTF32 split) would change the float32 parity gates, and is not attempted
// here.
#include "hopper_mma.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 32;    // keys per shared-memory tile (float32 kernel)
constexpr int NT = 128;   // threads per block
constexpr float NEG = -1e30f;

// ------------------------------------------------- float32, CUDA cores

template <int D>
constexpr size_t smem_floats() {
  return BQ * (D + 1)      // Q, scaled
         + BK * (D + 1)    // K
         + BK * D          // V
         + BQ * (BK + 1)   // S, then P
         + 3 * BQ;         // running max, running sum, rescale factor
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ klen,
                 float* __restrict__ out, float* __restrict__ lse, int H,
                 int Hkv, int Tq, int Tk, int causal, float scale) {
  constexpr int QS = D + 1, KS = D + 1, VS = D, SS = BK + 1;
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ss = Vs + BK * VS;
  float* m_s = Ss + BQ * SS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;

  const float* qp = q + (size_t)bh * Tq * D;
  const float* kp = k + (size_t)kvh * Tk * D;
  const float* vp = v + (size_t)kvh * Tk * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, qi = q0 + r;
    Qs[r * QS + c] = qi < Tq ? qp[(size_t)qi * D + c] * scale : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  // keys any row of this tile may see: below k_len and, when causal, at
  // or before the last row's end-aligned frontier
  int kend = kl;
  if (causal) kend = min(kend, max(0, min(q0 + BQ, Tq) + offset));
  const int ntiles = (kend + BK - 1) / BK;

  const int sr = tid / 8, sc = tid % 8;    // S patch: rows sr*4+i, cols sc+8j
  const int pr = tid / 16, pc = tid % 16;  // O patch: rows pr*8+i, cols pc+16j
  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D, ki = k0 + r;
      const bool in = ki < Tk;
      Ks[r * KS + c] = in ? kp[(size_t)ki * D + c] : 0.f;
      Vs[r * VS + c] = in ? vp[(size_t)ki * D + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(sr * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(sc + 8 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sr * 4 + i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sc + 8 * j, ki = k0 + c;
        const bool valid =
            ki < kl && qi < Tq && (!causal || ki <= qi + offset);
        Ss[r * SS + c] = valid ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    {  // online softmax update: two threads per row, 16 columns each
      const int r = tid >> 1, half = tid & 1;
      float* row = Ss + r * SS + half * 16;
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mt = fmaxf(mt, row[c]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mt);  // finite: m_old >= NEG
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);  // masked: exp(-inf) = 0
        row[c] = p;
        ls += p;
      }
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      if (half == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + ls;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float alpha = a_s[pr * 8 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[8], vv[CPT];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = Ss[(pr * 8 + i) * SS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = Vs[kk * VS + pc + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = pr * 8 + i, qi = q0 + r;
    if (qi >= Tq) continue;
    const float l = l_s[r];
    float* op = out + ((size_t)bh * Tq + qi) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      op[pc + 16 * j] = l > 0.f ? acc[i][j] / l : 0.f;
  }
  if (tid < BQ && q0 + tid < Tq) {
    const float l = l_s[tid];
    lse[(size_t)bh * Tq + q0 + tid] = l > 0.f ? m_s[tid] + logf(l) : NEG;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* klen,
               void* out, void* lse, int B, int H, int Hkv, int Tq, int Tk,
               int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)klen,
      (float*)out, (float*)lse, H, Hkv, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------------- bf16, tensor cores

constexpr int WK = 64;       // keys per tile (wgmma kernel)
constexpr int STAGES = 2;    // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// one [rows x 64] bf16 region of a tile in the 128-byte swizzle
template <int ROWS>
using Chunk = bf16[ROWS * 64];

template <int D>
struct FwdSmem {
  Chunk<BQ> q[D / 64];
  Chunk<WK> k[STAGES][D / 64];
  Chunk<WK> v[STAGES][D / 64];
  uint64_t qbar, full[STAGES], empty[STAGES];
};

// thread 0: K/V tile t of head kvh into stage s
template <int D>
__device__ __forceinline__ void load_kv(FwdSmem<D>& sm, const CUtensorMap* tk,
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
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const int* __restrict__ klen, bf16* __restrict__ out,
                       float* __restrict__ lse, int H, int Hkv, int Tq,
                       int Tk, int causal, float scale) {
  using namespace hopper;
  constexpr int NC = D / 64;  // 64-column chunks of a row
  extern __shared__ uint8_t smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(align_1024(smem_raw));

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;
  int kend = kl;
  if (causal) kend = min(kend, max(0, min(q0 + BQ, Tq) + offset));
  const int ntiles = (kend + WK - 1) / WK;

  if (tid == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NT);
    }
    mbar_fence_init();
    if (ntiles > 0) {
      mbar_expect_tx(&sm.qbar, BQ * D * sizeof(bf16));
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load_3d(sm.q[c], &tq, &sm.qbar, 64 * c, q0, bh);
      for (int s = 0; s < STAGES && s < ntiles; ++s)
        load_kv(sm, &tk, &tv, kvh, s, s);
    }
  }
  __syncthreads();

  // this thread's two rows of the tile: acc_row(i) is r0 + 8 ((i >> 1) & 1)
  const int r0 = acc_row(0);
  const float sl2 = scale * LOG2E;  // softmax in base 2
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's columns

  if (ntiles > 0) mbar_wait(&sm.qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES, ph = (t / STAGES) & 1;
    const int k0 = t * WK;
    mbar_wait(&sm.full[s], ph);

    float sacc[WK / 2];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int c = kc / 4, off = (kc % 4) * 16;
      wgmma_ss<0>(sacc, make_desc(sm.q[c] + off, 16, 1024),
                  make_desc(sm.k[s][c] + off, 16, 1024), kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // scale, mask (tiles that straddle k_len or the causal frontier of
    // the tile's first row; rows past Tq read zeros and are never
    // stored), row max over the 4 threads of a row
    const bool interior =
        k0 + WK <= kl && (!causal || k0 + WK - 1 <= q0 + offset);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < WK / 2; ++i) {
      float x = sacc[i] * sl2;
      if (!interior) {
        const int ki = k0 + acc_col(i), qi = q0 + acc_row(i);
        if (!(ki < kl && (!causal || ki <= qi + offset))) x = -INFINITY;
      }
      sacc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);  // finite: m >= NEG
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < WK / 2; ++i) {
      const int h = (i >> 1) & 1;
      const float p = exp2f(sacc[i] - m[h]);  // masked: exp2(-inf) = 0
      sacc[i] = p;
      l[h] += p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // O += P V with P in two bf16 terms (hi + lo)
    uint32_t phi[WK / 16][4], plo[WK / 16][4];
    acc_to_a_split(sacc, phi, plo);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      const uint64_t dv =
          make_desc(sm.v[s][0] + kk * 16 * 64, WK * 128, 1024);
      wgmma_rs<1>(o, phi[kk], dv, 1);
      wgmma_rs<1>(o, plo[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    mbar_arrive(&sm.empty[s]);
    if (tid == 0 && t + STAGES < ntiles) {
      mbar_wait(&sm.empty[s], ph);
      load_kv(sm, &tk, &tv, kvh, t + STAGES, s);
    }
  }

  const int cq = 2 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int qi = q0 + r0 + 8 * h;
    if (qi >= Tq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    bf16* op = out + ((size_t)bh * Tq + qi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                o[4 * j + 2 * h + 1] * inv);
    if (tid % 4 == 0)
      lse[(size_t)bh * Tq + qi] =
          l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : NEG;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* klen, void* out, void* lse, int B, int H,
                int Hkv, int Tq, int Tk, int causal, float scale,
                cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = hopper::map_bf16_3d(&mq, q, B * H, Tq, D, BQ);
  if (rc == 0) rc = hopper::map_bf16_3d(&mk, k, B * Hkv, Tk, D, WK);
  if (rc == 0) rc = hopper::map_bf16_3d(&mv, v, B * Hkv, Tk, D, WK);
  if (rc != 0) return rc;
  const size_t smem = sizeof(FwdSmem<D>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_wgmma_kernel<D><<<grid, NT, smem, stream>>>(
      mq, mk, mv, (const int*)klen, (bf16*)out, (float*)lse, H, Hkv, Tq, Tk,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B*H, Tq, D], k/v [B*Hkv, Tk, D], klen int32 [B], out like q,
// lse float32 [B*H, Tq]; dtype 0 = float32, 1 = bfloat16.  Returns the
// CUDA error of the launch (0 on success), -1 for arguments the kernel
// does not take, or -2 when the CUDA driver gives no TMA tensor map.
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            const void* klen, void* out, void* lse, int B,
                            int H, int Hkv, int Tq, int Tk, int D, int dtype,
                            int causal, float scale, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Tq < 1 || Tk < 1)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, klen, out, lse, B, H, Hkv, Tq, Tk,
                          causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, klen, out, lse, B, H, Hkv, Tq, Tk,
                           causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, klen, out, lse, B, H, Hkv, Tq, Tk,
                           causal, scale, s);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, klen, out, lse, B, H, Hkv, Tq, Tk,
                            causal, scale, s);
  return -1;
}
