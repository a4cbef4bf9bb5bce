// Flash-attention forward for Hopper (sm_90a) on tensor cores: bf16 through
// bf16 wgmma, float32 through TF32 wgmma in a 3xTF32 split.
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
// Hkv=8, T=2048, D=128, causal, float32) does ~69 GFLOP on ~200 MB and is
// bound by operations: 3xTF32 runs three TF32 products for each float32
// one, 3 x 68.75 GFLOP at 495 TFLOP/s = 0.417 ms (float32 FMAs on CUDA
// cores, 67 TFLOP/s, would take 1.026 ms).  The served llama at GPT-J-6B's
// widths (B=4, H=16 / 16, T=2048, D=256, causal) does 137.5 GFLOP: 0.139 ms
// on the bf16 tensor cores, 0.833 ms as 3xTF32.
//
// bf16, flash_fwd_wgmma_kernel<D, PADDED, KC> (D = 64, 128, 256): one
// warpgroup of 128 threads per (64-row query tile, b*h).  Thread 0 issues
// TMA copies: the Q
// tile once, K/V tiles of 64 keys into a 2-stage ring under mbarriers (full:
// the bytes arrived; empty: all 128 threads are done with the stage), so the
// next tile's copy runs under this tile's products. S = Q K^T is wgmma with
// both operands K-major in shared memory; scale and the masks apply to the
// float32 accumulator fragment in registers; the online softmax reduces each
// row over the 4 threads that hold it (exp2 with log2(e) folded into the
// scale); O += P V is wgmma with A = P from registers and B = V MN-major
// (tnspB = 1).  P goes in as two bf16 terms, hi = bf16(P) and lo = bf16(P -
// hi), one product each: a single bf16 rounding of P leaves rows with few
// valid keys (early causal rows) unaveraged, and there misses the float32
// reference by more than the bf16 check's atol of 1e-3
// (tests/test_torch_flash_wgmma_numerics.py shows it on the emulated
// arithmetic); hi + lo keeps P to ~2^-17 for a third more tensor-core work.
// Interior tiles skip the mask.  ptxas gives 106 registers at D=64, 153 at
// D=128 and 218 at D = 256, no spills.  At D = 256 the output accumulator
// is 128 registers a thread and P V one m64n256k16 product a k16 slice and
// term (V's four 64-column chunks LBO apart); Q 32 KB and the K/V ring 128
// KB make 164,904 bytes a block, one block an SM (82,984 and two at D =
// 128).  Not yet used: warp specialisation (a producer warp and
// two consumer warpgroups), setmaxnreg, overlapping the softmax of one tile
// with the next tile's Q K^T, a persistent grid, and a TMA store of O.
//
// float32, flash_fwd_tf32x3_kernel<D, PADDED, KC> (D = 64, 128): the same block
// shape, order of query tiles, masks and online softmax, with every product on
// the TF32 tensor cores as three: x y ~ x_hi y_hi + x_hi y_lo + x_lo y_hi,
// where x_hi = tf32(x) and x_lo = tf32(x - x_hi), both rounded to nearest
// (cvt.rna; the tensor cores would truncate an unrounded float32, and a lo
// taken from a rounded hi would then be off by up to a TF32 unit). hi + lo
// keeps x to ~2^-22 and the dropped lo x lo term is ~2^-22 of x y, so S and O
// keep float32's order of error and the float32 gates (rtol 1e-4, atol 1e-5
// against the plain version; served logits within 1e-4 of max |logit| of the
// CPU's) hold unchanged; one TF32 product (~2^-11) would miss them
// (tests/test_torch_flash_tf32x3_numerics.py emulates both).  What float32
// forces:
//  - both wgmma operands K-major (no transpose for .tf32): Q K^T reads Q
//    and K as they are; for P V the block stages V^T, keys contiguous;
//  - the split: TMA lands Q and each K/V tile as float32 (32 values to a
//    128-byte swizzle row, k8 products); the 128 threads round Q once into
//    Q_hi in place and Q_lo, and each tile's K into K_hi, K_lo and its V
//    into V^T_hi, V^T_lo (lane = key, so a warp writes whole V^T rows
//    without bank conflicts), then fence.proxy.async before wgmma reads
//    them (a tile's K and V are split once per query tile that reads them,
//    as the bf16 kernel copies them once per query tile);
//  - P from registers: the S fragment holds keys 2c, 2c+1 of each 8-key
//    group where the TF32 A fragment takes depth columns c, c+4, so V^T
//    is written with key 2c + e at position c + 4e of its group and the
//    split P_hi, P_lo feed wgmma without shuffles (the split helpers,
//    split_tf32, split_t and acc_to_tf32_split, are in hopper_mma.cuh,
//    shared with the float32 backward);
//  - shared memory: a float32 tile is twice a bf16 one and every operand
//    is held twice, so key tiles are 32 keys (S is m64n32), the raw K/V
//    ring (2 stages, TMA) is separate from the split copies, and V^T has
//    two split buffers: at D = 128, Q 64 KB + ring 64 KB + K 32 KB + V^T
//    64 KB = 224 KB, one block an SM (112 KB at D = 64, which also leaves
//    one block an SM: two would need 48 bytes more than the SM has);
//  - the split is work the bf16 kernel does not have, and the largest
//    cost beside the products when it ran between a tile's copy and its
//    products.  Each thread
//    loads all its words of a split before it rounds and stores any, and
//    tile t+1's K and V are split while tile t's P V runs on the tensor
//    cores (V^T double-buffered, so tile t's stays whole under it); the
//    ring stage a split has read is refilled at the top of the next pass.
//    Splitting V under Q K^T instead crashes ptxas (CUDA 12.9).
// Each tile runs 6 products: Q_lo K_hi, Q_hi K_lo, Q_hi K_hi, then P_lo
// V_hi, P_hi V_lo, P_hi V_hi (small terms first).  ptxas gives 127
// registers at D = 64 and 214 at D = 128 (CUDA 12.9; the same source gave
// 128 and 221 in an earlier build), no spills.  Not yet used: a
// producer warp, two consumer warpgroups (no room for a second Q at
// D = 128), the softmax under the next tile's Q K^T, a persistent grid.
//
// float32 at width 256 (tf32x3_wide): Q's hi + lo terms alone are 128 KB,
// and the layout above would need 448 KB, so keys come in tiles of 16
// (S is m64n16k8, P V two k8 steps of m64n256k8 a term).  TMA lands K in
// K_hi, split in place into K_hi, K_lo (no raw K); the threads read the
// next tile's V rows from global memory (zeros past Tk and past D) under
// this tile's Q K^T and write them split and transposed into V^T, whose
// 32-column region pair holds two tiles (double-buffered in 64 KB); the
// next K lands under the softmax and P V and is split during P V.  Q
// 128 KB + K 32 KB + V^T 64 KB = 230,416 bytes a block, one block an SM.
// Chosen over a cluster of two blocks splitting D (partial S through
// distributed shared memory), which is more work; this one ran first and
// met the float32 check.  ptxas: 254 registers at KC = 7, 8 (D = 256
// included), 236-237 at KC = 5, 6, no spills.
//
// The other head dims (D % 8 == 0 up to 256, not 64, 128 or 256) run the
// instance of padded width DP = 64 (D < 64), DP = 128 (64 < D < 128) or
// DP = 256 (128 < D < 256; hopper::with_fwd_instance), the kernels' PADDED =
// true instances, with the true D (Dt, dd) at run time, as
// csrc/flash_bwd.cu pads the backward up to 128; D = 64, 128 and 256 are the
// PADDED = false instances (dd is the constant D there).
// Each launcher builds its TMA maps with the true D, so the box columns at or
// past D arrive as zeros, and counts their full bytes on the mbarrier, as rows
// past Tq and Tk do.  Q K^T stops at the last 32-column region that holds
// column D - 1 (KC = ceil(D / 32), a template argument; 2 KC k16 steps in
// bf16, 4 KC k8 steps in float32, of which the columns past D are TMA's
// zeros).  A run-time count put control flow among the products, which ptxas
// then serializes (C7515: the bf16 instances' first build, with a run-time k16
// count, drew it).  A float32 region wholly past D is neither loaded nor split
// (Q, K, and V^T's rows from 32 KC on), nor a bf16 64-column chunk wholly
// past 32 KC (the last chunk of width 256 at D = 136 .. 184), and the
// expected bytes count the loaded ones only. P V runs at the full width DP
// (at D = 136, 136 / 256 of it is useful work); its accumulator columns
// at or past D (from V's zero columns, or from V^T rows no split wrote) are
// never stored: the stores take the true D as row stride and stop at column D
// (D % 8 == 0 keeps each thread's pair of columns whole).  The useful work is
// D / DP of P V, and D / (32 KC) of Q K^T: 3/4 and 1 at D = 96. ptxas (sm_90a,
// -O3, CUDA 12.9), registers a thread, no spills in any instance: bf16 106
// (<64, true, 1 or 2>), 153 (<128, true, 3 or 4>) and 218 (<256, true, 5 ..
// 8>), as the unpadded instances; float32 124, 127 (KC = 1, 2 at width 64),
// 168, 214 (KC = 3, 4 at 128), 237, 236, 254, 254 (KC = 5 .. 8 at 256).
// Shared memory a block as the unpadded instance of the same width (the same
// structs): bf16 42,024 bytes at width 64 (4 blocks an SM), 82,984 at 128 (2)
// and 164,904 at 256 (1), float32 115,736, 230,424 and 230,416 (1).
#include "hopper_mma.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;    // query rows per block
constexpr int NT = 128;   // threads per block: one warpgroup
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Scale, mask and exponentiate (base 2) one key tile's S fragment in place
// (NS = keys / 2 values a thread), and advance this thread's two rows'
// running max m and partial sum l; alpha gets the factors that rescale the
// rows of the output accumulator.  Tiles that straddle k_len or the
// causal frontier of the tile's first row are masked; rows past Tq read
// zeros and are never stored.
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&sacc)[NS], float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2], int q0,
                                             int k0, int kl, int causal,
                                             int offset, float sl2) {
  using hopper::acc_col;
  using hopper::acc_row;
  constexpr int KEYS = 2 * NS;
  const bool interior =
      k0 + KEYS <= kl && (!causal || k0 + KEYS - 1 <= q0 + offset);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float x = sacc[i] * sl2;
    if (!interior) {
      const int ki = k0 + acc_col(i), qi = q0 + acc_row(i);
      if (!(ki < kl && (!causal || ki <= qi + offset))) x = -INFINITY;
    }
    sacc[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
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
  for (int i = 0; i < NS; ++i) {
    const int h = (i >> 1) & 1;
    const float p = exp2f(sacc[i] - m[h]);  // masked: exp2(-inf) = 0
    sacc[i] = p;
    l[h] += p;
  }
}

// a row's sum over the 4 threads that hold it
__device__ __forceinline__ float row_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  return l + __shfl_xor_sync(0xffffffffu, l, 2);
}

// a row's logsumexp (natural log) from its base-2 max and sum
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * LN2 : NEG;
}

// --------------------------------------------------- bf16, tensor cores

constexpr int WK = 64;       // keys per tile (wgmma kernel)
constexpr int STAGES = 2;    // K/V ring depth

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

// thread 0: K/V tile t of head kvh into stage s, its first NL 64-column
// chunks (a chunk wholly past the true head dim is not loaded: Q K^T does
// not read it, and P V's columns from it are never stored)
template <int NL, int D>
__device__ __forceinline__ void load_kv(FwdSmem<D>& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int kvh, int t,
                                        int s) {
  hopper::mbar_expect_tx(&sm.full[s], 2 * WK * 64 * NL * sizeof(bf16));
#pragma unroll
  for (int c = 0; c < NL; ++c) {
    hopper::tma_load_3d(sm.k[s][c], tk, &sm.full[s], 64 * c, t * WK, kvh);
    hopper::tma_load_3d(sm.v[s][c], tv, &sm.full[s], 64 * c, t * WK, kvh);
  }
}

// KC: Q K^T runs 2 KC k16 steps, a compile-time count (D / 16 unpadded;
// in the padded instances the steps of the 32-column regions that hold
// columns below the true head dim, whose columns past it are TMA's zeros:
// a run-time count made ptxas serialize the products, C7515)
template <int D, bool PADDED, int KC>
__global__ void __launch_bounds__(NT)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const int* __restrict__ klen, bf16* __restrict__ out,
                       float* __restrict__ lse, int H, int Hkv, int Tq,
                       int Tk, int Dt, int causal, float scale) {
  using namespace hopper;
  // 64-column chunks loaded: those holding a column below 32 KC (all of
  // them but at D = 136 .. 184, whose last chunk of width 256 is zeros)
  constexpr int NL = (KC + 1) / 2;
  extern __shared__ uint8_t smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(align_1024(smem_raw));

  static_assert(PADDED ? 2 * KC <= D / 16 : 2 * KC == D / 16,
                "k16 steps of Q K^T");
  const int tid = threadIdx.x;
  const int dd = PADDED ? Dt : D;       // the true head dim (row stride)
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
      mbar_expect_tx(&sm.qbar, BQ * 64 * NL * sizeof(bf16));
#pragma unroll
      for (int c = 0; c < NL; ++c)
        tma_load_3d(sm.q[c], &tq, &sm.qbar, 64 * c, q0, bh);
      for (int s = 0; s < STAGES && s < ntiles; ++s)
        load_kv<NL>(sm, &tk, &tv, kvh, s, s);
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
    for (int kc = 0; kc < 2 * KC; ++kc) {
      const int c = kc / 4, off = (kc % 4) * 16;
      wgmma_ss<0>(sacc, make_desc(sm.q[c] + off, 16, 1024),
                  make_desc(sm.k[s][c] + off, 16, 1024), kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    float alpha[2];
    softmax_tile(sacc, m, l, alpha, q0, k0, kl, causal, offset, sl2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // O += P V with P in two bf16 terms (hi + lo); N = D (m64n256k16 at
    // width 256, V's four chunks LBO apart)
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
      load_kv<NL>(sm, &tk, &tv, kvh, t + STAGES, s);
    }
  }

  // columns below dd only (a thread's pair of columns 8 j + cq, + 1 lies
  // below dd whenever 8 j does, as dd % 8 == 0)
  const int cq = 2 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = row_sum(l[h]);
    const int qi = q0 + r0 + 8 * h;
    if (qi >= Tq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    bf16* op = out + ((size_t)bh * Tq + qi) * dd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j >= dd / 8) break;
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                o[4 * j + 2 * h + 1] * inv);
    }
    if (tid % 4 == 0) lse[(size_t)bh * Tq + qi] = row_lse(m[h], l[h]);
  }
}

// The launchers build their maps with the true head dim Dt, so TMA reads
// columns Dt .. D-1 of the padded width D as zeros
template <int D, bool PADDED, int KC>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* klen, void* out, void* lse, int B, int H,
                int Hkv, int Tq, int Tk, int Dt, int causal, float scale,
                cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = hopper::map_bf16_3d(&mq, q, B * H, Tq, Dt, BQ);
  if (rc == 0) rc = hopper::map_bf16_3d(&mk, k, B * Hkv, Tk, Dt, WK);
  if (rc == 0) rc = hopper::map_bf16_3d(&mv, v, B * Hkv, Tk, Dt, WK);
  if (rc != 0) return rc;
  const size_t smem = sizeof(FwdSmem<D>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, PADDED, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_wgmma_kernel<D, PADDED, KC><<<grid, NT, smem, stream>>>(
      mq, mk, mv, (const int*)klen, (bf16*)out, (float*)lse, H, Hkv, Tq, Tk,
      Dt, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------- float32, 3xTF32 tensor cores

constexpr int TK = 32;       // keys per tile (3xTF32 kernel, D <= 128)
constexpr int TSTAGES = 2;   // raw K/V ring depth

// one [rows x 32] float32 region of a tile in the 128-byte swizzle
template <int ROWS>
using FChunk = float[ROWS * 32];

template <int D>
struct Tf32Smem {
  FChunk<BQ> qhi[D / 32], qlo[D / 32];   // Q as TF32 hi + lo terms
  FChunk<TK> kraw[TSTAGES][D / 32];      // the TMA ring: K, V as loaded
  FChunk<TK> vraw[TSTAGES][D / 32];
  FChunk<TK> khi[D / 32], klo[D / 32];   // the next product's K, split
  FChunk<D> vthi[2][TK / 32], vtlo[2][TK / 32];  // V^T of tiles t, t+1
  uint64_t qbar, full[TSTAGES];
};

// thread 0: K/V tile t of head kvh into ring stage s, its first KC
// 32-column regions (a region wholly past the true head dim is not
// loaded: no product reads it)
template <int KC, int D>
__device__ __forceinline__ void load_kv_f32(Tf32Smem<D>& sm,
                                            const CUtensorMap* tk,
                                            const CUtensorMap* tv, int kvh,
                                            int t, int s) {
  hopper::mbar_expect_tx(&sm.full[s], 2 * TK * 32 * KC * sizeof(float));
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    hopper::tma_load_3d(sm.kraw[s][c], tk, &sm.full[s], 32 * c, t * TK, kvh);
    hopper::tma_load_3d(sm.vraw[s][c], tv, &sm.full[s], 32 * c, t * TK, kvh);
  }
}

// ring stage s: K into K_hi, K_lo and V into V^T buffer vb; the first KC
// regions (the loaded ones), so V^T rows from 32 KC on are never written
template <int KC, int D>
__device__ __forceinline__ void split_kv(Tf32Smem<D>& sm, int s, int vb) {
  static_assert(TK == 32, "split_t takes one key a lane");
  hopper::split_tf32<TK * 8 * KC>(
      reinterpret_cast<const float4*>(sm.kraw[s][0]),
      reinterpret_cast<float4*>(sm.khi[0]),
      reinterpret_cast<float4*>(sm.klo[0]));
  hopper::split_t<32 * KC, TK>(sm.vraw[s][0], sm.vthi[vb][0],
                               sm.vtlo[vb][0], 0);
}

// The body of flash_fwd_tf32x3_kernel at D <= 128: 32-key tiles through
// the raw TMA ring.  KC: the 32-column regions Q K^T reduces, a
// compile-time count (D / 32 unpadded; in the padded instances the
// regions that hold columns below the true head dim, whose columns past
// it are TMA's zeros)
template <int D, bool PADDED, int KC>
__device__ __forceinline__ void tf32x3_ring(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const int* __restrict__ klen, float* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Tq, int Tk, int Dt,
    int causal, float scale) {
  using namespace hopper;
  constexpr int NC = D / 32;  // 32-column regions of a row
  extern __shared__ uint8_t smem_raw[];
  Tf32Smem<D>& sm = *reinterpret_cast<Tf32Smem<D>*>(align_1024(smem_raw));

  static_assert(PADDED ? KC <= NC : KC == NC, "regions of Q K^T");
  const int tid = threadIdx.x;
  const int dd = PADDED ? Dt : D;       // the true head dim (row stride)
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;
  int kend = kl;
  if (causal) kend = min(kend, max(0, min(q0 + BQ, Tq) + offset));
  const int ntiles = (kend + TK - 1) / TK;

  if (tid == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < TSTAGES; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
    if (ntiles > 0) {
      mbar_expect_tx(&sm.qbar, BQ * 32 * KC * sizeof(float));
#pragma unroll
      for (int c = 0; c < KC; ++c)
        tma_load_3d(sm.qhi[c], tq, &sm.qbar, 32 * c, q0, bh);
      for (int s = 0; s < TSTAGES && s < ntiles; ++s)
        load_kv_f32<KC>(sm, tk, tv, kvh, s, s);
    }
  }
  __syncthreads();

  const int r0 = acc_row(0);
  const float sl2 = scale * LOG2E;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  // Q and tile 0 are split before the loop; tile t+1's K and V are split
  // while tile t's P V runs on the tensor cores
  if (ntiles > 0) {
    mbar_wait(&sm.qbar, 0);
    split_tf32<BQ * 8 * KC>(reinterpret_cast<const float4*>(sm.qhi[0]),
                            reinterpret_cast<float4*>(sm.qhi[0]),
                            reinterpret_cast<float4*>(sm.qlo[0]));
    mbar_wait(&sm.full[0], 0);
    split_kv<KC>(sm, 0, 0);
    fence_proxy_async();  // the split copies are read by wgmma
  }
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TK, vb = t % 2;
    // tile t's stage was split in the last pass: refill it
    if (tid == 0 && t + TSTAGES < ntiles)
      load_kv_f32<KC>(sm, tk, tv, kvh, t + TSTAGES, t % TSTAGES);

    float sacc[TK / 2];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4 * KC; ++kc) {
      const int c = kc / 4, off = (kc % 4) * 8;
      const uint64_t qh = make_desc(sm.qhi[c] + off, 16, 1024);
      const uint64_t kh = make_desc(sm.khi[c] + off, 16, 1024);
      wgmma_ss_tf32(sacc, make_desc(sm.qlo[c] + off, 16, 1024), kh, kc > 0);
      wgmma_ss_tf32(sacc, qh, make_desc(sm.klo[c] + off, 16, 1024), 1);
      wgmma_ss_tf32(sacc, qh, kh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    __syncthreads();  // every warp is done with K_hi, K_lo

    float alpha[2];
    softmax_tile(sacc, m, l, alpha, q0, k0, kl, causal, offset, sl2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // P as TF32 A fragments, hi and lo (V^T is permuted to match).  P V
    // runs at the full width D: its columns from 32 KC on read V^T rows
    // no split wrote, and are never stored
    uint32_t phi[TK / 8][4], plo[TK / 8][4];
    acc_to_tf32_split(sacc, phi, plo);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 8;
      const uint64_t vh = make_desc(sm.vthi[vb][c] + off, 16, 1024);
      wgmma_rs_tf32(o, plo[kk], vh, 1);
      wgmma_rs_tf32(o, phi[kk], make_desc(sm.vtlo[vb][c] + off, 16, 1024),
                    1);
      wgmma_rs_tf32(o, phi[kk], vh, 1);
    }
    wgmma_commit();
    if (t + 1 < ntiles) {
      // V^T buffer 1 - vb was read by tile t-1's P V, waited for by all
      const int s1 = (t + 1) % TSTAGES;
      mbar_wait(&sm.full[s1], ((t + 1) / TSTAGES) & 1);
      split_kv<KC>(sm, s1, 1 - vb);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_regs(o);
    keep_regs(phi);
    keep_regs(plo);
    __syncthreads();  // tile t+1 split; every warp is done with V^T vb
  }

  // columns below dd only, as in the bf16 kernel
  const int cq = 2 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = row_sum(l[h]);
    const int qi = q0 + r0 + 8 * h;
    if (qi >= Tq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    float* op = out + ((size_t)bh * Tq + qi) * dd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j >= dd / 8) break;
      *reinterpret_cast<float2*>(op + 8 * j + cq) =
          make_float2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
    if (tid % 4 == 0) lse[(size_t)bh * Tq + qi] = row_lse(m[h], l[h]);
  }
}

// ------------------------------- float32 at width 256: 16-key tiles
//
// Q as hi + lo alone takes 128 KB of the block's 227 KB at D = 256, so the
// D <= 128 layout (a raw ring beside the split copies, 448 KB here) does
// not fit.  Keys come in tiles of 16: TMA lands K in K_hi and the threads
// split it in place (no raw K), and each thread reads its words of the
// next tile's V from global memory into registers under this tile's
// Q K^T and writes them split and transposed into V^T, whose 32-column
// region holds two tiles (even tiles in columns 0-15, odd in 16-31), so
// V^T is double-buffered in one region pair.  Q 128 KB + K 32 KB + V^T
// 64 KB = 224 KB, one block an SM.

constexpr int WTK = 16;      // keys per tile (3xTF32 kernel, width 256)

template <int D>
struct Tf32WideSmem {
  FChunk<BQ> qhi[D / 32], qlo[D / 32];    // Q as TF32 hi + lo terms
  FChunk<WTK> khi[D / 32], klo[D / 32];   // K: TMA into K_hi, split in place
  FChunk<D> vthi, vtlo;                   // V^T of tiles t, t+1
  uint64_t qbar, kbar;
};

// thread 0: K tile t of head kvh into K_hi, its first KC regions
template <int KC, int D>
__device__ __forceinline__ void load_k_wide(Tf32WideSmem<D>& sm,
                                            const CUtensorMap* tk, int kvh,
                                            int t) {
  hopper::mbar_expect_tx(&sm.kbar, WTK * 32 * KC * sizeof(float));
#pragma unroll
  for (int c = 0; c < KC; ++c)
    hopper::tma_load_3d(sm.khi[c], tk, &sm.kbar, 32 * c, t * WTK, kvh);
}

// This thread's words of the V tile from key k0: key k0 + tid % 16, the
// 4-column group tid / 16 + 8 i of region i < KC (store_vt's order);
// zeros past Tk and past the true head dim dd
template <int KC>
__device__ __forceinline__ void load_v_rows(float4 (&x)[KC],
                                            const float* __restrict__ vh,
                                            int k0, int Tk, int dd) {
  const int t = threadIdx.x % hopper::kWarpgroup;
  const int key = k0 + t % WTK, grp = t / WTK;
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const int d = 4 * (grp + 8 * i);
    x[i] = key < Tk && d < dd
               ? __ldg(reinterpret_cast<const float4*>(
                     vh + (size_t)key * dd + d))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Those words split into V^T_hi, V^T_lo (rows d, 32-column regions of the
// 128-byte swizzle) at columns col0 .. col0 + 15, key 8a + 2c + e at
// column col0 + 8a + c + 4e, as hopper::split_t lays out a 16-row tile
template <int KC>
__device__ __forceinline__ void store_vt(const float4 (&x)[KC], float* thi,
                                         float* tlo, int col0) {
  const int t = threadIdx.x % hopper::kWarpgroup;
  const int j = t % WTK, grp = t / WTK;
  const int col = col0 + ((j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2));
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const float xs[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (grp + 8 * i) + e;
      const int at = d * 32 + ((((col >> 2) ^ (d & 7)) << 2) | (col & 3));
      const float h = __uint_as_float(hopper::tf32_rna(xs[e]));
      thi[at] = h;
      tlo[at] = __uint_as_float(hopper::tf32_rna(xs[e] - h));
    }
  }
}

// The body of flash_fwd_tf32x3_kernel at width 256: the masks, online
// softmax, products (small terms first) and stores of tf32x3_ring, over
// 16-key tiles.  Tile t+1's K lands by TMA under tile t's softmax and P V
// and is split during P V; its V rows are read before tile t's Q K^T and
// split into the other V^T columns during P V
template <int D, bool PADDED, int KC>
__device__ __forceinline__ void tf32x3_wide(
    const CUtensorMap* tq, const CUtensorMap* tk, const float* __restrict__ v,
    const int* __restrict__ klen, float* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Tq, int Tk, int Dt,
    int causal, float scale) {
  using namespace hopper;
  constexpr int NC = D / 32;  // 32-column regions of a row
  extern __shared__ uint8_t smem_raw[];
  Tf32WideSmem<D>& sm =
      *reinterpret_cast<Tf32WideSmem<D>*>(align_1024(smem_raw));

  static_assert(PADDED ? KC <= NC : KC == NC, "regions of Q K^T");
  const int tid = threadIdx.x;
  const int dd = PADDED ? Dt : D;       // the true head dim (row stride)
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;
  int kend = kl;
  if (causal) kend = min(kend, max(0, min(q0 + BQ, Tq) + offset));
  const int ntiles = (kend + WTK - 1) / WTK;
  const float* vh = v + (size_t)kvh * Tk * dd;

  if (tid == 0) {
    mbar_init(&sm.qbar, 1);
    mbar_init(&sm.kbar, 1);
    mbar_fence_init();
    if (ntiles > 0) {
      mbar_expect_tx(&sm.qbar, BQ * 32 * KC * sizeof(float));
#pragma unroll
      for (int c = 0; c < KC; ++c)
        tma_load_3d(sm.qhi[c], tq, &sm.qbar, 32 * c, q0, bh);
      load_k_wide<KC>(sm, tk, kvh, 0);
    }
  }
  __syncthreads();

  const int r0 = acc_row(0);
  const float sl2 = scale * LOG2E;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  float4 vx[KC];
  if (ntiles > 0) {
    load_v_rows(vx, vh, 0, Tk, dd);
    mbar_wait(&sm.qbar, 0);
    split_tf32<BQ * 8 * KC>(reinterpret_cast<const float4*>(sm.qhi[0]),
                            reinterpret_cast<float4*>(sm.qhi[0]),
                            reinterpret_cast<float4*>(sm.qlo[0]));
    store_vt(vx, sm.vthi, sm.vtlo, 0);
    mbar_wait(&sm.kbar, 0);
    split_tf32<WTK * 8 * KC>(reinterpret_cast<const float4*>(sm.khi[0]),
                             reinterpret_cast<float4*>(sm.khi[0]),
                             reinterpret_cast<float4*>(sm.klo[0]));
    fence_proxy_async();  // the split copies are read by wgmma
  }
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * WTK, col0 = (t % 2) * WTK;
    const bool more = t + 1 < ntiles;
    if (more) load_v_rows(vx, vh, k0 + WTK, Tk, dd);

    float sacc[WTK / 2];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4 * KC; ++kc) {
      const int c = kc / 4, off = (kc % 4) * 8;
      const uint64_t qh = make_desc(sm.qhi[c] + off, 16, 1024);
      const uint64_t kh = make_desc(sm.khi[c] + off, 16, 1024);
      wgmma_ss_tf32(sacc, make_desc(sm.qlo[c] + off, 16, 1024), kh, kc > 0);
      wgmma_ss_tf32(sacc, qh, make_desc(sm.klo[c] + off, 16, 1024), 1);
      wgmma_ss_tf32(sacc, qh, kh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    __syncthreads();  // every warp is done with K_hi, K_lo: refill them
    if (tid == 0 && more) load_k_wide<KC>(sm, tk, kvh, t + 1);

    float alpha[2];
    softmax_tile(sacc, m, l, alpha, q0, k0, kl, causal, offset, sl2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // P V at the full width D (m64n256k8): its columns from 32 KC on read
    // V^T rows no split wrote, and are never stored
    uint32_t phi[WTK / 8][4], plo[WTK / 8][4];
    acc_to_tf32_split(sacc, phi, plo);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WTK / 8; ++kk) {
      const int off = col0 + kk * 8;
      const uint64_t vhd = make_desc(sm.vthi + off, 16, 1024);
      wgmma_rs_tf32(o, plo[kk], vhd, 1);
      wgmma_rs_tf32(o, phi[kk], make_desc(sm.vtlo + off, 16, 1024), 1);
      wgmma_rs_tf32(o, phi[kk], vhd, 1);
    }
    wgmma_commit();
    if (more) {
      // tile t+1: V into the other V^T columns (read by tile t-1's P V,
      // waited for by all), K split in place once it has landed
      store_vt(vx, sm.vthi, sm.vtlo, WTK - col0);
      mbar_wait(&sm.kbar, (t + 1) & 1);
      split_tf32<WTK * 8 * KC>(reinterpret_cast<const float4*>(sm.khi[0]),
                               reinterpret_cast<float4*>(sm.khi[0]),
                               reinterpret_cast<float4*>(sm.klo[0]));
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_regs(o);
    keep_regs(phi);
    keep_regs(plo);
    __syncthreads();  // tile t+1 split; every warp is done with tile t's V^T
  }

  // columns below dd only, as in the bf16 kernel
  const int cq = 2 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = row_sum(l[h]);
    const int qi = q0 + r0 + 8 * h;
    if (qi >= Tq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    float* op = out + ((size_t)bh * Tq + qi) * dd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j >= dd / 8) break;
      *reinterpret_cast<float2*>(op + 8 * j + cq) =
          make_float2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
    if (tid % 4 == 0) lse[(size_t)bh * Tq + qi] = row_lse(m[h], l[h]);
  }
}

// The float32 forward: the 32-key ring design up to D = 128, the 16-key
// one at width 256 (v: V itself, which only the latter reads)
template <int D, bool PADDED, int KC>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ v,
                        const int* __restrict__ klen,
                        float* __restrict__ out, float* __restrict__ lse,
                        int H, int Hkv, int Tq, int Tk, int Dt, int causal,
                        float scale) {
  if constexpr (D <= 128)
    tf32x3_ring<D, PADDED, KC>(&tq, &tk, &tv, klen, out, lse, H, Hkv, Tq,
                               Tk, Dt, causal, scale);
  else
    tf32x3_wide<D, PADDED, KC>(&tq, &tk, v, klen, out, lse, H, Hkv, Tq, Tk,
                               Dt, causal, scale);
}

// the dynamic shared memory a float32 launch at width D asks for
template <int D>
constexpr size_t f32_smem() {
  if constexpr (D <= 128)
    return sizeof(Tf32Smem<D>) + 1024;
  else
    return sizeof(Tf32WideSmem<D>) + 1024;
}

template <int D, bool PADDED, int KC>
int launch_f32(const void* q, const void* k, const void* v, const void* klen,
               void* out, void* lse, int B, int H, int Hkv, int Tq, int Tk,
               int Dt, int causal, float scale, cudaStream_t stream) {
  constexpr int KT = D <= 128 ? TK : WTK;  // keys per tile
  CUtensorMap mq, mk, mv;
  int rc = hopper::map_f32_3d(&mq, q, B * H, Tq, Dt, BQ);
  if (rc == 0) rc = hopper::map_f32_3d(&mk, k, B * Hkv, Tk, Dt, KT);
  // (at width 256 the threads read V; its map checks its alignment)
  if (rc == 0) rc = hopper::map_f32_3d(&mv, v, B * Hkv, Tk, Dt, KT);
  if (rc != 0) return rc;
  const size_t smem = f32_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel<D, PADDED, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_tf32x3_kernel<D, PADDED, KC><<<grid, NT, smem, stream>>>(
      mq, mk, mv, (const float*)v, (const int*)klen, (float*)out,
      (float*)lse, H, Hkv, Tq, Tk, Dt, causal, scale);
  return (int)cudaGetLastError();
}

// the dynamic shared memory of a launch at D, and the blocks an SM holds
template <typename Kernel>
int occupancy(Kernel kernel, size_t smem, int* smem_out, int* blocks) {
  *smem_out = (int)smem;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, NT,
                                                      smem);
  return (int)e;
}

}  // namespace

// The shared memory a forward launch asks for at head dimension D and
// dtype (as in pt_flash_fwd), for the instance D runs, and how many such
// blocks an SM holds, as the CUDA runtime reports them; 0 on success.
extern "C" int pt_flash_fwd_occupancy(int D, int dtype, int* smem,
                                      int* blocks) {
  if (dtype != 0 && dtype != 1) return -1;
  return hopper::with_fwd_instance(D, [&](auto in) {
    using I = decltype(in);
    constexpr int DP = I::kDP, KC = I::kKC;
    constexpr bool P = I::kPadded;
    return dtype == 0
               ? occupancy(flash_fwd_tf32x3_kernel<DP, P, KC>, f32_smem<DP>(),
                           smem, blocks)
               : occupancy(flash_fwd_wgmma_kernel<DP, P, KC>,
                           sizeof(FwdSmem<DP>) + 1024, smem, blocks);
  });
}

// q [B*H, Tq, D], k/v [B*Hkv, Tk, D], klen int32 [B], out like q,
// lse float32 [B*H, Tq]; dtype 0 = float32, 1 = bfloat16; any D % 8 == 0
// up to 256 (hopper::with_fwd_instance).  Returns the CUDA error of the
// launch (0 on success), -1 for arguments the kernel does not take, or -2
// when the CUDA driver gives no TMA tensor map.
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            const void* klen, void* out, void* lse, int B,
                            int H, int Hkv, int Tq, int Tk, int D, int dtype,
                            int causal, float scale, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Tq < 1 || Tk < 1 ||
      (dtype != 0 && dtype != 1))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return hopper::with_fwd_instance(D, [&](auto in) {
    using I = decltype(in);
    return dtype == 0
               ? launch_f32<I::kDP, I::kPadded, I::kKC>(
                     q, k, v, klen, out, lse, B, H, Hkv, Tq, Tk, D, causal,
                     scale, s)
               : launch_bf16<I::kDP, I::kPadded, I::kKC>(
                     q, k, v, klen, out, lse, B, H, Hkv, Tq, Tk, D, causal,
                     scale, s);
  });
}
