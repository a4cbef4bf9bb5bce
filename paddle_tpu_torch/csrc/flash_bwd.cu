// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV on tensor
// cores (wgmma), bf16 directly and float32 as 3xTF32, at every head dim D
// with D % 8 == 0 up to 256 (instances of width 64, 128 and 256; float32
// at width 256 as clusters of two blocks that split D).
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
// H=8, T=256, D=64) dQ does 3 and dK/dV 4 products of 2*D FLOPs per valid
// (query, key) pair (~6.4 and ~8.6 GFLOP without the causal mask) against
// 42 and 51 MB of traffic in bf16 (84 and 101 MB in float32: Q, K, V, dO,
// LSE and delta read once, the gradients written once).  In bf16 that is
// 6.5 and 8.7 us of tensor-core work against 12.7 and 15.2 us of bytes:
// bound by bytes.  In float32 every product runs as three TF32 products,
// 165 TFLOP/s in effect (495 / 3): 39.0 and 52.1 us of work against 25
// and 30 us of bytes, bound by operations (float32 FMAs on CUDA cores, 67
// TFLOP/s, would take 96 and 128 us).
//
// dQ, bf16, flash_bwd_dq_wgmma_kernel<D>: one warpgroup of 128 threads per
// (b*H, 64-row query tile), heaviest causal tiles first.  Q and dO stay
// resident in shared memory (one TMA copy each); LSE and delta of the tile's
// rows are plain loads by warp 0 (a TMA box does not take rows that start off a
// 16-byte boundary) and then sit in registers, two rows a thread.  K/V tiles of
// 64 keys flow through a 2-stage ring under mbarriers (full: the bytes arrived;
// empty: all 128 threads are done with the stage) from key 0 to the tile's end,
// min(k_len, causal frontier); later tiles are never loaded.  S = Q K^T and dP
// = dO V^T are wgmma with every operand K-major (64 query rows x 64 keys,
// reduced over D); P and dS are formed on the float32 fragments in registers,
// dS split there into two bf16 terms (SplitDs), and dQ += dS K runs as two
// products with A = dS_lo, then dS_hi, from registers and B = K MN-major (tnspB
// = 1; N = D, both 64-column chunk regions at D=128).  dQ x scale once in the
// epilogue, written in bf16 up to row Tq.  One D-wide float32 accumulator (D/2
// registers a thread) beside the S and dP fragments (32 each): ptxas gives 124
// registers at D=64 and 156 at D=128, no spills; with 50 KB of shared memory at
// D=64, four blocks (16 warps) fit an SM.  Not yet used: warp specialisation,
// setmaxnreg, overlapping one tile's elementwise work with the next tile's
// products, a persistent grid.
//
// dK/dV, bf16, flash_bwd_dkv_wgmma_kernel<D>: one warpgroup of 128 threads per
// (b*Hkv, 64-key tile).  K and V stay resident in shared memory (one TMA copy
// each); Q/dO tiles of WQ query rows (TMA) with their LSE and delta (loaded by
// warp 0) flow through a 2-stage ring under mbarriers, over the g query heads
// of the GQA group and the q tiles from the causal frontier on.  The products
// run transposed, so that the keys are the 64-row M dimension: S^T = K Q^T and
// dP^T = V dO^T by wgmma with every operand K-major in shared memory; P^T and
// dS^T are formed on the float32 fragments in registers, P^T rounded to bf16
// there once and dS^T split into two bf16 terms (SplitDs), and dV += P^T dO and
// dK += dS^T Q (two products, lo first) run with A from registers and B = dO or
// Q MN-major (tnspB = 1); dK x scale once in the epilogue.  The two D-wide
// float32 accumulators take D registers a thread (128 at D=128) besides S^T and
// dP^T (WQ each): ptxas gives 176 registers at D=64 and 234 at D=128, no
// spills, so the 64-row ring tile stays at D=128, and two blocks (8 warps) fit
// an SM at D=64.  Not yet used: warp specialisation, setmaxnreg, two consumer
// warpgroups sharing K/V, overlapping one ring tile's elementwise work with the
// next tile's products, a persistent grid.
//
// bf16 at width 256 (D = 136 .. 256), the same two kernels, <256, PADDED>.
// What rules the design is registers.  dQ keeps its shape: one warpgroup a
// 64-row query tile, its accumulator 128 float32 registers a thread beside
// S and dP (32 each); Q and dO resident (64 KB) and a K/V ring of two
// 64-key stages (128 KB), 198,184 bytes a block; dQ += dS K is m64n256k16
// with K's four 64-column chunks LBO apart.  dK/dV cannot: one warpgroup a
// 64-key tile would hold dK and dV in 256 registers a thread, past the 255
// a thread may have (at width 128, where the two take 128, ptxas gives
// 234-254).  So a block computes one of the two outputs, picked by the
// grid's z (dkv_block<.., OUT>): the dV block S^T = K Q^T, P^T, dV += P^T
// dO (K resident, V not loaded); the dK block S^T, dP^T = V dO^T, dS^T
// as hi + lo, dK += dS^T Q (K and V resident); both over the same Q/dO
// ring, 64 KB resident beside 128 KB of ring, 198,696 bytes a block.
// Each keeps one accumulator of 128 registers beside S^T and dP^T.  S^T
// is computed twice, 10 D FLOPs a valid pair where the function needs 8
// D; everything else, and the rounding (P^T once, dS^T as hi + lo), is
// the width-128 kernel's.  Both blocks are one launch, so a dK/dV call is
// one kernel, and the lighter dV blocks are scheduled first.  Left for a
// redesign: two consumer warpgroups in one block, each holding half of D
// of both accumulators and adding their partial S^T and dP^T through
// shared memory (S^T once, the Q/dO tile read once for both outputs);
// and a cluster of two blocks splitting D, adding the partial products
// through distributed shared memory.  At D = 136 .. 184 the last
// 64-column chunk lies wholly past D and is not loaded (loaded_chunks):
// the products over D stop before it, and the accumulator columns the
// products over rows make from it are never stored.  ptxas (sm_90a, -O3),
// no spills: dQ 224 registers unpadded and 250 padded, dK/dV 219 and 248
// (one block an SM: ~194 KB of shared memory each).
//
// float32, flash_bwd_dq_tf32x3_kernel<D> and flash_bwd_dkv_tf32x3_kernel<D>
// (D = 64, 128): the bf16 kernels' block shapes, order of tiles, masks and
// skipping, with every product on the TF32 tensor cores as three, x y ~
// x_lo y_hi + x_hi y_lo + x_hi y_hi (small terms first), x_hi =
// tf32_rna(x), x_lo = tf32_rna(x - x_hi) (hopper_mma.cuh; one TF32
// product would miss the float32 check: the CPU emulation in
// tests/test_torch_flash_bwd_tf32x3_numerics.py shows both).  What float32
// forces, as in csrc/flash_fwd.cu's flash_fwd_tf32x3_kernel:
//  - both wgmma operands K-major (.tf32 has no transpose), so the product
//    that reduces over a ring tile's rows reads that tile transposed:
//    K^T for dQ += dS K, dO^T and Q^T for dV += P^T dO and dK += dS^T Q,
//    written rows contiguous by split_t with the 8-row permutation that
//    lets the S / S^T accumulator feed wgmma as the A fragment (dS, P^T,
//    dS^T as hi + lo) without shuffles;
//  - ring tiles of TT rows (keys for dQ, query rows for dK/dV; S is
//    m64nTT), since every operand is held twice and a float32 tile is
//    twice a bf16 one.  At D = 64, TT = 32.  dQ: Q, dO hi + lo 64 KB, the
//    raw K/V ring (2 stages, TMA) 32 KB, this tile's K, V split 32 KB,
//    K^T of tiles t and t+1 32 KB: 160 KB.  dK/dV: K, V hi + lo 64 KB, the
//    raw Q/dO ring 32 KB, this tile's Q, dO split 32 KB, Q^T and dO^T of
//    tiles it and it+1 64 KB, and their LSE and delta: 192 KB;
//  - at D = 128 those layouts need 320 and 384 KB, above the 227 KB a
//    block may have, so TT = 16 (ring_rows): every tile buffer halves and
//    two 16-row transposed tiles share one [D x 32] region, at columns 0
//    and 16 (tregion, tcol).  dQ: Q, dO hi + lo 128 KB, ring 32 KB, split
//    32 KB, K^T of tiles t and t+1 in one region pair 32 KB: 224 KB.
//    dK/dV: K, V hi + lo 128 KB, ring 32 KB, split 32 KB, and one slot of
//    Q^T beside dO^T in one region pair 32 KB: 224 KB (two slots would
//    need 256);
//  - the split: tile t+1 is split while tile t's last products (dS K, or
//    P^T dO and dS^T Q) run on the tensor cores, which is why the
//    transposed copies have two slots; the ring stage a split has read is
//    refilled at the top of the next pass.  The dK/dV split also loads
//    the next tile's LSE and delta (plain loads, first warp).  With one
//    transposed slot (dK/dV at D = 128) a tile's Q^T and dO^T are written
//    while its own S^T and dP^T run (they read Q and dO, not the
//    transposes), and its ring stage is refilled after that.  One block
//    (4 warps) an SM;
//  - the sums: a block adds dQ, or dK and dV, from its registers into its
//    output tile at every 256th row of the reduction and starts them
//    again from zero (flush_acc says why), so no chain of truncating
//    tensor-core adds is longer than 256 rows.
// Each key tile of dQ runs 3 x 2 x D/8 products for S and dP and 3 x TT/8
// for dS K; each ring tile of dK/dV 3 x 2 x D/8 for S^T and dP^T and 3 x
// TT/4 for dV and dK.  S and dP keep their big and small terms in
// separate accumulators, dP's big terms in four (product_x3 says why).
// What bounds D = 128: the m64n16 products of S and dP read their A tile
// (the resident Q or K, hi and lo) from shared memory once every 16 rows,
// about 2.5 KB a k8 product for 16 K FLOPs, so shared-memory reads, not
// the tensor cores, bound them.  ptxas: 170 registers (dQ) and 202
// (dK/dV) at D = 64, 155 and 253 at D = 128, no spills; 164,888 and
// 198,168 bytes of shared memory a block at D = 64, 230,424 and 230,680
// at D = 128, one block an SM, as the CUDA runtime reports them.  Not
// yet used: a producer warp, the second products in transposed form (no
// transposed copies), a persistent grid.
//
// float32 at width 256 (D = 136 .. 256), flash_bwd_dq_tf32x3_kernel<256,
// PADDED, KC> and flash_bwd_dkv_tf32x3_kernel<256, PADDED, KC>: a cluster
// of two blocks (cudaLaunchKernelEx, cluster dims (2, 1, 1), the grid's x
// doubled) that split D.  What rules the design is shared memory: the D =
// 128 layouts above keep two operands resident as hi + lo, 128 KB at
// width 128 and 256 KB at 256, past the 227 KB a block may have, and they
// leave about 2 KB free.  So each block of the pair runs the D = 128
// layout and loop on its half of D: rank 0 on columns 0-127 (KC 4), rank
// 1 on the KC - 4 regions from column 128 (one to four; its TMA boxes
// start at column 128 of the same maps, so the columns at or past D
// arrive as zeros, and a region wholly past D is neither loaded nor
// split).  Each block reduces its partial S and dP (dQ) or S^T and dP^T
// (dK/dV) for a ring tile with product_x3 as at D = 128, and the two add
// their partial sums (exchange_partials): 8 KB a tile, written by st.async
// into the ring stage of that tile in the peer, which both blocks split
// in the pass before (no room for a buffer of its own), completing their
// bytes on the peer's mbarrier; each block adds own + peer in float32,
// which is commutative, so both hold the same S and dP bit for bit and
// take the same masks, P and dS.  The products over rows (dS K; P^T dO
// and dS^T Q) stay per block at width 128, and each block stores its own
// columns of dQ, or dK and dV, at the true D.  dK/dV computes S^T once (8
// D FLOPs a pair, not the 10 D of the bf16 width-256 dK/dV), with 64 + 64
// accumulator registers a thread as at D = 128.  A pass splits the next
// tile before the exchange (the peer writes only stages split before its
// last exchange); in dK/dV a tile's Q^T and dO^T are transposed from its
// split (transpose_t) beside its S^T and dP^T products, so a ring stage
// is read by one split only.  Both blocks walk the same tiles, decided
// from (b, h, tile) alone: a block that skipped a tile its peer exchanges
// would wait on its barrier until the trap.  The rank picks one of two
// fully unrolled bodies (KC a template argument in each: a run-time count
// of k8 steps serializes the 3xTF32 products, C7515), one body at KC 8.
// Two other forms timed slower on an H100: one barrier a tile with 128
// remote arrivals (st.shared::cluster and mbarrier.arrive.release), and
// a second barrier a stage to keep the split beside the products over
// rows.  ptxas (sm_90a, -O3), no spills: dQ 193-197
// registers, dK/dV 248-255; 230,440 and 230,696 bytes of shared memory a
// block, one block an SM.  The rounding changes in one place, S = S0 +
// S1 (and dP), which tests/test_torch_flash_bwd_tf32x3_numerics.py
// models.  Not yet used: the exchange overlapped with the next tile's
// products, TMA multicast of the shared rows, a producer warp.
//
// The other head dims (D % 8 == 0 up to 128, not 64 or 128; in bf16 also 136
// .. 248) run the instance of padded width DP = 64 (D < 64), DP = 128 (64 <
// D < 128) or DP = 256, the kernels' PADDED = true instances, with the true D
// (Dt, dd) at run time; D = 64, 128 and 256 are the PADDED = false
// instances, which compile as they did before (dd is the constant D
// there).  Each launcher builds its TMA maps with the true
// D, so the box columns at or past D arrive as zeros
// (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE), and count their full bytes on the
// mbarrier, as rows past Tq and Tk do.  The products over D (S and dP, S^T and
// dP^T) stop where the columns below D end: bf16 at the k16 step that holds
// column D - 1 (a run-time count; at D % 16 == 8 that step is half zeros,
// which add nothing), float32 at the last 32-column region that holds it (KC =
// ceil(D / 32), a template argument: a run-time count of k8 steps put control
// flow between the 3xTF32 products, and ptxas serialized them, C7515: the D =
// 96 float32 pair took 1.57 ms on an H100 against 1.69 for the CUDA-core
// pair).  A float32 region wholly past D is neither loaded nor split, and the
// expected bytes count the loaded regions only.  The products over rows (dS K,
// P^T dO, dS^T Q) run at the full width DP; their accumulator columns past D
// (from zero columns of their B operand, or from the transposed rows past 32
// KC, which a float32 split never writes) are never stored: every store takes
// the true D as its row stride and stops at column D (D % 8 == 0 keeps each
// thread's pair of columns whole).  The useful work is D / DP of the padded
// products over rows, and D / (32 KC) of float32's products over D: 3/4 and 1
// at D = 96.  ptxas (sm_90a, -O3), registers a thread, no spills in any
// instance: bf16 dQ 157 (<64, true>) and 186 (<128, true>), dK/dV 204 and 254;
// float32 dQ 175, 173, 151, 157 and dK/dV 204, 208, 251, 254 (KC = 1, 2 at
// width 64; 3, 4 at 128); the unpadded D = 64 and 128 instances as listed
// above (124 / 156, 176 / 234 since they split dS too; 170 / 155, 202 / 253).
// Shared memory a block as the unpadded instance of the same width (the same
// structs): bf16 dQ 50,728 bytes at width 64 (3 blocks an SM, 4 unpadded) and
// 99,880 at 128 (2), dK/dV 51,240 and 100,392 (2 each); float32 as above, one
// block an SM.
#include "hopper_mma.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr int NT = 128;   // threads per block

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

// The 64-column chunks of a row that TMA loads: every one, except at width
// 256 for D = 136 .. 184, whose last chunk lies wholly past the true head
// dim dd: the products over D stop before it, and the accumulator columns
// that the products over rows make from it are never stored
template <int D, bool PADDED>
__device__ __forceinline__ int loaded_chunks(int dd) {
  return D == 256 && PADDED ? (dd + 63) / 64 : D / 64;
}

// SplitDs: dS = P (dP - delta) sums to zero over a row's keys, so dQ =
// scale dS K and dK = scale dS^T Q cancel, and one bf16 rounding of dS
// (2^-9 of each term) can leave more error than the bf16 check (8e-3
// relative, 2e-3 of max|grad|) allows on an element the sum cancels: the
// CPU emulation (tests/test_torch_flash_wgmma_numerics.py) finds inputs
// where it reaches 1.34x of the check at D = 128 (dQ) and at D = 16 (dK).
// So every instance hands dS (dQ) and dS^T (dK) to its products as hi =
// bf16(x) and lo = bf16(x - hi), small terms first: one more product a
// tile (dQ 4 products of the 3 a pair would need, dK/dV 5 of 4), and
// within 0.52 of the check on those inputs.  P^T stays one rounding (P >=
// 0: dV does not cancel).  The reference keeps dS in float32 for both
// products (paddle_tpu/ops/attention.py:151, :201, :260).

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
// tile qt0 + it % nq, of `rows` query rows
struct RingPos {
  int bh, q0;
};

__device__ __forceinline__ RingPos ring_pos(int it, int b, int H, int hk,
                                            int g, int qt0, int nq,
                                            int rows) {
  return {b * H + hk * g + it / nq, (qt0 + it % nq) * rows};
}

// warp 0: Q and dO of ring tile `pos` into stage s by TMA (lane 0; their
// first nl chunks, loaded_chunks), LSE and delta by plain loads (rows past
// Tq read 0; a ring tile's rows start at any float of the flat [B*H*Tq]
// vectors, which a TMA box does not take); every lane arrives on the
// stage's full barrier after its stores
template <int D>
__device__ __forceinline__ void load_ring(DkvSmem<D>& sm,
                                          const CUtensorMap* tq,
                                          const CUtensorMap* tdo,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          RingPos pos, int Tq, int s,
                                          int nl) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    hopper::mbar_expect_tx(&sm.full[s], 2 * WQ * 64 * nl * sizeof(bf16));
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      if (c >= nl) break;
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

// What a dK/dV block computes: both outputs (widths 64 and 128), or at
// width 256 one of them, dV or dK (flash_bwd_dkv_wgmma_kernel says why)
enum DkvOut { kDv = 1, kDk = 2, kDkv = 3 };

// One block's (b*Hkv, 64-key tile) work, OUT of its outputs; the block's
// key tile is blockIdx.y.  The shared memory is taken here, not passed in:
// through a reference parameter the compiler lost that it is shared memory
// (generic accesses; at width 128, 5 registers more and the kernel 2%
// slower on an H100)
template <int D, bool PADDED, int OUT>
__device__ __forceinline__ void dkv_block(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ klen,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int Tq,
    int Tk, int Dt, int causal, float scale) {
  using namespace hopper;
  constexpr bool DV = OUT & kDv, DK = OUT & kDk;
  extern __shared__ uint8_t smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int dd = PADDED ? Dt : D;       // the true head dim (row stride)
  const int nk16 = (dd + 15) / 16;      // k16 steps of the products over D
  const int nl = loaded_chunks<D, PADDED>(dd);
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

  if (tid < 32) {  // warp 0 produces: barriers, K (and V), the first stages
    if (tid == 0) {
      mbar_init(&sm.kvbar, 1);
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&sm.full[s], 1 + 32);  // TMA bytes + warp 0's stores
        mbar_init(&sm.empty[s], NT);
      }
      mbar_fence_init();
      if (total > 0) {
        // the dV pass reads no V (dP^T is dK's alone)
        mbar_expect_tx(&sm.kvbar, (DK ? 2 : 1) * WK * 64 * nl * sizeof(bf16));
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          if (c >= nl) break;
          tma_load_3d(sm.k[c], tk, &sm.kvbar, 64 * c, k0, bkv);
          if constexpr (DK) tma_load_3d(sm.v[c], tv, &sm.kvbar, 64 * c, k0,
                                        bkv);
        }
      }
    }
    __syncwarp();
    for (int s = 0; s < STAGES && s < total; ++s)
      load_ring(sm, tq, tdo, lse, delta,
                ring_pos(s, b, H, hk, g, qt0, nq, WQ), Tq, s, nl);
  }
  __syncthreads();

  const float sl2 = scale * LOG2E;
  float dka[DK ? D / 2 : 1], dva[DV ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < (DK ? D / 2 : 1); ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DV ? D / 2 : 1); ++i) dva[i] = 0.f;

  if (total > 0) mbar_wait(&sm.kvbar, 0);
  for (int it = 0; it < total; ++it) {
    const int s = it % STAGES, ph = (it / STAGES) & 1;
    const int q0 = ring_pos(it, b, H, hk, g, qt0, nq, WQ).q0;
    mbar_wait(&sm.full[s], ph);

    // S^T = K Q^T and dP^T = V dO^T: keys are the 64 rows, queries the
    // WQ columns; all operands K-major (D contiguous)
    float st[WQ / 2], dpt[WQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      if (kc >= nk16) break;
      const int c = kc / 4, off = (kc % 4) * 16;
      wgmma_ss<0>(st, make_desc(sm.k[c] + off, 16, 1024),
                  make_desc(sm.q[s][c] + off, 16, 1024), kc > 0);
    }
    if constexpr (DK) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        if (kc >= nk16) break;
        const int c = kc / 4, off = (kc % 4) * 16;
        wgmma_ss<0>(dpt, make_desc(sm.v[c] + off, 16, 1024),
                    make_desc(sm.dout[s][c] + off, 16, 1024), kc > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    if constexpr (DK) fence_regs(dpt);

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
      if constexpr (DK) dpt[i] = valid ? p * (dpt[i] - sm.delta[s][qc]) : 0.f;
      st[i] = p;
    }
    // P^T rounded once; dS^T goes to dK as two bf16 terms (hi, lo:
    // SplitDs says why)
    uint32_t pa[WQ / 16][4], dsa[WQ / 16][4], dsl[WQ / 16][4];
    if constexpr (DV) acc_to_a(st, pa);
    if constexpr (DK) acc_to_a_split(dpt, dsa, dsl);

    // dV += P^T dO and dK += dS^T Q: B = dO or Q, the query rows being
    // the reduction (MN-major, tnspB = 1; N = D, the chunk regions LBO
    // apart)
    wgmma_fence();
    if constexpr (DV) {
#pragma unroll
      for (int kk = 0; kk < WQ / 16; ++kk)
        wgmma_rs<1>(dva, pa[kk],
                    make_desc(sm.dout[s][0] + kk * 16 * 64, WQ * 128, 1024),
                    1);
    }
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < WQ / 16; ++kk)
        wgmma_rs<1>(dka, dsl[kk],
                    make_desc(sm.q[s][0] + kk * 16 * 64, WQ * 128, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < WQ / 16; ++kk)
        wgmma_rs<1>(dka, dsa[kk],
                    make_desc(sm.q[s][0] + kk * 16 * 64, WQ * 128, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (DV) fence_regs(dva);
    if constexpr (DK) fence_regs(dka);

    mbar_arrive(&sm.empty[s]);
    if (tid < 32 && it + STAGES < total) {  // warp 0 refills the stage
      mbar_wait(&sm.empty[s], ph);
      load_ring(sm, tq, tdo, lse, delta,
                ring_pos(it + STAGES, b, H, hk, g, qt0, nq, WQ), Tq, s, nl);
    }
  }

  // dK x scale once; each is written once, in k's dtype, columns below
  // dd only (a thread's pair of columns 8 j + cq, + 1 lies below dd
  // whenever 8 j does, as dd % 8 == 0)
  const int cq = 2 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ki = k0 + acc_row(0) + 8 * h;
    if (ki >= Tk) continue;
    const size_t row = ((size_t)bkv * Tk + ki) * dd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j >= dd / 8) break;
      const int i = 4 * j + 2 * h;
      if constexpr (DK)
        *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * j + cq) =
            __floats2bfloat162_rn(dka[i] * scale, dka[i + 1] * scale);
      if constexpr (DV)
        *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * j + cq) =
            __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

// Widths 64 and 128: one block a (b*Hkv, key tile), both outputs.  Width
// 256: the grid's z picks the output, dV (z = 0) or dK (z = 1); see the
// file's note on the width-256 instances
template <int D, bool PADDED>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ klen,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int H, int Hkv, int Tq, int Tk, int Dt,
                           int causal, float scale) {
  if constexpr (D <= 128) {
    dkv_block<D, PADDED, kDkv>(&tq, &tk, &tv, &tdo, lse, delta, klen, dk,
                               dv, H, Hkv, Tq, Tk, Dt, causal, scale);
  } else if (blockIdx.z == 0) {
    dkv_block<D, PADDED, kDv>(&tq, &tk, &tv, &tdo, lse, delta, klen, dk, dv,
                              H, Hkv, Tq, Tk, Dt, causal, scale);
  } else {
    dkv_block<D, PADDED, kDk>(&tq, &tk, &tv, &tdo, lse, delta, klen, dk, dv,
                              H, Hkv, Tq, Tk, Dt, causal, scale);
  }
}

// The launchers build their maps with the true head dim Dt, so TMA reads
// columns Dt .. D-1 of the padded width D as zeros
template <int D, bool PADDED>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* klen, const void* lse, const void* delta,
                    const void* dout, void* dk, void* dv, int B, int H,
                    int Hkv, int Tq, int Tk, int Dt, int causal, float scale,
                    cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc = hopper::map_bf16_3d(&mq, q, B * H, Tq, Dt, WQ);
  if (rc == 0) rc = hopper::map_bf16_3d(&mdo, dout, B * H, Tq, Dt, WQ);
  if (rc == 0) rc = hopper::map_bf16_3d(&mk, k, B * Hkv, Tk, Dt, WK);
  if (rc == 0) rc = hopper::map_bf16_3d(&mv, v, B * Hkv, Tk, Dt, WK);
  if (rc != 0) return rc;
  const size_t smem = sizeof(DkvSmem<D>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D, PADDED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * Hkv, (Tk + WK - 1) / WK, D <= 128 ? 1 : 2);
  flash_bwd_dkv_wgmma_kernel<D, PADDED><<<grid, NT, smem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta,
      (const int*)klen, (bf16*)dk, (bf16*)dv, H, Hkv, Tq, Tk, Dt, causal,
      scale);
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

// thread 0: K/V tile t of head kvh into stage s, their first nl chunks
// (loaded_chunks)
template <int D>
__device__ __forceinline__ void load_kv(DqSmem<D>& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int kvh, int t,
                                        int s, int nl) {
  hopper::mbar_expect_tx(&sm.full[s], 2 * WK * 64 * nl * sizeof(bf16));
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    if (c >= nl) break;
    hopper::tma_load_3d(sm.k[s][c], tk, &sm.full[s], 64 * c, t * WK, kvh);
    hopper::tma_load_3d(sm.v[s][c], tv, &sm.full[s], 64 * c, t * WK, kvh);
  }
}

template <int D, bool PADDED>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ klen, bf16* __restrict__ dq,
                          int H, int Hkv, int Tq, int Tk, int Dt, int causal,
                          float scale) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(align_1024(smem_raw));

  const int tid = threadIdx.x;
  const int dd = PADDED ? Dt : D;       // the true head dim (row stride)
  const int nk16 = (dd + 15) / 16;      // k16 steps of the products over D
  const int nl = loaded_chunks<D, PADDED>(dd);
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
        mbar_expect_tx(&sm.qbar, 2 * WQ * 64 * nl * sizeof(bf16));
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          if (c >= nl) break;
          tma_load_3d(sm.q[c], &tq, &sm.qbar, 64 * c, q0, bh);
          tma_load_3d(sm.dout[c], &tdo, &sm.qbar, 64 * c, q0, bh);
        }
        for (int s = 0; s < STAGES && s < ntiles; ++s)
          load_kv(sm, &tk, &tv, kvh, s, s, nl);
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
      if (kc >= nk16) break;
      const int c = kc / 4, off = (kc % 4) * 16;
      wgmma_ss<0>(sacc, make_desc(sm.q[c] + off, 16, 1024),
                  make_desc(sm.k[s][c] + off, 16, 1024), kc > 0);
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      if (kc >= nk16) break;
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
    // dS goes to dQ as two bf16 terms (hi, lo: SplitDs says why)
    uint32_t dsa[WK / 16][4], dsl[WK / 16][4];
    acc_to_a_split(dp, dsa, dsl);

    // dQ += dS K: B = K, the keys being the reduction (MN-major, tnspB = 1;
    // N = D, the chunk regions LBO apart)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      wgmma_rs<1>(acc, dsl[kk],
                  make_desc(sm.k[s][0] + kk * 16 * 64, WK * 128, 1024), 1);
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
      load_kv(sm, &tk, &tv, kvh, t + STAGES, s, nl);
    }
  }

  // dQ x scale once, in q's dtype, columns below dd only; TMA bounds its
  // reads at Tq and dd, not these stores
  const int cq = 2 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r0 + 8 * h;
    if (qi >= Tq) continue;
    bf16* op = dq + ((size_t)bh * Tq + qi) * dd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j >= dd / 8) break;
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale,
                                acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

template <int D, bool PADDED>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* klen, const void* lse, const void* delta,
                   const void* dout, void* dq, int B, int H, int Hkv, int Tq,
                   int Tk, int Dt, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc = hopper::map_bf16_3d(&mq, q, B * H, Tq, Dt, WQ);
  if (rc == 0) rc = hopper::map_bf16_3d(&mdo, dout, B * H, Tq, Dt, WQ);
  if (rc == 0) rc = hopper::map_bf16_3d(&mk, k, B * Hkv, Tk, Dt, WK);
  if (rc == 0) rc = hopper::map_bf16_3d(&mv, v, B * Hkv, Tk, Dt, WK);
  if (rc != 0) return rc;
  const size_t smem = sizeof(DqSmem<D>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D, PADDED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + WQ - 1) / WQ);
  flash_bwd_dq_wgmma_kernel<D, PADDED><<<grid, NT, smem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta,
      (const int*)klen, (bf16*)dq, H, Hkv, Tq, Tk, Dt, causal, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------- float32, 3xTF32 tensor cores

// rows of a ring tile: keys (dQ), query rows (dK/dV).  32 at D = 64, 16 at
// D = 128, where the 32-row layouts need more shared memory than a block
// may have
template <int D>
__host__ __device__ constexpr int ring_rows() {
  return D == 64 ? 32 : 16;
}
constexpr int TSTAGES = 2;   // raw ring depth

// one [rows x 32] float32 region of a tile in the 128-byte swizzle
template <int ROWS>
using FChunk = float[ROWS * 32];

__device__ __forceinline__ const float4* f4(const float* p) {
  return reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4* f4(float* p) {
  return reinterpret_cast<float4*>(p);
}

// Where transposed slot vb (0, 1) of TT-row tiles lies among [D x 32]
// regions: a 32-row tile fills region vb; two 16-row tiles share region 0,
// at columns 0 and 16 (split_t writes there, the B descriptor starts there)
template <int TT>
__device__ __forceinline__ int tregion(int vb) {
  return TT == 32 ? vb : 0;
}

template <int TT>
__device__ __forceinline__ int tcol(int vb) {
  return TT == 32 ? 0 : 16 * vb;
}

// A B^T [64 x N] over D as three TF32 products a k8 step (A: 64 rows, B:
// N = 2 NR rows, both K-major hi + lo regions of 32 columns; NR
// accumulator values a thread), into NB + 1 accumulators: the big terms
// A_hi B_hi of k8 step kc into big[kc % NB], the small ones A_lo B_hi +
// A_hi B_lo into small; sum_terms adds them once the products are done.
// The tensor cores add each k8 step's products into the accumulator
// truncating toward zero, not rounding to nearest.  Added into the big
// terms' accumulator, the small terms lose their low bits at the big
// terms' scale: dS = P (dP - delta) of a row with one valid key (dP =
// delta exactly, so dS is all rounding) came out 2.3x past the float32
// check on an H100.  In their own accumulator they keep them at their
// own, 2^-11 smaller, scale; the truncations of one long chain of big
// terms still added up past the check there, so dP spreads its k8 steps
// over NB = 4 accumulators, which holds it
// (tests/test_torch_flash_bwd_tf32x3_numerics.py models the first design
// and this one).  D is the width reduced: the padded instances' KC
// regions, 32 KC (a compile-time count: a run-time one puts control flow
// between the products, and ptxas then serializes them).
template <int D, int AROWS, int NB, int NR>
__device__ __forceinline__ void product_x3(float (&big)[NB][NR],
                                           float (&small)[NR],
                                           const FChunk<AROWS>* ahi,
                                           const FChunk<AROWS>* alo,
                                           const float* bhi,
                                           const float* blo) {
  using namespace hopper;
  constexpr int BREGION = 2 * NR * 32;  // floats of a B region
#pragma unroll
  for (int kc = 0; kc < D / 8; ++kc) {
    const int c = kc / 4, off = (kc % 4) * 8;
    const uint64_t ah = make_desc(ahi[c] + off, 16, 1024);
    const uint64_t bh = make_desc(bhi + c * BREGION + off, 16, 1024);
    wgmma_ss_tf32(small, make_desc(alo[c] + off, 16, 1024), bh, kc > 0);
    wgmma_ss_tf32(small, ah, make_desc(blo + c * BREGION + off, 16, 1024),
                  1);
    wgmma_ss_tf32(big[kc % NB], ah, bh, kc >= NB);
  }
}

// out = the big accumulators, summed pairwise, + small (float32, rounded
// to nearest), once the products into them have been waited for
template <int NB, int NR>
__device__ __forceinline__ void sum_terms(float (&big)[NB][NR],
                                          float (&small)[NR],
                                          float (&out)[NR]) {
  static_assert(NB == 1 || NB == 2 || NB == 4, "pairwise sum");
#pragma unroll
  for (int b = 0; b < NB; ++b) hopper::fence_regs(big[b]);
  hopper::fence_regs(small);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float x = big[0][i];
    if constexpr (NB == 2) x += big[1][i];
    if constexpr (NB == 4) x = (x + big[1][i]) + (big[2][i] + big[3][i]);
    out[i] = x + small[i];
  }
}

// The tensor cores add into an accumulator truncating toward zero, so a
// long chain of adds drifts toward zero: dK/dV at the training llama's
// shape (4,096 query rows a key) missed the float32 check on an H100, as
// the CPU emulation predicts.  So a block adds its register
// sums into its own output tile, rounded to nearest, at every
// FLUSH_ROWS-th row of the reduction (keys for dQ, query rows of a head
// for dK/dV, also where the head changes), and starts them again from
// zero; the output is read back only by the thread that wrote it.
constexpr int FLUSH_ROWS = 256;

// out rows row0 .. row0 + 63 (below `rows`) of a [rows x dd] float32
// tensor = (the first flush) or += acc x mul, in the accumulator layout
// (2 NACC columns, of which the first dd, a multiple of 8, are stored);
// then acc = 0.  ld >= 0: the rows are ld apart (a cluster's block stores
// its dd columns of a wider row)
template <int NACC>
__device__ __forceinline__ void flush_acc(float* __restrict__ out, int row0,
                                          int rows, float (&acc)[NACC],
                                          float mul, bool first,
                                          int dd = 2 * NACC, int ld = -1) {
  constexpr int D = 2 * NACC;
  const int cq = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + hopper::acc_row(0) + 8 * h;
    if (r >= rows) continue;
    float* op = out + (size_t)r * (ld < 0 ? dd : ld);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (dd < D && j >= dd / 8) break;
      float2* p = reinterpret_cast<float2*>(op + 8 * j + cq);
      float2 x = make_float2(acc[4 * j + 2 * h] * mul,
                             acc[4 * j + 2 * h + 1] * mul);
      if (!first) {
        const float2 o = *p;
        x = make_float2(o.x + x.x, o.y + x.y);
      }
      *p = x;
    }
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
}

// acc[64 x D] += A B over the 8 K8 rows of a ring tile: A = hi + lo
// register fragments of an accumulator, B = the tile transposed (split_t),
// bthi / btlo at its first column
template <int NACC, int K8>
__device__ __forceinline__ void product_rs_x3(float (&acc)[NACC],
                                              uint32_t (&ahi)[K8][4],
                                              uint32_t (&alo)[K8][4],
                                              const float* bthi,
                                              const float* btlo) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < K8; ++kk) {
    const uint64_t bh = make_desc(bthi + kk * 8, 16, 1024);
    wgmma_rs_tf32(acc, alo[kk], bh, 1);
    wgmma_rs_tf32(acc, ahi[kk], make_desc(btlo + kk * 8, 16, 1024), 1);
    wgmma_rs_tf32(acc, ahi[kk], bh, 1);
  }
}

// The width-256 instances run as a cluster of two blocks that split D:
// each block reduces S and dP (S^T and dP^T) over its 128 columns, and
// the two add their partial sums.  exchange_partials writes this block's
// partials a[NR], b[NR] into the peer's copy of `buf` (8 KB: float4 j of
// thread t at j NT + t, so the thread that holds the same (row, column)
// in the peer reads it) by st.async, each store completing its bytes on
// the peer's xfull, then waits for the peer's bytes on its own xfull
// (phase `parity`; thread 0 arrives expecting them) and adds them: a =
// own + peer, rounded to nearest, which is peer + own, so both blocks
// hold the same sums bit for bit.  `buf` is the ring stage of the tile
// the pass works on, which both blocks split in the pass before, ahead of
// that pass's exchange: so the peer, which writes here only after it
// received this block's partials of the pass before, finds it free.  The
// caller does not reuse `buf` before a __syncthreads after.  xfull[2]
// alternates by pass (parity (t / 2) & 1): the peer's bytes of the next
// pass may land before this block has waited for this one's.
template <int NR>
__device__ __forceinline__ void exchange_partials(float (&a)[NR],
                                                  float (&b)[NR], float* buf,
                                                  uint64_t* xfull,
                                                  int parity,
                                                  uint32_t peer) {
  using namespace hopper;
  static_assert(NR % 4 == 0, "whole float4s");
  const int t = threadIdx.x;
  const uint32_t rbuf = peer_addr(buf, peer), rbar = peer_addr(xfull, peer);
#pragma unroll
  for (int j = 0; j < NR / 4; ++j) {
    st_async(rbuf + 16 * (j * NT + t),
             make_float4(a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3]),
             rbar);
    st_async(rbuf + 16 * ((NR / 4 + j) * NT + t),
             make_float4(b[4 * j], b[4 * j + 1], b[4 * j + 2], b[4 * j + 3]),
             rbar);
  }
  if (t == 0) mbar_expect_tx(xfull, 2 * NR * NT * sizeof(float));
  mbar_wait_cluster(xfull, parity);
  const float4* x = f4(buf);
#pragma unroll
  for (int j = 0; j < NR / 4; ++j) {
    const float4 u = x[j * NT + t], w = x[(NR / 4 + j) * NT + t];
    a[4 * j] += u.x;
    a[4 * j + 1] += u.y;
    a[4 * j + 2] += u.z;
    a[4 * j + 3] += u.w;
    b[4 * j] += w.x;
    b[4 * j + 1] += w.y;
    b[4 * j + 2] += w.z;
    b[4 * j + 3] += w.w;
  }
}

// ------------------------------------------------------------ dQ, float32

template <int D>
struct DqTf32Smem {
  static constexpr int TT = ring_rows<D>();
  FChunk<WQ> qhi[D / 32], qlo[D / 32];    // Q, dO as TF32 hi + lo
  FChunk<WQ> dohi[D / 32], dolo[D / 32];
  FChunk<TT> kraw[TSTAGES][D / 32];       // the TMA ring: K, V as loaded
  FChunk<TT> vraw[TSTAGES][D / 32];
  FChunk<TT> khi[D / 32], klo[D / 32];    // this tile's K, V (S, dP)
  FChunk<TT> vhi[D / 32], vlo[D / 32];
  FChunk<D> kthi[TT / 16], ktlo[TT / 16];  // K^T of tiles t, t+1 (tregion)
  uint64_t qbar, full[TSTAGES];
};

// thread 0: K/V tile t of head kvh into ring stage s, its first KC
// 32-column regions (a region wholly past the true head dim is not
// loaded: no product reads it), from column col0 on
template <int KC, int D>
__device__ __forceinline__ void load_kv_f32(DqTf32Smem<D>& sm,
                                            const CUtensorMap* tk,
                                            const CUtensorMap* tv, int kvh,
                                            int t, int s, int col0 = 0) {
  constexpr int TT = ring_rows<D>();
  hopper::mbar_expect_tx(&sm.full[s], 2 * TT * 32 * KC * sizeof(float));
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    hopper::tma_load_3d(sm.kraw[s][c], tk, &sm.full[s], col0 + 32 * c,
                        t * TT, kvh);
    hopper::tma_load_3d(sm.vraw[s][c], tv, &sm.full[s], col0 + 32 * c,
                        t * TT, kvh);
  }
}

// ring stage s: K into K_hi, K_lo and K^T slot vb, V into V_hi, V_lo;
// the first KC regions (the loaded ones)
template <int KC, int D>
__device__ __forceinline__ void split_kv_tile(DqTf32Smem<D>& sm, int s,
                                              int vb) {
  constexpr int TT = ring_rows<D>();
  hopper::split_tf32<TT * 8 * KC>(f4(sm.kraw[s][0]), f4(sm.khi[0]),
                                  f4(sm.klo[0]));
  hopper::split_tf32<TT * 8 * KC>(f4(sm.vraw[s][0]), f4(sm.vhi[0]),
                                  f4(sm.vlo[0]));
  hopper::split_t<32 * KC, TT>(sm.kraw[s][0], sm.kthi[tregion<TT>(vb)],
                               sm.ktlo[tregion<TT>(vb)], tcol<TT>(vb));
}

// The width-256 dQ: one block of a two-block cluster, rank r taking
// columns col0 = 128 r on (KC of their 32-column regions), with the D =
// 128 layout (DqTf32Smem<128>) and the peer's arrivals (xfull, one
// barrier a pass parity: the peer's arrivals of the next pass may land
// before this block has seen this one's).  A pass of tile t: S and dP
// over this block's columns, tile t+1 split (its ring stage is then free),
// the partials exchanged through ring stage t % 2 (split in the last
// pass), that stage refilled, then P, dS and dQ += dS K on this block's
// columns.  The peer writes stage t % 2 only after this block's arrival of
// pass t-1, which comes after its split of tile t; both blocks walk the
// same tiles, decided from (b, h, q tile) alone.
struct DqClusterSmem : DqTf32Smem<128> {
  uint64_t xfull[2];
};

template <int KC>
__device__ __forceinline__ void dq_cluster_half(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ klen,
    float* __restrict__ dq, int H, int Hkv, int Tq, int Tk, int dd,
    int causal, float scale, uint32_t rank) {
  using namespace hopper;
  constexpr int TT = ring_rows<128>();
  extern __shared__ uint8_t smem_raw[];
  DqClusterSmem& sm =
      *reinterpret_cast<DqClusterSmem*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int col0 = 128 * rank;
  const int cols = min(128, dd - col0);  // this block's columns of dQ
  const uint32_t peer = rank ^ 1;
  const int bh = blockIdx.x / 2;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WQ;  // heaviest tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;
  int kend = kl;
  if (causal) kend = min(kend, max(0, min(q0 + WQ, Tq) + offset));
  const int ntiles = (kend + TT - 1) / TT;

  if (tid == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < TSTAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.xfull[s], 1);  // thread 0, with the peer's bytes
    }
    mbar_fence_init();
    if (ntiles > 0) {
      mbar_expect_tx(&sm.qbar, 2 * WQ * 32 * KC * sizeof(float));
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        tma_load_3d(sm.qhi[c], tq, &sm.qbar, col0 + 32 * c, q0, bh);
        tma_load_3d(sm.dohi[c], tdo, &sm.qbar, col0 + 32 * c, q0, bh);
      }
      for (int s = 0; s < TSTAGES && s < ntiles; ++s)
        load_kv_f32<KC>(sm, tk, tv, kvh, s, s, col0);
    }
  }
  const int r0 = acc_row(0);
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r0 + 8 * h;
    const size_t row = (size_t)bh * Tq + qi;
    lse2[h] = qi < Tq ? lse[row] * LOG2E : 0.f;
    dl[h] = qi < Tq ? delta[row] : 0.f;
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  bool first = true;
  float* const out = dq + (size_t)bh * Tq * dd + col0;

  if (ntiles > 0) {
    mbar_wait(&sm.qbar, 0);
    split_tf32<WQ * 8 * KC>(f4(sm.qhi[0]), f4(sm.qhi[0]), f4(sm.qlo[0]));
    split_tf32<WQ * 8 * KC>(f4(sm.dohi[0]), f4(sm.dohi[0]), f4(sm.dolo[0]));
    mbar_wait(&sm.full[0], 0);
    split_kv_tile<KC>(sm, 0, 0);
    fence_proxy_async();
  }
  // both blocks run, their barriers are set up, tile 0 is split in both
  // (the peer may write its stage)
  cluster_sync();
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TT, vb = t % 2, s = t % TSTAGES;

    // partial S = Q K^T and dP = dO V^T over this block's columns
    float sbig[1][TT / 2], ssm[TT / 2], dpbig[4][TT / 2], dpsm[TT / 2];
    wgmma_fence();
    product_x3<32 * KC, WQ>(sbig, ssm, sm.qhi, sm.qlo, sm.khi[0],
                            sm.klo[0]);
    product_x3<32 * KC, WQ>(dpbig, dpsm, sm.dohi, sm.dolo, sm.vhi[0],
                            sm.vlo[0]);
    wgmma_commit();
    wgmma_wait<0>();
    float sacc[TT / 2], dp[TT / 2];
    sum_terms(sbig, ssm, sacc);
    sum_terms(dpbig, dpsm, dp);
    __syncthreads();  // every warp is done with K and V split
    if (t + 1 < ntiles) {
      // K^T slot 1 - vb was read by tile t-1's dS K, waited for by all
      const int s1 = (t + 1) % TSTAGES;
      mbar_wait(&sm.full[s1], ((t + 1) / TSTAGES) & 1);
      split_kv_tile<KC>(sm, s1, 1 - vb);
      fence_proxy_async();
    }
    exchange_partials(sacc, dp, sm.kraw[s][0], &sm.xfull[vb], (t / 2) & 1,
                      peer);
    __syncthreads();  // every thread has read the peer's partials
    if (tid == 0 && t + TSTAGES < ntiles) {
      fence_proxy_async();  // the peer's writes, then TMA's
      load_kv_f32<KC>(sm, tk, tv, kvh, t + TSTAGES, s, col0);
    }

    // P and dS under the masks, as in the width-128 kernel
    const bool interior = k0 + TT <= kl && q0 + WQ <= Tq &&
                          (!causal || k0 + TT - 1 <= q0 + offset);
#pragma unroll
    for (int i = 0; i < TT / 2; ++i) {
      const int h = (i >> 1) & 1;
      bool valid = true;
      if (!interior) {
        const int ki = k0 + acc_col(i), qi = q0 + acc_row(i);
        valid = ki < kl && qi < Tq && (!causal || ki <= qi + offset);
      }
      const float p = valid ? exp2f(sacc[i] * sl2 - lse2[h]) : 0.f;
      dp[i] = valid ? p * (dp[i] - dl[h]) : 0.f;
    }
    uint32_t dshi[TT / 8][4], dslo[TT / 8][4];
    acc_to_tf32_split(dp, dshi, dslo);

    // dQ += dS K on this block's columns, K^T staged keys contiguous
    wgmma_fence();
    product_rs_x3(acc, dshi, dslo, sm.kthi[tregion<TT>(vb)] + tcol<TT>(vb),
                  sm.ktlo[tregion<TT>(vb)] + tcol<TT>(vb));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    keep_regs(dshi);
    keep_regs(dslo);
    if ((k0 + TT) % FLUSH_ROWS == 0 && t + 1 < ntiles) {
      flush_acc(out, q0, Tq, acc, scale, first, cols, dd);
      first = false;
    }
  }

  // the last chain, x scale (a tile without keys writes zeros)
  flush_acc(out, q0, Tq, acc, scale, first, cols, dd);
}

// KC: the 32-column regions the products over D reduce, a compile-time
// count (D / 32 unpadded; in the padded instances the regions that hold
// columns below the true head dim, whose columns past it are TMA's zeros)
template <int D, bool PADDED, int KC>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ klen,
                           float* __restrict__ dq, int H, int Hkv, int Tq,
                           int Tk, int Dt, int causal, float scale) {
  if constexpr (D == 256) {
    // a cluster of two blocks splitting D (dq_cluster_half): rank 0 takes
    // columns 0-127, rank 1 the KC - 4 regions from 128 on; one fully
    // unrolled body a rank
    static_assert(KC >= 5 && KC <= 8 && (PADDED || KC == 8),
                  "the regions of the second block");
    const uint32_t rank = hopper::cluster_rank();
    if constexpr (KC == 8) {
      dq_cluster_half<4>(&tq, &tk, &tv, &tdo, lse, delta, klen, dq, H, Hkv,
                         Tq, Tk, PADDED ? Dt : D, causal, scale, rank);
    } else if (rank == 0) {
      dq_cluster_half<4>(&tq, &tk, &tv, &tdo, lse, delta, klen, dq, H, Hkv,
                         Tq, Tk, Dt, causal, scale, 0);
    } else {
      dq_cluster_half<KC - 4>(&tq, &tk, &tv, &tdo, lse, delta, klen, dq, H,
                              Hkv, Tq, Tk, Dt, causal, scale, 1);
    }
  } else {
    using namespace hopper;
    constexpr int NC = D / 32;  // 32-column regions of a row
    constexpr int TT = ring_rows<D>();
    extern __shared__ uint8_t smem_raw[];
    DqTf32Smem<D>& sm = *reinterpret_cast<DqTf32Smem<D>*>(align_1024(smem_raw));

    static_assert(PADDED ? KC <= NC : KC == NC, "regions of the products");
    const int tid = threadIdx.x;
    const int dd = PADDED ? Dt : D;       // the true head dim (row stride)
    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * WQ;  // heaviest tiles first
    const int b = bh / H;
    const int kvh = b * Hkv + (bh % H) / (H / Hkv);
    const int kl = min(klen[b], Tk);
    const int offset = Tk - Tq;
    // keys any row of this tile may see, as in the forward
    int kend = kl;
    if (causal) kend = min(kend, max(0, min(q0 + WQ, Tq) + offset));
    const int ntiles = (kend + TT - 1) / TT;

    if (tid == 0) {
      mbar_init(&sm.qbar, 1);
      for (int s = 0; s < TSTAGES; ++s) mbar_init(&sm.full[s], 1);
      mbar_fence_init();
      if (ntiles > 0) {
        mbar_expect_tx(&sm.qbar, 2 * WQ * 32 * KC * sizeof(float));
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          tma_load_3d(sm.qhi[c], &tq, &sm.qbar, 32 * c, q0, bh);
          tma_load_3d(sm.dohi[c], &tdo, &sm.qbar, 32 * c, q0, bh);
        }
        for (int s = 0; s < TSTAGES && s < ntiles; ++s)
          load_kv_f32<KC>(sm, &tk, &tv, kvh, s, s);
      }
    }
    // this thread's two rows of the tile (acc_row(i) is r0 + 8 ((i >> 1) &
    // 1)): LSE in base 2 and delta, 0 past Tq
    const int r0 = acc_row(0);
    const float sl2 = scale * LOG2E;
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + r0 + 8 * h;
      const size_t row = (size_t)bh * Tq + qi;
      lse2[h] = qi < Tq ? lse[row] * LOG2E : 0.f;
      dl[h] = qi < Tq ? delta[row] : 0.f;
    }
    __syncthreads();

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    bool first = true;  // no chain added into dq yet

    // Q, dO and tile 0 are split before the loop; tile t+1 is split while
    // tile t's dS K runs on the tensor cores
    if (ntiles > 0) {
      mbar_wait(&sm.qbar, 0);
      split_tf32<WQ * 8 * KC>(f4(sm.qhi[0]), f4(sm.qhi[0]), f4(sm.qlo[0]));
      split_tf32<WQ * 8 * KC>(f4(sm.dohi[0]), f4(sm.dohi[0]), f4(sm.dolo[0]));
      mbar_wait(&sm.full[0], 0);
      split_kv_tile<KC>(sm, 0, 0);
      fence_proxy_async();  // the split copies are read by wgmma
    }
    __syncthreads();
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = t * TT, vb = t % 2;
      // tile t's stage was split in the last pass: refill it
      if (tid == 0 && t + TSTAGES < ntiles)
        load_kv_f32<KC>(sm, &tk, &tv, kvh, t + TSTAGES, t % TSTAGES);

      // S = Q K^T and dP = dO V^T: 64 query rows x TT keys
      float sbig[1][TT / 2], ssm[TT / 2], dpbig[4][TT / 2], dpsm[TT / 2];
      wgmma_fence();
      product_x3<32 * KC, WQ>(sbig, ssm, sm.qhi, sm.qlo, sm.khi[0],
                              sm.klo[0]);
      product_x3<32 * KC, WQ>(dpbig, dpsm, sm.dohi, sm.dolo, sm.vhi[0],
                              sm.vlo[0]);
      wgmma_commit();
      wgmma_wait<0>();
      float sacc[TT / 2], dp[TT / 2];
      sum_terms(sbig, ssm, sacc);
      sum_terms(dpbig, dpsm, dp);
      __syncthreads();  // every warp is done with K and V split

      // P = exp(scale S - LSE) and dS = P (dP - delta) under the masks, P =
      // 0 where masked; interior tiles skip the mask
      const bool interior = k0 + TT <= kl && q0 + WQ <= Tq &&
                            (!causal || k0 + TT - 1 <= q0 + offset);
#pragma unroll
      for (int i = 0; i < TT / 2; ++i) {
        const int h = (i >> 1) & 1;
        bool valid = true;
        if (!interior) {
          const int ki = k0 + acc_col(i), qi = q0 + acc_row(i);
          valid = ki < kl && qi < Tq && (!causal || ki <= qi + offset);
        }
        const float p = valid ? exp2f(sacc[i] * sl2 - lse2[h]) : 0.f;
        dp[i] = valid ? p * (dp[i] - dl[h]) : 0.f;
      }
      uint32_t dshi[TT / 8][4], dslo[TT / 8][4];
      acc_to_tf32_split(dp, dshi, dslo);

      // dQ += dS K, K^T staged keys contiguous
      wgmma_fence();
      product_rs_x3(acc, dshi, dslo, sm.kthi[tregion<TT>(vb)] + tcol<TT>(vb),
                    sm.ktlo[tregion<TT>(vb)] + tcol<TT>(vb));
      wgmma_commit();
      if (t + 1 < ntiles) {
        // K^T slot 1 - vb was read by tile t-1's dS K, waited for by all
        const int s1 = (t + 1) % TSTAGES;
        mbar_wait(&sm.full[s1], ((t + 1) / TSTAGES) & 1);
        split_kv_tile<KC>(sm, s1, 1 - vb);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      keep_regs(dshi);
      keep_regs(dslo);
      if ((k0 + TT) % FLUSH_ROWS == 0 && t + 1 < ntiles) {
        flush_acc(dq + (size_t)bh * Tq * dd, q0, Tq, acc, scale, first, dd);
        first = false;
      }
      __syncthreads();  // tile t+1 split; every warp is done with K^T vb
    }

    // the last chain, x scale (a tile without keys writes zeros)
    flush_acc(dq + (size_t)bh * Tq * dd, q0, Tq, acc, scale, first, dd);
  }
}

// a launch in clusters of two blocks along x (the grid's x is even)
template <typename... Params, typename... Args>
cudaError_t launch_pairs(void (*kernel)(Params...), dim3 grid, size_t smem,
                         cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int D, bool PADDED, int KC>
int launch_dq_tf32x3(const void* q, const void* k, const void* v,
                     const void* klen, const void* lse, const void* delta,
                     const void* dout, void* dq, int B, int H, int Hkv,
                     int Tq, int Tk, int Dt, int causal, float scale,
                     cudaStream_t stream) {
  constexpr int TT = ring_rows<D>();
  CUtensorMap mq, mk, mv, mdo;
  int rc = hopper::map_f32_3d(&mq, q, B * H, Tq, Dt, WQ);
  if (rc == 0) rc = hopper::map_f32_3d(&mdo, dout, B * H, Tq, Dt, WQ);
  if (rc == 0) rc = hopper::map_f32_3d(&mk, k, B * Hkv, Tk, Dt, TT);
  if (rc == 0) rc = hopper::map_f32_3d(&mv, v, B * Hkv, Tk, Dt, TT);
  if (rc != 0) return rc;
  // the width-256 instance lays each block of its cluster out as the
  // width-128 one, with the peer's barriers
  using Smem = std::conditional_t<D == 256, DqClusterSmem, DqTf32Smem<D>>;
  const size_t smem = sizeof(Smem) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_tf32x3_kernel<D, PADDED, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if constexpr (D == 256) {
    const dim3 grid(2 * B * H, (Tq + WQ - 1) / WQ);
    e = launch_pairs(flash_bwd_dq_tf32x3_kernel<D, PADDED, KC>, grid, smem,
                     stream, mq, mk, mv, mdo, (const float*)lse,
                     (const float*)delta, (const int*)klen, (float*)dq, H,
                     Hkv, Tq, Tk, Dt, causal, scale);
    if (e != cudaSuccess) return (int)e;
  } else {
    const dim3 grid(B * H, (Tq + WQ - 1) / WQ);
    flash_bwd_dq_tf32x3_kernel<D, PADDED, KC><<<grid, NT, smem, stream>>>(
        mq, mk, mv, mdo, (const float*)lse, (const float*)delta,
        (const int*)klen, (float*)dq, H, Hkv, Tq, Tk, Dt, causal, scale);
  }
  return (int)cudaGetLastError();
}

// --------------------------------------------------------- dK/dV, float32

// Q^T and dO^T: 32-row tiles keep two slots of each (Q^T slots 0, 1, dO^T
// 2, 3), so tile it+1's are written while tile it's dV and dK products
// read tile it's; 16-row tiles (D = 128) keep one slot of each, Q^T and
// dO^T side by side in one region (qt_slot)
template <int D>
struct DkvTf32Smem {
  static constexpr int TT = ring_rows<D>();
  static constexpr int T_REGIONS = TT == 32 ? 4 : 1;
  FChunk<WK> khi[D / 32], klo[D / 32];    // K, V as TF32 hi + lo
  FChunk<WK> vhi[D / 32], vlo[D / 32];
  FChunk<TT> qraw[TSTAGES][D / 32];       // the TMA ring: Q, dO as loaded
  FChunk<TT> doraw[TSTAGES][D / 32];
  FChunk<TT> qhi[D / 32], qlo[D / 32];    // this tile's Q, dO (S^T, dP^T)
  FChunk<TT> dohi[D / 32], dolo[D / 32];
  FChunk<D> thi[T_REGIONS], tlo[T_REGIONS];  // Q^T, dO^T
  float lse2[2][TT], delta[2][TT];        // LSE (base 2) and delta of
                                          // ring tiles it, it+1
  uint64_t kvbar, full[TSTAGES];
};

// the transposed slot (tregion, tcol) of Q^T (which = 0) or dO^T (which
// = 1) for tiles of parity vb
template <int TT>
__device__ __forceinline__ int qt_slot(int which, int vb) {
  return TT == 32 ? 2 * which + vb : which;
}

// thread 0: Q and dO of ring tile `pos` into stage s, their first KC
// 32-column regions from column col0 on (as load_kv_f32)
template <int KC, int D>
__device__ __forceinline__ void load_qdo_f32(DkvTf32Smem<D>& sm,
                                             const CUtensorMap* tq,
                                             const CUtensorMap* tdo,
                                             RingPos pos, int s,
                                             int col0 = 0) {
  constexpr int TT = ring_rows<D>();
  hopper::mbar_expect_tx(&sm.full[s], 2 * TT * 32 * KC * sizeof(float));
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    hopper::tma_load_3d(sm.qraw[s][c], tq, &sm.full[s], col0 + 32 * c,
                        pos.q0, pos.bh);
    hopper::tma_load_3d(sm.doraw[s][c], tdo, &sm.full[s], col0 + 32 * c,
                        pos.q0, pos.bh);
  }
}

// ring stage s: Q^T and dO^T into transposed slot vb, their first 32 KC
// rows
template <int KC, int D>
__device__ __forceinline__ void split_qdo_t(DkvTf32Smem<D>& sm, int s,
                                            int vb) {
  constexpr int TT = ring_rows<D>();
  const int sq = qt_slot<TT>(0, vb), sdo = qt_slot<TT>(1, vb);
  hopper::split_t<32 * KC, TT>(sm.qraw[s][0], sm.thi[tregion<TT>(sq)],
                               sm.tlo[tregion<TT>(sq)], tcol<TT>(sq));
  hopper::split_t<32 * KC, TT>(sm.doraw[s][0], sm.thi[tregion<TT>(sdo)],
                               sm.tlo[tregion<TT>(sdo)], tcol<TT>(sdo));
}

// ring stage s (tile `pos`): Q into Q_hi, Q_lo and dO into dO_hi, dO_lo,
// and with WITH_T Q^T and dO^T into transposed slot vb; the first warp
// loads the tile's LSE and delta into buffer vb, 0 past Tq (plain loads: a
// tile's rows start at any float of the flat [B*H*Tq] vectors, which a TMA
// box does not take); the first KC regions (the loaded ones)
template <int KC, bool WITH_T, int D>
__device__ __forceinline__ void split_qdo_tile(DkvTf32Smem<D>& sm, int s,
                                               int vb, RingPos pos,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int Tq) {
  constexpr int TT = ring_rows<D>();
  const int r = threadIdx.x;
  if (r < TT) {
    const bool in = pos.q0 + r < Tq;
    const size_t row = (size_t)pos.bh * Tq + pos.q0 + r;
    sm.lse2[vb][r] = in ? lse[row] * LOG2E : 0.f;
    sm.delta[vb][r] = in ? delta[row] : 0.f;
  }
  hopper::split_tf32<TT * 8 * KC>(f4(sm.qraw[s][0]), f4(sm.qhi[0]),
                                  f4(sm.qlo[0]));
  hopper::split_tf32<TT * 8 * KC>(f4(sm.doraw[s][0]), f4(sm.dohi[0]),
                                  f4(sm.dolo[0]));
  if constexpr (WITH_T) split_qdo_t<KC>(sm, s, vb);
}

// The width-256 dK/dV: one block of a two-block cluster, rank r taking
// columns col0 = 128 r on (KC regions), with the D = 128 layout
// (DkvTf32Smem<128>, one transposed slot) and xfull as in dq_cluster_half.
// A pass of ring tile it: S^T and dP^T over this block's columns, beside
// them tile it's Q^T and dO^T transposed from its split (transpose_t: the
// ring stage is then read no more); tile it+1 split with its LSE and
// delta; the partials exchanged through ring stage it % 2; that stage
// refilled; then P^T, dS^T, dV += P^T dO and dK += dS^T Q on this
// block's columns.  Both blocks walk the same ring tiles, decided from
// (b, hk, key tile) alone.
struct DkvClusterSmem : DkvTf32Smem<128> {
  uint64_t xfull[2];
};

template <int KC>
__device__ __forceinline__ void dkv_cluster_half(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ klen,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Tq,
    int Tk, int dd, int causal, float scale, uint32_t rank) {
  using namespace hopper;
  constexpr int TT = ring_rows<128>();
  extern __shared__ uint8_t smem_raw[];
  DkvClusterSmem& sm =
      *reinterpret_cast<DkvClusterSmem*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int col0 = 128 * rank;
  const int cols = min(128, dd - col0);  // this block's columns
  const uint32_t peer = rank ^ 1;
  const int bkv = blockIdx.x / 2;
  const int k0 = blockIdx.y * WK;
  const int b = bkv / Hkv, hk = bkv % Hkv, g = H / Hkv;
  const int kl = min(klen[b], Tk);
  const int offset = Tk - Tq;
  const int qt0 = causal ? max(0, k0 - offset) / TT : 0;
  const int nq = (Tq + TT - 1) / TT - qt0;
  const int total = (k0 < kl && nq > 0) ? g * nq : 0;

  if (tid == 0) {
    mbar_init(&sm.kvbar, 1);
    for (int s = 0; s < TSTAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.xfull[s], 1);  // thread 0, with the peer's bytes
    }
    mbar_fence_init();
    if (total > 0) {
      mbar_expect_tx(&sm.kvbar, 2 * WK * 32 * KC * sizeof(float));
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        tma_load_3d(sm.khi[c], tk, &sm.kvbar, col0 + 32 * c, k0, bkv);
        tma_load_3d(sm.vhi[c], tv, &sm.kvbar, col0 + 32 * c, k0, bkv);
      }
      for (int s = 0; s < TSTAGES && s < total; ++s)
        load_qdo_f32<KC>(sm, tq, tdo, ring_pos(s, b, H, hk, g, qt0, nq, TT),
                         s, col0);
    }
  }
  __syncthreads();

  const float sl2 = scale * LOG2E;
  float dka[64], dva[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
  bool first = true;
  float* const dkb = dk + (size_t)bkv * Tk * dd + col0;
  float* const dvb = dv + (size_t)bkv * Tk * dd + col0;

  if (total > 0) {
    mbar_wait(&sm.kvbar, 0);
    split_tf32<WK * 8 * KC>(f4(sm.khi[0]), f4(sm.khi[0]), f4(sm.klo[0]));
    split_tf32<WK * 8 * KC>(f4(sm.vhi[0]), f4(sm.vhi[0]), f4(sm.vlo[0]));
    mbar_wait(&sm.full[0], 0);
    split_qdo_tile<KC, false>(sm, 0, 0,
                              ring_pos(0, b, H, hk, g, qt0, nq, TT), lse,
                              delta, Tq);
    fence_proxy_async();
  }
  // both blocks run, their barriers are set up, ring tile 0 is split
  cluster_sync();
  for (int it = 0; it < total; ++it) {
    const int vb = it % 2, s = it % TSTAGES;
    const int q0 = ring_pos(it, b, H, hk, g, qt0, nq, TT).q0;

    // partial S^T = K Q^T and dP^T = V dO^T over this block's columns
    float stbig[1][TT / 2], stsm[TT / 2], dptbig[4][TT / 2], dptsm[TT / 2];
    wgmma_fence();
    product_x3<32 * KC, WK>(stbig, stsm, sm.khi, sm.klo, sm.qhi[0],
                            sm.qlo[0]);
    product_x3<32 * KC, WK>(dptbig, dptsm, sm.vhi, sm.vlo, sm.dohi[0],
                            sm.dolo[0]);
    wgmma_commit();
    // Q^T beside dO^T in the one slot (read by tile it-1's dV and dK
    // products, waited for by every warp)
    transpose_t<32 * KC, TT>(sm.qhi[0], sm.thi[0], 0);
    transpose_t<32 * KC, TT>(sm.qlo[0], sm.tlo[0], 0);
    transpose_t<32 * KC, TT>(sm.dohi[0], sm.thi[0], 16);
    transpose_t<32 * KC, TT>(sm.dolo[0], sm.tlo[0], 16);
    fence_proxy_async();
    wgmma_wait<0>();
    float st[TT / 2], dpt[TT / 2];
    sum_terms(stbig, stsm, st);
    sum_terms(dptbig, dptsm, dpt);
    __syncthreads();  // every warp is done with Q and dO split and has
                      // written Q^T and dO^T
    if (it + 1 < total) {
      const int s1 = (it + 1) % TSTAGES;
      mbar_wait(&sm.full[s1], ((it + 1) / TSTAGES) & 1);
      split_qdo_tile<KC, false>(sm, s1, 1 - vb,
                                ring_pos(it + 1, b, H, hk, g, qt0, nq, TT),
                                lse, delta, Tq);
      fence_proxy_async();
    }
    exchange_partials(st, dpt, sm.qraw[s][0], &sm.xfull[vb], (it / 2) & 1,
                      peer);
    __syncthreads();  // every thread has read the peer's partials
    if (tid == 0 && it + TSTAGES < total) {
      fence_proxy_async();  // the peer's writes, then TMA's
      load_qdo_f32<KC>(sm, tq, tdo,
                       ring_pos(it + TSTAGES, b, H, hk, g, qt0, nq, TT), s,
                       col0);
    }

    // P^T and dS^T under the masks, as in the width-128 kernel
    const bool interior = k0 + WK <= kl && q0 + TT <= Tq &&
                          (!causal || k0 + WK - 1 <= q0 + offset);
#pragma unroll
    for (int i = 0; i < TT / 2; ++i) {
      const int qc = acc_col(i);
      bool valid = true;
      if (!interior) {
        const int ki = k0 + acc_row(i), qi = q0 + qc;
        valid = ki < kl && qi < Tq && (!causal || ki <= qi + offset);
      }
      const float p = valid ? exp2f(st[i] * sl2 - sm.lse2[vb][qc]) : 0.f;
      dpt[i] = valid ? p * (dpt[i] - sm.delta[vb][qc]) : 0.f;
      st[i] = p;
    }
    uint32_t phi[TT / 8][4], plo[TT / 8][4], dshi[TT / 8][4],
        dslo[TT / 8][4];
    acc_to_tf32_split(st, phi, plo);
    acc_to_tf32_split(dpt, dshi, dslo);

    // dV += P^T dO and dK += dS^T Q on this block's columns
    wgmma_fence();
    product_rs_x3(dva, phi, plo, sm.thi[0] + 16, sm.tlo[0] + 16);
    product_rs_x3(dka, dshi, dslo, sm.thi[0], sm.tlo[0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    keep_regs(phi);
    keep_regs(plo);
    keep_regs(dshi);
    keep_regs(dslo);
    // a chain ends at every FLUSH_ROWS-th query row and with each head
    if (((q0 + TT) % FLUSH_ROWS == 0 || q0 + TT >= Tq) && it + 1 < total) {
      flush_acc(dkb, k0, Tk, dka, scale, first, cols, dd);
      flush_acc(dvb, k0, Tk, dva, 1.f, first, cols, dd);
      first = false;
    }
    __syncthreads();  // every warp is done with Q^T and dO^T
  }

  // the last chain, dK x scale (a tile without work writes zeros)
  flush_acc(dkb, k0, Tk, dka, scale, first, cols, dd);
  flush_acc(dvb, k0, Tk, dva, 1.f, first, cols, dd);
}

// KC as in flash_bwd_dq_tf32x3_kernel
template <int D, bool PADDED, int KC>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ klen,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int H, int Hkv, int Tq, int Tk, int Dt,
                            int causal, float scale) {
  if constexpr (D == 256) {
    // a cluster of two blocks splitting D (dkv_cluster_half), as the dQ
    // kernel's
    static_assert(KC >= 5 && KC <= 8 && (PADDED || KC == 8),
                  "the regions of the second block");
    const uint32_t rank = hopper::cluster_rank();
    if constexpr (KC == 8) {
      dkv_cluster_half<4>(&tq, &tk, &tv, &tdo, lse, delta, klen, dk, dv, H,
                          Hkv, Tq, Tk, PADDED ? Dt : D, causal, scale,
                          rank);
    } else if (rank == 0) {
      dkv_cluster_half<4>(&tq, &tk, &tv, &tdo, lse, delta, klen, dk, dv, H,
                          Hkv, Tq, Tk, Dt, causal, scale, 0);
    } else {
      dkv_cluster_half<KC - 4>(&tq, &tk, &tv, &tdo, lse, delta, klen, dk,
                               dv, H, Hkv, Tq, Tk, Dt, causal, scale, 1);
    }
  } else {
    using namespace hopper;
    constexpr int NC = D / 32;
    constexpr int TT = ring_rows<D>();
    // two transposed slots: tile it+1's Q^T, dO^T are written beside tile
    // it's dV and dK products; one slot (D = 128): tile it's are written
    // beside its own S^T and dP^T products, which do not read them
    constexpr bool TWO_T = TT == 32;
    extern __shared__ uint8_t smem_raw[];
    DkvTf32Smem<D>& sm =
        *reinterpret_cast<DkvTf32Smem<D>*>(align_1024(smem_raw));

    static_assert(PADDED ? KC <= NC : KC == NC, "regions of the products");
    const int tid = threadIdx.x;
    const int dd = PADDED ? Dt : D;       // the true head dim (row stride)
    const int bkv = blockIdx.x;
    const int k0 = blockIdx.y * WK;
    const int b = bkv / Hkv, hk = bkv % Hkv, g = H / Hkv;
    const int kl = min(klen[b], Tk);
    const int offset = Tk - Tq;
    // the first query tile that sees this tile's first key (end-aligned
    // causal); no work when every key of the tile is past k_len
    const int qt0 = causal ? max(0, k0 - offset) / TT : 0;
    const int nq = (Tq + TT - 1) / TT - qt0;
    const int total = (k0 < kl && nq > 0) ? g * nq : 0;

    if (tid == 0) {
      mbar_init(&sm.kvbar, 1);
      for (int s = 0; s < TSTAGES; ++s) mbar_init(&sm.full[s], 1);
      mbar_fence_init();
      if (total > 0) {
        mbar_expect_tx(&sm.kvbar, 2 * WK * 32 * KC * sizeof(float));
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          tma_load_3d(sm.khi[c], &tk, &sm.kvbar, 32 * c, k0, bkv);
          tma_load_3d(sm.vhi[c], &tv, &sm.kvbar, 32 * c, k0, bkv);
        }
        for (int s = 0; s < TSTAGES && s < total; ++s)
          load_qdo_f32<KC>(sm, &tq, &tdo,
                           ring_pos(s, b, H, hk, g, qt0, nq, TT), s);
      }
    }
    __syncthreads();

    const float sl2 = scale * LOG2E;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    bool first = true;  // no chain added into dk, dv yet
    float* const dkb = dk + (size_t)bkv * Tk * dd;
    float* const dvb = dv + (size_t)bkv * Tk * dd;

    // K, V and ring tile 0 are split before the loop; tile it+1 is split
    // while tile it's dV and dK products run on the tensor cores
    if (total > 0) {
      mbar_wait(&sm.kvbar, 0);
      split_tf32<WK * 8 * KC>(f4(sm.khi[0]), f4(sm.khi[0]), f4(sm.klo[0]));
      split_tf32<WK * 8 * KC>(f4(sm.vhi[0]), f4(sm.vhi[0]), f4(sm.vlo[0]));
      mbar_wait(&sm.full[0], 0);
      split_qdo_tile<KC, TWO_T>(sm, 0, 0,
                                ring_pos(0, b, H, hk, g, qt0, nq, TT), lse,
                                delta, Tq);
      fence_proxy_async();
    }
    __syncthreads();
    for (int it = 0; it < total; ++it) {
      const int vb = it % 2, s = it % TSTAGES;
      const int q0 = ring_pos(it, b, H, hk, g, qt0, nq, TT).q0;
      // with two transposed slots, tile it's stage was read in the last pass
      if (TWO_T && tid == 0 && it + TSTAGES < total)
        load_qdo_f32<KC>(sm, &tq, &tdo,
                         ring_pos(it + TSTAGES, b, H, hk, g, qt0, nq, TT), s);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x TT query rows
      float stbig[1][TT / 2], stsm[TT / 2], dptbig[4][TT / 2], dptsm[TT / 2];
      wgmma_fence();
      product_x3<32 * KC, WK>(stbig, stsm, sm.khi, sm.klo, sm.qhi[0],
                              sm.qlo[0]);
      product_x3<32 * KC, WK>(dptbig, dptsm, sm.vhi, sm.vlo, sm.dohi[0],
                              sm.dolo[0]);
      wgmma_commit();
      if constexpr (!TWO_T) {
        // tile it-1's dV and dK, which read the one slot, were waited for
        split_qdo_t<KC>(sm, s, 0);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      float st[TT / 2], dpt[TT / 2];
      sum_terms(stbig, stsm, st);
      sum_terms(dptbig, dptsm, dpt);
      __syncthreads();  // every warp is done with Q and dO split (one slot:
                        // and has written Q^T and dO^T)
      if (!TWO_T && tid == 0 && it + TSTAGES < total)
        load_qdo_f32<KC>(sm, &tq, &tdo,
                         ring_pos(it + TSTAGES, b, H, hk, g, qt0, nq, TT), s);

      // P^T = exp(scale S^T - LSE[col]) and dS^T = P^T (dP^T - delta[col])
      // under the masks, P = 0 where masked; interior tiles skip the mask
      const bool interior = k0 + WK <= kl && q0 + TT <= Tq &&
                            (!causal || k0 + WK - 1 <= q0 + offset);
#pragma unroll
      for (int i = 0; i < TT / 2; ++i) {
        const int qc = acc_col(i);
        bool valid = true;
        if (!interior) {
          const int ki = k0 + acc_row(i), qi = q0 + qc;
          valid = ki < kl && qi < Tq && (!causal || ki <= qi + offset);
        }
        const float p = valid ? exp2f(st[i] * sl2 - sm.lse2[vb][qc]) : 0.f;
        dpt[i] = valid ? p * (dpt[i] - sm.delta[vb][qc]) : 0.f;
        st[i] = p;
      }
      uint32_t phi[TT / 8][4], plo[TT / 8][4], dshi[TT / 8][4],
          dslo[TT / 8][4];
      acc_to_tf32_split(st, phi, plo);
      acc_to_tf32_split(dpt, dshi, dslo);

      // dV += P^T dO and dK += dS^T Q, dO^T and Q^T staged rows contiguous
      const int sq = qt_slot<TT>(0, vb), sdo = qt_slot<TT>(1, vb);
      wgmma_fence();
      product_rs_x3(dva, phi, plo, sm.thi[tregion<TT>(sdo)] + tcol<TT>(sdo),
                    sm.tlo[tregion<TT>(sdo)] + tcol<TT>(sdo));
      product_rs_x3(dka, dshi, dslo, sm.thi[tregion<TT>(sq)] + tcol<TT>(sq),
                    sm.tlo[tregion<TT>(sq)] + tcol<TT>(sq));
      wgmma_commit();
      if (it + 1 < total) {
        // Q and dO split were read by tile it's S^T and dP^T, waited for;
        // with two slots, slot 1 - vb by tile it-1's products, waited for
        const int s1 = (it + 1) % TSTAGES;
        mbar_wait(&sm.full[s1], ((it + 1) / TSTAGES) & 1);
        split_qdo_tile<KC, TWO_T>(sm, s1, 1 - vb,
                                  ring_pos(it + 1, b, H, hk, g, qt0, nq, TT),
                                  lse, delta, Tq);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      keep_regs(phi);
      keep_regs(plo);
      keep_regs(dshi);
      keep_regs(dslo);
      // a chain ends at every FLUSH_ROWS-th query row and with each head
      if (((q0 + TT) % FLUSH_ROWS == 0 || q0 + TT >= Tq) && it + 1 < total) {
        flush_acc(dkb, k0, Tk, dka, scale, first, dd);
        flush_acc(dvb, k0, Tk, dva, 1.f, first, dd);
        first = false;
      }
      __syncthreads();  // tile it+1 split; every warp is done with slots vb
    }

    // the last chain, dK x scale (a tile without work writes zeros)
    flush_acc(dkb, k0, Tk, dka, scale, first, dd);
    flush_acc(dvb, k0, Tk, dva, 1.f, first, dd);
  }
}

template <int D, bool PADDED, int KC>
int launch_dkv_tf32x3(const void* q, const void* k, const void* v,
                      const void* klen, const void* lse, const void* delta,
                      const void* dout, void* dk, void* dv, int B, int H,
                      int Hkv, int Tq, int Tk, int Dt, int causal,
                      float scale, cudaStream_t stream) {
  constexpr int TT = ring_rows<D>();
  CUtensorMap mq, mk, mv, mdo;
  int rc = hopper::map_f32_3d(&mq, q, B * H, Tq, Dt, TT);
  if (rc == 0) rc = hopper::map_f32_3d(&mdo, dout, B * H, Tq, Dt, TT);
  if (rc == 0) rc = hopper::map_f32_3d(&mk, k, B * Hkv, Tk, Dt, WK);
  if (rc == 0) rc = hopper::map_f32_3d(&mv, v, B * Hkv, Tk, Dt, WK);
  if (rc != 0) return rc;
  using Smem = std::conditional_t<D == 256, DkvClusterSmem,
                                  DkvTf32Smem<D>>;
  const size_t smem = sizeof(Smem) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32x3_kernel<D, PADDED, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if constexpr (D == 256) {
    const dim3 grid(2 * B * Hkv, (Tk + WK - 1) / WK);
    e = launch_pairs(flash_bwd_dkv_tf32x3_kernel<D, PADDED, KC>, grid, smem,
                     stream, mq, mk, mv, mdo, (const float*)lse,
                     (const float*)delta, (const int*)klen, (float*)dk,
                     (float*)dv, H, Hkv, Tq, Tk, Dt, causal, scale);
    if (e != cudaSuccess) return (int)e;
  } else {
    const dim3 grid(B * Hkv, (Tk + WK - 1) / WK);
    flash_bwd_dkv_tf32x3_kernel<D, PADDED, KC><<<grid, NT, smem, stream>>>(
        mq, mk, mv, mdo, (const float*)lse, (const float*)delta,
        (const int*)klen, (float*)dk, (float*)dv, H, Hkv, Tq, Tk, Dt,
        causal, scale);
  }
  return (int)cudaGetLastError();
}

// the dynamic shared memory of a launch, and the blocks an SM holds
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

bool args_ok(int B, int H, int Hkv, int Tq, int Tk) {
  return B >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && Tq >= 1 && Tk >= 1;
}

}  // namespace

// q/dout/dq [B*H, Tq, D], k/v/dk/dv [B*Hkv, Tk, D], klen int32 [B], lse and
// delta float32 [B*H, Tq]; dtype 0 = float32, 1 = bfloat16; any D % 8 ==
// 0 up to 256 (hopper::with_bwd_instance; float32 above 128 launches
// clusters of two blocks).  Each returns the CUDA error of its launch (0
// on success), -1 for arguments the kernel does not take, or -2 when the
// CUDA driver gives no TMA tensor map.
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* klen, const void* lse,
                               const void* delta, const void* dout, void* dq,
                               int B, int H, int Hkv, int Tq, int Tk, int D,
                               int dtype, int causal, float scale,
                               void* stream) {
  if (!args_ok(B, H, Hkv, Tq, Tk) || (dtype != 0 && dtype != 1)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return hopper::with_bwd_instance(D, dtype, [&](auto in) {
    using I = decltype(in);
    return dtype == 0
               ? launch_dq_tf32x3<I::kDP, I::kPadded, I::kKC>(
                     q, k, v, klen, lse, delta, dout, dq, B, H, Hkv, Tq, Tk,
                     D, causal, scale, s)
               : launch_dq_bf16<I::kDP, I::kPadded>(
                     q, k, v, klen, lse, delta, dout, dq, B, H, Hkv, Tq, Tk,
                     D, causal, scale, s);
  });
}

extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* klen, const void* lse,
                                const void* delta, const void* dout,
                                void* dk, void* dv, int B, int H, int Hkv,
                                int Tq, int Tk, int D, int dtype, int causal,
                                float scale, void* stream) {
  if (!args_ok(B, H, Hkv, Tq, Tk) || (dtype != 0 && dtype != 1)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return hopper::with_bwd_instance(D, dtype, [&](auto in) {
    using I = decltype(in);
    return dtype == 0
               ? launch_dkv_tf32x3<I::kDP, I::kPadded, I::kKC>(
                     q, k, v, klen, lse, delta, dout, dk, dv, B, H, Hkv, Tq,
                     Tk, D, causal, scale, s)
               : launch_dkv_bf16<I::kDP, I::kPadded>(
                     q, k, v, klen, lse, delta, dout, dk, dv, B, H, Hkv, Tq,
                     Tk, D, causal, scale, s);
  });
}

// The shared memory a backward launch asks for at head dimension D and
// dtype (as in pt_flash_bwd_dq), for the dQ kernel (kind 0) or the dK/dV
// kernel (kind 1) of the instance D runs, and how many such blocks an SM
// holds, as the CUDA runtime reports them; 0 on success.
extern "C" int pt_flash_bwd_occupancy(int D, int dtype, int kind, int* smem,
                                      int* blocks) {
  if (dtype != 0 && dtype != 1) return -1;
  return hopper::with_bwd_instance(D, dtype, [&](auto in) {
    using I = decltype(in);
    constexpr int DP = I::kDP, KC = I::kKC;
    constexpr bool P = I::kPadded;
    using DqS = std::conditional_t<DP == 256, DqClusterSmem,
                                   DqTf32Smem<DP>>;
    using DkvS = std::conditional_t<DP == 256, DkvClusterSmem,
                                    DkvTf32Smem<DP>>;
    if (dtype == 0)
      return kind == 0 ? occupancy(flash_bwd_dq_tf32x3_kernel<DP, P, KC>,
                                   sizeof(DqS) + 1024, smem, blocks)
                       : occupancy(flash_bwd_dkv_tf32x3_kernel<DP, P, KC>,
                                   sizeof(DkvS) + 1024, smem, blocks);
    return kind == 0 ? occupancy(flash_bwd_dq_wgmma_kernel<DP, P>,
                                 sizeof(DqSmem<DP>) + 1024, smem, blocks)
                     : occupancy(flash_bwd_dkv_wgmma_kernel<DP, P>,
                                 sizeof(DkvSmem<DP>) + 1024, smem, blocks);
  });
}
