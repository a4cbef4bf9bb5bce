// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (csrc/flash_fwd.cu, csrc/flash_bwd.cu): wgmma on bf16 and on TF32 tiles
// with float32 accumulators, mbarriers, TMA tile copies, and the
// distributed shared memory of a cluster of blocks.
//
// Tiles live in shared memory in the 128-byte swizzle (B128): a row of a
// tile is 64 bf16 values (128 bytes), rows are 128 bytes apart, and 8 rows
// form a 1024-byte swizzle atom.  A head dimension of 128 is two such
// 64-column chunks, each stored as its own [rows x 64] region.  Every
// region starts on a 1024-byte boundary, so the hardware's address-based
// swizzle, the TMA writes and the wgmma reads agree.  A float32 (TF32)
// tile has the same byte geometry with 32 values to a 128-byte row, so a
// head dimension of 128 is four [rows x 32] regions.
//
// The tile copy is TMA (`cp.async.bulk.tensor`), not `cp.async`: one thread
// asks for a whole box of 128-byte rows, the hardware writes it in the B128
// swizzle, zero-fills rows past the tensor's end (ragged Tq and Tk need no
// padding by the caller and no bounds checks in the copy), and reports the
// bytes to an mbarrier.  The threads spend no registers or instructions on addresses, which
// the wgmma accumulators need.  The tensor map is encoded on the host through
// cudaGetDriverEntryPoint("cuTensorMapEncodeTiled"), so the library links
// against the runtime alone (no -lcuda), and passed to the kernel as a `const
// __grid_constant__ CUtensorMap`.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no driver link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled, looked up once through the
// runtime
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = (EncodeTiledFn)p;
  }
  return fn;
}

// Error codes of the map builders, beside the CUDA errors the entry points
// return: -1 arguments the kernels do not take (a pointer not 16-byte
// aligned), -2 the CUDA driver refused or lacks cuTensorMapEncodeTiled.
constexpr int kBadArgs = -1;
constexpr int kNoTensorMap = -2;

// 3-D map over a contiguous [heads, rows, D] tensor of `elem`-byte values:
// boxes of 128 bytes of columns x box_rows rows x 1 head, written in the
// 128-byte swizzle; rows past `rows` read as zero
static inline int map_3d(CUtensorMap* map, const void* base,
                         CUtensorMapDataType type, int elem, int heads,
                         int rows, int D, int box_rows) {
  if ((uintptr_t)base % 16) return kBadArgs;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kNoTensorMap;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elem,
                                 (cuuint64_t)rows * D * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows,
                             1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides, box,
                  elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kNoTensorMap;
}

// bf16 [heads, rows, D]: boxes of 64 columns
static inline int map_bf16_3d(CUtensorMap* map, const void* base, int heads,
                              int rows, int D, int box_rows) {
  return map_3d(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, heads, rows,
                D, box_rows);
}

// float32 [heads, rows, D]: boxes of 32 columns
static inline int map_f32_3d(CUtensorMap* map, const void* base, int heads,
                             int rows, int D, int box_rows) {
  return map_3d(map, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, heads, rows,
                D, box_rows);
}

// The instance of a flash kernel (csrc/flash_fwd.cu, csrc/flash_bwd.cu)
// that head dim D runs: padded width DP = 64 for D <= 64 and 128 for 64 <
// D <= 128, PADDED unless D == DP (so D = 64 and 128 compile as they did
// before the padded instances), and the KC = ceil(D / 32) 32-column
// regions its products over D reduce; f(Inst<DP, PADDED, KC>{}), or -1
// for a D the kernels do not take (D % 8 != 0, or above 128).
// with_bwd_instance (the backward's dispatch) and with_fwd_instance (the
// forward's) add the width 256
template <int DP, bool PAD, int NKC>
struct Inst {
  static constexpr int kDP = DP;
  static constexpr bool kPadded = PAD;
  static constexpr int kKC = NKC;
};

template <typename F>
int with_instance(int D, F&& f) {
  if (D < 8 || D % 8 != 0 || D > 128) return -1;
  if (D == 64) return f(Inst<64, false, 2>{});
  if (D == 128) return f(Inst<128, false, 4>{});
  switch ((D + 31) / 32) {
    case 1: return f(Inst<64, true, 1>{});
    case 2: return f(Inst<64, true, 2>{});
    case 3: return f(Inst<128, true, 3>{});
    default: return f(Inst<128, true, 4>{});
  }
}

// The forward's instances (csrc/flash_fwd.cu): with_instance's up to 128,
// and above it, up to 256, the width DP = 256, unpadded at D = 256 (KC 8)
// and padded at D = 136 .. 248 (KC = ceil(D / 32) = 5 .. 8; KC 8 padded
// at D = 232 .. 248); -1 for a D the forward does not take
template <typename F>
int with_fwd_instance(int D, F&& f) {
  if (D <= 128 || D > 256 || D % 8 != 0) return with_instance(D, f);
  if (D == 256) return f(Inst<256, false, 8>{});
  switch ((D + 31) / 32) {
    case 5: return f(Inst<256, true, 5>{});
    case 6: return f(Inst<256, true, 6>{});
    case 7: return f(Inst<256, true, 7>{});
    default: return f(Inst<256, true, 8>{});
  }
}

// The backward's instances (csrc/flash_bwd.cu): with_instance's up to
// 128, and above it, up to 256, the width DP = 256, unpadded at D = 256
// and padded at D = 136 .. 248: in bf16 (dtype 1) with KC 8 (the bf16
// backward stops its products over D at a run-time k16 step, so KC is not
// read), in float32 with_fwd_instance's KC = ceil(D / 32) (the cluster's
// second block reduces KC - 4 regions); -1 for a D the backward does not
// take
template <typename F>
int with_bwd_instance(int D, int dtype, F&& f) {
  if (D <= 128 || D > 256 || D % 8 != 0) return with_instance(D, f);
  if (dtype != 1) return with_fwd_instance(D, f);
  if (D == 256) return f(Inst<256, false, 8>{});
  return f(Inst<256, true, 8>{});
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the first 1024-byte boundary at or after p (dynamic shared memory is
// allocated with 1024 bytes to spare)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// mbarrier: init (one thread), then fence before any other thread uses it
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transfers to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the phase of parity `parity` has completed.  A wait that
// never ends (a copy that never lands) traps after ~2^26 polls, seconds
// of waiting, so the launch fails with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// ------------------------------------------- clusters of thread blocks
//
// A cluster's blocks run on neighbouring SMs and may read and write each
// other's shared memory (distributed shared memory): mapa turns an address
// of this block's shared memory into the same offset in block `rank`'s,
// which st.async writes.  Every block of a cluster here lays its shared
// memory out the same way, so the peer's copy of a buffer is at this
// block's offset.

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster: all writes before it, to
// any block's shared memory, are seen by all reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of p's offset in block `rank`'s shared memory
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// an asynchronous 16-byte store into a peer's shared memory (addr and
// bar from peer_addr) that completes its bytes on the peer's mbarrier
// bar, as a TMA copy does: the sender does not wait for it, the peer
// waits on bar (mbar_wait_cluster) after an arrival expecting the bytes
__device__ __forceinline__ void st_async(uint32_t addr, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// mbar_wait at the cluster's scope, for bytes the peers' stores complete
// on this block's barrier; traps as mbar_wait does
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  int parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// TMA: one box of a 3-D map at coordinates (c0 innermost, c1, c2) into
// shared memory, completing `bytes` on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a B128 tile region starting at p:
// start address, leading byte offset (LBO), stride byte offset (SBO), all
// in 16-byte units, and the 128-byte swizzle mode.
//   K-major operand (the reduction dimension contiguous, as K for Q K^T):
//     rows of 128 bytes, 8-row groups SBO = 1024 bytes apart; LBO unused.
//     A k16 step moves p by 16 values (32 bytes) inside the row; the next
//     64 values of the reduction are the next chunk region.
//   MN-major operand (the output dimension contiguous, as V for P V, with
//     tnspB = 1): 8 reduction rows of 128 bytes form an atom, atoms SBO =
//     1024 bytes apart; LBO = the bytes between two 64-column chunk
//     regions (used when N = 128 or 256).  A k16 step moves p by 16 rows.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
}

// wgmma ordering: fence before a batch of products whose accumulator or A
// registers were touched by other instructions; commit the batch as one
// group; wait until at most N groups are in flight
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, float32 accumulators.
// wgmma_ss: A and B from shared memory, A K-major.  wgmma_rs: A from
// registers (4 x 32 bits a thread, see acc_to_a).  tnspB = 0 when B is
// K-major, 1 when MN-major.  accumulate = 0 overwrites D.
// Accumulator element i of thread t holds row 16 (t / 32) + (t % 32) / 4 +
// 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2 (acc_row, acc_col).
template <int tnspB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(tnspB));
}

template <int tnspB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(tnspB));
}

template <int tnspB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(tnspB));
}

template <int tnspB>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(tnspB));
}

__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x % 128;
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A float32 accumulator of an m64nN product, rounded to bf16, as the
// register A fragments of the next product, one per k16 slice of its N
// columns: the accumulator's (row, column) layout is the A fragment's, so
// slice kk takes elements 8 kk .. 8 kk + 7 in order, two to a register.
template <int NACC>
__device__ __forceinline__ void acc_to_a(const float (&acc)[NACC],
                                         uint32_t (&a)[NACC / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NACC / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
}

// The same in two terms, hi = bf16(x) and lo = bf16(x - hi): hi + lo keeps
// x to ~2^-17 relative, so two products (hi, then lo) with one B give a
// float32-accurate x B at twice the tensor-core work of one.
template <int NACC>
__device__ __forceinline__ void acc_to_a_split(const float (&acc)[NACC],
                                               uint32_t (&hi)[NACC / 8][4],
                                               uint32_t (&lo)[NACC / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NACC / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = acc[8 * kk + 2 * j], x1 = acc[8 * kk + 2 * j + 1];
      __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][j] = *reinterpret_cast<uint32_t*>(&h);
      lo[kk][j] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
}

// ------------------------------------------------------------------ TF32
//
// wgmma on float32 data read as TF32 (10 mantissa bits): 8 values of depth
// a product (k8: 32 bytes, the byte depth of a bf16 k16), float32
// accumulators in the layout above (acc_row, acc_col).  Both operands are
// K-major: the PTX ISA gives .tf32 no transpose flags, so a B whose
// reduction dimension is not contiguous (V in P V) is staged transposed.
// A k8 step moves a K-major descriptor's start by 32 bytes, as a bf16 k16
// step does.  The tensor cores read a float32 as TF32 by dropping its low
// 13 bits; tf32_rna rounds to nearest instead, so a value handed over as
// tf32_rna(x) is read exactly.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// order this thread's generic-proxy shared-memory writes (and reads)
// before later async-proxy accesses (wgmma operand reads, TMA writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x 32] (+)= A[64 x 8] B[8 x 32], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 8] B[8 x 16], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[8], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x N] (+)= A[64 x 8] B[8 x N] (N = 64, 128, 256), A from registers:
// thread
// t holds rows r = 16 (t / 32) + (t % 32) / 4 and r + 8 at the depth
// columns c = t % 4 and c + 4, as {(r, c), (r + 8, c), (r, c + 4),
// (r + 8, c + 4)}, each a tf32_rna value
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// ------------------------------------------------------- 3xTF32 splits
//
// A float32 product as three TF32 ones: x y ~ x_hi y_hi + x_hi y_lo +
// x_lo y_hi, with x_hi = tf32_rna(x) and x_lo = tf32_rna(x - x_hi).  hi +
// lo keeps x to ~2^-22, and the dropped lo x lo term is ~2^-22 of x y, so
// the sum keeps float32's order of error where one TF32 product (~2^-11)
// would not.  The helpers below are run by all 128 threads of a
// warpgroup-sized block.

constexpr int kWarpgroup = 128;

// src -> (hi, lo) over N float4s; hi may be src.  The regions share one
// swizzled layout, so the split is element by element.  Each thread loads
// all its words before it rounds and stores any.
template <int N>
__device__ __forceinline__ void split_tf32(const float4* src, float4* hi,
                                           float4* lo) {
  static_assert(N % kWarpgroup == 0, "whole float4s a thread");
  constexpr int PER = N / kWarpgroup;
  const int t = threadIdx.x % kWarpgroup;
  float4 x[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) x[j] = src[t + j * kWarpgroup];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float xs[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
    float h[4], r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = __uint_as_float(tf32_rna(xs[e]));
      r[e] = __uint_as_float(tf32_rna(xs[e] - h[e]));
    }
    hi[t + j * kWarpgroup] = make_float4(h[0], h[1], h[2], h[3]);
    lo[t + j * kWarpgroup] = make_float4(r[0], r[1], r[2], r[3]);
  }
}

// A tile of ROWS (32 or 16) rows x D float32 columns, as TMA lands it (D /
// 32 regions of [ROWS x 32 columns] in the 128-byte swizzle), transposed
// into hi and lo: [D x 32] regions, rows contiguous, the K-major B operand
// of a product that reduces over the tile's rows (V in P V, K in dS K, dO
// in P^T dO, Q in dS^T Q).  The tile's rows land at columns col0 .. col0 +
// ROWS - 1 of the region (col0 = 0 or 16 when ROWS = 16: two tiles share
// a region).  Thread t takes row j = t % ROWS, so a warp's stores fill
// whole transposed rows, one bank each; row 8a + 2c + e lands at position
// 8a + c + 4e, the depth column where an accumulator turned A fragment
// holds it (acc_to_tf32_split).  The 128 / ROWS thread groups of ROWS
// take the 4-column groups round robin.
template <int D, int ROWS>
__device__ __forceinline__ void split_t(const float* raw, float* thi,
                                        float* tlo, int col0) {
  static_assert(ROWS == 32 || ROWS == 16, "one row a thread of a group");
  constexpr int NG = kWarpgroup / ROWS;  // thread groups
  constexpr int IT = D / 4 / NG;         // 4-column groups a thread group
  const int t = threadIdx.x % kWarpgroup;
  const int j = t % ROWS, grp = t / ROWS;
  const int col = col0 + ((j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2));
  float4 x[IT];
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int d4 = grp + NG * i;
    const int c = d4 / 8, w = d4 % 8;  // region, 16-byte word of its row
    x[i] = *reinterpret_cast<const float4*>(raw + c * ROWS * 32 + j * 32 +
                                            ((w ^ (j & 7)) << 2));
  }
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const float xs[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (grp + NG * i) + e;
      const int at = d * 32 + ((((col >> 2) ^ (d & 7)) << 2) | (col & 3));
      const float h = __uint_as_float(tf32_rna(xs[e]));
      thi[at] = h;
      tlo[at] = __uint_as_float(tf32_rna(xs[e] - h));
    }
  }
}

// split_t's transpose of a tile already split (src: its hi or its lo
// regions, as split_tf32 writes them), copied without rounding: the same
// bits as split_t's from the raw tile
template <int D, int ROWS>
__device__ __forceinline__ void transpose_t(const float* src, float* dst,
                                            int col0) {
  static_assert(ROWS == 32 || ROWS == 16, "one row a thread of a group");
  constexpr int NG = kWarpgroup / ROWS;
  constexpr int IT = D / 4 / NG;
  const int t = threadIdx.x % kWarpgroup;
  const int j = t % ROWS, grp = t / ROWS;
  const int col = col0 + ((j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2));
  float4 x[IT];
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int d4 = grp + NG * i;
    const int c = d4 / 8, w = d4 % 8;
    x[i] = *reinterpret_cast<const float4*>(src + c * ROWS * 32 + j * 32 +
                                            ((w ^ (j & 7)) << 2));
  }
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const float xs[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (grp + NG * i) + e;
      dst[d * 32 + ((((col >> 2) ^ (d & 7)) << 2) | (col & 3))] = xs[e];
    }
  }
}

// A float32 accumulator of an m64nN product (NACC = N / 2 values a
// thread) as
// the TF32 A fragments, hi and lo, of the next product that reduces over
// those N columns: 8-column group kk of the accumulator holds columns 2c,
// 2c + 1 (c = thread % 4) of rows r, r + 8, which are depth columns c,
// c + 4 of the A fragment, so the B operand is staged with the
// permutation of split_t and no shuffles are needed.
template <int NACC>
__device__ __forceinline__ void acc_to_tf32_split(
    const float (&acc)[NACC], uint32_t (&hi)[NACC / 4][4],
    uint32_t (&lo)[NACC / 4][4]) {
#pragma unroll
  for (int kk = 0; kk < NACC / 4; ++kk) {
    const int at[4] = {4 * kk, 4 * kk + 2, 4 * kk + 1, 4 * kk + 3};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = acc[at[j]];
      hi[kk][j] = tf32_rna(x);
      lo[kk][j] = tf32_rna(x - __uint_as_float(hi[kk][j]));
    }
  }
}

// keep register A fragments unchanged until the product that reads them
// has been waited for
template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

}  // namespace hopper
