// Embedding row gather for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/gather.py:34 _gather_kernel, which the JAX
// package launches from _pallas_gather (:66, pallas_call at :78) through
// embedding_gather (:131).  It computes embedding_gather's function: out[i]
// is row ids[i] of the [V, D] table; a negative id wraps once by +V, and an
// id still outside [0, V) yields a NaN row, so corruption surfaces instead
// of reading unchecked memory.  The clamp and the NaN fill that the JAX
// wrapper does around its DMA kernel happen here, in the same pass.
//
// What bounds it on this card: it moves bytes and computes nothing.  At the
// served llama_1b shape (8192 ids, D = 2048, float32) it reads 67 MB of
// rows and writes 67 MB, about 40 us at 3.35 TB/s; at the training shape
// (8192 ids, D = 512) 16.8 MB each way, 10 us, and there the output and
// the rows it reads fit in the 50 MB L2.
//
// What the design does about it: the bytes bound needs bytes in flight,
// ~20 KB an SM by Little's law (3.35 TB/s x ~0.8 us over 132 SMs), and a
// short call (the training shape's) needs its rows in as few waves of
// warps as it can get, since each warp reads its id before its row.  A
// warp copies one segment of one output row, up to 32 x U words (U = 4
// words a lane: 2 KB of a float32 row in 16-byte words), and each lane
// issues all its loads (read-only path, ld.global.nc) before any of its
// stores.  At 32 registers a thread an SM holds 64 such warps, 128 KB in
// flight, and the card 8448: the training shape's 8192 rows of 2 KB are
// one wave; the served rows of 8 KB are 4 segments each.  The grid has a
// warp for every segment; grids of the card's resident warps walking the
// rows (the next id read ahead), and 4 KB segments (more registers, fewer
// warps an SM), measured slower.  The stores stream (st.global.cs, evict
// first): faster in every warm and L2-flushed comparison on the card, at
// both shapes.  When a row is a whole number of 16-byte words and both
// tables are 16-byte aligned, each lane moves 16 bytes per access;
// otherwise the same kernel walks the row in element-sized words.  A plain
// device copy of the served shape's bytes reaches about the same share of
// the bound (chip_smoke.py prints both).  The TPU kernel's per-row DMA descriptors and their
// 256-row grid blocks have no counterpart: the warps' loads are the copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 4;  // words a lane has in flight

// the NaN pattern of one element, repeated across a copy word
template <typename W>
__device__ __forceinline__ W nan_word(uint32_t nan32);
template <>
__device__ __forceinline__ uint4 nan_word<uint4>(uint32_t nan32) {
  return make_uint4(nan32, nan32, nan32, nan32);
}
template <>
__device__ __forceinline__ uint32_t nan_word<uint32_t>(uint32_t nan32) {
  return nan32;
}
template <>
__device__ __forceinline__ uint16_t nan_word<uint16_t>(uint32_t nan32) {
  return (uint16_t)nan32;
}

// work item `it`: segment it % segs of output row it / segs, one a warp
// (the loop runs again only for grids past the launch limit)
template <typename W>
__global__ void __launch_bounds__(THREADS, 8)  // 8 blocks an SM: 32 registers
gather_rows(const W* __restrict__ table, const void* __restrict__ ids,
            int ids64, W* __restrict__ out, long long n, long long vocab,
            int words, int segs, uint32_t nan32) {
  const W nan = nan_word<W>(nan32);
  const int lane = threadIdx.x & 31;
  const long long nwarps = ((long long)gridDim.x * THREADS) >> 5;
  for (long long it = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
       it < n * segs; it += nwarps) {
    const long long r = it / segs;
    long long id = ids64 ? __ldg((const long long*)ids + r)
                         : (long long)__ldg((const int*)ids + r);
    if (id < 0) id += vocab;
    const int w0 = (int)(it - r * segs) * 32 * U + lane;
    W* dst = out + r * words;
    W buf[U];
    if (id < 0 || id >= vocab) {
#pragma unroll
      for (int u = 0; u < U; ++u) buf[u] = nan;
    } else {
      const W* src = table + id * words;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (w0 + 32 * u < words) buf[u] = __ldg(src + w0 + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (w0 + 32 * u < words) __stcs(dst + w0 + 32 * u, buf[u]);
  }
}

template <typename W>
int launch(const void* table, const void* ids, int ids64, void* out,
           long long n, long long vocab, int words, uint32_t nan32,
           cudaStream_t stream) {
  const int segs = (words + 32 * U - 1) / (32 * U);
  const long long warps_per_block = THREADS / 32;
  long long blocks = (n * segs + warps_per_block - 1) / warps_per_block;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  gather_rows<W><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const W*)table, ids, ids64, (W*)out, n, vocab, words, segs, nan32);
  return (int)cudaGetLastError();
}

}  // namespace

// table [V, D], ids int32 or int64 [n], out [n, D]; dtype 0 = float32,
// 1 = bfloat16, 2 = float16.  Returns the CUDA error of the launch (0 on
// success), or -1 for arguments the kernel does not take.
extern "C" int pt_embedding_gather(const void* table, const void* ids,
                                   void* out, long long n, int vocab, int D,
                                   int dtype, int ids64, void* stream) {
  if (n < 0 || vocab < 1 || D < 1 || dtype < 0 || dtype > 2) return -1;
  if (n == 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  const uint32_t nan16 = dtype == 1 ? 0x7fc0u : 0x7e00u;
  const uint32_t nan32 = dtype == 0 ? 0x7fc00000u : (nan16 | (nan16 << 16));
  const long long row_bytes = (long long)D * elem;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && (uintptr_t)table % 16 == 0 &&
      (uintptr_t)out % 16 == 0) {
    return launch<uint4>(table, ids, ids64, out, n, vocab,
                         (int)(row_bytes / 16), nan32, s);
  }
  if (elem == 4)
    return launch<uint32_t>(table, ids, ids64, out, n, vocab, D, nan32, s);
  return launch<uint16_t>(table, ids, ids64, out, n, vocab, D, nan16, s);
}

// Message for a code returned by the entry points above.
extern "C" const char* pt_error_string(int code) {
  if (code == -1) return "arguments the kernel does not take";
  if (code == -2) return "no TMA tensor map (cuTensorMapEncodeTiled)";
  return cudaGetErrorString((cudaError_t)code);
}
