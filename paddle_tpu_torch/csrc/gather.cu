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
// rows and writes 67 MB, about 40 us at 3.35 TB/s.
//
// What the design does about it: one warp per output row (grid-stride over
// rows), so a row is read and written by 32 neighbouring lanes on
// neighbouring addresses.  When a row is a whole number of 16-byte words
// and both tables are 16-byte aligned, each lane moves 16 bytes per access;
// otherwise the same kernel walks the row in element-sized words.  The TPU
// kernel's per-row DMA descriptors and their 256-row grid blocks have no
// counterpart: the warps' loads are the copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

template <typename W>
__global__ void __launch_bounds__(THREADS)
gather_rows(const W* __restrict__ table, const void* __restrict__ ids,
            int ids64, W* __restrict__ out, long long n, long long vocab,
            int words, uint32_t nan32) {
  const W nan = nan_word<W>(nan32);
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = warp; r < n; r += nwarps) {
    long long id = ids64 ? ((const long long*)ids)[r]
                         : (long long)((const int*)ids)[r];
    if (id < 0) id += vocab;
    W* dst = out + r * words;
    if (id < 0 || id >= vocab) {
      for (int w = lane; w < words; w += 32) dst[w] = nan;
    } else {
      const W* src = table + id * words;
      for (int w = lane; w < words; w += 32) dst[w] = src[w];
    }
  }
}

template <typename W>
int launch(const void* table, const void* ids, int ids64, void* out,
           long long n, long long vocab, int words, uint32_t nan32,
           cudaStream_t stream) {
  const long long rows_per_block = THREADS / 32;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  gather_rows<W><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const W*)table, ids, ids64, (W*)out, n, vocab, words, nan32);
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
