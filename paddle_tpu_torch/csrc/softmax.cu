// Softmax rows for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/kernelgen/rules.py:291 _softmax_step, the
// kernel-generator step the JAX package runs for `softmax` ops (pallas_call
// at :311).  It computes that step's function on rows x cols, over the
// trailing axis: in float32, m = max(x), u = exp(x - m), y = u / sum(u);
// Y in the input dtype (float32 or bfloat16).  A row that is all -inf
// gives NaN, as the plain version and jax.nn.softmax do (-inf - -inf).
// The backward is plain PyTorch (ops/nn.py): the JAX package has no
// backward kernel either.
//
// What bounds it on this card: it moves bytes.  At the transformer's
// attention scores (65,536 rows x 256 cols, float32) it reads 67 MB and
// writes 67 MB, about 40 us at 3.35 TB/s; the 3 operations an element
// (exp, subtract, divide) are far below the arithmetic bound.
//
// What the design does about it: one warp per row, four rows per block.
// A row of up to 32 * MAXK columns stays in registers (MAXK values a
// lane, MAXK the next power of two of cols / 32, a template argument), so
// X is read from device memory once and Y written once; the lanes stride
// over the row, so neighbouring lanes read neighbouring addresses and any
// column count works with a bound check.  The max and the sum reduce with
// warp shuffles, with no shared memory or barriers.  A row longer than 32
// * 32 columns takes the block-per-row branch of the same kernel (one
// block of four warps per row, reductions through shared memory, X read
// three times); the launcher picks the branch's grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_REG_K = 32;  // the register branch holds <= 1024 cols

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max of a and b that keeps NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ __forceinline__ float warp_nan_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide reductions of the long-row branch (THREADS threads)
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_nan_max(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = nan_max(r, red[i]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = __fadd_rn(r, red[i]);
  return r;
}

template <typename T, int MAXK>
__global__ void __launch_bounds__(THREADS)
softmax_kernel(const T* __restrict__ x, T* __restrict__ y, long long rows,
               int cols) {
  const int lane = threadIdx.x & 31;
  if (cols <= 32 * MAXK) {
    // register branch: one warp per row
    const long long stride = (long long)gridDim.x * WARPS;
    for (long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
         row < rows; row += stride) {
      const T* xr = x + row * cols;
      float v[MAXK];
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < MAXK; ++k) {
        const int c = k * 32 + lane;
        v[k] = c < cols ? to_f(xr[c]) : -INFINITY;
        m = nan_max(m, v[k]);
      }
      m = warp_nan_max(m);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < MAXK; ++k) {
        const int c = k * 32 + lane;
        v[k] = expf(__fsub_rn(v[k], m));
        if (c < cols) s = __fadd_rn(s, v[k]);
      }
      s = warp_sum(s);
      T* yr = y + row * cols;
#pragma unroll
      for (int k = 0; k < MAXK; ++k) {
        const int c = k * 32 + lane;
        if (c < cols) yr[c] = from_f<T>(__fdiv_rn(v[k], s));
      }
    }
    return;
  }
  // long rows: one block per row, three passes over the row
  __shared__ float red[WARPS];
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * cols;
    float m = -INFINITY;
    for (int c = threadIdx.x; c < cols; c += THREADS)
      m = nan_max(m, to_f(xr[c]));
    m = block_max(m, red);
    float s = 0.f;
    for (int c = threadIdx.x; c < cols; c += THREADS)
      s = __fadd_rn(s, expf(__fsub_rn(to_f(xr[c]), m)));
    s = block_sum(s, red);
    T* yr = y + row * cols;
    for (int c = threadIdx.x; c < cols; c += THREADS)
      yr[c] = from_f<T>(__fdiv_rn(expf(__fsub_rn(to_f(xr[c]), m)), s));
  }
}

template <typename T, int MAXK>
int launch_k(const void* x, void* y, long long rows, int cols,
             cudaStream_t stream) {
  const long long per_block = cols <= 32 * MAXK ? WARPS : 1;
  long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 132 * 256) blocks = 132 * 256;  // grid-stride beyond this
  softmax_kernel<T, MAXK><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)x, (T*)y, rows, cols);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, long long rows, int cols,
           cudaStream_t stream) {
  const int k = (cols + 31) / 32;
  if (k <= 1) return launch_k<T, 1>(x, y, rows, cols, stream);
  if (k <= 2) return launch_k<T, 2>(x, y, rows, cols, stream);
  if (k <= 4) return launch_k<T, 4>(x, y, rows, cols, stream);
  if (k <= 8) return launch_k<T, 8>(x, y, rows, cols, stream);
  if (k <= 16) return launch_k<T, 16>(x, y, rows, cols, stream);
  return launch_k<T, MAX_REG_K>(x, y, rows, cols, stream);
}

}  // namespace

// x, y [rows, cols], contiguous; dtype 0 = float32, 1 = bfloat16.  Returns
// the CUDA error of the launch (0 on success), or -1 for arguments the
// kernel does not take.
extern "C" int pt_softmax(const void* x, void* y, long long rows, int cols,
                          int dtype, void* stream) {
  if (rows < 1 || cols < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, y, rows, cols, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, rows, cols, s);
  return -1;
}
