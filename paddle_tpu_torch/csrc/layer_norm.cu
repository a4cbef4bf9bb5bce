// LayerNorm rows for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/kernelgen/rules.py:336 _layer_norm_step, the
// kernel-generator step the JAX package runs for `layer_norm` ops (pallas_call
// at :381).  It computes that step's function on rows x cols: float32
// statistics shifted by the row's first element (the pilot c; d = x - c,
// mean = E[d] + c, var = max(E[d^2] - E[d]^2, 0)), or the exact two-pass
// form (mean first, then E[(x - mean)^2]) when the wrapper passes
// two_pass, as PT_TWO_PASS_NORM=1 selects in the JAX package; y = (x -
// mean) * rsqrt(var + eps), times Scale and plus Bias when given (float32
// [cols], either may be null).  Y is in the input dtype, Mean and Variance
// float32 [rows].  The backward is plain PyTorch (ops/nn.py): the JAX
// package has no backward kernel either.
//
// What bounds it on this card: it moves bytes.  At the transformer training
// shape (8192 rows x 512 cols, float32) it reads 16.8 MB and writes 16.8 MB
// plus 64 KB of statistics, about 10 us at 3.35 TB/s.
//
// What the design does about it: one warp per row, eight rows per block, so
// a row is read by 32 neighbouring lanes on neighbouring addresses and the
// statistics reduce with warp shuffles, without shared memory or block
// barriers.  The one-pass form reads the row once for both sums; the
// normalising pass reads it again from L1/L2 (a 512-column float32 row is
// 2 KB), so device memory sees each byte about once.  Any number of columns
// works: the lanes stride over the row, so a ragged tail needs no mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int ROWS_PER_BLOCK = 8;
constexpr int THREADS = 32 * ROWS_PER_BLOCK;

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
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ var,
                  long long rows, int cols, float eps, int two_pass) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * ROWS_PER_BLOCK;
  const float n = (float)cols;
  for (long long row = (long long)blockIdx.x * ROWS_PER_BLOCK +
                       threadIdx.x / 32;
       row < rows; row += stride) {
    const T* xr = x + row * cols;
    float c, md, v;  // shift, mean of (x - c), variance
    if (two_pass) {
      float s = 0.f;
      for (int j = lane; j < cols; j += 32) s += to_f(xr[j]);
      c = warp_sum(s) / n;
      float s2 = 0.f;
      for (int j = lane; j < cols; j += 32) {
        const float d = to_f(xr[j]) - c;
        s2 += d * d;
      }
      md = 0.f;
      v = warp_sum(s2) / n;
    } else {
      c = to_f(xr[0]);
      float s = 0.f, s2 = 0.f;
      for (int j = lane; j < cols; j += 32) {
        const float d = to_f(xr[j]) - c;
        s += d;
        s2 += d * d;
      }
      md = warp_sum(s) / n;
      v = fmaxf(warp_sum(s2) / n - md * md, 0.f);
    }
    const float rstd = rsqrtf(v + eps);
    T* yr = y + row * cols;
    for (int j = lane; j < cols; j += 32) {
      float o = (to_f(xr[j]) - c - md) * rstd;
      if (scale) o *= scale[j];
      if (bias) o += bias[j];
      yr[j] = from_f<T>(o);
    }
    if (lane == 0) {
      mean[row] = md + c;
      var[row] = v;
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y,
           void* mean, void* var, long long rows, int cols, float eps,
           int two_pass, cudaStream_t stream) {
  long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  layer_norm_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)x, (const float*)scale, (const float*)bias, (T*)y,
      (float*)mean, (float*)var, rows, cols, eps, two_pass);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y [rows, cols]; scale, bias float32 [cols] or null; mean, var float32
// [rows]; dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error of the
// launch (0 on success), or -1 for arguments the kernel does not take.
extern "C" int pt_layer_norm(const void* x, const void* scale,
                             const void* bias, void* y, void* mean, void* var,
                             long long rows, int cols, float eps, int dtype,
                             int two_pass, void* stream) {
  if (rows < 1 || cols < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, scale, bias, y, mean, var, rows, cols, eps,
                         two_pass, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, bias, y, mean, var, rows, cols,
                                 eps, two_pass, s);
  return -1;
}
