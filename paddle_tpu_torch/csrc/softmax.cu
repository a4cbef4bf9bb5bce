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
// writes 67 MB, about 40 us at 3.35 TB/s; the 5 operations an element
// (max, subtract, exp, sum, divide) are far below the arithmetic bound.
//
// The vector branch, softmax_kernel_vec<T, VPL, ROWS>, takes rows of up to
// 1024 columns whose column count is a multiple of 16 bytes (4 float32 or
// 8 bf16 values) on 16-byte aligned tensors: one warp per ROWS rows, the
// rows held in registers, so X is read from device memory once and Y
// written once, as 16-byte accesses with streaming cache hints (ld.global.cs
// / st.global.cs: each byte is touched once, so it should not displace
// anything from L1 or L2).  Lane l holds the 16-byte vectors l, l + 32, ...
// of its rows (VPL a row, the next power of two of cols / 32 / values a
// vector), so a warp's access covers 512 consecutive bytes.  The max and
// the sum reduce with warp shuffles, with no shared memory or barriers.
// There is no grid-stride loop: the grid has one warp per ROWS rows.
//
// Bytes in flight (Little's law): 3.35 TB/s x ~0.8 us of loaded HBM3
// latency is ~2.7 MB across the card, ~20 KB per SM of its 132.  A lane
// issues all ROWS x VPL of its 16-byte loads before its first reduction;
// ROWS = max(1, 4 / VPL) makes that at least 4 loads, 2 KB a warp.  At the
// scores' 256 float32 columns VPL = 2 and ROWS = 2: 16 values a lane,
// 40 registers a thread (ptxas), 48 resident warps (6 blocks of 8) an SM,
// so up to 96 KB an SM in flight, about 5x the need; the grid of 4,096
// blocks is 5.2 waves of 792.
//
// The row sum is taken in another order than the plain version's (each
// lane sums its own values in order, then a butterfly over the 32 lanes):
// with 256 terms of u <= 1 that moves y by a few float32 units in the last
// place, inside the float32 check (rtol 1e-5, atol 1e-7); max, exp (expf)
// and the division (__fdiv_rn) are the plain version's operations.
//
// The scalar branch (softmax_kernel, register part) takes the other column
// counts up to 1024: one warp per row, the lanes stride over the row with
// 4-byte (or 2-byte) accesses and a bound check.  A row longer than 32 *
// 32 columns takes the block-per-row branch of the same kernel (one block
// of four warps per row, reductions through shared memory, X read three
// times); the launcher picks the branch's grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_REG_K = 32;  // the register branches hold <= 1024 cols
constexpr int VEC_WARPS = 8;   // warps a block of the vector branch
constexpr int VEC_THREADS = 32 * VEC_WARPS;

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

// 16 bytes of T: 4 float32 or 8 bf16 values, loaded and stored with the
// streaming (evict-first) cache hint
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

template <typename T, int VPL, int ROWS>
__global__ void __launch_bounds__(VEC_THREADS)
softmax_kernel_vec(const T* __restrict__ x, T* __restrict__ y, long long rows,
                   int cols) {
  constexpr int N = Vec16<T>::N;
  const int lane = threadIdx.x & 31;
  const long long row0 =
      ((long long)blockIdx.x * VEC_WARPS + threadIdx.x / 32) * ROWS;
  const int nvec = cols / N;  // 16-byte vectors a row
  // every load first: ROWS x VPL 16-byte loads in flight a lane
  float v[ROWS][VPL * N];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int j = k * 32 + lane;
      if (row0 + r < rows && j < nvec) {
        Vec16<T>::load(x + (row0 + r) * cols + j * N, &v[r][k * N]);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) v[r][k * N + e] = -INFINITY;
      }
    }
  float m[ROWS], s[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
#pragma unroll
    for (int e = 0; e < VPL * N; ++e) m[r] = nan_max(m[r], v[r][e]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      m[r] = nan_max(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    s[r] = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const bool in = k * 32 + lane < nvec;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float& u = v[r][k * N + e];
        u = expf(__fsub_rn(u, m[r]));
        if (in) s[r] = __fadd_rn(s[r], u);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      s[r] = __fadd_rn(s[r], __shfl_xor_sync(0xffffffffu, s[r], o));
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (row0 + r >= rows) break;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int j = k * 32 + lane;
      if (j >= nvec) continue;
      float w[N];
#pragma unroll
      for (int e = 0; e < N; ++e) w[e] = __fdiv_rn(v[r][k * N + e], s[r]);
      Vec16<T>::store(y + (row0 + r) * cols + j * N, w);
    }
  }
}

template <typename T, int VPL>
int launch_vec(const void* x, void* y, long long rows, int cols,
               cudaStream_t stream) {
  constexpr int ROWS = VPL >= 4 ? 1 : 4 / VPL;
  const long long per_block = (long long)VEC_WARPS * ROWS;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return -1;
  softmax_kernel_vec<T, VPL, ROWS><<<(unsigned)blocks, VEC_THREADS, 0,
                                     stream>>>((const T*)x, (T*)y, rows,
                                               cols);
  return (int)cudaGetLastError();
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
  constexpr int N = Vec16<T>::N;
  if (cols <= 32 * MAX_REG_K && cols % N == 0 && (uintptr_t)x % 16 == 0 &&
      (uintptr_t)y % 16 == 0) {
    constexpr int MAXV = MAX_REG_K / N;    // vectors a lane at 1024 cols
    const int vpl = (cols / N + 31) / 32;  // 16-byte vectors a lane
    if (vpl <= 1) return launch_vec<T, 1>(x, y, rows, cols, stream);
    if (vpl <= 2) return launch_vec<T, 2>(x, y, rows, cols, stream);
    if (vpl <= 4) return launch_vec<T, 4>(x, y, rows, cols, stream);
    return launch_vec<T, MAXV>(x, y, rows, cols, stream);
  }
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
