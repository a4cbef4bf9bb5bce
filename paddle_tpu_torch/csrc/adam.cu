// Multi-tensor Adam for Hopper (sm_90a): every parameter of a step in one
// launch.
//
// Replaces the main instance of paddle_tpu/ops/kernelgen/builder.py:795
// _compile_segment (pallas_call at :929): the JAX package's fuse pass turns
// the step's per-parameter `adam` ops into one fused group, and the kernel
// generator emits one kernel for it that updates the donated buffers in
// place (builder.py:832-860).  Here the parameters, moments and beta powers
// are likewise updated in place, through the storage the executor's scope
// holds.  The math is the `adam` op's (paddle_tpu/ops/optimizer_ops.py:51-65)
// in float32, rounded op by op in the reference's order (no contraction into
// fused multiply-adds):
//
//   m1' = b1 m1 + (1 - b1) g       m2' = b2 m2 + (1 - b2) g^2
//   lr_t = lr sqrt(1 - b2p) / (1 - b1p)
//   p' = p - lr_t m1' / (sqrt(m2') + eps)      b1p' = b1p b1, b2p' = b2p b2
//
// LR and the powers are read from the device, so a step needs no host sync.
//
// Two int64 tables, built by ops/optimizer_ops.py.  The state table, cached
// while its pointers hold (in-place updates keep them): per tensor, pointers
// to param, m1, m2, beta1_pow and beta2_pow and the element count; then one
// entry per chunk of CHUNK elements, (tensor index << 32) | chunk index.
// The step table, uploaded each step from pinned memory without a host
// sync: per tensor, pointers to its grad and LR, which are new every step.
// One block per chunk.
//
// The race on the powers: every block of a tensor reads beta1_pow and
// beta2_pow, so they may be written only after all those reads.  They are
// advanced by a second, one-thread-per-tensor kernel launched right after
// the update on the same stream (two kernels, one entry-point call).
//
// What bounds it on this card: bytes.  Per element it reads p, g, m1, m2
// and writes p, m1, m2 (28 B); the transformer-base step's 93.3 M elements
// move 2.6 GB, about 0.78 ms at 3.35 TB/s.  What the design does about it:
// 16-byte loads and stores where all four arrays of a chunk are aligned,
// element-wide otherwise, and enough chunks (~2,900 at that size) to keep
// every SM streaming.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32768;  // elements per block (ops/optimizer_ops.py)
constexpr int THREADS = 256;

struct Update {
  float b1, b2, omb1, omb2, eps, lr_t;
  __device__ __forceinline__ void step(float& p, float g, float& m1,
                                       float& m2) const {
    m1 = __fadd_rn(__fmul_rn(b1, m1), __fmul_rn(omb1, g));
    m2 = __fadd_rn(__fmul_rn(b2, m2), __fmul_rn(omb2, __fmul_rn(g, g)));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr_t, m1),
                               __fadd_rn(__fsqrt_rn(m2), eps)));
  }
};

__global__ void __launch_bounds__(THREADS)
adam_kernel(const long long* __restrict__ table,
            const long long* __restrict__ step, int n_tensors, float b1,
            float b2, float omb1, float omb2, float eps) {
  const long long entry = table[6 * (long long)n_tensors + blockIdx.x];
  const long long ti = entry >> 32;
  const long long* t = table + 6 * ti;
  float* p = (float*)t[0];
  float* m1 = (float*)t[1];
  float* m2 = (float*)t[2];
  const float b1p = *(const float*)t[3];
  const float b2p = *(const float*)t[4];
  const long long n = t[5];
  const float* g = (const float*)step[2 * ti];
  const float lr = *(const float*)step[2 * ti + 1];
  const long long start = (entry & 0xffffffffLL) * CHUNK;
  const long long end = min(n, start + CHUNK);
  const Update u{b1, b2, omb1, omb2, eps,
                 __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, b2p))),
                           __fsub_rn(1.f, b1p))};
  long long i = start + threadIdx.x;
  const uintptr_t align = (uintptr_t)p | (uintptr_t)g | (uintptr_t)m1 |
                          (uintptr_t)m2;
  if ((align & 15) == 0) {  // start is a multiple of 4 elements
    const long long vend = start + ((end - start) & ~3LL);
    for (long long j = start + 4 * threadIdx.x; j < vend; j += 4 * THREADS) {
      float4 pv = *(float4*)(p + j);
      const float4 gv = *(const float4*)(g + j);
      float4 av = *(float4*)(m1 + j);
      float4 bv = *(float4*)(m2 + j);
      u.step(pv.x, gv.x, av.x, bv.x);
      u.step(pv.y, gv.y, av.y, bv.y);
      u.step(pv.z, gv.z, av.z, bv.z);
      u.step(pv.w, gv.w, av.w, bv.w);
      *(float4*)(p + j) = pv;
      *(float4*)(m1 + j) = av;
      *(float4*)(m2 + j) = bv;
    }
    i = vend + threadIdx.x;
  }
  for (; i < end; i += THREADS) {
    float pe = p[i], a = m1[i], b = m2[i];
    u.step(pe, g[i], a, b);
    p[i] = pe;
    m1[i] = a;
    m2[i] = b;
  }
}

__global__ void adam_pows_kernel(const long long* __restrict__ table,
                                 int n_tensors, float b1, float b2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tensors) return;
  float* b1p = (float*)table[6 * i + 3];
  float* b2p = (float*)table[6 * i + 4];
  *b1p = __fmul_rn(*b1p, b1);
  *b2p = __fmul_rn(*b2p, b2);
}

// ------------------------------------------------- any operand in bf16
//
// adam_bf16_kernel: the instance for tensors of which any of the param,
// the grad, the moments or the beta powers is bf16 (the JAX package's
// bf16 build, paddle_tpu/models/llama.py build(dtype='bfloat16')).  It
// computes in float32 and rounds where the reference's jnp rounds: every
// operation to the promoted dtype of its operands (R_X: to bf16 when X is
// bf16), a Python scalar first to the dtype of the array it meets:
//
//   m1' = R_C(R_M(R_M(b1) m1) + R_G(R_G(1 - b1) g))      C = promote(M, G)
//   m2' = R_C(R_M(R_M(b2) m2) + R_G(R_G(1 - b2) R_G(g g)))
//   lr_t = lr R_W(sqrt(R_W(1 - b2p))) / R_W(1 - b1p)     (lr float32)
//   p' = p - lr_t m1' / R_C(R_C(sqrt(m2')) + R_C(eps))   (float32)
//   b1p' = R_W(b1p R_W(b1)),  b2p' = R_W(b2p R_W(b2))
//
// The float32 learning rate makes p' float32 whatever p's dtype, and the
// moments come out in C, so p' and a promoted moment go to new tensors
// (the table's out pointers), as the reference's outputs take the new
// dtype; an output of its input's dtype is its input.  The table has 9
// entries a tensor: p, m1, m2, beta1_pow, beta2_pow, the element count,
// then the out pointers of p, m1, m2; then the chunks as above.  The
// dtypes are flags of the launch (one launch per combination).
// Element-wide loads and stores.

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? rbf(x) : x;
}
__device__ __forceinline__ float ldx(const void* p, long long i, bool bf) {
  return bf ? __bfloat162float(((const __nv_bfloat16*)p)[i])
            : ((const float*)p)[i];
}
__device__ __forceinline__ void stx(void* p, long long i, float v, bool bf) {
  if (bf)
    ((__nv_bfloat16*)p)[i] = __float2bfloat16_rn(v);
  else
    ((float*)p)[i] = v;
}

struct Flags {
  bool p, g, m, w, c;  // bf16: param, grad, moments, powers, moments out
};

__global__ void __launch_bounds__(THREADS)
adam_bf16_kernel(const long long* __restrict__ table,
                 const long long* __restrict__ step, int n_tensors, float b1,
                 float b2, float omb1, float omb2, float eps, Flags f) {
  const long long entry = table[9 * (long long)n_tensors + blockIdx.x];
  const long long ti = entry >> 32;
  const long long* t = table + 9 * ti;
  const void* p = (const void*)t[0];
  const void* m1 = (const void*)t[1];
  const void* m2 = (const void*)t[2];
  const float b1p = ldx((const void*)t[3], 0, f.w);
  const float b2p = ldx((const void*)t[4], 0, f.w);
  const long long n = t[5];
  float* po = (float*)t[6];
  void* m1o = (void*)t[7];
  void* m2o = (void*)t[8];
  const void* g = (const void*)step[2 * ti];
  const float lr = *(const float*)step[2 * ti + 1];
  const long long start = (entry & 0xffffffffLL) * CHUNK;
  const long long end = min(n, start + CHUNK);
  const float lr_t = __fdiv_rn(
      __fmul_rn(lr, rnd(__fsqrt_rn(rnd(__fsub_rn(1.f, b2p), f.w)), f.w)),
      rnd(__fsub_rn(1.f, b1p), f.w));
  const float b1m = rnd(b1, f.m), b2m = rnd(b2, f.m);
  const float omb1g = rnd(omb1, f.g), omb2g = rnd(omb2, f.g);
  const float epsc = rnd(eps, f.c);
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    const float gv = ldx(g, i, f.g);
    const float a = rnd(__fadd_rn(rnd(__fmul_rn(b1m, ldx(m1, i, f.m)), f.m),
                                  rnd(__fmul_rn(omb1g, gv), f.g)),
                        f.c);
    const float gg = rnd(__fmul_rn(gv, gv), f.g);
    const float b = rnd(__fadd_rn(rnd(__fmul_rn(b2m, ldx(m2, i, f.m)), f.m),
                                  rnd(__fmul_rn(omb2g, gg), f.g)),
                        f.c);
    const float den = rnd(__fadd_rn(rnd(__fsqrt_rn(b), f.c), epsc), f.c);
    po[i] = __fsub_rn(ldx(p, i, f.p), __fdiv_rn(__fmul_rn(lr_t, a), den));
    stx(m1o, i, a, f.c);
    stx(m2o, i, b, f.c);
  }
}

__global__ void adam_bf16_pows_kernel(const long long* __restrict__ table,
                                      int n_tensors, float b1, float b2,
                                      bool w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tensors) return;
  void* b1p = (void*)table[9 * i + 3];
  void* b2p = (void*)table[9 * i + 4];
  stx(b1p, 0, rnd(__fmul_rn(ldx(b1p, 0, w), rnd(b1, w)), w), w);
  stx(b2p, 0, rnd(__fmul_rn(ldx(b2p, 0, w), rnd(b2, w)), w), w);
}

}  // namespace

// table, step: the int64 device tables above; omb1 / omb2 are (1 - beta1)
// and (1 - beta2) rounded from double, as the reference's Python scalars
// are.  Returns the CUDA error of the launches (0 on success), or -1 for
// arguments the kernel does not take.
extern "C" int pt_adam_multi(const void* table, const void* step,
                             int n_tensors, int n_chunks, float b1, float b2,
                             float omb1, float omb2, float eps,
                             void* stream) {
  if (n_tensors < 1 || n_chunks < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  adam_kernel<<<n_chunks, THREADS, 0, s>>>(
      (const long long*)table, (const long long*)step, n_tensors, b1, b2,
      omb1, omb2, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  adam_pows_kernel<<<(n_tensors + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const long long*)table, n_tensors, b1, b2);
  return (int)cudaGetLastError();
}

// The bf16 instance (adam_bf16_kernel): table with 9 entries a tensor,
// step as above; the flags say which of param, grad, moments and beta
// powers are bf16 (1) or float32 (0); the moments come out bf16 when both
// the moments and the grad are.  Returns as pt_adam_multi.
extern "C" int pt_adam_multi_bf16(const void* table, const void* step,
                                  int n_tensors, int n_chunks, float b1,
                                  float b2, float omb1, float omb2,
                                  float eps, int p_bf16, int g_bf16,
                                  int m_bf16, int w_bf16, void* stream) {
  if (n_tensors < 1 || n_chunks < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const Flags f{p_bf16 != 0, g_bf16 != 0, m_bf16 != 0, w_bf16 != 0,
                m_bf16 != 0 && g_bf16 != 0};
  adam_bf16_kernel<<<n_chunks, THREADS, 0, s>>>(
      (const long long*)table, (const long long*)step, n_tensors, b1, b2,
      omb1, omb2, eps, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  adam_bf16_pows_kernel<<<(n_tensors + THREADS - 1) / THREADS, THREADS, 0,
                          s>>>((const long long*)table, n_tensors, b1, b2,
                               f.w);
  return (int)cudaGetLastError();
}
