// Multi-tensor Momentum for Hopper (sm_90a): every parameter of a step in
// one launch.
//
// Replaces the momentum instance of paddle_tpu/ops/kernelgen/builder.py:795
// _compile_segment (pallas_call at :929) with the rule
// paddle_tpu/ops/kernelgen/rules.py:495 `momentum`: the JAX package's fuse
// pass turns the step's per-parameter `momentum` ops into one fused group,
// and the kernel generator emits one kernel for it that updates the donated
// buffers in place.  Here the parameters and velocities are likewise
// updated in place, through the storage the executor's scope holds.  The
// math is the `momentum` op's (paddle_tpu/ops/optimizer_ops.py:24-34) in
// float32, rounded op by op in the reference's order (no contraction into
// fused multiply-adds):
//
//   v' = mu v + g
//   p' = p - lr (g + mu v')   (nesterov)      p' = p - lr v'   (else)
//
// LR is read from the device, so a step needs no host sync.
//
// Two int64 tables, built by ops/optimizer_ops.py.  The state table,
// cached while its pointers hold (in-place updates keep them): per tensor,
// pointers to param and velocity and the element count; then one entry per
// chunk of CHUNK elements, (tensor index << 32) | chunk index.  The step
// table, uploaded each step: per tensor, pointers to its grad and LR, which
// are new every step.  One block per chunk.
//
// What bounds it on this card: bytes.  Per element it reads p, g and v and
// writes p and v (20 B); ResNet-50's 161 tensors hold 25.56 M elements, so
// a step moves 511 MB, 0.153 ms at 3.35 TB/s.  What the design does about
// it: 16-byte loads and stores where the three arrays of a chunk are
// aligned (element-wide otherwise), loads and stores marked streaming
// (each value is touched once), and enough chunks (~6,300 at that size) to
// keep every SM streaming.
#include <cuda_runtime.h>
#include <stdint.h>

#include "jnp_dtypes.cuh"

namespace {

using namespace jnp;

constexpr int CHUNK = 4096;  // elements per block (ops/optimizer_ops.py)
constexpr int THREADS = 256;

// T float: the float32 instance's IEEE operations; T J: jnp's dtypes
template <class T>
struct Update {
  T lr;
  W mu;
  bool nesterov;
  __device__ __forceinline__ void step(T& p, T g, T& v) const {
    v = add(mul(wk(mu, v), v), g);
    const T d = nesterov ? add(g, mul(wk(mu, v), v)) : v;
    p = sub(p, mul(lr, d));
  }
};

__global__ void __launch_bounds__(THREADS)
momentum_kernel(const long long* __restrict__ table,
                const long long* __restrict__ step, int n_tensors, float mu,
                int nesterov) {
  const long long entry = table[3 * (long long)n_tensors + blockIdx.x];
  const long long ti = entry >> 32;
  const long long* t = table + 3 * ti;
  float* p = (float*)t[0];
  float* v = (float*)t[1];
  const long long n = t[2];
  const float* g = (const float*)step[2 * ti];
  const Update<float> u{*(const float*)step[2 * ti + 1], W{mu, mu},
                        nesterov != 0};
  const long long start = (entry & 0xffffffffLL) * CHUNK;
  const long long end = min(n, start + CHUNK);
  long long i = start + threadIdx.x;
  const uintptr_t align = (uintptr_t)p | (uintptr_t)g | (uintptr_t)v;
  if ((align & 15) == 0) {  // start is a multiple of 4 elements
    const long long vend = start + ((end - start) & ~3LL);
    for (long long j = start + 4 * threadIdx.x; j < vend; j += 4 * THREADS) {
      float4 pv = __ldcs((const float4*)(p + j));
      const float4 gv = __ldcs((const float4*)(g + j));
      float4 vv = __ldcs((const float4*)(v + j));
      u.step(pv.x, gv.x, vv.x);
      u.step(pv.y, gv.y, vv.y);
      u.step(pv.z, gv.z, vv.z);
      u.step(pv.w, gv.w, vv.w);
      __stcs((float4*)(p + j), pv);
      __stcs((float4*)(v + j), vv);
    }
    i = vend + threadIdx.x;
  }
  for (; i < end; i += THREADS) {
    float pe = __ldcs(p + i), ve = __ldcs(v + i);
    u.step(pe, __ldcs(g + i), ve);
    __stcs(p + i, pe);
    __stcs(v + i, ve);
  }
}

// ------------------------------------------------- any operand in bf16
//
// momentum_bf16_kernel: the instance for tensors of which any of the
// param, the grad or the velocity is bf16, adam_bf16_kernel's design
// (adam.cu).  It computes in float32 and rounds where the reference's jnp
// rounds (jnp_dtypes.cuh): each operation to its operands' promoted dtype,
// mu first to the dtype of the array it meets:
//
//   v' = R_C(R_V(R_V(mu) v) + g)           C = promote(V, G)
//   p' = p - lr R_C(g + R_C(R_C(mu) v'))   (nesterov; float32)
//   p' = p - lr v'                         (else; float32)
//
// The float32 learning rate makes p' float32 whatever p's dtype, so p'
// and a promoted velocity go to new tensors (the table's out pointers),
// as the reference's outputs take the new dtype; an output of its input's
// dtype is its input.  The table has 5 entries a tensor: p, v, the
// element count, the out pointers of p and v; then the chunks as above.
// The dtypes are flags of the launch (one launch per combination): bit 0
// p, 1 g, 2 v, 3 p out, 4 v out bf16.  Element-wise loads and stores.

__global__ void __launch_bounds__(THREADS)
momentum_bf16_kernel(const long long* __restrict__ table,
                     const long long* __restrict__ step, int n_tensors,
                     W mu, int nesterov, unsigned flags) {
  const long long entry = table[5 * (long long)n_tensors + blockIdx.x];
  const long long ti = entry >> 32;
  const long long* t = table + 5 * ti;
  const void* p = (const void*)t[0];
  const void* v = (const void*)t[1];
  const long long n = t[2];
  void* po = (void*)t[3];
  void* vo = (void*)t[4];
  const void* g = (const void*)step[2 * ti];
  const bool fp = flags & 1, fg = flags & 2, fv = flags & 4,
             fpo = flags & 8, fvo = flags & 16;
  const Update<J> u{J{*(const float*)step[2 * ti + 1], false}, mu,
                    nesterov != 0};
  const long long start = (entry & 0xffffffffLL) * CHUNK;
  const long long end = min(n, start + CHUNK);
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    J pe = val(p, i, fp), ve = val(v, i, fv);
    u.step(pe, val(g, i, fg), ve);
    jnp::st(po, i, pe.v, fpo);
    jnp::st(vo, i, ve.v, fvo);
  }
}

}  // namespace

// table, step: the int64 device tables above; mu is the op's attribute
// rounded to float32, as the reference's Python scalar is; nesterov 0 or
// 1.  Returns the CUDA error of the launch (0 on success), or -1 for
// arguments the kernel does not take.
extern "C" int pt_momentum_multi(const void* table, const void* step,
                                 int n_tensors, int n_chunks, float mu,
                                 int nesterov, void* stream) {
  if (n_tensors < 1 || n_chunks < 1) return -1;
  momentum_kernel<<<n_chunks, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)table, (const long long*)step, n_tensors, mu,
      nesterov);
  return (int)cudaGetLastError();
}

// The bf16 instance (momentum_bf16_kernel): table with 5 entries a
// tensor, step as above; mu_f and mu_h the attribute rounded to float32
// and to bf16; flags as above.  Returns as pt_momentum_multi.
extern "C" int pt_momentum_multi_bf16(const void* table, const void* step,
                                      int n_tensors, int n_chunks,
                                      float mu_f, float mu_h, int nesterov,
                                      int flags, void* stream) {
  if (n_tensors < 1 || n_chunks < 1) return -1;
  momentum_bf16_kernel<<<n_chunks, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)table, (const long long*)step, n_tensors,
      W{mu_f, mu_h}, nesterov, (unsigned)flags);
  return (int)cudaGetLastError();
}
