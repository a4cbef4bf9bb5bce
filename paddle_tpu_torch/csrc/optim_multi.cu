// Multi-tensor optimizer updates for Hopper (sm_90a): sgd, adagrad,
// decayed_adagrad, adamax, adadelta, rmsprop (plain and centered) and ftrl,
// every parameter of a step in one launch.
//
// Replaces those instances of paddle_tpu/ops/kernelgen/builder.py:795
// _compile_segment (pallas_call at :929) with the in-place rules of
// paddle_tpu/ops/kernelgen/rules.py:494-511: the JAX package's fuse pass
// turns a step's per-parameter update ops into one fused group, and the
// kernel generator emits one kernel for it that updates the donated buffers
// in place.  Here the parameters and the optimizer's state arrays are
// likewise updated in place, through the storage the executor's scope
// holds.  One kernel design, seven update functors (nine instances: rmsprop
// centered or not, ftrl at lr_power -0.5 or another power).  The math is the
// ops' (paddle_tpu/ops/optimizer_ops.py:19-163) in float32, rounded op by op
// in the reference's order (no contraction into fused multiply-adds):
//
//   sgd       p' = p - lr g
//   adagrad   m' = m + g^2                    p' = p - lr g / (sqrt(m') + eps)
//   decayed   m' = d m + (1 - d) g^2          p' as adagrad
//   adamax    m' = b1 m + (1 - b1) g          u' = max(b2 u, |g|)
//             p' = p - (lr / (1 - b1p)) m' / (u' + eps)
//   adadelta  G' = rho G + (1 - rho) g^2      x = -sqrt((U + eps) / (G' + eps)) g
//             U' = rho U + (1 - rho) x^2      p' = p + x
//   rmsprop   s' = rho s + (1 - rho) g^2      [c' = rho c + (1 - rho) g]
//             v' = mu v + lr g / sqrt(s' [- c'^2] + eps)      p' = p - v'
//   ftrl      n' = n + g^2   a = n'^e, b = n^e (sqrt when lr_power = -0.5)
//             z' = z + g - ((a - b) / lr) p   den = l2 + a / lr
//             p' = |z'| > l1 ? (l1 sign(z') - z') / den : 0
//
// The Python constants of the reference (1 - rho, 1 - b1, l1 + 1e-10, the
// exponent e = -lr_power) are computed in double on the host and rounded to
// float32 there, as jnp's weak types round them where they meet a float32
// array (ops/optimizer_ops.py _optim_consts); device values (lr, 1 - b1p)
// are computed here in float32.  powf is not correctly rounded, so the
// ftrl_pow instance is held to a bound, not bit for bit.  LR and Beta1Pow
// are read from the device, so a step needs no host sync.
//
// Two int64 tables, built by ops/optimizer_ops.py.  The state table, cached
// while its pointers hold (in-place updates keep them): per tensor, HEAD
// entries: pointers to the param and up to three state arrays (0 where the
// instance has fewer) and the element count; then one entry per chunk of
// CHUNK elements, (tensor index << 32) | chunk index.  The step table,
// uploaded each step: per tensor, pointers to its grad, its LR (0 for
// adadelta) and its scalar input (adamax's Beta1Pow, else 0), which may be
// new every step.  One block per chunk.
//
// What bounds it on this card: bytes.  Per element it reads p, g and the
// state arrays and writes p and the state arrays: 12 B for sgd, 20 for
// adagrad, 28 for adamax, adadelta, rmsprop and ftrl, 36 for centered
// rmsprop.  What the design does about it: 16-byte loads and stores where
// the arrays of a chunk are aligned (element-wide otherwise), loads and
// stores marked streaming (each value is touched once), and enough chunks
// to keep every SM streaming.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 4096;  // elements per block (ops/optimizer_ops.py)
constexpr int THREADS = 256;
constexpr int HEAD = 5;      // state table entries per tensor
constexpr int STEP = 3;      // step table entries per tensor

__device__ __forceinline__ float rd(const long long p) {
  return *(const float*)p;
}
__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }
// jnp.maximum: NaN propagates
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Consts {
  float c0, c1, c2, c3;
};

struct Sgd {
  static constexpr int NS = 0;
  float lr;
  __device__ void prep(const long long* st, const Consts&) { lr = rd(st[1]); }
  __device__ void step(float& p, float g, float&, float&, float&) const {
    p = __fsub_rn(p, __fmul_rn(lr, g));
  }
};

// adagrad (DECAYED false: c0 eps) and decayed_adagrad (c0 decay,
// c1 1 - decay, c2 eps)
template <bool DECAYED>
struct Adagrad {
  static constexpr int NS = 1;
  float lr, d, omd, eps;
  __device__ void prep(const long long* st, const Consts& c) {
    lr = rd(st[1]);
    d = c.c0;
    omd = c.c1;
    eps = DECAYED ? c.c2 : c.c0;
  }
  __device__ void step(float& p, float g, float& m, float&, float&) const {
    m = DECAYED ? __fadd_rn(__fmul_rn(d, m), __fmul_rn(omd, sq(g)))
                : __fadd_rn(m, sq(g));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g),
                               __fadd_rn(__fsqrt_rn(m), eps)));
  }
};

// c0 beta1, c1 1 - beta1, c2 beta2, c3 eps
struct Adamax {
  static constexpr int NS = 2;
  float lr_t, b1, omb1, b2, eps;
  __device__ void prep(const long long* st, const Consts& c) {
    lr_t = __fdiv_rn(rd(st[1]), __fsub_rn(1.f, rd(st[2])));
    b1 = c.c0;
    omb1 = c.c1;
    b2 = c.c2;
    eps = c.c3;
  }
  __device__ void step(float& p, float g, float& m, float& u, float&) const {
    m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
    u = nanmax(__fmul_rn(b2, u), fabsf(g));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr_t, m), __fadd_rn(u, eps)));
  }
};

// c0 rho, c1 1 - rho, c2 eps
struct Adadelta {
  static constexpr int NS = 2;
  float rho, omr, eps;
  __device__ void prep(const long long*, const Consts& c) {
    rho = c.c0;
    omr = c.c1;
    eps = c.c2;
  }
  __device__ void step(float& p, float g, float& ag, float& au,
                       float&) const {
    ag = __fadd_rn(__fmul_rn(rho, ag), __fmul_rn(omr, sq(g)));
    const float x = -__fmul_rn(
        __fsqrt_rn(__fdiv_rn(__fadd_rn(au, eps), __fadd_rn(ag, eps))), g);
    au = __fadd_rn(__fmul_rn(rho, au), __fmul_rn(omr, sq(x)));
    p = __fadd_rn(p, x);
  }
};

// c0 rho, c1 1 - rho, c2 eps, c3 momentum; states mean square, moment and
// (CENTERED) mean grad
template <bool CENTERED>
struct Rmsprop {
  static constexpr int NS = CENTERED ? 3 : 2;
  float lr, rho, omr, eps, mu;
  __device__ void prep(const long long* st, const Consts& c) {
    lr = rd(st[1]);
    rho = c.c0;
    omr = c.c1;
    eps = c.c2;
    mu = c.c3;
  }
  __device__ void step(float& p, float g, float& ms, float& mom,
                       float& mg) const {
    ms = __fadd_rn(__fmul_rn(rho, ms), __fmul_rn(omr, sq(g)));
    float den = ms;
    if (CENTERED) {
      mg = __fadd_rn(__fmul_rn(rho, mg), __fmul_rn(omr, g));
      den = __fsub_rn(ms, sq(mg));
    }
    mom = __fadd_rn(__fmul_rn(mu, mom),
                    __fdiv_rn(__fmul_rn(lr, g), __fsqrt_rn(__fadd_rn(den, eps))));
    p = __fsub_rn(p, mom);
  }
};

// c0 l1 + 1e-10, c1 l2 + 1e-10, c2 -lr_power (POW only)
template <bool POW>
struct Ftrl {
  static constexpr int NS = 2;
  float lr, l1, l2, e;
  __device__ void prep(const long long* st, const Consts& c) {
    lr = rd(st[1]);
    l1 = c.c0;
    l2 = c.c1;
    e = c.c2;
  }
  __device__ float root(float x) const {
    return POW ? powf(x, e) : __fsqrt_rn(x);
  }
  __device__ void step(float& p, float g, float& n, float& z, float&) const {
    const float nn = __fadd_rn(n, sq(g));
    const float a = root(nn);
    const float sigma = __fdiv_rn(__fsub_rn(a, root(n)), lr);
    z = __fsub_rn(__fadd_rn(z, g), __fmul_rn(sigma, p));
    const float den = __fadd_rn(l2, __fdiv_rn(a, lr));
    p = fabsf(z) > l1
            ? __fdiv_rn(__fsub_rn(z > 0.f ? l1 : -l1, z), den)
            : 0.f;
    n = nn;
  }
};

template <class Op>
__global__ void __launch_bounds__(THREADS)
optim_kernel(const long long* __restrict__ table,
             const long long* __restrict__ step, int n_tensors, Consts c) {
  const long long entry = table[HEAD * (long long)n_tensors + blockIdx.x];
  const long long ti = entry >> 32;
  const long long* t = table + HEAD * ti;
  float* p = (float*)t[0];
  float* s0 = (float*)t[1];
  float* s1 = (float*)t[2];
  float* s2 = (float*)t[3];
  const long long n = t[4];
  const float* g = (const float*)step[STEP * ti];
  Op op;
  op.prep(step + STEP * ti, c);
  const long long start = (entry & 0xffffffffLL) * CHUNK;
  const long long end = min(n, start + CHUNK);
  long long i = start + threadIdx.x;
  uintptr_t align = (uintptr_t)p | (uintptr_t)g;
  if (Op::NS > 0) align |= (uintptr_t)s0;
  if (Op::NS > 1) align |= (uintptr_t)s1;
  if (Op::NS > 2) align |= (uintptr_t)s2;
  if ((align & 15) == 0) {  // start is a multiple of 4 elements
    const long long vend = start + ((end - start) & ~3LL);
    for (long long j = start + 4 * threadIdx.x; j < vend; j += 4 * THREADS) {
      float4 pv = __ldcs((const float4*)(p + j));
      const float4 gv = __ldcs((const float4*)(g + j));
      float4 a = {}, b = {}, d = {};
      if (Op::NS > 0) a = __ldcs((const float4*)(s0 + j));
      if (Op::NS > 1) b = __ldcs((const float4*)(s1 + j));
      if (Op::NS > 2) d = __ldcs((const float4*)(s2 + j));
      op.step(pv.x, gv.x, a.x, b.x, d.x);
      op.step(pv.y, gv.y, a.y, b.y, d.y);
      op.step(pv.z, gv.z, a.z, b.z, d.z);
      op.step(pv.w, gv.w, a.w, b.w, d.w);
      __stcs((float4*)(p + j), pv);
      if (Op::NS > 0) __stcs((float4*)(s0 + j), a);
      if (Op::NS > 1) __stcs((float4*)(s1 + j), b);
      if (Op::NS > 2) __stcs((float4*)(s2 + j), d);
    }
    i = vend + threadIdx.x;
  }
  for (; i < end; i += THREADS) {
    float pe = __ldcs(p + i);
    float a = Op::NS > 0 ? __ldcs(s0 + i) : 0.f;
    float b = Op::NS > 1 ? __ldcs(s1 + i) : 0.f;
    float d = Op::NS > 2 ? __ldcs(s2 + i) : 0.f;
    op.step(pe, __ldcs(g + i), a, b, d);
    __stcs(p + i, pe);
    if (Op::NS > 0) __stcs(s0 + i, a);
    if (Op::NS > 1) __stcs(s1 + i, b);
    if (Op::NS > 2) __stcs(s2 + i, d);
  }
}

template <class Op>
int launch(const void* table, const void* step, int n_tensors, int n_chunks,
           Consts c, cudaStream_t stream) {
  optim_kernel<Op><<<n_chunks, THREADS, 0, stream>>>(
      (const long long*)table, (const long long*)step, n_tensors, c);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: the instance, in ops/optimizer_ops.py _KINDS order (0 sgd,
// 1 adagrad, 2 decayed_adagrad, 3 adamax, 4 adadelta, 5 rmsprop,
// 6 rmsprop centered, 7 ftrl, 8 ftrl with powf); table, step: the int64
// device tables above; c0..c3: the instance's float32 constants
// (ops/optimizer_ops.py _optim_consts).  Returns the CUDA error of the
// launch (0 on success), or -1 for arguments the kernel does not take.
extern "C" int pt_optim_multi(int kind, const void* table, const void* step,
                              int n_tensors, int n_chunks, float c0, float c1,
                              float c2, float c3, void* stream) {
  if (n_tensors < 1 || n_chunks < 1) return -1;
  const Consts c{c0, c1, c2, c3};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0: return launch<Sgd>(table, step, n_tensors, n_chunks, c, s);
    case 1: return launch<Adagrad<false>>(table, step, n_tensors, n_chunks, c, s);
    case 2: return launch<Adagrad<true>>(table, step, n_tensors, n_chunks, c, s);
    case 3: return launch<Adamax>(table, step, n_tensors, n_chunks, c, s);
    case 4: return launch<Adadelta>(table, step, n_tensors, n_chunks, c, s);
    case 5: return launch<Rmsprop<false>>(table, step, n_tensors, n_chunks, c, s);
    case 6: return launch<Rmsprop<true>>(table, step, n_tensors, n_chunks, c, s);
    case 7: return launch<Ftrl<false>>(table, step, n_tensors, n_chunks, c, s);
    case 8: return launch<Ftrl<true>>(table, step, n_tensors, n_chunks, c, s);
    default: return -1;
  }
}
