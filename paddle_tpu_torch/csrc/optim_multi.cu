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

#include "jnp_dtypes.cuh"

namespace {

using namespace jnp;

constexpr int CHUNK = 4096;  // elements per block (ops/optimizer_ops.py)
constexpr int THREADS = 256;
constexpr int HEAD = 5;      // state table entries per tensor
constexpr int STEP = 3;      // step table entries per tensor

// the instance's constants c0..c3, each rounded to float32 and to bf16
struct Consts {
  W c0, c1, c2, c3;
};

// The update functors, on T float (the float32 instances' IEEE
// operations) or T J (jnp's dtypes, the bf16 instances): `prep` takes the
// learning rate and the scalar input (adamax's Beta1Pow) as values of T.
template <class T>
struct Sgd {
  static constexpr int NS = 0;
  T lr;
  __device__ void prep(T lr_, T, const Consts&) { lr = lr_; }
  __device__ void step(T& p, T g, T&, T&, T&) const {
    p = sub(p, mul(lr, g));
  }
};

// adagrad (DECAYED false: c0 eps) and decayed_adagrad (c0 decay,
// c1 1 - decay, c2 eps)
template <class T, bool DECAYED>
struct Adagrad {
  static constexpr int NS = 1;
  T lr;
  W d, omd, eps;
  __device__ void prep(T lr_, T, const Consts& c) {
    lr = lr_;
    d = c.c0;
    omd = c.c1;
    eps = DECAYED ? c.c2 : c.c0;
  }
  __device__ void step(T& p, T g, T& m, T&, T&) const {
    const T gg = mul(g, g);
    m = DECAYED ? add(mul(wk(d, m), m), mul(wk(omd, gg), gg)) : add(m, gg);
    const T s = sqrt_(m);
    p = sub(p, div(mul(lr, g), add(s, wk(eps, s))));
  }
};
template <class T>
using Adagrad0 = Adagrad<T, false>;
template <class T>
using Adagrad1 = Adagrad<T, true>;

// c0 beta1, c1 1 - beta1, c2 beta2, c3 eps
template <class T>
struct Adamax {
  static constexpr int NS = 2;
  T lr_t;
  W b1, omb1, b2, eps;
  __device__ void prep(T lr, T b1p, const Consts& c) {
    lr_t = div(lr, sub(wk(W{1.f, 1.f}, b1p), b1p));
    b1 = c.c0;
    omb1 = c.c1;
    b2 = c.c2;
    eps = c.c3;
  }
  __device__ void step(T& p, T g, T& m, T& u, T&) const {
    m = add(mul(wk(b1, m), m), mul(wk(omb1, g), g));
    u = max_(mul(wk(b2, u), u), abs_(g));
    p = sub(p, div(mul(lr_t, m), add(u, wk(eps, u))));
  }
};

// c0 rho, c1 1 - rho, c2 eps
template <class T>
struct Adadelta {
  static constexpr int NS = 2;
  W rho, omr, eps;
  __device__ void prep(T, T, const Consts& c) {
    rho = c.c0;
    omr = c.c1;
    eps = c.c2;
  }
  __device__ void step(T& p, T g, T& ag, T& au, T&) const {
    const T gg = mul(g, g);
    ag = add(mul(wk(rho, ag), ag), mul(wk(omr, gg), gg));
    const T x = mul(neg(sqrt_(div(add(au, wk(eps, au)),
                                  add(ag, wk(eps, ag))))), g);
    const T xx = mul(x, x);
    au = add(mul(wk(rho, au), au), mul(wk(omr, xx), xx));
    p = add(p, x);
  }
};

// c0 rho, c1 1 - rho, c2 eps, c3 momentum; states mean square, moment and
// (CENTERED) mean grad
template <class T, bool CENTERED>
struct Rmsprop {
  static constexpr int NS = CENTERED ? 3 : 2;
  T lr;
  W rho, omr, eps, mu;
  __device__ void prep(T lr_, T, const Consts& c) {
    lr = lr_;
    rho = c.c0;
    omr = c.c1;
    eps = c.c2;
    mu = c.c3;
  }
  __device__ void step(T& p, T g, T& ms, T& mom, T& mg) const {
    const T gg = mul(g, g);
    ms = add(mul(wk(rho, ms), ms), mul(wk(omr, gg), gg));
    T den = ms;
    if (CENTERED) {
      mg = add(mul(wk(rho, mg), mg), mul(wk(omr, g), g));
      den = sub(ms, mul(mg, mg));
    }
    mom = add(mul(wk(mu, mom), mom),
              div(mul(lr, g), sqrt_(add(den, wk(eps, den)))));
    p = sub(p, mom);
  }
};
template <class T>
using Rmsprop0 = Rmsprop<T, false>;
template <class T>
using Rmsprop1 = Rmsprop<T, true>;

// c0 l1 + 1e-10, c1 l2 + 1e-10, c2 -lr_power (POW only)
template <class T, bool POW>
struct Ftrl {
  static constexpr int NS = 2;
  T lr;
  W l1, l2, e;
  __device__ void prep(T lr_, T, const Consts& c) {
    lr = lr_;
    l1 = c.c0;
    l2 = c.c1;
    e = c.c2;
  }
  __device__ T root(T x) const { return POW ? pow_(x, wk(e, x)) : sqrt_(x); }
  __device__ void step(T& p, T g, T& n, T& z, T&) const {
    const T nn = add(n, mul(g, g));
    const T a = root(nn);
    const T sigma = div(sub(a, root(n)), lr);
    z = sub(add(z, g), mul(sigma, p));
    const T al = div(a, lr);
    const T den = add(wk(l2, al), al);
    // jnp.where(|z'| > l1, (l1 sign(z') - z') / den, zeros_like(p))
    const T l1z = wk(l1, z);
    p = where_(fabsf(value(z)) > value(l1z),
               div(sub(value(z) > 0.f ? l1z : neg(l1z), z), den),
               wk(W{0.f, 0.f}, p));
    n = nn;
  }
};
template <class T>
using Ftrl0 = Ftrl<T, false>;
template <class T>
using Ftrl1 = Ftrl<T, true>;

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
  const long long* st = step + STEP * ti;
  const float* g = (const float*)st[0];
  Op op;
  op.prep(st[1] ? *(const float*)st[1] : 0.f,
          st[2] ? *(const float*)st[2] : 0.f, c);
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

// ------------------------------------------------- any operand in bf16
//
// optim_bf16_kernel: the instance for tensors of which any of the param,
// the grad, the state arrays or adamax's Beta1Pow is bf16, adam.cu's
// adam_bf16_kernel design.  The same functor on J values (jnp_dtypes.cuh):
// each operation rounded to its operands' promoted dtype, each constant
// first to the dtype of the array it meets.  The float32 learning rate
// makes p' float32 wherever it enters the update (all but adadelta), and
// rmsprop's moment and ftrl's linear accumulator float32 with it; each
// output whose dtype is not its input's goes to a new tensor (the table's
// out pointers: ops/optimizer_ops.py _optim_dtypes gives the dtypes).
// The table has 2 HEAD - 1 entries a tensor: the param and three state
// pointers, the element count, the out pointers of the param and the
// three states; then the chunks as above.  Flags (one launch per dtype
// combination): bit 0 param, 1 grad, 2-4 states, 5 Beta1Pow, 6 param out,
// 7-9 state outs bf16.  Element-wise loads and stores.

template <class Op>
__global__ void __launch_bounds__(THREADS)
optim_bf16_kernel(const long long* __restrict__ table,
                  const long long* __restrict__ step, int n_tensors,
                  Consts c, unsigned f) {
  constexpr int H = 2 * HEAD - 1;
  const long long entry = table[H * (long long)n_tensors + blockIdx.x];
  const long long ti = entry >> 32;
  const long long* t = table + H * ti;
  const long long n = t[HEAD - 1];
  const long long* st = step + STEP * ti;
  const void* g = (const void*)st[0];
  Op op;
  op.prep(J{st[1] ? *(const float*)st[1] : 0.f, false},
          st[2] ? val((const void*)st[2], 0, f & 32) : J{0.f, false}, c);
  const long long start = (entry & 0xffffffffLL) * CHUNK;
  const long long end = min(n, start + CHUNK);
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    J pe = val((const void*)t[0], i, f & 1);
    J a = Op::NS > 0 ? val((const void*)t[1], i, f & 4) : J{0.f, false};
    J b = Op::NS > 1 ? val((const void*)t[2], i, f & 8) : J{0.f, false};
    J d = Op::NS > 2 ? val((const void*)t[3], i, f & 16) : J{0.f, false};
    op.step(pe, val(g, i, f & 2), a, b, d);
    jnp::st((void*)t[HEAD], i, pe.v, f & 64);
    if (Op::NS > 0) jnp::st((void*)t[HEAD + 1], i, a.v, f & 128);
    if (Op::NS > 1) jnp::st((void*)t[HEAD + 2], i, b.v, f & 256);
    if (Op::NS > 2) jnp::st((void*)t[HEAD + 3], i, d.v, f & 512);
  }
}

template <template <class> class Op>
int launch(bool bf16, const void* table, const void* step, int n_tensors,
           int n_chunks, Consts c, unsigned flags, cudaStream_t stream) {
  if (bf16)
    optim_bf16_kernel<Op<J>><<<n_chunks, THREADS, 0, stream>>>(
        (const long long*)table, (const long long*)step, n_tensors, c,
        flags);
  else
    optim_kernel<Op<float>><<<n_chunks, THREADS, 0, stream>>>(
        (const long long*)table, (const long long*)step, n_tensors, c);
  return (int)cudaGetLastError();
}

int dispatch(int kind, bool bf16, const void* table, const void* step,
             int n_tensors, int n_chunks, Consts c, unsigned flags,
             cudaStream_t s) {
  if (n_tensors < 1 || n_chunks < 1) return -1;
  switch (kind) {
    case 0: return launch<Sgd>(bf16, table, step, n_tensors, n_chunks, c, flags, s);
    case 1: return launch<Adagrad0>(bf16, table, step, n_tensors, n_chunks, c, flags, s);
    case 2: return launch<Adagrad1>(bf16, table, step, n_tensors, n_chunks, c, flags, s);
    case 3: return launch<Adamax>(bf16, table, step, n_tensors, n_chunks, c, flags, s);
    case 4: return launch<Adadelta>(bf16, table, step, n_tensors, n_chunks, c, flags, s);
    case 5: return launch<Rmsprop0>(bf16, table, step, n_tensors, n_chunks, c, flags, s);
    case 6: return launch<Rmsprop1>(bf16, table, step, n_tensors, n_chunks, c, flags, s);
    case 7: return launch<Ftrl0>(bf16, table, step, n_tensors, n_chunks, c, flags, s);
    case 8: return launch<Ftrl1>(bf16, table, step, n_tensors, n_chunks, c, flags, s);
    default: return -1;
  }
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
  const Consts c{W{c0, c0}, W{c1, c1}, W{c2, c2}, W{c3, c3}};
  return dispatch(kind, false, table, step, n_tensors, n_chunks, c, 0u,
                  (cudaStream_t)stream);
}

// The bf16 instances (optim_bf16_kernel): kind as above, table with
// 2 HEAD - 1 entries a tensor, step as above, c0..c3 the constants
// rounded to float32 and h0..h3 the same rounded to bf16, flags as above.
// Returns as pt_optim_multi.
extern "C" int pt_optim_multi_bf16(int kind, const void* table,
                                   const void* step, int n_tensors,
                                   int n_chunks, float c0, float c1,
                                   float c2, float c3, float h0, float h1,
                                   float h2, float h3, int flags,
                                   void* stream) {
  const Consts c{W{c0, h0}, W{c1, h1}, W{c2, h2}, W{c3, h3}};
  return dispatch(kind, true, table, step, n_tensors, n_chunks, c,
                  (unsigned)flags, (cudaStream_t)stream);
}
