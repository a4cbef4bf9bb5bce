// jnp's dtype rules for the bf16 instances of the optimizer kernels
// (momentum.cu, optim_multi.cu).
//
// A value J is a float and whether jnp holds it in bf16.  Every operation
// computes in float32 with IEEE rounding (no contraction into fused
// multiply-adds) and rounds its result to the promoted dtype of its
// operands: bf16 only when both are (R_X in adam.cu's notation), as jnp
// rounds each operation of the reference's update ops.  A Python constant
// of the reference (mu, 1 - rho, eps) is a weak type in jnp: it takes the
// dtype of the array it meets.  W carries it rounded on the host both to
// float32 and to bf16, and `wk` picks the one of the array it meets.
//
// The same functions on plain floats are the float32 instances' IEEE
// operations, so one update functor, templated on its value type, writes
// both instances.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace jnp {

struct J {
  float v;
  bool b;  // bf16
};

// a Python constant rounded to float32 (f) and to bf16 (h)
struct W {
  float f, h;
};

__device__ __forceinline__ float rnd(float x, bool b) {
  return b ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}
__device__ __forceinline__ float ld(const void* p, long long i, bool b) {
  return b ? __bfloat162float(((const __nv_bfloat16*)p)[i])
           : ((const float*)p)[i];
}
__device__ __forceinline__ void st(void* p, long long i, float v, bool b) {
  if (b)
    ((__nv_bfloat16*)p)[i] = __float2bfloat16_rn(v);
  else
    ((float*)p)[i] = v;
}
__device__ __forceinline__ J val(const void* p, long long i, bool b) {
  return J{ld(p, i, b), b};
}

__device__ __forceinline__ float add(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ float sub(float x, float y) {
  return __fsub_rn(x, y);
}
__device__ __forceinline__ float mul(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ float div(float x, float y) {
  return __fdiv_rn(x, y);
}
__device__ __forceinline__ float sqrt_(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ float pow_(float x, float e) { return powf(x, e); }
__device__ __forceinline__ float neg(float x) { return -x; }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
// jnp.maximum: NaN propagates
__device__ __forceinline__ float max_(float x, float y) {
  return (x > y || x != x) ? x : y;
}
// jnp.where(c, x, y)
__device__ __forceinline__ float where_(bool c, float x, float y) {
  return c ? x : y;
}
__device__ __forceinline__ float wk(W c, float) { return c.f; }
__device__ __forceinline__ float value(float x) { return x; }

__device__ __forceinline__ J add(J x, J y) {
  const bool b = x.b && y.b;
  return J{rnd(__fadd_rn(x.v, y.v), b), b};
}
__device__ __forceinline__ J sub(J x, J y) {
  const bool b = x.b && y.b;
  return J{rnd(__fsub_rn(x.v, y.v), b), b};
}
__device__ __forceinline__ J mul(J x, J y) {
  const bool b = x.b && y.b;
  return J{rnd(__fmul_rn(x.v, y.v), b), b};
}
__device__ __forceinline__ J div(J x, J y) {
  const bool b = x.b && y.b;
  return J{rnd(__fdiv_rn(x.v, y.v), b), b};
}
__device__ __forceinline__ J sqrt_(J x) {
  return J{rnd(__fsqrt_rn(x.v), x.b), x.b};
}
// the exponent a weak constant met by x (wk), so of x's dtype
__device__ __forceinline__ J pow_(J x, J e) {
  return J{rnd(powf(x.v, e.v), x.b), x.b};
}
__device__ __forceinline__ J neg(J x) { return J{-x.v, x.b}; }
__device__ __forceinline__ J abs_(J x) { return J{fabsf(x.v), x.b}; }
__device__ __forceinline__ J max_(J x, J y) {
  return J{(x.v > y.v || x.v != x.v) ? x.v : y.v, x.b && y.b};
}
__device__ __forceinline__ J where_(bool c, J x, J y) {
  return J{c ? x.v : y.v, x.b && y.b};
}
__device__ __forceinline__ J wk(W c, J x) { return J{x.b ? c.h : c.f, x.b}; }
__device__ __forceinline__ float value(J x) { return x.v; }

}  // namespace jnp
