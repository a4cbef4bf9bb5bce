"""The kernel generator: fused_elementwise groups as generated CUDA kernels.

Counterpart of paddle_tpu/ops/kernelgen/__init__.py.  On a CUDA tensor,
ops/fused.py hands each fused group to `run_fused`, which runs its plan
(builder.py): random draws, views and transposes, the dedicated kernels
K5 / K6 / K1, `adam_multi`, `momentum_multi`, `optim_multi` (the other
update ops), and one generated kernel per segment.  There is no fallback on the card: a sub-op without a rule, or a
shape a template cannot take, raises `KernelgenUnsupported` naming it,
and a failing nvcc or launch raises.  The port has no `PT_KERNELGEN` switch;
`PT_OPT=0` (no fusion) is the only way to run unfused.

The generated functions of every plan made so far that are not built yet
compile together, in up to 8 nvcc calls run in parallel and one link,
at the first launch that needs one of them (`ensure_built`); the executor's planning pass makes all of a
program's plans before its first launch.  `launches` counts the
launches of each generated function; `build_stats` the builds.

Entry points: `run_fused`, `plan_for`, `clear_plan_cache`,
`unsupported_sub_ops`, `ensure_built`, `generated_source`.
"""
import ctypes
import threading

import torch

from ... import kernels
from ...core.amp import amp_sub_ins, amp_sub_outs
from ...core.dtypes import torch_dtype
from ...core.registry import get_op
from .rules import KERNEL_RULES
from .builder import (SOURCES, KernelgenUnsupported, avals_of, clear_plans,
                      plan_for)

__all__ = ['KERNEL_RULES', 'KernelgenUnsupported', 'run_fused', 'plan_for',
           'clear_plan_cache', 'avals_of', 'unsupported_sub_ops',
           'ensure_built', 'generated_source', 'launches', 'build_stats',
           'plan_of', 'vector_groups']

# launches of each generated function, by name
launches = {}
# builds of generated sources: count, functions, nvcc seconds
build_stats = {'builds': 0, 'functions': 0, 'nvcc_s': 0.0, 'log': ''}

_PRELUDE = r'''// Generated by paddle_tpu_torch/ops/kernelgen from fused_elementwise
// groups (see builder.py): one __global__ function and one extern "C"
// launcher per segment.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float kg_rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// jnp.minimum / jnp.maximum (ops/math.py): NaN propagates, -0 < +0
__device__ __forceinline__ float kg_nanmin(float a, float b) {
  return (a != a || a < b || (a == b && signbit(a))) ? a : b;
}
__device__ __forceinline__ float kg_nanmax(float a, float b) {
  return (a != a || a > b || (a == b && signbit(b))) ? a : b;
}
__device__ __forceinline__ float kg_sign(float a) {
  return (a != a || a == 0.f) ? a : (a > 0.f ? 1.f : -1.f);
}
// F.threshold(a, 0, 0): -0 gives +0, NaN stays NaN
__device__ __forceinline__ float kg_relu(float a) {
  return (a > 0.f || a != a) ? a : 0.f;
}
// one torch operation's float32 result in the output's dtype
template <bool BF>
__device__ __forceinline__ float kg_r(float x) {
  return BF ? kg_rbf(x) : x;
}
// jnp.maximum / jnp.minimum against a constant: NaN propagates, -0 < +0
// (`eq`: an x equal to c, a zero of the other sign, is taken)
__device__ __forceinline__ float kg_jmax(float x, float c, bool eq) {
  return (x != x || x > c || (eq && x == c)) ? x : c;
}
__device__ __forceinline__ float kg_jmin(float x, float c, bool eq) {
  return (x != x || x < c || (eq && x == c)) ? x : c;
}
// ops/math.py _mod and _floordiv (jnp.mod, jnp.floor_divide)
template <bool BF>
__device__ __forceinline__ float kg_mod(float x, float y) {
  const float t = kg_r<BF>(fmodf(x, y));
  return (t != 0.f && ((t < 0.f) != (y < 0.f))) ? kg_r<BF>(__fadd_rn(t, y))
                                                 : t;
}
template <bool BF>
__device__ __forceinline__ float kg_floordiv(float x, float y) {
  const float mod = kg_r<BF>(fmodf(x, y));
  const float div = kg_r<BF>(__fdiv_rn(kg_r<BF>(__fsub_rn(x, mod)), y));
  const bool ind = mod != 0.f && kg_sign(y) != kg_sign(mod);
  const float d = ind ? kg_r<BF>(__fsub_rn(div, 1.f)) : div;
  const float t = truncf(d);
  return fabsf(kg_r<BF>(__fsub_rn(d, t))) >= 0.5f
             ? kg_r<BF>(__fadd_rn(t, kg_sign(d))) : t;
}
__device__ __forceinline__ int kg_imod(int x, int y) {
  if (y == 0) y = 1;
  const int t = x % y;
  return (t != 0 && ((t < 0) != (y < 0))) ? t + y : t;
}
// XLA's integer division: x / 0 is -1 and x % 0 is x
__device__ __forceinline__ int kg_ifloordiv(int x, int y) {
  const int q = y == 0 ? -1 : x / y;
  const int r = y == 0 ? x : x % y;
  const int sx = (x > 0) - (x < 0), sy = (y > 0) - (y < 0);
  return (sx != sy && r != 0) ? q - 1 : q;
}
// jax.nn.softplus: max(x, 0) + log1p(exp(-|x|)), each op rounded
template <bool BF>
__device__ __forceinline__ float kg_softplus(float x) {
  return kg_r<BF>(__fadd_rn(kg_relu(x),
                            kg_r<BF>(log1pf(kg_r<BF>(expf(-fabsf(x)))))));
}

__device__ __forceinline__ float kg_ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float kg_ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ int kg_ld(const int* p, long long i) {
  return p[i];
}
__device__ __forceinline__ bool kg_ld(const bool* p, long long i) {
  return p[i];
}
__device__ __forceinline__ void kg_st(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void kg_st(__nv_bfloat16* p, long long i,
                                      float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void kg_st(int* p, long long i, int v) {
  p[i] = v;
}
__device__ __forceinline__ void kg_st(bool* p, long long i, bool v) {
  p[i] = v;
}

// a broadcast operand's element; F false: nothing for a vector's lanes
// past its group's end
template <bool F, typename M>
__device__ __forceinline__ auto kg_ldb(const M* p, long long i, bool ok)
    -> decltype(kg_ld(p, i)) {
  return F || ok ? kg_ld(p, i) : decltype(kg_ld(p, i))();
}

// 16 bytes of memory as four 32-bit words: PER elements of M, each
// element k converted to and from its register type
template <typename M>
struct kg_mem;
template <>
struct kg_mem<float> {
  static constexpr int PER = 4;
  static __device__ __forceinline__ float get(const unsigned (&w)[4],
                                              int k) {
    return __uint_as_float(w[k]);
  }
  static __device__ __forceinline__ void put(unsigned (&w)[4], int k,
                                             float v) {
    w[k] = __float_as_uint(v);
  }
};
template <>
struct kg_mem<int> {
  static constexpr int PER = 4;
  static __device__ __forceinline__ int get(const unsigned (&w)[4], int k) {
    return (int)w[k];
  }
  static __device__ __forceinline__ void put(unsigned (&w)[4], int k,
                                             int v) {
    w[k] = (unsigned)v;
  }
};
template <>
struct kg_mem<__nv_bfloat16> {
  static constexpr int PER = 8;
  static __device__ __forceinline__ float get(const unsigned (&w)[4],
                                              int k) {
    return __uint_as_float((k & 1 ? w[k >> 1] >> 16 : w[k >> 1]) << 16);
  }
  static __device__ __forceinline__ void put(unsigned (&w)[4], int k,
                                             float v) {
    const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    w[k >> 1] = k & 1 ? (w[k >> 1] & 0xffffu) | (h << 16) : h;
  }
};
template <>
struct kg_mem<bool> {
  static constexpr int PER = 16;
  static __device__ __forceinline__ bool get(const unsigned (&w)[4], int k) {
    return (w[k >> 2] >> (8 * (k & 3))) & 0xffu;
  }
  static __device__ __forceinline__ void put(unsigned (&w)[4], int k,
                                             bool v) {
    const unsigned b = (unsigned)v << (8 * (k & 3));
    w[k >> 2] = (k & 3) ? w[k >> 2] | b : b;
  }
};

// one access of B bytes (4, 8 or 16): its type, and its 32-bit words
template <int B>
struct kg_acc;
template <>
struct kg_acc<16> {
  typedef uint4 T;
  static __device__ __forceinline__ void words(const T& t,
                                               unsigned (&w)[4]) {
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  }
  static __device__ __forceinline__ T make(const unsigned (&w)[4]) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct kg_acc<8> {
  typedef uint2 T;
  static __device__ __forceinline__ void words(const T& t,
                                               unsigned (&w)[4]) {
    w[0] = t.x; w[1] = t.y;
  }
  static __device__ __forceinline__ T make(const unsigned (&w)[4]) {
    return make_uint2(w[0], w[1]);
  }
};
template <>
struct kg_acc<4> {
  typedef unsigned T;
  static __device__ __forceinline__ void words(const T& t,
                                               unsigned (&w)[4]) {
    w[0] = t;
  }
  static __device__ __forceinline__ T make(const unsigned (&w)[4]) {
    return w[0];
  }
};

// V consecutive elements from i.  F: all V in range and the pointer
// 16-byte aligned, one access of V elements (V is 16 bytes of the group's
// widest operand, so a narrower one's access is 4 or 8 bytes, each
// warp-contiguous); otherwise the nv (0..V) in range one at a time.  CS:
// streaming (__ldcs / __stcs)
template <int V, bool CS, bool F, typename M, typename R>
__device__ __forceinline__ void kg_ldv(R (&d)[V], const M* p, long long i,
                                       int nv) {
  constexpr int B = V * (16 / kg_mem<M>::PER);
  typedef typename kg_acc<B>::T T;
  if (F) {
    const T* q = reinterpret_cast<const T*>(p + i);
    const T t = CS ? __ldcs(q) : *q;
    unsigned w[4];
    kg_acc<B>::words(t, w);
#pragma unroll
    for (int k = 0; k < V; ++k) d[k] = kg_mem<M>::get(w, k);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) d[j] = j < nv ? kg_ld(p, i + j) : R();
  }
}
template <int V, bool CS, bool F, typename M, typename R>
__device__ __forceinline__ void kg_stv(M* p, long long i, const R (&v)[V],
                                       int nv) {
  constexpr int B = V * (16 / kg_mem<M>::PER);
  typedef typename kg_acc<B>::T T;
  if (F) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < V; ++k) kg_mem<M>::put(w, k, v[k]);
    T* q = reinterpret_cast<T*>(p + i);
    const T t = kg_acc<B>::make(w);
    if (CS)
      __stcs(q, t);
    else
      *q = t;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < nv) kg_st(p, i + j, v[j]);
  }
}

}  // namespace

'''

_lock = threading.Lock()
_FUNCS = {}            # name -> bound ctypes launcher
_LIBS = []             # loaded libraries (kept alive)
_LAST_PLAN = {}        # id(fused attrs) -> the plan its last run used
# (id(attrs), input shapes and dtypes, amp) -> (attrs, plan): a run finds
# its plan without canonicalizing the sub-program again
_FAST = {}


def clear_plan_cache():
    clear_plans()
    _FAST.clear()


def unsupported_sub_ops(attrs):
    """Sub-op types of one fused_elementwise op with no KERNEL_RULES entry
    (deduped, first-seen order)."""
    out, seen = [], set()
    for sub in attrs.get('sub_ops') or ():
        t = sub['type']
        if t not in KERNEL_RULES and t not in seen:
            seen.add(t)
            out.append(t)
    return out


def generated_source(names=None):
    """The CUDA C++ file of the generated functions `names` (default:
    every one planned so far), in name order."""
    names = sorted(SOURCES if names is None else names)
    return _PRELUDE + '\n'.join(SOURCES[n] for n in names)


def ensure_built():
    """Compile every planned generated function not built yet (one
    build_generated: up to 8 nvcc calls in parallel, one link) and bind
    its launcher."""
    with _lock:
        pending = sorted(n for n in SOURCES if n not in _FUNCS)
        if not pending:
            return
        from ...kernels.build import build_generated
        # up to 8 translation units, compiled in parallel; the split
        # depends on the sources alone, so the library's cache key does
        n = max(1, min(8, len(pending) // 4))
        path, log, seconds = build_generated(
            [generated_source(pending[k::n]) for k in range(n)])
        lib = ctypes.CDLL(path)
        _LIBS.append(lib)
        for n in pending:
            fn = getattr(lib, n + '_launch')
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _FUNCS[n] = fn
        build_stats['builds'] += 1
        build_stats['functions'] += len(pending)
        build_stats['nvcc_s'] += seconds
        build_stats['log'] += log


def _launch(spec, ents):
    """One generated segment on the card: outputs allocated here."""
    dev = ents[0].device if ents else torch.device(
        'cuda', torch.cuda.current_device())
    if spec.name not in _FUNCS:
        ensure_built()
    out_dt = [torch_dtype(dt) for _, dt in spec.esc_aval]
    outs = [torch.empty(shape, dtype=d, device=dev)
            for (shape, _), d in zip(spec.esc_aval, out_dt)]
    for e, (_, dt) in zip(ents, spec.entry_avals):
        if e.device != dev or e.dtype != torch_dtype(dt) or \
                not e.is_contiguous():
            raise ValueError('generated kernel %s takes contiguous %s on %s, '
                             'got %s on %s' % (spec.name, dt, dev, e.dtype,
                                               e.device))
    ptrs = [t.data_ptr() for t in ents] + [o.data_ptr() for o in outs]
    arr = (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)
    mask = (ctypes.c_ulonglong * max(1, (len(spec.layout.groups) + 63) //
                                     64))()
    for gi, g in enumerate(vector_groups(spec, ptrs)):
        if g:
            mask[gi >> 6] |= 1 << (gi & 63)
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            rc = _call(spec, arr, mask, dev)
    else:
        rc = _call(spec, arr, mask, dev)
    kernels.check(rc, spec.name)
    # a replay runs none of this: core/graphs.py credits its capture's
    # counts once a replay
    kernels.launches['kernelgen_segment'] += 1
    launches[spec.name] = launches.get(spec.name, 0) + 1
    return outs


def vector_groups(spec, ptrs):
    """Whether each group of a segment (spec.layout.groups, in order)
    runs its 16-byte vector path: every one of its flat pointers
    (`ptrs`, the launch's inputs then outputs) 16-byte aligned.  A CUDA
    graph (core/graphs.py) fixes the answer at its capture, with the
    addresses."""
    return [all(ptrs[ix] % 16 == 0 for ix in g['ptrs'])
            for g in spec.layout.groups]


def _call(spec, arr, mask, dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _FUNCS[spec.name](ctypes.cast(arr, ctypes.c_void_p),
                             ctypes.cast(mask, ctypes.c_void_p), stream)


class _SegmentFn(torch.autograd.Function):
    """A generated segment under autograd: its backward replays the
    segment's sub-ops with their plain impls and differentiates them."""

    @staticmethod
    def forward(ctx, spec, *ents):
        outs = _launch(spec, ents)
        ctx.spec = spec
        ctx.save_for_backward(*ents)
        fixed = [o for o in outs if not o.is_floating_point()]
        if fixed:
            ctx.mark_non_differentiable(*fixed)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        ents = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            xs = [e.detach().requires_grad_(n) for e, n in zip(ents, need)]
            outs = ctx.spec.replay(xs)
        pairs = [(o, g) for o, g in zip(outs, gouts)
                 if g is not None and o.requires_grad]
        wrt = [x for x, n in zip(xs, need) if n]
        grads = list(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True)) if pairs else [None] * len(wrt)
        return (None,) + tuple(grads.pop(0) if n else None for n in need)


def _run_kernel(spec, mats):
    ents = [mats[e[0]].contiguous() for e in spec.entries]
    if torch.is_grad_enabled() and any(e.requires_grad for e in ents):
        outs = _SegmentFn.apply(spec, *ents)
    else:
        outs = _launch(spec, ents)
    for mid, o in zip(spec.out_mids, outs):
        mats[mid] = o


def _run_adam(st, mats, ctx):
    from ..optimizer_ops import adam_multi
    _, gkey, ins, outs, in_place = st
    cols = {slot: [mats[d[slot]] for d in ins]
            for slot in ('Param', 'Grad', 'Moment1', 'Moment2', 'Beta1Pow',
                         'Beta2Pow', 'LearningRate')}
    # a column that is not in place gets a new tensor each run; a CUDA
    # graph copies it into the scope's tensor at the end of its step
    # (core/graphs.py)
    for slot in ('Param', 'Moment1', 'Moment2', 'Beta1Pow', 'Beta2Pow'):
        cols[slot] = [t if ip else t.clone()
                      for t, ip in zip(cols[slot], in_place)]
    (cols['Param'], cols['Moment1'], cols['Moment2']) = adam_multi(
        cols['Param'], cols['Grad'], cols['Moment1'], cols['Moment2'],
        cols['Beta1Pow'], cols['Beta2Pow'], cols['LearningRate'],
        *gkey, cache=getattr(ctx, 'cache', None),
        recorder=getattr(ctx, 'recorder', None))
    for k, ob in enumerate(outs):
        for oslot, mid in ob.items():
            mats[mid] = cols[oslot[:-3]][k]


def _run_momentum(st, mats, ctx):
    from ..optimizer_ops import momentum_multi
    _, gkey, ins, outs, in_place = st
    cols = {slot: [mats[d[slot]] for d in ins]
            for slot in ('Param', 'Grad', 'Velocity', 'LearningRate')}
    # as in _run_adam: a column that is not in place gets a new tensor
    for slot in ('Param', 'Velocity'):
        cols[slot] = [t if ip else t.clone()
                      for t, ip in zip(cols[slot], in_place)]
    # each the tensor updated in place, or a new one where jnp promotes
    # its dtype
    new = dict(zip(('Param', 'Velocity'), momentum_multi(
        cols['Param'], cols['Grad'], cols['Velocity'], cols['LearningRate'],
        *gkey, cache=getattr(ctx, 'cache', None),
        recorder=getattr(ctx, 'recorder', None))))
    for k, ob in enumerate(outs):
        for oslot, mid in ob.items():
            mats[mid] = new[oslot[:-3]][k]


def _run_optim(st, mats, ctx):
    from ..optimizer_ops import OPTIM_SLOTS, array_slots, optim_multi
    stype, key, ins, outs, in_place = st
    slots = array_slots(stype, key)
    scalar = OPTIM_SLOTS[stype][2]

    def col(slot):
        return [mats[d[slot]] for d in ins]
    # as in _run_adam: a column that is not in place gets a new tensor
    written = {slot: [t if ip else t.clone()
                      for t, ip in zip(col(slot), in_place)]
               for slot in ('Param',) + slots}
    params, arrays = optim_multi(
        stype, written['Param'], col('Grad'), [written[s] for s in slots],
        col(scalar) if scalar else None,
        None if stype == 'adadelta' else col('LearningRate'), key,
        cache=getattr(ctx, 'cache', None),
        recorder=getattr(ctx, 'recorder', None))
    new = dict(zip(slots, arrays), Param=params)
    aliases = OPTIM_SLOTS[stype][1]
    for k, ob in enumerate(outs):
        for oslot, mid in ob.items():
            mats[mid] = new[aliases[oslot]][k]


def plan_of(attrs):
    """The plan the last `run_fused` of this fused op used."""
    return _LAST_PLAN.get(id(attrs))


def run_fused(ctx, xs, attrs, amp):
    """Run one fused group's plan on the card -> its `Out` list."""
    from ..nn import dropout_mask
    key = (id(attrs), tuple((x.shape, x.dtype) for x in xs), amp)
    hit = _FAST.get(key)
    if hit is not None and hit[0] is attrs:
        plan = hit[1]
    else:
        plan = plan_for(attrs, avals_of(xs), amp)
        _FAST[key] = (attrs, plan)
    _LAST_PLAN[id(attrs)] = plan
    device = xs[0].device if xs else ctx.device
    mats = dict(enumerate(xs))
    for st in plan.steps:
        kind = st[0]
        if kind == 'kernel':
            _run_kernel(st[1], mats)
        elif kind == 'draw':
            _, mid, si, x_aval = st
            sub = attrs['sub_ops'][si]
            sctx = ctx.sub_ctx(sub)
            if x_aval is None:      # the whole op is the draw
                mats[mid] = get_op(sub['type'])(sctx, {},
                                                sub['attrs'])['Out']
            else:
                a = sub['attrs']
                mats[mid] = dropout_mask(
                    x_aval[0], torch_dtype(x_aval[1]), device,
                    a.get('dropout_prob', 0.5),
                    sctx.generator(a.get('seed', 0)))
        elif kind == 'glue':
            _, mid, src, perm, shape = st
            x = mats[src]
            mats[mid] = x.reshape(shape) if perm is None else \
                x.permute(*perm).contiguous()
        elif kind == 'dstep':
            _, si, in_mids, out_bind = st
            sub = attrs['sub_ops'][si]
            ins = {}
            for slot, mids in in_mids.items():
                vals = [mats[m] for m in mids]
                ins[slot] = vals if sub['input_is_list'].get(slot) \
                    else vals[0]
            ins = amp_sub_ins(sub['type'], ins, amp)
            outs = get_op(sub['type'])(ctx.sub_ctx(sub), ins,
                                       sub['attrs']) or {}
            outs = amp_sub_outs(sub['type'], sub['attrs'], outs, amp)
            for slot, binds in out_bind.items():
                vals = outs.get(slot)
                vals = vals if isinstance(vals, (list, tuple)) else [vals]
                for mid, v in zip(binds, vals):
                    if mid is not None:
                        mats[mid] = v
        elif kind == 'momentum':
            _run_momentum(st, mats, ctx)
        elif kind == 'adam':
            _run_adam(st, mats, ctx)
        else:
            _run_optim(st, mats, ctx)
    return [mats[m].detach() if stop and mats[m].requires_grad else mats[m]
            for m, stop in zip(plan.finals, plan.final_stop)]
