"""Optimizer update ops and their multi-tensor kernels: `adam`,
`momentum`, `sgd`, `adagrad`, `decayed_adagrad`, `adamax`, `adadelta`,
`rmsprop`, `ftrl`, and `lars_momentum` (no kernel).

Counterpart of paddle_tpu/ops/optimizer_ops.py.  The math is the
reference's (:51-65):

    m1' = b1 m1 + (1 - b1) g          m2' = b2 m2 + (1 - b2) g^2
    lr_t = lr sqrt(1 - b2p) / (1 - b1p)
    p'  = p - lr_t m1' / (sqrt(m2') + eps)        b1p' = b1p b1, b2p' = b2p b2

with jnp's dtypes: each operation rounds to its operands' promoted dtype,
a Python scalar takes the dtype of the array it meets, and the float32
learning rate makes p' float32.  So a bf16 parameter comes out float32,
a bf16 moment stays bf16 only while its gradient is bf16, and the beta
powers keep their dtype.  An output whose dtype is its input's is updated
in place; any other is a new tensor, which the caller binds to the op's
output name (the scope then holds it, as the JAX package's does).

`adam_multi` updates a whole list of parameters, their moments and beta
powers with one call: on CUDA tensors it launches csrc/adam.cu, which
replaces the Adam instance of the TPU's generated fused-segment kernel
(`_compile_segment`): `adam_multi` for all-float32 tensors (in place) and
`adam_multi_bf16` for tensors of which any is bf16 (it computes in
float32 and rounds where jnp rounds); on CPU tensors it runs
`adam_reference`, the per-tensor loop of the op.  LR and the powers are
read on the device, so a step needs no host sync.  The executor hands
each maximal run of consecutive in-place `adam` ops to one `adam_multi`
call (`run_adam_group`); the program still holds one `adam` op per
parameter, as the JAX package's does.

`momentum` is the reference's (:24-34):

    v' = mu v + g        p' = p - lr (g + mu v')  (use_nesterov)
                         p' = p - lr v'           (else)

`momentum_multi` updates lists of parameters and velocities with one
call per dtype combination: on CUDA tensors it launches csrc/momentum.cu,
the momentum instance of the TPU's generated fused-segment kernel
(`_compile_segment` with the `momentum` rule): `momentum_kernel` for
all-float32 tensors, in place, and `momentum_bf16_kernel` for a mix
with a bf16 among them; on CPU tensors it runs `momentum_reference`,
the per-tensor loop of the op.  Its float32 pointer table is cached per
executor as Adam's is, and LR is read on the device.  The executor
hands each maximal run of consecutive in-place `momentum` ops sharing mu
and use_nesterov to one `momentum_multi` call (`run_momentum_group`).

`sgd`, `adagrad`, `decayed_adagrad`, `adamax`, `adadelta`, `rmsprop`
(plain and `centered`) and `ftrl` are the reference's (:19-163), one
rounding an operation in its order (`_optim_one`); a Python constant
such as 1 - rho or l1 + 1e-10 is computed in double and meets an array
in its dtype, as jnp's weak types do.  `optim_reference` is the
per-tensor loop, `optim_multi` (and `<op>_multi`, `<op>_reference` for
each) the entry: on CUDA tensors it launches csrc/optim_multi.cu's
instance for the op and its key (`optim_key`: every attribute the
update reads), float32 (`optim_kernel<Op>`) or with a bf16 among the
tensors (`optim_bf16_kernel<Op>`); on CPU tensors the plain version.
Ftrl at lr_power -0.5 takes square roots; at any other power pow, which
no implementation rounds correctly, so that instance is held to
`ftrl_pow_bound`.  The executor and the kernel generator hand each run of
consecutive in-place ops of one type and key to one call
(`run_optim_group`); an adamax run also holds the `scale` ops that bump
its own ops' Beta1Pow (`adamax_bump`), run after the launch.
`lars_momentum` stays plain torch ops, one op a tensor, its norms
sqrt(sum(square(x))): the reference leaves it to XLA, outside its fused
kernels.

Every update has jnp's dtypes, as Adam's: the float32 learning rate (and
Beta1Pow) meets the arrays at their rank (`_dims`: torch's 0-dim rule
would leave a bf16 array bf16, where jnp promotes it), so a bf16
parameter comes out float32 (adadelta's, which has no rate, stays bf16),
and each state array in the promoted dtype of what it is updated from.
"""
import functools

import numpy as np
import torch

from .. import kernels
from ..core.registry import get_op, register

_IN_PLACE = (('Param', 'ParamOut'), ('Moment1', 'Moment1Out'),
             ('Moment2', 'Moment2Out'), ('Beta1Pow', 'Beta1PowOut'),
             ('Beta2Pow', 'Beta2PowOut'))
# elements per block of the kernels (csrc/adam.cu CHUNK)
_CHUNK = 32768
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _scalar(v, t):
    """A Python scalar as jnp meets it with array `t`: in t's dtype."""
    return torch.tensor(v, dtype=t.dtype, device=t.device)


def _weak(v, t):
    """`_scalar`, but the Python float itself where `t` is float32: torch
    rounds a Python float that meets a float32 tensor to float32, as jnp
    does, and keeps it in float32 where it meets a bf16 one, where jnp
    rounds it to bf16."""
    return v if t.dtype == torch.float32 else _scalar(v, t)


def _adam_one(p, g, m1, m2, b1p, b2p, lr, beta1, beta2, epsilon):
    """The `adam` op's math on one tensor, jnp's dtypes and roundings ->
    (p', m1', m2', b1p', b2p'), new tensors."""
    c = torch.promote_types(m1.dtype, g.dtype)
    m1n = (_scalar(beta1, m1) * m1).to(c) + \
        (_scalar(1 - beta1, g) * g).to(c)
    m2n = (_scalar(beta2, m2) * m2).to(c) + \
        (_scalar(1 - beta2, g) * g.square()).to(c)
    b1p0, b2p0 = b1p.reshape(()), b2p.reshape(())
    lw = torch.promote_types(lr.dtype, b1p.dtype)
    lr_t = (lr.reshape(()).to(lw) * torch.sqrt(1 - b2p0).to(lw)) / \
        (1 - b1p0).to(lw)
    nd = torch.promote_types(lw, c)
    sq = torch.sqrt(m2n)
    upd = (lr_t.to(nd) * m1n.to(nd)) / (sq + _scalar(epsilon, sq)).to(nd)
    pd = torch.promote_types(p.dtype, nd)
    return (p.to(pd) - upd.to(pd), m1n, m2n, b1p * _scalar(beta1, b1p),
            b2p * _scalar(beta2, b2p))


def _into(t, new):
    """`new` written into `t` when their dtypes agree (in place), else
    `new` itself."""
    if new.dtype == t.dtype:
        t.copy_(new)
        return t
    return new


def adam_reference(params, grads, moment1s, moment2s, beta1_pows,
                   beta2_pows, lrs, beta1, beta2, epsilon):
    """Plain version: the `adam` op's math per tensor.  -> (params,
    moment1s, moment2s) after the step: each the input tensor, updated in
    place, or a new tensor where jnp promotes its dtype."""
    outs = ([], [], [])
    for p, g, m1, m2, b1p, b2p, lr in zip(params, grads, moment1s,
                                          moment2s, beta1_pows, beta2_pows,
                                          lrs):
        pn, m1n, m2n, b1n, b2n = _adam_one(p, g, m1, m2, b1p, b2p, lr,
                                           beta1, beta2, epsilon)
        for col, t, new in zip(outs, (p, m1, m2), (pn, m1n, m2n)):
            col.append(_into(t, new))
        b1p.copy_(b1n)
        b2p.copy_(b2n)
    return outs


def _state_host(params, moment1s, moment2s, beta1_pows, beta2_pows):
    """The state table on the host: per tensor 6 entries (param, m1, m2,
    beta1_pow and beta2_pow pointers and the element count), then one
    entry per chunk, (tensor index << 32) | chunk index."""
    state = (params, moment1s, moment2s, beta1_pows, beta2_pows)
    head = np.empty((len(params), 6), np.int64)
    for c, col in enumerate(state):
        head[:, c] = [t.data_ptr() for t in col]
    head[:, 5] = [p.numel() for p in params]
    chunks = [(i << 32) | c for i, p in enumerate(params)
              for c in range((p.numel() + _CHUNK - 1) // _CHUNK)]
    return np.concatenate([head.reshape(-1), np.asarray(chunks, np.int64)])


def _tables(params, grads, moment1s, moment2s, beta1_pows, beta2_pows,
            lrs, cache, recorder):
    """The kernel's two device tables, int64: the state table
    (`_state_host`), whose pointers in-place updates keep, so it is cached
    while they hold, and the step table, per tensor the grad and LR
    pointers, new every step (autograd allocates the grads): it goes up
    from pinned memory without a host sync.

    Inside a CUDA graph entry (core/graphs.py) its `recorder` takes both
    tables: a capture may not copy from pageable memory, and a
    captured copy from a pinned buffer would keep a host address that the
    caching host allocator reuses.  Under the graph the grads sit at
    fixed addresses, so both tables are constant: the entry fills device
    buffers it owns, outside the capture."""
    dev = params[0].device
    step_host = np.asarray([t.data_ptr() for pair in zip(grads, lrs)
                            for t in pair], np.int64)
    if recorder is not None:
        state = _state_host(params, moment1s, moment2s, beta1_pows,
                            beta2_pows)
        n_chunks = state.size - 6 * len(params)
        return recorder.upload(state, dev), recorder.upload(step_host, dev), \
            n_chunks
    key = tuple(t.data_ptr() for col in (params, moment1s, moment2s,
                                         beta1_pows, beta2_pows)
                for t in col) + tuple(p.numel() for p in params)
    hit = cache.get('adam_multi') if cache is not None else None
    if hit is not None and hit[0] == key:
        table, n_chunks = hit[1], hit[2]
    else:
        host = _state_host(params, moment1s, moment2s, beta1_pows,
                           beta2_pows)
        table, n_chunks = torch.from_numpy(host).to(dev), \
            host.size - 6 * len(params)
        if cache is not None:
            cache['adam_multi'] = (key, table, n_chunks)
            cache['adam_multi_tables'] = \
                cache.get('adam_multi_tables', 0) + 1
    step = torch.from_numpy(step_host).pin_memory()
    return table, step.to(dev, non_blocking=True), n_chunks


def _check_state(params, grads, moment1s, moment2s, beta1_pows, beta2_pows,
                 lrs):
    dev = params[0].device
    for p, g, m1, m2 in zip(params, grads, moment1s, moment2s):
        for t in (p, g, m1, m2):
            if t.dtype not in _KERNEL_DTYPES or t.device != dev or \
                    not t.is_contiguous() or t.numel() != p.numel():
                raise ValueError('adam_multi kernels take contiguous float32 '
                                 'or bf16 params, grads and moments of one '
                                 'size on one device')
        if m2.dtype != m1.dtype:
            raise ValueError('adam_multi kernels take both moments in one '
                             'dtype')
    for b1p, b2p, lr in zip(beta1_pows, beta2_pows, lrs):
        for t in (b1p, b2p, lr):
            if t.dtype not in _KERNEL_DTYPES or t.device != dev or \
                    t.numel() != 1:
                raise ValueError('adam_multi kernels take [1] beta powers '
                                 'and learning rates on the device')
        if lr.dtype != torch.float32 or b2p.dtype != b1p.dtype:
            raise ValueError('adam_multi kernels take a float32 learning '
                             'rate and both beta powers in one dtype')


def _launch_adam(params, grads, moment1s, moment2s, beta1_pows, beta2_pows,
                 lrs, beta1, beta2, epsilon, cache, recorder):
    """The all-float32 instance: csrc/adam.cu adam_kernel, in place."""
    dev = params[0].device
    table, step, n_chunks = _tables(params, grads, moment1s, moment2s,
                                    beta1_pows, beta2_pows, lrs, cache,
                                    recorder)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernels.library().pt_adam_multi(
            table.data_ptr(), step.data_ptr(), len(params), n_chunks,
            float(beta1),
            float(beta2), float(1 - beta1), float(1 - beta2), float(epsilon),
            stream)
    kernels.check(rc, 'adam_multi')
    kernels.launches['adam_multi'] += 1
    return list(params), list(moment1s), list(moment2s)


def _launch_adam_bf16(params, grads, moment1s, moment2s, beta1_pows,
                      beta2_pows, lrs, beta1, beta2, epsilon, recorder):
    """The instance for tensors of one dtype combination with a bf16 among
    them: csrc/adam.cu adam_bf16_kernel.  A param comes out float32 and
    the moments in promote(moment, grad) dtype, in new tensors where that
    is not their dtype."""
    dev = params[0].device
    bf = torch.bfloat16
    c = torch.promote_types(moment1s[0].dtype, grads[0].dtype)
    outs = ([p if p.dtype == torch.float32 else
             torch.empty(p.shape, dtype=torch.float32, device=dev)
             for p in params],
            [m if m.dtype == c else torch.empty(m.shape, dtype=c, device=dev)
             for m in moment1s],
            [m if m.dtype == c else torch.empty(m.shape, dtype=c, device=dev)
             for m in moment2s])
    head = np.empty((len(params), 9), np.int64)
    for col, ts in enumerate((params, moment1s, moment2s, beta1_pows,
                              beta2_pows)):
        head[:, col] = [t.data_ptr() for t in ts]
    head[:, 5] = [p.numel() for p in params]
    for col, ts in zip((6, 7, 8), outs):
        head[:, col] = [t.data_ptr() for t in ts]
    chunks = [(i << 32) | k for i, p in enumerate(params)
              for k in range((p.numel() + _CHUNK - 1) // _CHUNK)]
    host = np.concatenate([head.reshape(-1), np.asarray(chunks, np.int64)])
    step_host = np.asarray([t.data_ptr() for pair in zip(grads, lrs)
                            for t in pair], np.int64)
    if recorder is not None:
        table, step = recorder.upload(host, dev), \
            recorder.upload(step_host, dev)
    else:
        table = torch.from_numpy(host).to(dev)
        step = torch.from_numpy(step_host).to(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernels.library().pt_adam_multi_bf16(
            table.data_ptr(), step.data_ptr(), len(params), len(chunks),
            float(beta1), float(beta2), float(1 - beta1), float(1 - beta2),
            float(epsilon), int(params[0].dtype == bf),
            int(grads[0].dtype == bf), int(moment1s[0].dtype == bf),
            int(beta1_pows[0].dtype == bf), stream)
    kernels.check(rc, 'adam_multi_bf16')
    kernels.launches['adam_multi_bf16'] += 1
    return outs


def _launch(params, grads, moment1s, moment2s, beta1_pows, beta2_pows, lrs,
            beta1, beta2, epsilon, cache, recorder):
    """One launch per dtype combination: the float32 instance for the
    all-float32 tensors, the bf16 instance for each other combination."""
    _check_state(params, grads, moment1s, moment2s, beta1_pows, beta2_pows,
                 lrs)
    cols = (params, grads, moment1s, moment2s, beta1_pows, beta2_pows, lrs)
    groups = {}
    for i in range(len(params)):
        key = (params[i].dtype, grads[i].dtype, moment1s[i].dtype,
               beta1_pows[i].dtype)
        groups.setdefault(key, []).append(i)
    outs = ([None] * len(params), [None] * len(params), [None] * len(params))
    for key, idx in groups.items():
        sub = [[col[i] for i in idx] for col in cols]
        if all(d == torch.float32 for d in key):
            got = _launch_adam(*sub, beta1, beta2, epsilon, cache, recorder)
        else:
            got = _launch_adam_bf16(*sub, beta1, beta2, epsilon, recorder)
        for out, g in zip(outs, got):
            for i, t in zip(idx, g):
                out[i] = t
    return outs


def adam_multi(params, grads, moment1s, moment2s, beta1_pows, beta2_pows,
               lrs, beta1, beta2, epsilon, cache=None, recorder=None):
    """Adam over lists of tensors.  -> (params, moment1s, moment2s) after
    the step: each the input tensor, updated in place, or a new tensor
    where jnp promotes its dtype (the beta powers are always updated in
    place).  `cache` (a dict kept across steps) holds the float32
    kernel's state table; `recorder`, a CUDA graph entry's
    (core/graphs.py), makes the host uploads."""
    if not params:
        return [], [], []
    lists = (grads, moment1s, moment2s, beta1_pows, beta2_pows, lrs)
    if any(len(x) != len(params) for x in lists):
        raise ValueError('adam_multi: the tensor lists differ in length')
    dev = params[0].device
    if dev.type == 'cuda':
        return _launch(params, grads, moment1s, moment2s, beta1_pows,
                       beta2_pows, lrs, beta1, beta2, epsilon, cache,
                       recorder)
    if dev.type in ('cpu', 'meta'):
        return adam_reference(params, grads, moment1s, moment2s, beta1_pows,
                              beta2_pows, lrs, beta1, beta2, epsilon)
    raise RuntimeError('adam_multi: no kernel for device %s' % dev)


def _attrs(attrs):
    return (attrs.get('beta1', 0.9), attrs.get('beta2', 0.999),
            attrs.get('epsilon', 1e-8))


def adam_group_key(op):
    """(beta1, beta2, epsilon) of an `adam` op whose outputs are its inputs
    (the optimizer's in-place form), else None."""
    if op.type != 'adam' or any(op.input(i) != op.output(o)
                                for i, o in _IN_PLACE):
        return None
    return _attrs(op.attrs)


def run_adam_group(ops, env, ectx):
    """One `adam_multi` call for consecutive in-place adam ops sharing
    beta1/beta2/epsilon (adam_group_key)."""
    cols = [[env[op.input(slot)[0]] for op in ops] for slot in (
        'Param', 'Grad', 'Moment1', 'Moment2', 'Beta1Pow', 'Beta2Pow',
        'LearningRate')]
    outs = adam_multi(*cols, *_attrs(ops[0].attrs), cache=ectx.cache,
                      recorder=ectx.recorder)
    for slot, col in zip(('ParamOut', 'Moment1Out', 'Moment2Out'), outs):
        for op, t in zip(ops, col):
            env[op.output(slot)[0]] = t


@register('adam')
def adam(ctx, ins, attrs):
    """One op, functional: the update runs on copies of its state."""
    p, m1, m2, b1p, b2p = (ins[s].clone() for s in (
        'Param', 'Moment1', 'Moment2', 'Beta1Pow', 'Beta2Pow'))
    (p,), (m1,), (m2,) = adam_multi(
        [p], [ins['Grad']], [m1], [m2], [b1p], [b2p], [ins['LearningRate']],
        *_attrs(attrs), recorder=getattr(ctx, 'recorder', None))
    return {'ParamOut': p, 'Moment1Out': m1, 'Moment2Out': m2,
            'Beta1PowOut': b1p, 'Beta2PowOut': b2p}


# ---------------------------------------------------------------- momentum

# elements per block of the kernel (csrc/momentum.cu CHUNK)
_MOMENTUM_CHUNK = 4096


def _dims(lr, p):
    """A [1] learning rate (or power) shaped to broadcast against `p` with
    as many dimensions: jnp promotes a float32 array that meets a bf16 one
    whatever its rank, torch only one of at least the other's rank (a
    0-dim float32 tensor leaves a bf16 tensor bf16)."""
    return lr.reshape((1,) * p.dim())


def _momentum_one(p, g, v, lr, mu, nesterov):
    """The `momentum` op's math on one tensor, jnp's dtypes and roundings
    (each operation in its operands' promoted dtype, `mu` first in the
    dtype of the array it meets) -> (p', v'), new tensors."""
    vn = _weak(mu, v) * v + g
    lr = _dims(lr, p)
    if nesterov:
        return p - lr * (g + _weak(mu, vn) * vn), vn
    return p - lr * vn, vn


def momentum_reference(params, grads, velocities, lrs, mu, nesterov):
    """Plain version: the `momentum` op's math per tensor.  -> (params,
    velocities) after the step: each the input tensor, updated in place,
    or a new tensor where jnp promotes its dtype (a bf16 param comes out
    float32: the learning rate is float32)."""
    outs = ([], [])
    for p, g, v, lr in zip(params, grads, velocities, lrs):
        pn, vn = _momentum_one(p, g, v, lr, mu, nesterov)
        outs[0].append(_into(p, pn))
        outs[1].append(_into(v, vn))
    return outs


@functools.lru_cache(maxsize=None)
def _momentum_dtypes(dts, nesterov):
    """(param out, velocity out) dtypes of the update of (param, grad,
    velocity, lr) dtypes `dts`: the plain version on meta tensors."""
    p, g, v, lr = (torch.empty((1,), dtype=d, device='meta') for d in dts)
    return tuple(t.dtype for t in _momentum_one(p, g, v, lr, 0.9, nesterov))


def _check_momentum(params, grads, velocities, lrs):
    dev = params[0].device
    for p, g, v, lr in zip(params, grads, velocities, lrs):
        for t in (p, g, v):
            if t.dtype not in _KERNEL_DTYPES or t.device != dev or \
                    not t.is_contiguous() or t.numel() != p.numel():
                raise ValueError('momentum_multi kernels take contiguous '
                                 'float32 or bf16 params, grads and '
                                 'velocities of one size on one device, '
                                 'got %s, %s and %s'
                                 % (p.dtype, g.dtype, v.dtype))
        if lr.dtype != torch.float32 or lr.device != dev or lr.numel() != 1:
            raise ValueError('momentum_multi kernels take a [1] float32 '
                             'learning rate on the device, got %s'
                             % lr.dtype)


def _momentum_tables(params, grads, velocities, lrs, cache, recorder):
    """The kernel's two int64 device tables, as `_tables` makes Adam's:
    the state table (per tensor the param and velocity pointers and the
    element count, then one entry per chunk, (tensor index << 32) | chunk
    index), cached while its pointers hold, and the step table (per
    tensor the grad and LR pointers), uploaded each step from pinned
    memory; inside a CUDA graph entry both go through its `recorder`."""
    dev = params[0].device
    step_host = np.asarray([t.data_ptr() for pair in zip(grads, lrs)
                            for t in pair], np.int64)

    def state_host():
        head = np.empty((len(params), 3), np.int64)
        head[:, 0] = [p.data_ptr() for p in params]
        head[:, 1] = [v.data_ptr() for v in velocities]
        head[:, 2] = [p.numel() for p in params]
        chunks = [(i << 32) | c for i, p in enumerate(params)
                  for c in range((p.numel() + _MOMENTUM_CHUNK - 1) //
                                 _MOMENTUM_CHUNK)]
        return np.concatenate([head.reshape(-1),
                               np.asarray(chunks, np.int64)])
    if recorder is not None:
        host = state_host()
        return recorder.upload(host, dev), recorder.upload(step_host, dev), \
            host.size - 3 * len(params)
    key = tuple((t.data_ptr(), t.dtype) for col in (params, velocities)
                for t in col) + tuple(p.numel() for p in params)
    hit = cache.get('momentum_multi') if cache is not None else None
    if hit is not None and hit[0] == key:
        table, n_chunks = hit[1], hit[2]
    else:
        host = state_host()
        table, n_chunks = torch.from_numpy(host).to(dev), \
            host.size - 3 * len(params)
        if cache is not None:
            cache['momentum_multi'] = (key, table, n_chunks)
            cache['momentum_multi_tables'] = \
                cache.get('momentum_multi_tables', 0) + 1
    step = torch.from_numpy(step_host).pin_memory()
    return table, step.to(dev, non_blocking=True), n_chunks


def _launch_momentum(params, grads, velocities, lrs, mu, nesterov, cache,
                     recorder):
    """The all-float32 instance: csrc/momentum.cu momentum_kernel, in
    place."""
    dev = params[0].device
    table, step, n_chunks = _momentum_tables(params, grads, velocities, lrs,
                                             cache, recorder)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernels.library().pt_momentum_multi(
            table.data_ptr(), step.data_ptr(), len(params), n_chunks,
            float(mu), int(bool(nesterov)), stream)
    kernels.check(rc, 'momentum_multi')
    kernels.launches['momentum_multi'] += 1
    return list(params), list(velocities)


def _upload(host, dev, recorder):
    """An int64 table to the device: through a CUDA graph entry's
    `recorder` inside one, else a copy."""
    if recorder is not None:
        return recorder.upload(host, dev)
    return torch.from_numpy(host).to(dev)


def _bf16_const(c):
    """A Python constant as jnp meets a bf16 array: rounded to bf16 (as
    `_scalar` rounds it), as a float."""
    return float(torch.tensor(c, dtype=torch.bfloat16))


def _momentum_bf16_tables(params, grads, velocities, lrs, nesterov,
                          recorder):
    """The bf16 instance's outputs and tables -> (table, step, n_chunks,
    (params out, velocities out), flags): the outputs in the dtypes the
    plain version gives them (`_momentum_dtypes`: the param float32, the
    velocity promote(v, g)), new tensors where that is not their input's
    dtype; the state table per tensor p, v, the element count and the
    out pointers of p and v, then the chunks; the step table as
    `_momentum_tables`'."""
    dev = params[0].device
    bf = torch.bfloat16
    p_dt, v_dt = _momentum_dtypes((params[0].dtype, grads[0].dtype,
                                   velocities[0].dtype, torch.float32),
                                  bool(nesterov))
    outs = ([p if p.dtype == p_dt else
             torch.empty(p.shape, dtype=p_dt, device=dev) for p in params],
            [v if v.dtype == v_dt else
             torch.empty(v.shape, dtype=v_dt, device=dev)
             for v in velocities])
    head = np.empty((len(params), 5), np.int64)
    head[:, 0] = [p.data_ptr() for p in params]
    head[:, 1] = [v.data_ptr() for v in velocities]
    head[:, 2] = [p.numel() for p in params]
    head[:, 3] = [p.data_ptr() for p in outs[0]]
    head[:, 4] = [v.data_ptr() for v in outs[1]]
    chunks = [(i << 32) | c for i, p in enumerate(params)
              for c in range((p.numel() + _MOMENTUM_CHUNK - 1) //
                             _MOMENTUM_CHUNK)]
    host = np.concatenate([head.reshape(-1), np.asarray(chunks, np.int64)])
    step_host = np.asarray([t.data_ptr() for pair in zip(grads, lrs)
                            for t in pair], np.int64)
    flags = sum(b << k for k, b in enumerate((
        params[0].dtype == bf, grads[0].dtype == bf,
        velocities[0].dtype == bf, p_dt == bf, v_dt == bf)))
    return _upload(host, dev, recorder), _upload(step_host, dev, recorder), \
        len(chunks), outs, flags


def _launch_momentum_bf16(params, grads, velocities, lrs, mu, nesterov,
                          recorder):
    """The instance for one dtype combination with a bf16 among the
    params, grads and velocities: csrc/momentum.cu momentum_bf16_kernel,
    into the outputs of `_momentum_bf16_tables`."""
    dev = params[0].device
    table, step, n_chunks, outs, flags = _momentum_bf16_tables(
        params, grads, velocities, lrs, nesterov, recorder)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernels.library().pt_momentum_multi_bf16(
            table.data_ptr(), step.data_ptr(), len(params), n_chunks,
            float(mu), _bf16_const(mu), int(bool(nesterov)), flags, stream)
    kernels.check(rc, 'momentum_multi_bf16')
    kernels.launches['momentum_multi_bf16'] += 1
    return outs


def _by_dtypes(n, *cols):
    """Tensor indices grouped by the dtypes of `cols` (lists of n tensors,
    or None) at each index: {dtypes: [indices]}, in first-seen order."""
    groups = {}
    for i in range(n):
        groups.setdefault(tuple(c[i].dtype for c in cols if c is not None),
                          []).append(i)
    return groups


def momentum_multi(params, grads, velocities, lrs, mu, nesterov,
                   cache=None, recorder=None):
    """Momentum over lists of tensors.  -> (params, velocities) after the
    step: each the input tensor, updated in place, or a new tensor where
    jnp promotes its dtype.  On CUDA tensors one launch per dtype
    combination: csrc/momentum.cu's float32 instance for the all-float32
    tensors, its bf16 instance for each other combination; on CPU tensors
    `momentum_reference`.  `cache` (a dict kept across steps) holds the
    float32 kernel's state table; `recorder`, a CUDA graph entry's
    (core/graphs.py), makes the host uploads."""
    if not params:
        return [], []
    if any(len(x) != len(params) for x in (grads, velocities, lrs)):
        raise ValueError('momentum_multi: the tensor lists differ in length')
    dev = params[0].device
    if dev.type in ('cpu', 'meta'):
        return momentum_reference(params, grads, velocities, lrs, mu,
                                  nesterov)
    if dev.type != 'cuda':
        raise RuntimeError('momentum_multi: no kernel for device %s' % dev)
    _check_momentum(params, grads, velocities, lrs)
    outs = ([None] * len(params), [None] * len(params))
    for dts, idx in _by_dtypes(len(params), params, grads,
                               velocities).items():
        sub = [[col[i] for i in idx] for col in (params, grads, velocities,
                                                 lrs)]
        if all(d == torch.float32 for d in dts):
            got = _launch_momentum(*sub, mu, nesterov, cache, recorder)
        else:
            got = _launch_momentum_bf16(*sub, mu, nesterov, recorder)
        for out, col in zip(outs, got):
            for i, t in zip(idx, col):
                out[i] = t
    return outs


def _momentum_attrs(attrs):
    return attrs.get('mu', 0.9), bool(attrs.get('use_nesterov', False))


def momentum_group_key(op):
    """(mu, use_nesterov) of a `momentum` op whose outputs are its inputs
    (the optimizer's in-place form), else None."""
    if op.type != 'momentum' or op.input('Param') != op.output('ParamOut') \
            or op.input('Velocity') != op.output('VelocityOut'):
        return None
    return _momentum_attrs(op.attrs)


def run_momentum_group(ops, env, ectx):
    """One `momentum_multi` call for consecutive in-place momentum ops
    sharing mu and use_nesterov (momentum_group_key); a param or velocity
    whose dtype jnp promotes is bound anew under its name."""
    cols = [[env[op.input(slot)[0]] for op in ops] for slot in (
        'Param', 'Grad', 'Velocity', 'LearningRate')]
    outs = momentum_multi(*cols, *_momentum_attrs(ops[0].attrs),
                          cache=ectx.cache, recorder=ectx.recorder)
    for slot, col in zip(('ParamOut', 'VelocityOut'), outs):
        for op, t in zip(ops, col):
            env[op.output(slot)[0]] = t


@register('momentum')
def momentum(ctx, ins, attrs):
    """One op, functional: the update runs on copies of its state."""
    (p,), (v,) = momentum_multi(
        [ins['Param'].clone()], [ins['Grad']], [ins['Velocity'].clone()],
        [ins['LearningRate']], *_momentum_attrs(attrs),
        recorder=getattr(ctx, 'recorder', None))
    return {'ParamOut': p, 'VelocityOut': v}


# ------------------------------------- the other in-place update ops

# elements per block of the kernel (csrc/optim_multi.cu CHUNK)
_OPTIM_CHUNK = 4096
# per tensor in the state table: param, three state arrays, the element
# count (csrc/optim_multi.cu HEAD)
_OPTIM_HEAD = 5
# op type -> (the state slots it updates in place, {output slot: the input
# slot it updates}, the [1] input it only reads); rmsprop's `MeanGrad`
# only when `centered` (array_slots)
OPTIM_SLOTS = {
    'sgd': ((), {'ParamOut': 'Param'}, None),
    'adagrad': (('Moment',), {'ParamOut': 'Param', 'MomentOut': 'Moment'},
                None),
    'decayed_adagrad': (('Moment',), {'ParamOut': 'Param',
                                      'MomentOut': 'Moment'}, None),
    'adamax': (('Moment', 'InfNorm'),
               {'ParamOut': 'Param', 'MomentOut': 'Moment',
                'InfNormOut': 'InfNorm'}, 'Beta1Pow'),
    'adadelta': (('AvgSquaredGrad', 'AvgSquaredUpdate'),
                 {'ParamOut': 'Param', 'AvgSquaredGradOut': 'AvgSquaredGrad',
                  'AvgSquaredUpdateOut': 'AvgSquaredUpdate'}, None),
    'rmsprop': (('MeanSquare', 'Moment', 'MeanGrad'),
                {'ParamOut': 'Param', 'MeanSquareOut': 'MeanSquare',
                 'MomentOut': 'Moment', 'MeanGradOut': 'MeanGrad'}, None),
    'ftrl': (('SquaredAccumulator', 'LinearAccumulator'),
             {'ParamOut': 'Param', 'SquaredAccumOut': 'SquaredAccumulator',
              'LinearAccumOut': 'LinearAccumulator'}, None),
}
# the kernel's instances (csrc/optim_multi.cu Kind): the launch counter of
# each is its name
_KINDS = ('sgd', 'adagrad', 'decayed_adagrad', 'adamax', 'adadelta',
          'rmsprop', 'rmsprop_centered', 'ftrl', 'ftrl_pow')


# op type -> the attributes its update reads, with the reference's defaults
_ATTRS = {
    'sgd': (),
    'adagrad': (('epsilon', 1e-6),),
    'decayed_adagrad': (('decay', 0.95), ('epsilon', 1e-6)),
    'adamax': (('beta1', 0.9), ('beta2', 0.999), ('epsilon', 1e-8)),
    'adadelta': (('rho', 0.95), ('epsilon', 1e-6)),
    'rmsprop': (('decay', 0.95), ('epsilon', 1e-6), ('momentum', 0.0),
                ('centered', False)),
    'ftrl': (('l1', 0.0), ('l2', 0.0), ('lr_power', -0.5)),
}


def optim_key(op_type, attrs):
    """The attributes the `op_type` update reads (_ATTRS), as one tuple:
    what a run of such ops shares."""
    return tuple(attrs.get(k, d) for k, d in _ATTRS[op_type])


def array_slots(op_type, key):
    slots = OPTIM_SLOTS[op_type][0]
    if op_type == 'rmsprop' and not key[3]:
        return slots[:2]
    return slots


def _kind(op_type, key):
    if op_type == 'rmsprop' and key[3]:
        return 'rmsprop_centered'
    if op_type == 'ftrl' and key[2] != -0.5:
        return 'ftrl_pow'
    return op_type


def _optim_one(op_type, key, p, g, arrays, scalar, lr):
    """The `op_type` op's math on one tensor, jnp's dtypes and roundings
    in the reference's order (paddle_tpu/ops/optimizer_ops.py): each
    operation in its operands' promoted dtype, the float32 learning rate
    and Beta1Pow as arrays of p's rank (`_dims`); a Python constant, such
    as 1 - rho, computed in double and met as jnp's weak types meet an
    array, in its dtype (`_weak`).  -> (p', arrays'), new tensors."""
    w = _weak
    lr = _dims(lr, p) if lr is not None else None
    if op_type == 'sgd':
        return p - lr * g, ()
    if op_type in ('adagrad', 'decayed_adagrad'):
        m, = arrays
        gg = g * g
        if op_type == 'adagrad':
            mn = m + gg
        else:
            mn = w(key[0], m) * m + w(1 - key[0], gg) * gg
        sq = torch.sqrt(mn)
        return p - lr * g / (sq + w(key[-1], sq)), (mn,)
    if op_type == 'adamax':
        b1, b2, eps = key
        m, u = arrays
        mn = w(b1, m) * m + w(1 - b1, g) * g
        un = torch.maximum(w(b2, u) * u, g.abs())
        bp = _dims(scalar, p)
        return p - (lr / (1 - bp)) * mn / (un + w(eps, un)), (mn, un)
    if op_type == 'adadelta':
        rho, eps = key
        ag, au = arrays
        gg = g * g
        gn = w(rho, ag) * ag + w(1 - rho, gg) * gg
        upd = -torch.sqrt((au + w(eps, au)) / (gn + w(eps, gn))) * g
        uu = upd * upd
        return p + upd, (gn, w(rho, au) * au + w(1 - rho, uu) * uu)
    if op_type == 'rmsprop':
        rho, eps, mu, centered = key
        ms, mom = arrays[:2]
        gg = g * g
        msn = w(rho, ms) * ms + w(1 - rho, gg) * gg
        den = msn
        if centered:
            mg = arrays[2]
            mgn = w(rho, mg) * mg + w(1 - rho, g) * g
            den = msn - mgn * mgn
        momn = w(mu, mom) * mom + lr * g / torch.sqrt(den + w(eps, den))
        return p - momn, (msn, momn, mgn) if centered else (msn, momn)
    if op_type == 'ftrl':
        l1, l2, power = key[0] + 1e-10, key[1] + 1e-10, key[2]
        sq, lin = arrays
        nsq = sq + g * g
        if power == -0.5:
            a, b = torch.sqrt(nsq), torch.sqrt(sq)
        else:
            a, b = torch.pow(nsq, w(-power, nsq)), torch.pow(sq, w(-power, sq))
        sigma = (a - b) / lr
        nlin = lin + g - sigma * p
        al = a / lr
        denom = w(l2, al) + al
        s = torch.sign(nlin)
        pn = torch.where(nlin.abs() > w(l1, nlin),
                         (w(l1, s) * s - nlin) / denom, torch.zeros_like(p))
        return pn, (nsq, nlin)
    raise KeyError(op_type)


# ulps a float32 pow of any implementation the port is held against may be
# off the exact value: CUDA's powf, PyTorch's CPU pow (7.3 ulps measured at
# exponent 0.6) and XLA's CPU pow (0.5 ulps)
POW_ULPS = 16


def ftrl_pow_bound(p, g, sq, lin, lr, key):
    """The bound the ftrl instance with lr_power != -0.5 is held to: per
    element, (|dp'|, |dz'|) that two implementations may differ by when
    each computes the `ftrl` op from the same inputs with a pow within
    POW_ULPS ulps of float32 (the squared accumulator has no pow: it
    agrees bit for bit).  With u = 2^-24, K = POW_ULPS, a = n'^e, b = n^e,
    sigma = (a - b) / lr, den = l2 + a / lr and p' the update, each pow
    differs by 4 K u |.| between the two, each rounding by 2 u |.|, so
      |d sigma| <= Es = ((4 K + 6) u + 3 r) (|a| + |b|) / lr
      |dz'|    <= Ez = |p| Es + 4 u (|z| + |g| + |sigma p|)
      |d den|  <= Ed = ((4 K + 2) u + r) |a| / lr + 2 u |den|
      |dp'|    <= (Ez + |p'| Ed) / den + 4 u |p'|
    where r = 0, or 2^-7 when the squared accumulator and the grad are
    bf16: a and b, their difference too, are then rounded to bf16, and a
    pow that differs in its last float32 bits may round to a neighbouring
    bf16 value (z' and p' are float32: the learning rate is).  A branch
    that flips, |z'| within Ez of l1, moves p' by at most Ez / den; both
    doubled.  Computed in float64 from the inputs."""
    bf = torch.promote_types(sq.dtype, g.dtype) == torch.bfloat16
    f = [t.detach().double() for t in (p, g, sq, lin)]
    p, g, sq, lin = f
    lr = float(lr.reshape(()))
    l1, l2, e = (float(np.float32(v)) for v in _optim_consts('ftrl', key)[:3])
    if bf:
        e = _bf16_const(-key[2])
    u, k, r = 2.0 ** -24, POW_ULPS, 2.0 ** -7 if bf else 0.0
    nsq = sq + g * g
    a, b = nsq ** e, sq ** e
    sigma = (a - b) / lr
    z = lin + g - sigma * p
    den = l2 + a / lr
    pn = torch.where(z.abs() > l1, (l1 * torch.sign(z) - z) / den,
                     torch.zeros_like(z))
    es = ((4 * k + 6) * u + 3 * r) * (a.abs() + b.abs()) / lr
    ez = p.abs() * es + 4 * u * (lin.abs() + g.abs() + (sigma * p).abs())
    ed = ((4 * k + 2) * u + r) * a.abs() / lr + 2 * u * den.abs()
    ep = (ez + pn.abs() * ed) / den.abs() + 4 * u * pn.abs()
    return 2 * ep, 2 * ez


def optim_reference(op_type, params, grads, arrays, scalars, lrs, key):
    """Plain version: the `op_type` op's math per tensor.  `arrays`: one
    list of tensors a slot of array_slots(op_type, key); `scalars`:
    adamax's Beta1Pow list (read only), else None; `lrs`: None for
    adadelta, which has none.  -> (params, arrays) after the step: each
    the input tensor, updated in place, or a new tensor where jnp promotes
    its dtype."""
    outs = ([], [[] for _ in arrays])
    for i, (p, g) in enumerate(zip(params, grads)):
        pn, new = _optim_one(op_type, key, p, g, [col[i] for col in arrays],
                             scalars[i] if scalars is not None else None,
                             lrs[i] if lrs is not None else None)
        outs[0].append(_into(p, pn))
        for out, col, t in zip(outs[1], arrays, new):
            out.append(_into(col[i], t))
    return outs


def _optim_consts(op_type, key, dtype=torch.float32):
    """The kernel's constants c0..c3, each computed on the host in double,
    as the reference's Python scalars are, and rounded to `dtype`, as
    jnp's weak types round them where they meet an array of that dtype
    (csrc/optim_multi.cu reads them in this order; its bf16 instance
    takes both roundings and picks by the dtype of the array each
    meets)."""
    if op_type == 'sgd':
        c = []
    elif op_type == 'adagrad':
        c = [key[0]]
    elif op_type == 'decayed_adagrad':
        c = [key[0], 1 - key[0], key[1]]
    elif op_type == 'adamax':
        c = [key[0], 1 - key[0], key[1], key[2]]
    elif op_type == 'adadelta':
        c = [key[0], 1 - key[0], key[1]]
    elif op_type == 'rmsprop':
        c = [key[0], 1 - key[0], key[1], key[2]]
    else:
        c = [key[0] + 1e-10, key[1] + 1e-10, -key[2]]
    rnd = _bf16_const if dtype == torch.bfloat16 else \
        (lambda v: float(np.float32(v)))
    return [rnd(v) for v in c] + [0.0] * (4 - len(c))


@functools.lru_cache(maxsize=None)
def _optim_dtypes(op_type, key, dts):
    """(param out, state outs...) dtypes of the `op_type` update of
    (param, grad, state arrays..., scalar or None, lr or None) dtypes
    `dts`: the plain version on meta tensors."""
    def meta(d):
        return None if d is None else \
            torch.empty((1,), dtype=d, device='meta')
    p, g, *rest = (meta(d) for d in dts)
    arrays, scalar, lr = rest[:-2], rest[-2], rest[-1]
    pn, new = _optim_one(op_type, key, p, g, arrays, scalar, lr)
    return (pn.dtype,) + tuple(t.dtype for t in new)


def _check_optim(op_type, params, grads, arrays, scalars, lrs):
    dev = params[0].device
    for i, p in enumerate(params):
        ts = [p, grads[i]] + [col[i] for col in arrays]
        for t in ts:
            if t.dtype not in _KERNEL_DTYPES or t.device != dev or \
                    not t.is_contiguous() or t.numel() != p.numel():
                raise ValueError('%s_multi kernels take contiguous float32 '
                                 'or bf16 params, grads and state of one '
                                 'size on one device, got %s'
                                 % (op_type, [str(t.dtype) for t in ts]))
        for col, dts in ((scalars, _KERNEL_DTYPES), (lrs, (torch.float32,))):
            if col is not None and (col[i].dtype not in dts or
                                    col[i].device != dev or
                                    col[i].numel() != 1):
                raise ValueError('%s_multi kernels take [1] float32 '
                                 'learning rates and [1] float32 or bf16 '
                                 'powers on the device, got %s'
                                 % (op_type, col[i].dtype))


def _optim_tables(kind, params, grads, arrays, scalars, lrs, cache,
                  recorder):
    """The kernel's two int64 device tables, as `_momentum_tables` makes
    them: the state table (per tensor _OPTIM_HEAD entries: the param's
    and up to three state arrays' pointers, 0 where the instance has
    none, and the element count; then one entry per chunk, (tensor index
    << 32) | chunk index), cached while its pointers hold, and the step
    table (per tensor the grad, LR and scalar input's pointers, 0 where
    there is none: adamax's Beta1Pow is bumped into a new tensor each step
    on the fused path), uploaded each step from pinned memory; inside a
    CUDA graph entry both go through its `recorder`."""
    dev = params[0].device
    n = len(params)
    step_host = np.zeros((n, 3), np.int64)
    for c, col in enumerate((grads, lrs, scalars)):
        if col is not None:
            step_host[:, c] = [t.data_ptr() for t in col]
    step_host = step_host.reshape(-1)
    cols = [params] + list(arrays) + [None] * (3 - len(arrays))

    def state_host():
        head = np.zeros((n, _OPTIM_HEAD), np.int64)
        for c, col in enumerate(cols):
            if col is not None:
                head[:, c] = [t.data_ptr() for t in col]
        head[:, _OPTIM_HEAD - 1] = [p.numel() for p in params]
        chunks = [(i << 32) | c for i, p in enumerate(params)
                  for c in range((p.numel() + _OPTIM_CHUNK - 1) //
                                 _OPTIM_CHUNK)]
        return np.concatenate([head.reshape(-1),
                               np.asarray(chunks, np.int64)])
    if recorder is not None:
        host = state_host()
        return recorder.upload(host, dev), recorder.upload(step_host, dev), \
            host.size - _OPTIM_HEAD * n
    key = tuple((t.data_ptr(), t.dtype) for col in cols if col is not None
                for t in col) + tuple(p.numel() for p in params)
    name = kind + '_multi'
    hit = cache.get(name) if cache is not None else None
    if hit is not None and hit[0] == key:
        table, n_chunks = hit[1], hit[2]
    else:
        host = state_host()
        table, n_chunks = torch.from_numpy(host).to(dev), \
            host.size - _OPTIM_HEAD * n
        if cache is not None:
            cache[name] = (key, table, n_chunks)
            cache[name + '_tables'] = cache.get(name + '_tables', 0) + 1
    step = torch.from_numpy(step_host).pin_memory()
    return table, step.to(dev, non_blocking=True), n_chunks


def _launch_optim(op_type, key, params, grads, arrays, scalars, lrs, cache,
                  recorder):
    """The all-float32 instance of csrc/optim_multi.cu for `op_type` and
    `key`, in place."""
    kind = _kind(op_type, key)
    table, step, n_chunks = _optim_tables(kind, params, grads, arrays,
                                          scalars, lrs, cache, recorder)
    dev = params[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernels.library().pt_optim_multi(
            _KINDS.index(kind), table.data_ptr(), step.data_ptr(),
            len(params), n_chunks, *_optim_consts(op_type, key), stream)
    kernels.check(rc, kind + '_multi')
    kernels.launches[kind + '_multi'] += 1
    return list(params), [list(col) for col in arrays]


def _optim_bf16_tables(op_type, key, params, grads, arrays, scalars, lrs,
                       recorder):
    """The bf16 instance's outputs and tables -> (table, step, n_chunks,
    (params out, arrays out), flags): the outputs in the dtypes the plain
    version gives them (`_optim_dtypes`), new tensors where that is not
    their input's dtype."""
    dev = params[0].device
    n = len(params)
    bf = torch.bfloat16
    ins = [params[0], grads[0]] + [col[0] for col in arrays]
    dts = tuple(t.dtype for t in ins) + (
        scalars[0].dtype if scalars is not None else None,
        torch.float32 if lrs is not None else None)
    out_dts = _optim_dtypes(op_type, key, dts)
    outs = [[t if t.dtype == d else torch.empty(t.shape, dtype=d, device=dev)
             for t in col] for col, d in zip([params] + list(arrays),
                                             out_dts)]
    # per tensor: param and three state pointers, the element count, the
    # four out pointers (0 where the instance has fewer arrays)
    head = np.zeros((n, 2 * _OPTIM_HEAD - 1), np.int64)
    for c, col in enumerate([params] + list(arrays)):
        head[:, c] = [t.data_ptr() for t in col]
    head[:, _OPTIM_HEAD - 1] = [p.numel() for p in params]
    for c, col in enumerate(outs):
        head[:, _OPTIM_HEAD + c] = [t.data_ptr() for t in col]
    chunks = [(i << 32) | c for i, p in enumerate(params)
              for c in range((p.numel() + _OPTIM_CHUNK - 1) // _OPTIM_CHUNK)]
    host = np.concatenate([head.reshape(-1), np.asarray(chunks, np.int64)])
    step_host = np.zeros((n, 3), np.int64)
    for c, col in enumerate((grads, lrs, scalars)):
        if col is not None:
            step_host[:, c] = [t.data_ptr() for t in col]
    # bits 0-4: param, grad, state 0-2 bf16; 5: the power; 6-9: the
    # param's and the states' outputs
    in_bf = [t.dtype == bf for t in ins] + [False] * (3 - len(arrays))
    out_bf = [d == bf for d in out_dts] + [False] * (3 - len(arrays))
    flags = sum(int(b) << k for k, b in enumerate(
        in_bf + [dts[-2] == bf] + out_bf))
    return _upload(host, dev, recorder), \
        _upload(step_host.reshape(-1), dev, recorder), len(chunks), \
        (outs[0], outs[1:]), flags


def _launch_optim_bf16(op_type, key, params, grads, arrays, scalars, lrs,
                       recorder):
    """The instance of csrc/optim_multi.cu for `op_type` and `key` and one
    dtype combination with a bf16 among the params, grads, state arrays
    and powers (optim_bf16_kernel), into the outputs of
    `_optim_bf16_tables`."""
    kind = _kind(op_type, key)
    dev = params[0].device
    table, step, n_chunks, outs, flags = _optim_bf16_tables(
        op_type, key, params, grads, arrays, scalars, lrs, recorder)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernels.library().pt_optim_multi_bf16(
            _KINDS.index(kind), table.data_ptr(), step.data_ptr(),
            len(params), n_chunks, *_optim_consts(op_type, key),
            *_optim_consts(op_type, key, torch.bfloat16), flags, stream)
    kernels.check(rc, kind + '_multi_bf16')
    kernels.launches[kind + '_multi_bf16'] += 1
    return outs


def optim_multi(op_type, params, grads, arrays, scalars, lrs, key,
                cache=None, recorder=None):
    """The `op_type` update over lists of tensors (arguments as
    `optim_reference` takes them).  -> (params, arrays) after the step:
    each the input tensor, updated in place, or a new tensor where jnp
    promotes its dtype.  On CUDA tensors one launch per dtype combination
    of csrc/optim_multi.cu's instance for `op_type` and `key`: the
    float32 one for the all-float32 tensors, the bf16 one for each other
    combination; on CPU tensors `optim_reference`.  `cache` (a dict kept
    across steps) holds the float32 kernel's state table; `recorder`, a
    CUDA graph entry's (core/graphs.py), makes the host uploads."""
    if not params:
        return [], [[] for _ in arrays]
    cols = [grads] + list(arrays) + [c for c in (scalars, lrs)
                                     if c is not None]
    if len(arrays) != len(array_slots(op_type, key)) or \
            any(len(x) != len(params) for x in cols) or \
            (scalars is None) != (OPTIM_SLOTS[op_type][2] is None) or \
            (lrs is None) != (op_type == 'adadelta'):
        raise ValueError('%s_multi: the tensor lists differ in length or '
                         'number' % op_type)
    dev = params[0].device
    if dev.type in ('cpu', 'meta'):
        return optim_reference(op_type, params, grads, arrays, scalars, lrs,
                               key)
    if dev.type != 'cuda':
        raise RuntimeError('%s_multi: no kernel for device %s'
                           % (op_type, dev))
    _check_optim(op_type, params, grads, arrays, scalars, lrs)
    outs = ([None] * len(params), [[None] * len(params) for _ in arrays])
    for dts, idx in _by_dtypes(len(params), params, grads, *arrays,
                               scalars).items():
        def sub(col):
            return None if col is None else [col[i] for i in idx]
        args = (sub(params), sub(grads), [sub(c) for c in arrays],
                sub(scalars), sub(lrs))
        if all(d == torch.float32 for d in dts):
            got = _launch_optim(op_type, key, *args, cache, recorder)
        else:
            got = _launch_optim_bf16(op_type, key, *args, recorder)
        for out, col in zip([outs[0]] + outs[1], [got[0]] + list(got[1])):
            for i, t in zip(idx, col):
                out[i] = t
    return outs


def _entries(op_type):
    """(`<op_type>_reference`, `<op_type>_multi`): optim_reference and
    optim_multi for one op type."""
    def reference(params, grads, arrays, scalars, lrs, key):
        return optim_reference(op_type, params, grads, arrays, scalars, lrs,
                               key)

    def multi(params, grads, arrays, scalars, lrs, key, cache=None,
              recorder=None):
        return optim_multi(op_type, params, grads, arrays, scalars, lrs,
                           key, cache, recorder)
    reference.__name__ = op_type + '_reference'
    multi.__name__ = op_type + '_multi'
    reference.__doc__ = 'optim_reference for `%s`.' % op_type
    multi.__doc__ = 'optim_multi for `%s`.' % op_type
    return reference, multi


sgd_reference, sgd_multi = _entries('sgd')
adagrad_reference, adagrad_multi = _entries('adagrad')
decayed_adagrad_reference, decayed_adagrad_multi = \
    _entries('decayed_adagrad')
adamax_reference, adamax_multi = _entries('adamax')
adadelta_reference, adadelta_multi = _entries('adadelta')
rmsprop_reference, rmsprop_multi = _entries('rmsprop')
ftrl_reference, ftrl_multi = _entries('ftrl')


def _op_cols(op_type, key, ops, env):
    """(params, grads, arrays, scalars, lrs) of a run of `op_type` ops
    from `env`."""
    def col(slot):
        return [env[op.input(slot)[0]] for op in ops]
    scalar = OPTIM_SLOTS[op_type][2]
    return (col('Param'), col('Grad'),
            [col(s) for s in array_slots(op_type, key)],
            col(scalar) if scalar else None,
            None if op_type == 'adadelta' else col('LearningRate'))


def optim_group_key(op):
    """optim_key of an update op of OPTIM_SLOTS whose outputs are its
    inputs (the optimizer's in-place form), else None."""
    if op.type not in OPTIM_SLOTS:
        return None
    key = optim_key(op.type, op.attrs)
    outs = OPTIM_SLOTS[op.type][1]
    slots = ('Param',) + array_slots(op.type, key)
    if any(not op.input(i) or op.input(i) != op.output(o)
           for o, i in outs.items() if i in slots):
        return None
    return (op.type,) + key


def adamax_bump(op, adamaxes):
    """Whether `op` is the `scale` AdamaxOptimizer appends after an adamax
    op of `adamaxes`: it writes that op's Beta1Pow in place, which only
    that op reads."""
    if op.type != 'scale' or op.input('X') != op.output('Out'):
        return False
    return any(op.input('X') == a.input('Beta1Pow') for a in adamaxes)


def run_optim_group(ops, env, ectx):
    """One optim_multi call for consecutive in-place update ops of one
    type sharing their key (optim_group_key); a param or state array
    whose dtype jnp promotes is bound anew under its name.  An adamax run
    also holds its ops' Beta1Pow bumps (adamax_bump), which run after the
    launch: each adamax op reads its own power before its bump, as in the
    program."""
    updates = [op for op in ops if op.type != 'scale']
    op_type = updates[0].type
    key = optim_key(op_type, updates[0].attrs)
    params, arrays = optim_multi(op_type, *_op_cols(op_type, key, updates,
                                                    env), key,
                                 cache=ectx.cache, recorder=ectx.recorder)
    slots = array_slots(op_type, key)
    for o, i in OPTIM_SLOTS[op_type][1].items():
        if i == 'Param' or i in slots:
            col = params if i == 'Param' else arrays[slots.index(i)]
            for op, t in zip(updates, col):
                env[op.output(o)[0]] = t
    for op in ops:
        if op.type == 'scale':
            pow_ = env[op.input('X')[0]]
            pow_.copy_(get_op('scale')(ectx, {'X': pow_}, op.attrs)['Out'])


def _optim_op(op_type):
    def impl(ctx, ins, attrs):
        """One op, functional: the update runs on copies of its state."""
        key = optim_key(op_type, attrs)
        slots = array_slots(op_type, key)
        scalar = OPTIM_SLOTS[op_type][2]
        (p,), arrays = optim_multi(
            op_type, [ins['Param'].clone()], [ins['Grad']],
            [[ins[s].clone()] for s in slots],
            [ins[scalar]] if scalar else None,
            None if op_type == 'adadelta' else [ins['LearningRate']], key,
            recorder=getattr(ctx, 'recorder', None))
        outs = {'ParamOut': p}
        for o, i in OPTIM_SLOTS[op_type][1].items():
            if i in slots:
                outs[o] = arrays[slots.index(i)][0]
        return outs
    impl.__name__ = op_type
    return impl


for _t in OPTIM_SLOTS:
    register(_t)(_optim_op(_t))


@register('lars_momentum')
def lars_momentum(ctx, ins, attrs):
    """The reference's (paddle_tpu/ops/optimizer_ops.py:37-48), one op a
    tensor in plain torch ops (no kernel: XLA computes it there, the
    fuse pass leaves it out), the norms as sqrt(sum(square(x))), with
    jnp's dtypes: the learning rate and the norms as arrays of p's rank
    (`_dims`), so the float32 rate promotes a bf16 update to float32, and
    each Python constant in the dtype of the array it meets (`_weak`)."""
    p, g, v = ins['Param'], ins['Grad'], ins['Velocity']
    w = _weak
    mu = attrs.get('mu', 0.9)
    coeff = attrs.get('lars_coeff', 0.001)
    decay = attrs.get('lars_weight_decay', 0.0005)
    lr = _dims(ins['LearningRate'], p)
    pn = _dims(torch.sqrt(torch.sum(torch.square(p))), p)
    gn = _dims(torch.sqrt(torch.sum(torch.square(g))), p)
    den = gn + w(decay, pn) * pn
    local_lr = lr * w(coeff, lr) * pn / (den + w(1e-12, den))
    vn = w(mu, v) * v + local_lr * (g + w(decay, p) * p)
    return {'ParamOut': p - vn, 'VelocityOut': vn}


# the optimizer ops the executor groups: op type -> (key, runner).  A key
# holds every attribute the update reads; a run of one type sharing its
# key is one multi-tensor launch, an adamax run across its Beta1Pow bumps
# (adamax_bump).  ops/kernelgen's plan makes the same runs.
GROUPS = {'adam': (adam_group_key, run_adam_group),
          'momentum': (momentum_group_key, run_momentum_group)}
GROUPS.update({t: (optim_group_key, run_optim_group) for t in OPTIM_SLOTS})
