"""Optimizer update ops: `adam` and `momentum`, and their multi-tensor
kernels.

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

`momentum` is the reference's (:24-34), in float32:

    v' = mu v + g        p' = p - lr (g + mu v')  (use_nesterov)
                         p' = p - lr v'           (else)

`momentum_multi` updates lists of parameters and velocities in place with
one call: on CUDA tensors it launches csrc/momentum.cu, the momentum
instance of the TPU's generated fused-segment kernel (`_compile_segment`
with the `momentum` rule), for contiguous float32 tensors only (any other
raises); on CPU tensors it runs `momentum_reference`, the per-tensor
loop of the op.  Its pointer table is cached per executor as Adam's is,
and LR is read on the device.  The executor hands each maximal run of
consecutive in-place `momentum` ops sharing mu and use_nesterov to one
`momentum_multi` call (`run_momentum_group`).
"""
import numpy as np
import torch

from .. import kernels
from ..core.registry import register

_IN_PLACE = (('Param', 'ParamOut'), ('Moment1', 'Moment1Out'),
             ('Moment2', 'Moment2Out'), ('Beta1Pow', 'Beta1PowOut'),
             ('Beta2Pow', 'Beta2PowOut'))
# elements per block of the kernels (csrc/adam.cu CHUNK)
_CHUNK = 32768
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _scalar(v, t):
    """A Python scalar as jnp meets it with array `t`: in t's dtype."""
    return torch.tensor(v, dtype=t.dtype, device=t.device)


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


def _momentum_one(p, g, v, lr, mu, nesterov):
    """The `momentum` op's math on one tensor, one rounding an operation
    -> (p', v'), new tensors."""
    vn = mu * v + g
    lr = lr.reshape(())
    pn = p - lr * (g + mu * vn) if nesterov else p - lr * vn
    return pn, vn


def momentum_reference(params, grads, velocities, lrs, mu, nesterov):
    """Plain version: the `momentum` op's math per tensor, written into
    the params and velocities in place."""
    for p, g, v, lr in zip(params, grads, velocities, lrs):
        pn, vn = _momentum_one(p, g, v, lr, mu, nesterov)
        p.copy_(pn)
        v.copy_(vn)


def _check_momentum(params, grads, velocities, lrs):
    dev = params[0].device
    for p, g, v, lr in zip(params, grads, velocities, lrs):
        for t in (p, g, v):
            if t.dtype != torch.float32 or t.device != dev or \
                    not t.is_contiguous() or t.numel() != p.numel():
                raise ValueError('momentum_multi kernel takes contiguous '
                                 'float32 params, grads and velocities of '
                                 'one size on one device')
        if lr.dtype != torch.float32 or lr.device != dev or lr.numel() != 1:
            raise ValueError('momentum_multi kernel takes a [1] float32 '
                             'learning rate on the device')


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
    key = tuple(t.data_ptr() for col in (params, velocities)
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


def momentum_multi(params, grads, velocities, lrs, mu, nesterov,
                   cache=None, recorder=None):
    """Momentum over lists of tensors, params and velocities updated in
    place.  `cache` (a dict kept across steps) holds the kernel's state
    table; `recorder`, a CUDA graph entry's (core/graphs.py), makes the
    host uploads."""
    if not params:
        return
    if any(len(x) != len(params) for x in (grads, velocities, lrs)):
        raise ValueError('momentum_multi: the tensor lists differ in length')
    dev = params[0].device
    if dev.type in ('cpu', 'meta'):
        momentum_reference(params, grads, velocities, lrs, mu, nesterov)
        return
    if dev.type != 'cuda':
        raise RuntimeError('momentum_multi: no kernel for device %s' % dev)
    _check_momentum(params, grads, velocities, lrs)
    table, step, n_chunks = _momentum_tables(params, grads, velocities, lrs,
                                             cache, recorder)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernels.library().pt_momentum_multi(
            table.data_ptr(), step.data_ptr(), len(params), n_chunks,
            float(mu), int(bool(nesterov)), stream)
    kernels.check(rc, 'momentum_multi')
    kernels.launches['momentum_multi'] += 1


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
    sharing mu and use_nesterov (momentum_group_key)."""
    cols = [[env[op.input(slot)[0]] for op in ops] for slot in (
        'Param', 'Grad', 'Velocity', 'LearningRate')]
    momentum_multi(*cols, *_momentum_attrs(ops[0].attrs), cache=ectx.cache,
                   recorder=ectx.recorder)


# the optimizer ops the executor groups: op type -> (key, runner)
GROUPS = {'adam': (adam_group_key, run_adam_group),
          'momentum': (momentum_group_key, run_momentum_group)}


@register('momentum')
def momentum(ctx, ins, attrs):
    """One op, functional: the update runs on copies of its state."""
    p, v = ins['Param'].clone(), ins['Velocity'].clone()
    momentum_multi([p], [ins['Grad']], [v], [ins['LearningRate']],
                   *_momentum_attrs(attrs),
                   recorder=getattr(ctx, 'recorder', None))
    return {'ParamOut': p, 'VelocityOut': v}
