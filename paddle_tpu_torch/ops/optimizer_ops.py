"""Optimizer update ops: `adam`, and the multi-tensor Adam kernel.

Counterpart of paddle_tpu/ops/optimizer_ops.py.  The math is the
reference's (:51-65), in float32:

    m1' = b1 m1 + (1 - b1) g          m2' = b2 m2 + (1 - b2) g^2
    lr_t = lr sqrt(1 - b2p) / (1 - b1p)
    p'  = p - lr_t m1' / (sqrt(m2') + eps)        b1p' = b1p b1, b2p' = b2p b2

`adam_multi` updates a whole list of parameters, their moments and beta
powers in place, with one call: on CUDA tensors it launches
csrc/adam.cu, which replaces the Adam instance of the TPU's generated
fused-segment kernel (`_compile_segment`); on CPU tensors it runs
`adam_reference`, the per-tensor loop of the op.  LR and the powers are
read on the device, so a step needs no host sync.  The executor hands each
maximal run of consecutive in-place `adam` ops to one `adam_multi` call
(`run_adam_group`); the program still holds one `adam` op per parameter,
as the JAX package's does.  Updating in place is what the JAX package gets
by donating the buffers to its fused kernel.
"""
import numpy as np
import torch

from .. import kernels
from ..core.registry import register

_IN_PLACE = (('Param', 'ParamOut'), ('Moment1', 'Moment1Out'),
             ('Moment2', 'Moment2Out'), ('Beta1Pow', 'Beta1PowOut'),
             ('Beta2Pow', 'Beta2PowOut'))
# elements per block of the kernel (csrc/adam.cu CHUNK)
_CHUNK = 32768


def adam_reference(params, grads, moment1s, moment2s, beta1_pows,
                   beta2_pows, lrs, beta1, beta2, epsilon):
    """Plain version: the `adam` op's math per tensor, in place."""
    for p, g, m1, m2, b1p, b2p, lr in zip(params, grads, moment1s,
                                          moment2s, beta1_pows, beta2_pows,
                                          lrs):
        m1n = beta1 * m1 + (1 - beta1) * g
        m2n = beta2 * m2 + (1 - beta2) * g.square()
        lr_t = lr.reshape(()) * torch.sqrt(1 - b2p.reshape(())) / \
            (1 - b1p.reshape(()))
        p.copy_(p - lr_t * m1n / (torch.sqrt(m2n) + epsilon))
        m1.copy_(m1n)
        m2.copy_(m2n)
        b1p.mul_(beta1)
        b2p.mul_(beta2)


def _tables(params, grads, moment1s, moment2s, beta1_pows, beta2_pows,
            lrs, cache):
    """The kernel's two device tables, int64.  The state table holds per
    tensor 6 entries (param, m1, m2, beta1_pow and beta2_pow pointers and
    the element count), then one entry per chunk, (tensor index << 32) |
    chunk index; in-place updates keep its pointers, so it is cached while
    they hold.  The step table holds per tensor the grad and LR pointers,
    new every step (autograd allocates the grads): it goes up from pinned
    memory without a host sync."""
    state = (params, moment1s, moment2s, beta1_pows, beta2_pows)
    key = tuple(t.data_ptr() for col in state for t in col) + \
        tuple(p.numel() for p in params)
    dev = params[0].device
    hit = cache.get('adam_multi') if cache is not None else None
    if hit is not None and hit[0] == key:
        table, n_chunks = hit[1], hit[2]
    else:
        head = np.empty((len(params), 6), np.int64)
        for c, col in enumerate(state):
            head[:, c] = [t.data_ptr() for t in col]
        head[:, 5] = [p.numel() for p in params]
        chunks = [(i << 32) | c for i, p in enumerate(params)
                  for c in range((p.numel() + _CHUNK - 1) // _CHUNK)]
        host = np.concatenate([head.reshape(-1),
                               np.asarray(chunks, np.int64)])
        table, n_chunks = torch.from_numpy(host).to(dev), len(chunks)
        if cache is not None:
            cache['adam_multi'] = (key, table, n_chunks)
            cache['adam_multi_tables'] = \
                cache.get('adam_multi_tables', 0) + 1
    step = torch.tensor([t.data_ptr() for pair in zip(grads, lrs)
                         for t in pair], dtype=torch.int64).pin_memory()
    return table, step.to(dev, non_blocking=True), n_chunks


def _launch_adam(params, grads, moment1s, moment2s, beta1_pows, beta2_pows,
                 lrs, beta1, beta2, epsilon, cache):
    dev = params[0].device
    for p, g, m1, m2 in zip(params, grads, moment1s, moment2s):
        for t in (p, g, m1, m2):
            if t.dtype != torch.float32 or t.device != dev or \
                    not t.is_contiguous() or t.numel() != p.numel():
                raise ValueError('adam_multi kernel takes contiguous float32 '
                                 'params, grads and moments of one size on '
                                 'one device')
    for t in list(beta1_pows) + list(beta2_pows) + list(lrs):
        if t.dtype != torch.float32 or t.device != dev or t.numel() != 1:
            raise ValueError('adam_multi kernel takes float32 [1] beta '
                             'powers and learning rates on the device')
    table, step, n_chunks = _tables(params, grads, moment1s, moment2s,
                                    beta1_pows, beta2_pows, lrs, cache)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernels.library().pt_adam_multi(
            table.data_ptr(), step.data_ptr(), len(params), n_chunks,
            float(beta1),
            float(beta2), float(1 - beta1), float(1 - beta2), float(epsilon),
            stream)
    kernels.check(rc, 'adam_multi')
    kernels.launches['adam_multi'] += 1


def adam_multi(params, grads, moment1s, moment2s, beta1_pows, beta2_pows,
               lrs, beta1, beta2, epsilon, cache=None):
    """Adam over lists of tensors, in place.  `cache` (a dict kept across
    steps) holds the kernel's state table."""
    if not params:
        return
    lists = (grads, moment1s, moment2s, beta1_pows, beta2_pows, lrs)
    if any(len(x) != len(params) for x in lists):
        raise ValueError('adam_multi: the tensor lists differ in length')
    dev = params[0].device
    if dev.type == 'cuda':
        return _launch_adam(params, grads, moment1s, moment2s, beta1_pows,
                            beta2_pows, lrs, beta1, beta2, epsilon, cache)
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
    adam_multi(*cols, *_attrs(ops[0].attrs), cache=ectx.cache)


@register('adam')
def adam(ctx, ins, attrs):
    """One op, functional: the update runs on copies of its state."""
    p, m1, m2, b1p, b2p = (ins[s].clone() for s in (
        'Param', 'Moment1', 'Moment2', 'Beta1Pow', 'Beta2Pow'))
    adam_multi([p], [ins['Grad']], [m1], [m2], [b1p], [b2p],
               [ins['LearningRate']], *_attrs(attrs))
    return {'ParamOut': p, 'Moment1Out': m1, 'Moment2Out': m2,
            'Beta1PowOut': b1p, 'Beta2PowOut': b2p}
