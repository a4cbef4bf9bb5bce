"""Embedding row gather: the hand-written CUDA kernel and its plain version.

Counterpart of paddle_tpu/ops/gather.py.  `embedding_gather` keeps the JAX
function's semantics at every shape: negative ids wrap once by +V, and ids
still out of range give NaN rows (float tables).  On a CUDA tensor it
launches csrc/gather.cu (which replaces the TPU kernel `_gather_kernel`);
on a CPU tensor it runs `embedding_gather_reference`, the same function
in plain PyTorch.  There is no size gate: the JAX package's `_MIN_ROWS`
was measured on a TPU and says nothing about this card.

`lookup` is the differentiable form the `lookup_table` op uses: forward
is the gather, backward is the scatter-add of the rows' gradients into a
zero table in the table's dtype, as the JAX package's custom VJP does
with XLA's scatter-add (paddle_tpu/ops/gather.py:117-120) — not a
kernel.  On the card it is `index_put_(..., accumulate=True)`, which
sorts the ids and sums each row's contributions in their order: the same
sum on every run, equal bit for bit to the CPU's `index_add_`, a serial
loop in that order.  `index_add_` on the card adds them with float
atomics in whatever order the threads arrive, so two runs of one step
(and an interpreted step against its CUDA graph) differed in the
embedding gradients' last bits; the CPU's `index_put_` sums in yet
another order.
"""
import torch

from .. import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def embedding_gather_reference(w, idx):
    """Plain version: rows of `w` [V, D] at `idx` (any shape), with the
    wrap / NaN rule.  Non-float tables get the clamped row where a float
    table gets NaN."""
    V = w.shape[0]
    flat = idx.reshape(-1).long()
    wrapped = torch.where(flat < 0, flat + V, flat)
    oob = (wrapped < 0) | (wrapped >= V)
    out = torch.index_select(w, 0, wrapped.clamp(0, V - 1))
    if w.dtype.is_floating_point:
        out = torch.where(oob[:, None], torch.full_like(out, float('nan')),
                          out)
    return out.reshape(tuple(idx.shape) + (w.shape[1],))


def _launch_gather(w, ids):
    """Launch csrc/gather.cu on `ids` [N] (int32/int64) into a new [N, D]."""
    if w.dim() != 2 or ids.dim() != 1:
        raise ValueError('embedding gather takes a [V, D] table and [N] ids, '
                         'got %s and %s' % (tuple(w.shape), tuple(ids.shape)))
    if w.dtype not in _DTYPE_CODE:
        raise TypeError('embedding gather kernel takes float32, bfloat16 or '
                        'float16 tables, got %s' % w.dtype)
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError('embedding gather ids must be int32 or int64, got %s'
                        % ids.dtype)
    if ids.device != w.device:
        raise ValueError('table on %s, ids on %s' % (w.device, ids.device))
    if not (w.is_contiguous() and ids.is_contiguous()):
        raise ValueError('embedding gather kernel takes contiguous tensors')
    if w.shape[0] >= 2 ** 31:
        raise ValueError('embedding gather kernel takes V < 2**31')
    N, (V, D) = ids.shape[0], w.shape
    out = torch.empty((N, D), dtype=w.dtype, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = kernels.library().pt_embedding_gather(
            w.data_ptr(), ids.data_ptr(), out.data_ptr(), N, V, D,
            _DTYPE_CODE[w.dtype], int(ids.dtype == torch.int64), stream)
    kernels.check(rc, 'embedding_gather')
    kernels.launches['embedding_gather'] += 1
    return out


def embedding_gather(w, idx):
    """Rows of `w` at `idx` (any idx shape): the CUDA kernel for a CUDA
    table, the plain version for a CPU (or shape-only `meta`) table."""
    if w.device.type == 'cuda':
        out = _launch_gather(w, idx.reshape(-1).contiguous())
        return out.reshape(tuple(idx.shape) + (w.shape[1],))
    if w.device.type in ('cpu', 'meta'):
        return embedding_gather_reference(w, idx)
    raise RuntimeError('embedding_gather: no kernel for device %s' % w.device)


def _safe_ids(idx, V):
    """Flat ids wrapped once by +V and clamped, and the mask of those still
    out of range (their forward rows are NaN; they get no gradient)."""
    flat = idx.reshape(-1).long()
    wrapped = torch.where(flat < 0, flat + V, flat)
    oob = (wrapped < 0) | (wrapped >= V)
    return wrapped.clamp(0, V - 1), oob


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = tuple(w.shape)
        return embedding_gather(w, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        V, D = ctx.table_shape
        safe, oob = _safe_ids(idx, V)
        g = g.reshape(-1, D).masked_fill(oob[:, None], 0)
        dw = torch.zeros((V, D), dtype=g.dtype, device=g.device)
        if dw.is_cuda:
            return dw.index_put_((safe,), g, accumulate=True), None
        return dw.index_add_(0, safe, g), None


def lookup(w, idx):
    """`embedding_gather` with the scatter-add gradient w.r.t. `w`."""
    if torch.is_grad_enabled() and w.requires_grad:
        return _Lookup.apply(w, idx)
    return embedding_gather(w, idx)
