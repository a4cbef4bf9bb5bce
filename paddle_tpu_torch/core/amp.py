"""The bf16 AMP policy, per op.

Counterpart of the policy in paddle_tpu/core/executor.py:145-228.  The
executor's interpreter applies it to every op, and the fused_elementwise
op (ops/fused.py) and the kernel generator (ops/kernelgen/builder.py)
apply it to every sub-op, so a fused group sees exactly the dtypes the
unfused ops would:

- matrix-product ops (`_AMP_CAST_OPS`) get their float32 inputs cast to
  bf16, and their outputs cast back to float32 unless the op carries
  `amp_keep_bf16`;
- convolutions (`_AMP_FLOW_OPS`) get their float32 inputs cast to bf16
  too, and their outputs stay bf16, so the activations of a CNN flow in
  bf16 through its batch norms, relus and residual adds (the reference's
  `PT_AMP_FLOW` switch is not ported: its default, `conv`, is the policy);
- an elementwise op with a bf16 input (`_AMP_MATCH`) casts its float32
  inputs down, so the logits projection's bias add follows the bf16
  logits and the cross-entropy reads bf16.
"""
import torch

__all__ = ['AMP_CAST_OPS', 'AMP_FLOW_OPS', 'AMP_MATCH', 'amp_match_ins',
           'amp_sub_ins', 'amp_sub_outs']

AMP_CAST_OPS = frozenset({'mul', 'matmul', 'flash_attention'})
AMP_FLOW_OPS = frozenset({'conv2d'})
AMP_MATCH = frozenset({'elementwise_add', 'elementwise_sub',
                       'elementwise_mul', 'elementwise_div',
                       'elementwise_max', 'elementwise_min'})


def _cast(v, to):
    frm = torch.float32 if to == torch.bfloat16 else torch.bfloat16
    if isinstance(v, torch.Tensor) and v.dtype == frm:
        return v.to(to)
    return v


def _each(vals, fn):
    return {s: ([fn(x) for x in v] if isinstance(v, (list, tuple))
                else fn(v)) for s, v in vals.items()}


def amp_match_ins(op_type, ins):
    """The elementwise half: if any input of an `AMP_MATCH` op is bf16,
    its float32 inputs are cast down."""
    if op_type not in AMP_MATCH or not any(
            isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
            for v in ins.values()):
        return ins
    return {s: v if isinstance(v, (list, tuple))
            else _cast(v, torch.bfloat16) for s, v in ins.items()}


def amp_sub_ins(op_type, ins, amp):
    """The whole input policy of one op under `amp`."""
    if not amp:
        return ins
    if op_type in AMP_CAST_OPS or op_type in AMP_FLOW_OPS:
        ins = _each(ins, lambda x: _cast(x, torch.bfloat16))
    return amp_match_ins(op_type, ins)


def amp_sub_outs(op_type, attrs, outs, amp):
    """The cast-back half: `AMP_CAST_OPS` outputs return to float32
    unless the op carries `amp_keep_bf16`."""
    if not (amp and op_type in AMP_CAST_OPS and outs) or \
            attrs.get('amp_keep_bf16'):
        return outs
    return _each(outs, lambda x: _cast(x, torch.float32))
