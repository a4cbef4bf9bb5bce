"""Loss ops: softmax_with_cross_entropy for hard labels over the last axis,
and cross_entropy of probabilities.

Counterpart of paddle_tpu/ops/loss.py (`_make_hard_ce`, :43-93).  The
loss is a `torch.autograd.Function` with the reference's own backward:

- forward: the logsumexp in float32 whatever the logits' dtype, the target
  logit taken from the unconverted logits, the label-smoothing closed form
  `lse - (1 - eps) * tgt - eps * mean(x)`, zero on `ignore_index` rows;
  it keeps (logits, label, lse) for the backward;
- backward: `dlogits = g * (softmax - (1 - eps) * onehot - eps / V)` in
  the logits' dtype (bf16 under AMP), with `ignore_index` rows zeroed.

The `Softmax` output is computed only when a later op reads it or the run
fetches it (`ctx.wants`): otherwise every training step would build a
float32 [B, T, V] tensor that the JAX package's DCE never builds.

`cross_entropy` (the reference's :22-40) takes probabilities: `-log(p +
1e-8)` of the label's entry in float32 whatever their dtype, zero on
`ignore_index` rows, or `-sum(label * log(p + 1e-8))` with `soft_label`;
plain torch ops, differentiated by autograd as the JAX package's are by
its vjp.

`sigmoid_cross_entropy_with_logits` (the reference's :215-224) is the
stable form `max(x, 0) - x z + log1p(exp(-|x|))`, zero where the label is
`ignore_index`, divided by the count of other labels (at least 1) with
`normalize`; `square_error_cost` (:145) is `(x - y)^2`.  Both are plain
torch ops under autograd.
"""
import torch

from ..core.registry import register

_EPS = 1e-8


def _target(logits, lab):
    """The label's logit as `take_along_axis` reads it: a negative label
    wraps once, a label still out of range gives NaN.  The gather's index
    is clamped first, so no device-side assert fires on the card."""
    V = logits.shape[-1]
    lab = lab.long()
    wrapped = torch.where(lab < 0, lab + V, lab)
    inside = (wrapped >= 0) & (wrapped < V)
    tgt = logits.gather(-1, wrapped.clamp(0, V - 1)).float()
    return torch.where(inside, tgt, torch.full_like(tgt, float('nan')))


def _ce_forward(logits, lab, eps, ignore):
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1, keepdim=True)
    tgt = _target(logits, lab)
    if eps:
        loss = lse - (1.0 - eps) * tgt - eps * x.mean(dim=-1, keepdim=True)
    else:
        loss = lse - tgt
    return torch.where(lab == ignore, torch.zeros_like(loss), loss), lse


class _HardCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, lab, eps, ignore):
        loss, lse = _ce_forward(logits, lab, eps, ignore)
        ctx.save_for_backward(logits, lab, lse)
        ctx.eps, ctx.ignore = eps, ignore
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, lab, lse = ctx.saved_tensors
        eps, ignore = ctx.eps, ctx.ignore
        V = logits.shape[-1]
        d = torch.exp(logits.float() - lse)
        if eps:
            d.sub_(eps / V)
        # the reference's one-hot is arange(V) == label: a label outside
        # [0, V) (wrapped in the forward or not) subtracts nothing
        inside = (lab >= 0) & (lab < V)
        d.scatter_add_(-1, torch.where(inside, lab, torch.zeros_like(lab))
                       .long(), torch.where(inside, -(1.0 - eps), 0.0)
                       .to(d.dtype))
        gz = torch.where(lab == ignore, torch.zeros_like(g), g.float())
        return (gz * d).to(logits.dtype), None, None, None


def hard_cross_entropy(logits, lab, eps=0.0, ignore=-100):
    """Per-row loss [..., 1] float32 of `logits` [..., V] against int
    labels `lab` [..., 1]."""
    if torch.is_grad_enabled() and logits.requires_grad:
        return _HardCE.apply(logits, lab, float(eps), int(ignore))
    return _ce_forward(logits, lab, float(eps), int(ignore))[0]


@register('softmax_with_cross_entropy')
def softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = ins['Logits'], ins['Label']
    ndim = logits.ndim
    if attrs.get('soft_label', False) or \
            attrs.get('axis', -1) not in (-1, ndim - 1):
        raise NotImplementedError(
            'paddle_tpu_torch: softmax_with_cross_entropy is ported for hard '
            'labels over the last axis only')
    lab = label if label.ndim == ndim else label.unsqueeze(-1)
    loss = hard_cross_entropy(logits, lab.to(torch.int32),
                              attrs.get('label_smooth_eps', 0.0),
                              attrs.get('ignore_index', -100))
    outs = {'Loss': loss}
    if ctx.wants('Softmax'):
        outs['Softmax'] = torch.softmax(logits.float(), dim=-1)
    return outs


@register('cross_entropy')
def cross_entropy(ctx, ins, attrs):
    x, label = ins['X'].float(), ins['Label']
    if attrs.get('soft_label', False):
        return {'Y': -(label.float() * torch.log(x + _EPS)).sum(
            dim=-1, keepdim=True)}
    lab = label[..., 0] if label.ndim >= 2 and label.shape[-1] == 1 \
        else label
    lab = lab.unsqueeze(-1)
    out = -torch.log(_target(x, lab) + _EPS)
    ignore = attrs.get('ignore_index', -100)
    return {'Y': torch.where(lab == ignore, torch.zeros_like(out), out)}


@register('sigmoid_cross_entropy_with_logits')
def sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    x, label = ins['X'], ins['Label']
    ignore = attrs.get('ignore_index', -100)
    loss = torch.clamp_min(x, 0) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    kept = label != ignore
    loss = torch.where(kept, loss, torch.zeros_like(loss))
    if attrs.get('normalize', False):
        cnt = torch.sum(kept.to(x.dtype))
        loss = loss / torch.clamp_min(cnt, 1.0)
    return {'Out': loss}


@register('square_error_cost')
def square_error_cost(ctx, ins, attrs):
    d = ins['X'] - ins['Y']
    return {'Out': d * d}
