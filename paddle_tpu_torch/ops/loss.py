"""Loss ops: softmax_with_cross_entropy, cross_entropy of probabilities,
and the reference's other losses.

Counterpart of paddle_tpu/ops/loss.py.  Hard labels over the last axis
(`_make_hard_ce`, :43-93) take a `torch.autograd.Function` with the
reference's own backward:

- forward: the logsumexp in float32 whatever the logits' dtype, the target
  logit taken from the unconverted logits, the label-smoothing closed form
  `lse - (1 - eps) * tgt - eps * mean(x)`, zero on `ignore_index` rows;
  it keeps (logits, label, lse) for the backward;
- backward: `dlogits = g * (softmax - (1 - eps) * onehot - eps / V)` in
  the logits' dtype (bf16 under AMP), with `ignore_index` rows zeroed.

Soft labels, and hard labels over another axis (the reference's
:115-139), are its jnp branch in torch ops under autograd:
`logp = log_softmax(float32(logits), axis)`; soft labels give
`-sum(label logp, axis, keepdim)`; hard labels pick `logp` at the label
along `axis` (`take_along_axis`: a negative label wraps once, one still
out of range gives NaN), with the `label_smooth_eps` closed form
`(1 - eps) (-picked) + eps (-mean(logp, axis))` and zero on
`ignore_index`.

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
`normalize`; `square_error_cost` (:145) is `(x - y)^2`; smooth_l1_loss,
huber_loss, log_loss, rank_loss, margin_rank_loss, bpr_loss and
kldiv_loss (:150-250) are the reference's jnp formulas.  All are plain
torch ops under autograd.
"""
import torch

from ..core.dtypes import weak
from ..core.registry import register

_EPS = 1e-8


def _target(logits, lab, axis=-1):
    """The label's logit as `take_along_axis` reads it along `axis`: a
    negative label wraps once, a label still out of range gives NaN.  The
    gather's index is clamped first, so no device-side assert fires on
    the card."""
    V = logits.shape[axis]
    lab = lab.long()
    wrapped = torch.where(lab < 0, lab + V, lab)
    inside = (wrapped >= 0) & (wrapped < V)
    tgt = logits.gather(axis, wrapped.clamp(0, V - 1)).float()
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


def _general_cross_entropy(ctx, logits, label, attrs):
    """The reference's jnp branch: soft labels, or hard labels over a
    non-last axis (module docstring)."""
    axis = attrs.get('axis', -1) % logits.ndim
    logp = torch.log_softmax(logits.float(), dim=axis)
    if attrs.get('soft_label', False):
        loss = -(label.float() * logp).sum(dim=axis, keepdim=True)
    else:
        # the label keeps a size-1 dim at `axis`; the squeezed form gets it
        lab = label if label.ndim == logp.ndim else label.unsqueeze(axis)
        lab = lab.to(torch.int32)
        loss = -_target(logp, lab, axis)
        eps = attrs.get('label_smooth_eps', 0.0)
        if eps:
            loss = (1.0 - eps) * loss + eps * (
                -logp.mean(dim=axis, keepdim=True))
        loss = torch.where(lab == attrs.get('ignore_index', -100),
                           torch.zeros_like(loss), loss)
    outs = {'Loss': loss}
    if ctx is None or ctx.wants('Softmax'):
        outs['Softmax'] = torch.exp(logp)
    return outs


@register('softmax_with_cross_entropy')
def softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = ins['Logits'], ins['Label']
    ndim = logits.ndim
    if attrs.get('soft_label', False) or \
            attrs.get('axis', -1) not in (-1, ndim - 1):
        return _general_cross_entropy(ctx, logits, label, attrs)
    lab = label if label.ndim == ndim else label.unsqueeze(-1)
    loss = hard_cross_entropy(logits, lab.to(torch.int32),
                              attrs.get('label_smooth_eps', 0.0),
                              attrs.get('ignore_index', -100))
    outs = {'Loss': loss}
    if ctx is None or ctx.wants('Softmax'):
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


# each Python constant below meets its tensor as jnp meets a weak-typed
# scalar: rounded to the tensor's dtype first (`weak`, ROADMAP C12)

@register('smooth_l1_loss')
def smooth_l1_loss(ctx, ins, attrs):
    x, y = ins['X'], ins['Y']
    sigma = attrs.get('sigma', 1.0)
    s2 = sigma * sigma
    diff = x - y
    if ins.get('InsideWeight') is not None:
        diff = diff * ins['InsideWeight']
    ad = torch.abs(diff)
    loss = torch.where(ad < weak(1.0 / s2, ad),
                       weak(0.5 * s2, diff) * torch.square(diff),
                       ad - weak(0.5 / s2, ad))
    if ins.get('OutsideWeight') is not None:
        loss = loss * ins['OutsideWeight']
    return {'Out': loss.sum(dim=tuple(range(1, loss.ndim))).reshape(-1, 1),
            'Diff': diff}


@register('huber_loss')
def huber_loss(ctx, ins, attrs):
    x, y = ins['X'], ins['Y']
    d = attrs.get('delta', 1.0)
    r = y - x
    ar = torch.abs(r)
    loss = torch.where(ar <= weak(d, ar), weak(0.5, r) * torch.square(r),
                       weak(d, ar) * (ar - weak(0.5 * d, ar)))
    return {'Out': loss, 'Residual': r}


@register('log_loss')
def log_loss(ctx, ins, attrs):
    p, label = ins['Predicted'], ins['Labels']
    eps = attrs.get('epsilon', 1e-4)
    out = -label * torch.log(p + weak(eps, p)) - (1 - label) * torch.log(
        1 - p + weak(eps, p))
    return {'Loss': out}


@register('rank_loss')
def rank_loss(ctx, ins, attrs):
    d = ins['Left'] - ins['Right']
    return {'Out': torch.log1p(torch.exp(d)) - ins['Label'] * d}


@register('margin_rank_loss')
def margin_rank_loss(ctx, ins, attrs):
    from .math import _maximum
    label, x1, x2 = ins['Label'], ins['X1'], ins['X2']
    v = -label * (x1 - x2)
    out = _maximum(v + weak(attrs.get('margin', 0.0), v), 0.0)
    return {'Out': out, 'Activated': (out > 0).to(x1.dtype)}


@register('bpr_loss')
def bpr_loss(ctx, ins, attrs):
    """sum over the other classes of -log(sigmoid(x_label - x_j) + 1e-8),
    over C - 1; the label's logit read as `take_along_axis` reads it."""
    from .math import _sigmoid
    x, label = ins['X'], ins['Label']
    lab = label[..., 0] if label.ndim >= 2 and label.shape[-1] == 1 \
        else label
    lab = lab.long()
    n, c = x.shape
    wrapped = torch.where(lab < 0, lab + c, lab)
    inside = (wrapped >= 0) & (wrapped < c)
    pos = x.gather(1, wrapped.clamp(0, c - 1)[:, None])
    pos = torch.where(inside[:, None], pos, torch.full_like(pos, float('nan')))
    diff = pos - x
    s = _sigmoid(diff)
    lse = -torch.log(s + weak(_EPS, s))
    mask = 1.0 - (lab[:, None] == torch.arange(c, device=x.device)).to(
        x.dtype)
    return {'Y': (lse * mask).sum(dim=1, keepdim=True) / weak(c - 1, lse)}


@register('kldiv_loss')
def kldiv_loss(ctx, ins, attrs):
    x, target = ins['X'], ins['Target']
    loss = target * (torch.log(target + weak(_EPS, target)) - x)
    red = attrs.get('reduction', 'mean')
    if red == 'mean':
        loss = loss.mean().reshape(1)
    elif red == 'sum':
        loss = loss.sum().reshape(1)
    elif red == 'batchmean':
        loss = (loss.sum() / weak(x.shape[0], loss)).reshape(1)
    return {'Loss': loss}
