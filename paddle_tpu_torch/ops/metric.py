"""Metric ops: accuracy.

Counterpart of paddle_tpu/ops/metric.py (:12-22): a row is correct when any
of its top-k indices is its label; `Accuracy` [1] float32, `Correct` and
`Total` [1] int32.
"""
import torch

from ..core.registry import register


@register('accuracy')
def accuracy(ctx, ins, attrs):
    indices, label = ins['Indices'], ins['Label']
    if label.ndim == 2 and label.shape[1] == 1:
        label = label[:, 0]
    correct = (indices == label[:, None]).any(dim=1)
    num = correct.sum(dtype=torch.int32).reshape(1)
    total = torch.full((1,), label.shape[0], dtype=torch.int32,
                       device=label.device)
    return {'Accuracy': num.float() / total.float(), 'Correct': num,
            'Total': total}
