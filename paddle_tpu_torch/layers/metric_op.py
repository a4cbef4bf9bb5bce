"""Metric layers: accuracy.

Counterpart of paddle_tpu/layers/metric_op.py (:11-28): `top_k`, then
`accuracy` on its indices.
"""
from ..core.layer_helper import LayerHelper

__all__ = ['accuracy']


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper('accuracy')
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference('int64')
    helper.append_op(type='top_k', inputs={'X': input},
                     outputs={'Out': values, 'Indices': indices},
                     attrs={'k': k})
    acc_out = helper.create_variable_for_type_inference('float32')
    if correct is None:
        correct = helper.create_variable_for_type_inference('int32')
    if total is None:
        total = helper.create_variable_for_type_inference('int32')
    helper.append_op(type='accuracy',
                     inputs={'Out': values, 'Indices': indices,
                             'Label': label},
                     outputs={'Accuracy': acc_out, 'Correct': correct,
                              'Total': total}, attrs={})
    return acc_out
