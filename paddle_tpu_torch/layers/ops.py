"""Generated wrappers for simple unary ops.

Counterpart of paddle_tpu/layers/ops.py (`_make_unary`); the port holds
the three that gradient clipping and weight decay build: square, sqrt
and sign.
"""
from ..core.layer_helper import LayerHelper

__all__ = ['square', 'sqrt', 'sign']


def _make_unary(op_type):
    def func(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={'X': x},
                         outputs={'Out': out}, attrs={})
        return out
    func.__name__ = op_type
    func.__doc__ = 'Elementwise %s.' % op_type
    return func


square = _make_unary('square')
sqrt = _make_unary('sqrt')
sign = _make_unary('sign')
