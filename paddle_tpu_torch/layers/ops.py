"""Generated wrappers for simple unary ops.

Counterpart of paddle_tpu/layers/ops.py (`_make_unary`): every name of
the reference's `__all__`.  The unary wrappers carry a ragged input's LoD
level and lengths companion to their output, as the reference's do.
"""
from ..core.layer_helper import LayerHelper
from .nn import _copy_lod

__all__ = [
    'sigmoid', 'logsigmoid', 'exp', 'tanh', 'tanh_shrink', 'softshrink',
    'sqrt', 'rsqrt', 'abs', 'ceil', 'floor', 'cos', 'sin', 'round',
    'reciprocal', 'square', 'softplus', 'softsign', 'uniform_random',
    'cumsum', 'thresholded_relu', 'hard_shrink', 'sign', 'erf',
]


def _make_unary(op_type):
    def func(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={'X': x},
                         outputs={'Out': out}, attrs={})
        _copy_lod(x, out)
        return out
    func.__name__ = op_type
    func.__doc__ = 'Elementwise %s.' % op_type
    return func


for _op in ['sigmoid', 'logsigmoid', 'exp', 'tanh', 'tanh_shrink', 'sqrt',
            'rsqrt', 'abs', 'ceil', 'floor', 'cos', 'sin', 'round',
            'reciprocal', 'square', 'softplus', 'softsign', 'sign', 'erf']:
    globals()[_op] = _make_unary(_op)


def _with_attr(op_type, x, attr, value, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={'X': x}, outputs={'Out': out},
                     attrs={attr: value})
    return out


def softshrink(x, alpha=None, name=None):
    return _with_attr('softshrink', x, 'lambda',
                      alpha if alpha is not None else 0.5, name)


def hard_shrink(x, threshold=None, name=None):
    return _with_attr('hard_shrink', x, 'threshold',
                      threshold if threshold is not None else 0.5, name)


def thresholded_relu(x, threshold=None, name=None):
    return _with_attr('thresholded_relu', x, 'threshold',
                      threshold if threshold is not None else 1.0, name)


def cumsum(x, axis=None, exclusive=None, reverse=None, name=None):
    helper = LayerHelper('cumsum', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='cumsum', inputs={'X': x}, outputs={'Out': out},
                     attrs={'axis': axis if axis is not None else -1,
                            'exclusive': bool(exclusive),
                            'reverse': bool(reverse)})
    return out


def uniform_random(shape, dtype='float32', min=-1.0, max=1.0, seed=0):
    helper = LayerHelper('uniform_random')
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='uniform_random', inputs={},
                     outputs={'Out': out},
                     attrs={'shape': list(shape), 'min': min, 'max': max,
                            'seed': seed, 'dtype': dtype})
    return out
