"""Weight-decay regularizers, appended as ops that rewrite a gradient.

Counterpart of paddle_tpu/regularizer.py: L1Decay, L2Decay and
append_regularization_ops.  A parameter's own `ParamAttr(regularizer=)`
comes before the optimizer's `regularization=`.
"""
from .core.framework import op_role_guard, OpRole

__all__ = ['L1Decay', 'L2Decay', 'L1DecayRegularizer', 'L2DecayRegularizer',
           'append_regularization_ops']


class WeightDecayRegularizer(object):
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad += coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(dtype=param.dtype)
        block.append_op(type='scale', inputs={'X': param},
                        outputs={'Out': decay},
                        attrs={'scale': self._regularization_coeff,
                               'bias': 0.0, 'bias_after_scale': True})
        block.append_op(type='elementwise_add',
                        inputs={'X': grad, 'Y': decay},
                        outputs={'Out': grad}, attrs={'axis': -1})
        return grad


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad += coeff * sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype)
        block.append_op(type='sign', inputs={'X': param},
                        outputs={'Out': sign}, attrs={})
        decay = block.create_var(dtype=param.dtype)
        block.append_op(type='scale', inputs={'X': sign},
                        outputs={'Out': decay},
                        attrs={'scale': self._regularization_coeff,
                               'bias': 0.0, 'bias_after_scale': True})
        block.append_op(type='elementwise_add',
                        inputs={'X': grad, 'Y': decay},
                        outputs={'Out': grad}, attrs={'axis': -1})
        return grad


def append_regularization_ops(parameters_and_grads, regularization=None):
    params_and_grads = []
    with op_role_guard(OpRole.Backward):
        for param, grad in parameters_and_grads:
            if grad is None:
                params_and_grads.append((param, grad))
                continue
            regularization_term = param.regularizer or regularization
            if regularization_term is not None:
                regularization_term(param, grad, grad.block)
            params_and_grads.append((param, grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
