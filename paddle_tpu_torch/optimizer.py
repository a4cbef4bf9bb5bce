"""Optimizers: program transforms that append backward and update ops.

Counterpart of paddle_tpu/optimizer.py; the port has `Optimizer`,
`AdamOptimizer` / `Adam` and `MomentumOptimizer` / `Momentum`.
`minimize(loss)` appends the `__backward__` op (core/backward.py), the
gradient clips (clip.py), the weight decay (regularizer.py) and one
`adam` or `momentum` op per parameter, with the same accumulators, names
and attrs as the JAX package.  The consecutive update ops run as one
multi-tensor kernel launch (ops/optimizer_ops.py).
"""
from .core import unique_name
from .core.backward import append_backward
from .core.framework import (Variable, default_main_program, op_role_guard,
                             OpRole)
from .clip import append_gradient_clip_ops
from .initializer import Constant
from .regularizer import append_regularization_ops

__all__ = ['Optimizer', 'Adam', 'AdamOptimizer', 'Momentum',
           'MomentumOptimizer']


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = {}
        self.helper = None

    # ----------------------------------------------------------- LR

    def _create_global_learning_rate(self):
        prog = default_main_program()
        if self._learning_rate_map.get(prog) is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[prog] = self._learning_rate
            return
        from .layers.tensor import create_global_var
        lr_var = create_global_var(
            name=unique_name.generate('learning_rate'),
            shape=[1], value=float(self._learning_rate), dtype='float32',
            persistable=True)
        lr_var.stop_gradient = True
        self._learning_rate_map[prog] = lr_var

    def _global_learning_rate(self, program=None):
        return self._learning_rate_map.get(program or default_main_program())

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = param.optimize_attr.get('learning_rate', 1.0)
        lr_var = self._global_learning_rate()
        if param_lr == 1.0:
            return lr_var
        block = default_main_program().global_block()
        out = block.create_var(dtype='float32')
        block.append_op(type='scale', inputs={'X': lr_var},
                        outputs={'Out': out},
                        attrs={'scale': float(param_lr), 'bias': 0.0,
                               'bias_after_scale': True})
        return out

    # ----------------------------------------------------- accumulators

    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if (name, param.name) in self._accumulators:
            return self._accumulators[(name, param.name)]
        block = default_main_program().global_block()
        shape = list(shape if shape is not None else param.shape)
        var = block.create_var(
            name=unique_name.generate('%s_%s' % (param.name, name)),
            shape=shape, dtype=dtype or param.dtype, persistable=True,
            stop_gradient=True)
        Constant(value=float(fill_value))(var)
        self._accumulators[(name, param.name)] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[(name, param.name)]

    # ------------------------------------------------------- pipeline

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        if not params_grads:
            return []
        # clip, then decay, then the updates: the reference's order
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        block = params_grads[0][0].block
        with op_role_guard(OpRole.Optimize):
            self._create_global_learning_rate()
            self._create_accumulators(
                block, [p for p, g in params_grads if g is not None])
            optimize_ops = []
            for pg in params_grads:
                if pg[1] is None or not pg[0].trainable:
                    continue
                optimize_ops.append(self._append_optimize_op(block, pg))
            self._finish_update(block, params_grads)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False):
        super(AdamOptimizer, self).__init__(learning_rate, regularization,
                                            name)
        self.type = 'adam'
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('moment1', p)
            self._add_accumulator('moment2', p)
            self._add_accumulator('beta1_pow_acc', p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator('beta2_pow_acc', p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        m1 = self._get_accumulator('moment1', p)
        m2 = self._get_accumulator('moment2', p)
        b1p = self._get_accumulator('beta1_pow_acc', p)
        b2p = self._get_accumulator('beta2_pow_acc', p)
        return block.append_op(
            type='adam',
            inputs={'Param': p, 'Grad': param_and_grad[1],
                    'LearningRate': self._create_param_lr(param_and_grad),
                    'Moment1': m1, 'Moment2': m2,
                    'Beta1Pow': b1p, 'Beta2Pow': b2p},
            outputs={'ParamOut': p, 'Moment1Out': m1, 'Moment2Out': m2,
                     'Beta1PowOut': b1p, 'Beta2PowOut': b2p},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon},
            infer_shape=False)


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super(MomentumOptimizer, self).__init__(learning_rate,
                                                regularization, name)
        self.type = 'momentum'
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('velocity', p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator('velocity', param_and_grad[0])
        return block.append_op(
            type='momentum',
            inputs={'Param': param_and_grad[0], 'Grad': param_and_grad[1],
                    'Velocity': velocity,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': param_and_grad[0],
                     'VelocityOut': velocity},
            attrs={'mu': self._momentum,
                   'use_nesterov': self._use_nesterov},
            infer_shape=False)


Adam = AdamOptimizer
Momentum = MomentumOptimizer
