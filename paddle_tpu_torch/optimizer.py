"""Optimizers: program transforms that append backward and update ops.

Counterpart of paddle_tpu/optimizer.py: `Optimizer`, SGD, Momentum,
LarsMomentum, Adagrad, Adam, Adamax, DecayedAdagrad, Adadelta, RMSProp,
Ftrl (each `<Name>Optimizer` and `<Name>`) and ModelAverage.
`minimize(loss)` appends the `__backward__` op (core/backward.py), the
gradient clips (clip.py), the weight decay (regularizer.py) and one
update op per parameter, with the same accumulators, names and attrs as
the JAX package (Adamax also a `scale` of its Beta1Pow after each).  The
consecutive update ops of one type run as one multi-tensor kernel launch
(ops/optimizer_ops.py); lars_momentum, which the reference leaves to
XLA, runs as plain torch ops, one op a parameter.
"""
import contextlib

from .core import unique_name
from .core.backward import append_backward
from .core.framework import (Variable, default_main_program, op_role_guard,
                             OpRole)
from .clip import append_gradient_clip_ops
from .initializer import Constant
from .regularizer import append_regularization_ops

__all__ = [
    'SGD', 'Momentum', 'Adagrad', 'Adam', 'Adamax', 'DecayedAdagrad', 'Ftrl',
    'SGDOptimizer', 'MomentumOptimizer', 'AdagradOptimizer', 'AdamOptimizer',
    'AdamaxOptimizer', 'DecayedAdagradOptimizer', 'RMSPropOptimizer',
    'FtrlOptimizer', 'Adadelta', 'AdadeltaOptimizer', 'ModelAverage',
    'LarsMomentum', 'LarsMomentumOptimizer',
]


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


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        super(SGDOptimizer, self).__init__(learning_rate, regularization,
                                           name)
        self.type = 'sgd'

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type='sgd',
            inputs={'Param': param_and_grad[0], 'Grad': param_and_grad[1],
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': param_and_grad[0]}, attrs={},
            infer_shape=False)


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        super(LarsMomentumOptimizer, self).__init__(learning_rate,
                                                    regularization, name)
        self.type = 'lars_momentum'
        self._momentum = momentum
        self._lars_coeff = float(lars_coeff)
        self._lars_weight_decay = float(lars_weight_decay)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('velocity', p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator('velocity', param_and_grad[0])
        return block.append_op(
            type='lars_momentum',
            inputs={'Param': param_and_grad[0], 'Grad': param_and_grad[1],
                    'Velocity': velocity,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': param_and_grad[0],
                     'VelocityOut': velocity},
            attrs={'mu': self._momentum, 'lars_coeff': self._lars_coeff,
                   'lars_weight_decay': self._lars_weight_decay},
            infer_shape=False)


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        super(AdagradOptimizer, self).__init__(learning_rate, regularization,
                                               name)
        self.type = 'adagrad'
        self._epsilon = epsilon
        self._initial_accumulator_value = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('moment', p,
                                  fill_value=self._initial_accumulator_value)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator('moment', param_and_grad[0])
        return block.append_op(
            type='adagrad',
            inputs={'Param': param_and_grad[0], 'Grad': param_and_grad[1],
                    'Moment': moment,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': param_and_grad[0], 'MomentOut': moment},
            attrs={'epsilon': self._epsilon}, infer_shape=False)


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super(AdamaxOptimizer, self).__init__(learning_rate, regularization,
                                              name)
        self.type = 'adamax'
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('moment', p)
            self._add_accumulator('inf_norm', p)
            self._add_accumulator('beta1_pow_acc', p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment = self._get_accumulator('moment', p)
        inf_norm = self._get_accumulator('inf_norm', p)
        b1p = self._get_accumulator('beta1_pow_acc', p)
        op = block.append_op(
            type='adamax',
            inputs={'Param': p, 'Grad': param_and_grad[1],
                    'LearningRate': self._create_param_lr(param_and_grad),
                    'Moment': moment, 'InfNorm': inf_norm, 'Beta1Pow': b1p},
            outputs={'ParamOut': p, 'MomentOut': moment,
                     'InfNormOut': inf_norm},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon},
            infer_shape=False)
        # bump beta1^t
        block.append_op(type='scale', inputs={'X': b1p},
                        outputs={'Out': b1p},
                        attrs={'scale': self._beta1, 'bias': 0.0,
                               'bias_after_scale': True},
                        infer_shape=False)
        return op


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super(DecayedAdagradOptimizer, self).__init__(
            learning_rate, regularization, name)
        self.type = 'decayed_adagrad'
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('moment', p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator('moment', param_and_grad[0])
        return block.append_op(
            type='decayed_adagrad',
            inputs={'Param': param_and_grad[0], 'Grad': param_and_grad[1],
                    'Moment': moment,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': param_and_grad[0], 'MomentOut': moment},
            attrs={'decay': self._decay, 'epsilon': self._epsilon},
            infer_shape=False)


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1.0e-6, rho=0.95,
                 regularization=None, name=None):
        super(AdadeltaOptimizer, self).__init__(learning_rate,
                                                regularization, name)
        self.type = 'adadelta'
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('_avg_squared_grad', p)
            self._add_accumulator('_avg_squared_update', p)

    def _append_optimize_op(self, block, param_and_grad):
        g = self._get_accumulator('_avg_squared_grad', param_and_grad[0])
        u = self._get_accumulator('_avg_squared_update', param_and_grad[0])
        return block.append_op(
            type='adadelta',
            inputs={'Param': param_and_grad[0], 'Grad': param_and_grad[1],
                    'AvgSquaredGrad': g, 'AvgSquaredUpdate': u},
            outputs={'ParamOut': param_and_grad[0], 'AvgSquaredGradOut': g,
                     'AvgSquaredUpdateOut': u},
            attrs={'epsilon': self._epsilon, 'rho': self._rho},
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1.0e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super(RMSPropOptimizer, self).__init__(learning_rate, regularization,
                                               name)
        self.type = 'rmsprop'
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('momentum', p)
            self._add_accumulator('mean_square', p)
            self._add_accumulator('mean_grad', p)

    def _append_optimize_op(self, block, param_and_grad):
        momentum_acc = self._get_accumulator('momentum', param_and_grad[0])
        mean_square_acc = self._get_accumulator('mean_square',
                                                param_and_grad[0])
        mean_grad_acc = self._get_accumulator('mean_grad', param_and_grad[0])
        outputs = {'ParamOut': param_and_grad[0],
                   'MomentOut': momentum_acc,
                   'MeanSquareOut': mean_square_acc}
        inputs = {'Param': param_and_grad[0], 'Grad': param_and_grad[1],
                  'Moment': momentum_acc, 'MeanSquare': mean_square_acc,
                  'LearningRate': self._create_param_lr(param_and_grad)}
        if self._centered:
            inputs['MeanGrad'] = mean_grad_acc
            outputs['MeanGradOut'] = mean_grad_acc
        return block.append_op(
            type='rmsprop', inputs=inputs, outputs=outputs,
            attrs={'epsilon': self._epsilon, 'decay': self._rho,
                   'momentum': self._momentum, 'centered': self._centered},
            infer_shape=False)


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super(FtrlOptimizer, self).__init__(learning_rate, regularization,
                                            name)
        self.type = 'ftrl'
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('squared', p)
            self._add_accumulator('linear', p)

    def _append_optimize_op(self, block, param_and_grad):
        sq = self._get_accumulator('squared', param_and_grad[0])
        lin = self._get_accumulator('linear', param_and_grad[0])
        return block.append_op(
            type='ftrl',
            inputs={'Param': param_and_grad[0], 'Grad': param_and_grad[1],
                    'SquaredAccumulator': sq, 'LinearAccumulator': lin,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': param_and_grad[0], 'SquaredAccumOut': sq,
                     'LinearAccumOut': lin},
            attrs={'l1': self._l1, 'l2': self._l2,
                   'lr_power': self._lr_power},
            infer_shape=False)


class ModelAverage(Optimizer):
    """Running parameter average with apply()/restore() (the reference's
    ModelAverage): an `elementwise_add` of each parameter into its `sum`
    accumulator and an `increment` of its `cnt` run inside the train
    step; apply() writes sum / max(cnt, 1) into each parameter's tensor in
    the scope, in place (a CUDA graph keeps its addresses), and restore()
    writes the saved values back."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super(ModelAverage, self).__init__(0.0, regularization, name)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = []
        self._avg_vars = {}
        prog = default_main_program()
        block = prog.global_block()
        with op_role_guard(OpRole.Optimize):
            for param in prog.global_block().all_parameters():
                if not param.do_model_average:
                    continue
                acc = self._add_accumulator('sum', param)
                cnt = self._add_accumulator('cnt', param, dtype='float32',
                                            fill_value=0.0, shape=[1])
                block.append_op(type='elementwise_add',
                                inputs={'X': acc, 'Y': param},
                                outputs={'Out': acc}, attrs={'axis': -1},
                                infer_shape=False)
                block.append_op(type='increment', inputs={'X': cnt},
                                outputs={'Out': cnt},
                                attrs={'step': 1.0}, infer_shape=False)
                self._avg_vars[param.name] = (acc, cnt)
        self._backup = {}

    def apply(self, executor, need_restore=True):
        import torch
        from .core.executor import global_scope

        @contextlib.contextmanager
        def cm():
            scope = global_scope()
            self._backup = {}
            with torch.no_grad():
                for pname, (acc, cnt) in self._avg_vars.items():
                    p = scope.get(pname)
                    self._backup[pname] = p.clone()
                    n = torch.clamp_min(scope.get(cnt.name), 1.0)
                    p.copy_(scope.get(acc.name) / n)
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)
        return cm()

    def restore(self, executor):
        import torch
        from .core.executor import global_scope
        scope = global_scope()
        with torch.no_grad():
            for pname, val in self._backup.items():
                scope.get(pname).copy_(val)
        self._backup = {}


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
RMSProp = RMSPropOptimizer
