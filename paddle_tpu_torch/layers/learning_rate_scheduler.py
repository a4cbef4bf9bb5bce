"""Learning-rate schedules, built as graph ops on the step counter.

Counterpart of paddle_tpu/layers/learning_rate_scheduler.py, op for op.
Each schedule runs in the step, keyed off the persistable
`@LR_DECAY_COUNTER@` (int64, computed as int32 on the device, starting at
`begin` and incremented each run), so a captured CUDA graph recomputes
the rate at every replay: its ops are fusable, and the optimizer kernels
read the rate through a device pointer.
"""
import math

from . import nn
from . import ops
from . import tensor
from .nn import autoincreased_step_counter

__all__ = ['exponential_decay', 'natural_exp_decay', 'inverse_time_decay',
           'polynomial_decay', 'piecewise_decay', 'noam_decay',
           'cosine_decay', 'append_LARS', 'linear_lr_warmup']


def _decay_step_counter(begin=0):
    global_step = autoincreased_step_counter(
        counter_name='@LR_DECAY_COUNTER@', begin=begin, step=1)
    return tensor.cast(global_step, 'float32')


def noam_decay(d_model, warmup_steps):
    global_step = _decay_step_counter(1)
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    return (d_model ** -0.5) * nn.elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate * (decay_rate ** div_res)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate * ops.exp(-1 * decay_rate * div_res)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate / (1 + decay_rate * div_res)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(global_step / decay_steps)
        one_var = tensor.fill_constant(shape=[1], dtype='float32', value=1.0)
        # max(div_res, 1) when step == 0
        div_res = nn.elementwise_max(div_res, one_var)
        decay_steps_var = decay_steps * div_res
    else:
        decay_steps_var = tensor.fill_constant(
            shape=[1], dtype='float32', value=float(decay_steps))
        global_step = nn.elementwise_min(global_step, decay_steps_var)
    frac = (1 - global_step / decay_steps_var) ** power
    return (learning_rate - end_learning_rate) * frac + end_learning_rate


def piecewise_decay(boundaries, values):
    """lr = values[i] for step in (boundaries[i-1], boundaries[i]]."""
    assert len(values) - len(boundaries) == 1
    global_step = _decay_step_counter()
    # piecewise via sum of indicator windows (branch-free, XLA-friendly)
    prev = None
    pieces = []
    for i, b in enumerate(boundaries):
        bvar = tensor.fill_constant([1], 'float32', float(b))
        ind = tensor.cast(global_step < bvar, 'float32')
        if prev is None:
            w = ind
        else:
            w = ind - prev
        pieces.append(w * values[i])
        prev = ind
    last = 1.0 - prev if prev is not None else 1.0
    out = pieces[0]
    for p in pieces[1:]:
        out = out + p
    out = out + last * values[-1]
    return out


def cosine_decay(learning_rate, step_each_epoch, epochs):
    global_step = _decay_step_counter()
    cur_epoch = ops.floor(global_step / step_each_epoch)
    return learning_rate * 0.5 * (
        ops.cos(cur_epoch * (math.pi / epochs)) + 1)


def append_LARS(params_grads, learning_rate, weight_decay):
    raise NotImplementedError(
        'use optimizer.LarsMomentumOptimizer')


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    global_step = _decay_step_counter()
    ws = tensor.fill_constant([1], 'float32', float(warmup_steps))
    warm = tensor.cast(global_step < ws, 'float32')
    warm_lr = start_lr + (end_lr - start_lr) * (global_step / ws)
    if not hasattr(learning_rate, 'block'):
        learning_rate = tensor.fill_constant([1], 'float32',
                                             float(learning_rate))
    return warm * warm_lr + (1.0 - warm) * learning_rate
