"""Learning-rate schedules, built as graph ops on the step counter.

Counterpart of paddle_tpu/layers/learning_rate_scheduler.py; the training
slice ports `noam_decay`.  The schedule runs in the step, keyed off the
persistable `@LR_DECAY_COUNTER@` (int64, computed as int32 on the device,
starting at 1 and incremented each run).
"""
from . import nn
from . import tensor
from .nn import autoincreased_step_counter

__all__ = ['noam_decay']


def _decay_step_counter(begin=0):
    global_step = autoincreased_step_counter(
        counter_name='@LR_DECAY_COUNTER@', begin=begin, step=1)
    return tensor.cast(global_step, 'float32')


def noam_decay(d_model, warmup_steps):
    global_step = _decay_step_counter(1)
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    return (d_model ** -0.5) * nn.elementwise_min(a, b)
