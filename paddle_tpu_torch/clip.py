"""Gradient and error clipping, appended as ops that rewrite a gradient.

Counterpart of paddle_tpu/clip.py: ErrorClipByValue, GradientClipByValue,
GradientClipByNorm, GradientClipByGlobalNorm (with `group_name`),
set_gradient_clip and append_gradient_clip_ops, appending the same op
sequence.  Each clip writes its result back to the gradient's own name
(`Out` = the grad), which the executor's interpreter, its CUDA graphs and
`run_steps` run as a rebinding of that name.
"""
from .core.framework import op_role_guard, OpRole

__all__ = ['ErrorClipByValue', 'GradientClipByValue', 'GradientClipByNorm',
           'GradientClipByGlobalNorm', 'set_gradient_clip',
           'append_gradient_clip_ops']


class BaseErrorClipAttr(object):
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class BaseGradientClipAttr(object):
    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _create_operators(self, param, grad):
        grad.block.append_op(type='clip', inputs={'X': grad},
                             outputs={'Out': grad},
                             attrs={'min': self.min, 'max': self.max})
        return param, grad


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        grad.block.append_op(type='clip_by_norm', inputs={'X': grad},
                             outputs={'Out': grad},
                             attrs={'max_norm': self.clip_norm})
        return param, grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale every gradient of a group by clip_norm / max(global norm,
    clip_norm), the global norm taken over the whole group."""

    def __init__(self, clip_norm, group_name='default_group'):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        context.setdefault(self.group_name, []).append((param, grad, self))

    @staticmethod
    def _create_group_operators(group):
        from .layers import nn as nn_layers
        from .layers import ops as ops_layers
        from .layers import tensor as tensor_layers
        clip_norm = group[0][2].clip_norm
        sq_sums = [nn_layers.reduce_sum(ops_layers.square(g))
                   for _, g, _ in group]
        global_norm = ops_layers.sqrt(tensor_layers.sums(sq_sums))
        cn = tensor_layers.fill_constant([1], 'float32', clip_norm)
        scale = cn / nn_layers.elementwise_max(global_norm, cn)
        out = []
        for p, g, _ in group:
            g.block.append_op(type='elementwise_mul',
                              inputs={'X': g, 'Y': scale},
                              outputs={'Out': g}, attrs={'axis': -1})
            out.append((p, g))
        return out


def set_gradient_clip(clip, param_list=None, program=None):
    """Give `clip` to every parameter of `param_list` (names or
    Parameters; default: all of the program's)."""
    from .core.framework import default_main_program
    program = program or default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    param_list = [program.global_block().var(p) if isinstance(p, str) else p
                  for p in param_list]
    for p in param_list:
        p.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    """The clip ops of every (param, grad) whose parameter has a clip
    attr; the global-norm groups after the per-parameter clips, in the
    order their first member appeared."""
    res = []
    context = {}
    with op_role_guard(OpRole.Backward):
        for p, g in param_grads:
            clip = getattr(p, 'gradient_clip_attr', None)
            if clip is None:
                res.append((p, g))
            elif isinstance(clip, GradientClipByGlobalNorm):
                clip._process_context(context, p, g)
            else:
                res.append(clip._create_operators(p, g))
        for group in context.values():
            res.extend(
                GradientClipByGlobalNorm._create_group_operators(group))
    return res
