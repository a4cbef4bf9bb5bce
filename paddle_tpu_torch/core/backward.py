"""Autodiff on the Program.

Counterpart of paddle_tpu/core/backward.py: `append_backward` inserts one
`__backward__` op after the loss, with a `<param>@GRAD` variable per
differentiated parameter and the loss's own `@GRAD`.  The executor runs it
as `torch.autograd.grad` over the forward ops before it (core/executor.py),
as the JAX package runs it as `jax.vjp` over the traced forward prefix.
"""
from . import framework
from .framework import Variable, OpRole

__all__ = ['append_backward']

GRAD_SUFFIX = '@GRAD'


def _grad_name(name):
    return name + GRAD_SUFFIX


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append a backward pass for `loss`; returns [(param, grad), ...]."""
    if not isinstance(loss, Variable):
        raise TypeError('loss must be a Variable, got %r' % (loss,))
    block = loss.block
    root = block.program.global_block()

    if parameter_list is not None:
        params = [root.var(p if isinstance(p, str) else p.name)
                  for p in parameter_list]
    else:
        params = [p for p in root.all_parameters() if p.trainable]
    no_grad = {n.name if isinstance(n, Variable) else n
               for n in (no_grad_set or [])}
    params = [p for p in params if p.name not in no_grad]
    if not params:
        raise ValueError('append_backward: no trainable parameters found')

    with framework.op_role_guard(OpRole.Backward):
        grad_vars = [root.create_var(name=_grad_name(p.name), shape=p.shape,
                                     dtype=p.dtype, persistable=False,
                                     stop_gradient=True) for p in params]
        loss_grad = root.create_var(name=_grad_name(loss.name),
                                    shape=loss.shape, dtype=loss.dtype,
                                    stop_gradient=True)
        block.append_op(
            type='__backward__',
            inputs={'Loss': loss},
            outputs={'Grads': grad_vars, 'LossGrad': loss_grad},
            attrs={'params': [p.name for p in params]},
            infer_shape=False)
    return [(p, root.var(_grad_name(p.name))) for p in params]
