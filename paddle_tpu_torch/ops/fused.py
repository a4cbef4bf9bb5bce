"""fused_elementwise: one op that runs a serialized elementwise sub-program
(built by core/passes/fuse.py).

Counterpart of paddle_tpu/ops/fused.py.  The op's attrs carry the run:
  sub_ops    [{type, inputs, outputs, input_is_list, output_is_list,
               attrs, stop_grad}], the original ops in original order
  arg_names  ordered external input names (bound from the 'X' slot)
  out_names  ordered escaping output names (returned in the 'Out' slot)

On a CUDA tensor the op runs its generated kernels
(ops/kernelgen.run_fused) and nothing else: a sub-op without a kernel rule
raises there.  On a CPU tensor it replays each sub-op through its own
registered impl, in order: the plain version of the generated kernels,
which the CPU tests compare with the JAX package.  The replay applies the
executor's per-op policy to each sub-op: the AMP casts (core/amp.py),
per-output stop_gradient, and random streams (`ctx.sub_ctx(sub)` draws
from the sub-op's own pinned `rng_stream`), so it computes what the
unfused ops compute.
"""
from ..core.amp import amp_sub_ins, amp_sub_outs
from ..core.registry import get_op, register

__all__ = ['run_sub_op', 'replay']


def run_sub_op(ctx, sub, env, amp):
    """Run one serialized sub-op on the values in `env`, in place."""
    ins = {}
    for slot, names in sub['inputs'].items():
        vals = [env[n] for n in names]
        ins[slot] = vals if sub['input_is_list'].get(slot) else vals[0]
    ins = amp_sub_ins(sub['type'], ins, amp)
    outs = get_op(sub['type'])(ctx.sub_ctx(sub), ins, sub['attrs']) or {}
    outs = amp_sub_outs(sub['type'], sub['attrs'], outs, amp)
    stop = set(sub.get('stop_grad') or ())
    for slot, names in sub['outputs'].items():
        vals = outs.get(slot)
        if vals is None:
            continue
        vals = vals if isinstance(vals, (list, tuple)) else [vals]
        for name, val in zip(names, vals):
            if val is None:
                continue
            if name in stop and val.requires_grad:
                val = val.detach()
            env[name] = val


def replay(ctx, xs, attrs, amp):
    """The plain version: every sub-op through its registered impl."""
    env = dict(zip(attrs['arg_names'], xs))
    for sub in attrs['sub_ops']:
        run_sub_op(ctx, sub, env, amp)
    return [env[n] for n in attrs['out_names']]


@register('fused_elementwise')
def fused_elementwise(ctx, ins, attrs):
    from . import kernelgen
    xs = ins.get('X', [])
    xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    amp = bool(getattr(ctx, 'amp', False))
    device = xs[0].device if xs else ctx.device
    if device.type == 'meta' and getattr(ctx, 'plan_device', None) == 'cuda':
        # the executor's planning pass: build the card's plan now, so
        # every generated kernel compiles in one nvcc call
        kernelgen.plan_for(attrs, kernelgen.avals_of(xs), amp)
    if device.type == 'cuda':
        return {'Out': kernelgen.run_fused(ctx, xs, attrs, amp)}
    if device.type in ('cpu', 'meta'):
        return {'Out': replay(ctx, xs, attrs, amp)}
    raise RuntimeError('fused_elementwise: no kernels for device %s'
                       % device)

