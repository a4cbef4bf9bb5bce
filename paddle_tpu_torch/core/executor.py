"""Scope + Executor: an op-by-op interpreter on an explicit device.

Counterpart of paddle_tpu/core/executor.py.  The JAX package traces a whole
block into one jitted XLA executable (`_lower`); the port runs the block's
ops one after another on the device, as the JAX package's
`_exec_ops_plain` does inside its trace, each op's impl launching its
kernels on the current stream.  Ops whose outputs nothing reads or keeps
are skipped, as XLA's dead-code elimination drops them from the
executable, and each intermediate is freed after its last reader.

`run` first hands the program to the rewriter (core/passes,
`maybe_optimize`, on unless PT_OPT=0) and interprets the optimized twin,
as the reference lowers it: dead ops go, constant chains fold, and runs
of elementwise, layout, dropout, row-reduction and optimizer ops become
`fused_elementwise` ops (ops/fused.py).  On the card, before a program's
first run at a feed shape, a planning pass runs its ops on `meta` tensors
so that every fused op builds its generated-kernel plan
(ops/kernelgen), and the generated CUDA source of all of them compiles
in one `nvcc` call at the first launch.

A program without `__backward__` runs under `torch.inference_mode()`.  A
training program runs the ops before `__backward__` under autograd, with
each differentiated parameter a leaf tensor sharing the scope's storage,
takes `torch.autograd.grad` of the loss (the JAX package's `jax.vjp`), and
runs the ops after it (the optimizer) under `torch.no_grad()`.  With the
passes off (PT_OPT=0), a maximal run of consecutive in-place `adam` ops
goes to one multi-tensor kernel launch (ops/optimizer_ops.py::adam_multi),
standing in for the fuse pass, which turns them into one fused group.

Not ported yet: control flow, executables / CUDA graphs (`run_steps`),
compile caching, check_nan, recompute scopes.
"""
import contextlib
import itertools

import numpy as np
import torch

from . import passes, registry
from .amp import amp_sub_ins, amp_sub_outs
from .dtypes import torch_dtype
from .framework import (CPUPlace, CUDAPlace, Variable, default_main_program,
                        require_cuda)

_BACKWARD_OP = '__backward__'
_FUSED_OP = 'fused_elementwise'

__all__ = ['Executor', 'Scope', 'scope_guard', 'global_scope']


class Scope(object):
    """name -> tensor holder for persistable variables."""

    def __init__(self):
        self.vars = {}

    def set(self, name, value):
        self.vars[name] = value

    def get(self, name):
        return self.vars[name]

    def keys(self):
        return self.vars.keys()

    def __contains__(self, name):
        return name in self.vars


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


def to_device(value, dtype_name, device):
    """A host value (numpy array, scalar) as a tensor on `device`, 64-bit
    dtypes narrowed to 32 bits as the JAX package computes them."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        a = np.ascontiguousarray(np.asarray(value))
        if not a.flags.writeable:   # e.g. a view of a JAX array
            a = a.copy()
        t = torch.from_numpy(a)
    dt = torch_dtype(dtype_name if dtype_name is not None else t.dtype)
    return t.to(device=device, dtype=dt)


def to_numpy(t):
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _plan(ops, keep):
    """Which ops run and when each intermediate dies.

    -> (live, wanted, dead): `live` lists the indices of the ops some
    output of which is read by a later live op or kept (XLA's DCE);
    `wanted` is every name a live op reads plus `keep`; `dead[i]` names
    the values whose last reader is op i, freed right after it (XLA's
    buffer assignment)."""
    needed = set(keep)
    live = []
    for i in range(len(ops) - 1, -1, -1):
        op = ops[i]
        outs = op.output_names()
        if not outs or any(n in needed for n in outs):
            live.append(i)
            needed.update(op.input_names())
    live.reverse()
    last = {}
    for i in live:
        for n in ops[i].input_names():
            last[n] = i
        for n in ops[i].output_names():
            last.setdefault(n, i)
    dead = {}
    for n, i in last.items():
        if n not in keep:
            dead.setdefault(i, []).append(n)
    return live, needed, dead


def _adam_run(ops, live, k):
    """End (exclusive, in `live`) of the run of consecutive in-place adam
    ops starting at live[k] that share beta1/beta2/epsilon, or k when
    live[k] is no in-place adam op."""
    from ..ops.optimizer_ops import adam_group_key
    key = adam_group_key(ops[live[k]])
    if key is None:
        return k
    j = k
    while j < len(live) and adam_group_key(ops[live[j]]) == key:
        j += 1
    return j


def _exec_ops(ops, env, ectx, keep):
    amp = ectx.amp
    live, wanted, dead = _plan(ops, keep)
    grad_mode = torch.is_grad_enabled()
    k = 0
    while k < len(live):
        i = live[k]
        op = ops[i]
        j = _adam_run(ops, live, k) if op.type == 'adam' else k
        if j > k:
            from ..ops.optimizer_ops import run_adam_group
            run_adam_group([ops[live[x]] for x in range(k, j)], env, ectx)
            for x in range(k, j):
                for n in dead.get(live[x], ()):
                    env.pop(n, None)
            k = j
            continue
        impl = registry.get_op(op.type)
        ins = {}
        for slot, names in op.inputs.items():
            vals = [env[n] for n in names]
            ins[slot] = vals if op.input_is_list[slot] else vals[0]
        ins = amp_sub_ins(op.type, ins, amp)
        outs = impl(ectx.for_op(i, op, wanted), ins, op.attrs) or {}
        outs = amp_sub_outs(op.type, op.attrs, outs, amp)
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            for name, val in zip(names, vals):
                if val is None:
                    continue
                if grad_mode and val.requires_grad:
                    # lax.stop_gradient on stop_gradient vars, as the
                    # JAX package's trace loop does
                    var = op.block._find_var_recursive(name)
                    if var is not None and var.stop_gradient:
                        val = val.detach()
                env[name] = val
        for n in dead.get(i, ()):
            env.pop(n, None)
        k += 1


def _run_backward(ops, bw_idx, env, ectx, keep):
    """The training step: forward under autograd, `torch.autograd.grad`
    of the loss w.r.t. the `__backward__` op's params, then the ops after
    it under no_grad.  Parameters are leaf tensors that share storage
    with the scope's, so the optimizer's in-place updates land there."""
    bw_op = ops[bw_idx]
    pnames = bw_op.attrs['params']
    loss_name = bw_op.inputs['Loss'][0]
    missing = [p for p in pnames if p not in env]
    if missing:
        raise ValueError(
            '__backward__ wrt non-leaf vars %s not supported yet; '
            'differentiate wrt parameters or feed vars' % missing)
    originals = {p: env[p] for p in pnames}
    leaves = {p: t.detach().requires_grad_(True)
              for p, t in originals.items()}
    post = ops[bw_idx + 1:]
    fw_keep = set(keep) | {loss_name}
    for op in post:
        fw_keep.update(op.input_names())
    with torch.enable_grad():
        env.update(leaves)
        _exec_ops(ops[:bw_idx], env, ectx, fw_keep)
        if loss_name not in env:
            raise ValueError('loss var %s not produced before backward'
                             % loss_name)
        loss = env[loss_name]
        grads = torch.autograd.grad(
            loss, [leaves[p] for p in pnames],
            grad_outputs=torch.ones_like(loss), allow_unused=True)
    env.update(originals)
    for p, gname, g in zip(pnames, bw_op.outputs.get('Grads', []), grads):
        env[gname] = g if g is not None else torch.zeros_like(originals[p])
    for name in bw_op.outputs.get('LossGrad', []):
        env[name] = torch.ones_like(loss.detach())
    env[loss_name] = loss.detach()
    with torch.no_grad():
        _exec_ops(post, env, ectx, keep)


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device='meta')


def _plan_kernels(ops, env, amp):
    """Run `ops` on `meta` tensors shaped like `env`'s, so that each
    fused_elementwise op builds its generated-kernel plan for the card
    (ops/fused.py): all of them are known before the first launch, which
    compiles their sources in one nvcc call.  `__backward__` only gives
    each gradient its parameter's shape."""
    menv = {n: _meta(t) for n, t in env.items()}
    for op in ops:
        if op.type == _BACKWARD_OP:
            for p, g in zip(op.attrs['params'], op.outputs.get('Grads', [])):
                if p in menv:
                    menv[g] = menv[p]
            for n in op.outputs.get('LossGrad', []):
                menv[n] = menv.get(op.inputs['Loss'][0])
            continue
        if any(n not in menv for n in op.input_names()):
            continue
        ins = {}
        for slot, names in op.inputs.items():
            vals = [menv[n] for n in names]
            ins[slot] = vals if op.input_is_list[slot] else vals[0]
        ctx = registry.InferCtx(op, amp=amp, plan_device='cuda')
        outs = registry.get_op(op.type)(ctx, amp_sub_ins(op.type, ins, amp),
                                        op.attrs) or {}
        outs = amp_sub_outs(op.type, op.attrs, outs, amp)
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            for name, val in zip(names, vals):
                if val is not None:
                    menv[name] = val


class Executor(object):
    """Runs a Program's global block on `place`'s device.

    place=None means CUDAPlace(0): with no CUDA device that raises instead
    of carrying on on the CPU.  The tests pass CPUPlace()."""

    def __init__(self, place=None):
        if place is None:
            require_cuda('Executor()')
            place = CUDAPlace(0)
        if not isinstance(place, (CPUPlace, CUDAPlace)):
            raise TypeError('Executor place must be CPUPlace or CUDAPlace, '
                            'got %r' % (place,))
        self.place = place
        self.device = place.device
        self._run_counter = itertools.count()
        # device-side tables impls keep between runs (ops/optimizer_ops.py)
        self._kernel_cache = {}
        # (program, feed signature) pairs whose kernels are planned
        self._planned = set()

    def _feed_tensors(self, block, feed):
        out = {}
        for name, value in (feed or {}).items():
            if not block.has_var(name):
                raise KeyError(
                    'feed var "%s" is not a variable of this program; data '
                    'vars: %s' % (name, sorted(n for n, v in block.vars.items()
                                                if v.is_data)))
            out[name] = to_device(value, block.var(name).dtype, self.device)
        return out

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True):
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        persistable = {n for b in program.blocks for n, v in b.vars.items()
                       if v.persistable}
        opt_program, _ = passes.maybe_optimize(program, fetch_names)
        ops = opt_program.global_block().ops
        bw_idx = next((i for i, op in enumerate(ops)
                       if op.type == _BACKWARD_OP), None)
        env = {}
        for name in persistable:
            if name in scope:
                val = scope.vars[name]
                if val.device != self.device:
                    raise ValueError(
                        'scope var %s lives on %s, the executor runs on %s'
                        % (name, val.device, self.device))
                if bw_idx is not None and val.is_inference():
                    # written by an inference-mode run (a startup): autograd
                    # and in-place updates outside that mode need a normal
                    # tensor; copied once, then the scope holds the copy
                    val = val.clone()
                env[name] = val
        feeds = self._feed_tensors(block, feed)
        env.update(feeds)
        amp = program._amp
        if self.device.type == 'cuda' and any(op.type == _FUSED_OP
                                              for op in ops):
            sig = (id(opt_program), opt_program._version, amp,
                   tuple((n, tuple(t.shape), t.dtype)
                         for n, t in sorted(feeds.items())))
            if sig not in self._planned:
                _plan_kernels(ops, env, amp)
                self._planned.add(sig)
        ectx = registry.ExecCtx(self.device, program.random_seed,
                                next(self._run_counter), self._kernel_cache,
                                amp)
        keep = persistable | set(fetch_names)
        if bw_idx is None:
            with torch.inference_mode():
                _exec_ops(ops, env, ectx, keep)
        else:
            _run_backward(ops, bw_idx, env, ectx, keep)
        for name in persistable:
            if name in env:
                scope.vars[name] = env[name]
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError('fetch vars %s were not computed by this program'
                           % missing)
        fetches = [env[n] for n in fetch_names]
        return [to_numpy(f) for f in fetches] if return_numpy else fetches
