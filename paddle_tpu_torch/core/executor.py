"""Scope + Executor: an op-by-op interpreter on an explicit device, and
on the card each launch signature replayed as a captured CUDA graph.

Counterpart of paddle_tpu/core/executor.py.  The JAX package traces a whole
block into one XLA executable per launch signature (`_lower`,
`_resolve_entry`); the port interprets the block's ops one after another,
as the JAX package's `_exec_ops_plain` does inside its trace, each op's
impl launching its kernels on the current stream.  Ops whose outputs
nothing reads or keeps are skipped, as XLA's dead-code elimination drops
them, and each intermediate is freed after its last reader.

The interpreter first hands the program to the rewriter (core/passes,
`maybe_optimize`, on unless PT_OPT=0) and runs the optimized twin: dead
ops go, constant chains fold, and runs of elementwise, layout, dropout,
row-reduction and optimizer ops become `fused_elementwise` ops
(ops/fused.py).  On the card, before a program's first run at a feed
shape, a planning pass runs its ops on `meta` tensors so that every fused
op builds its generated-kernel plan (ops/kernelgen), and the generated
CUDA source of all of them compiles in one `nvcc` call.

A program without `__backward__` runs under `torch.inference_mode()`.  A
training program runs the ops before `__backward__` under autograd, with
each differentiated parameter a leaf tensor sharing the scope's storage,
takes `torch.autograd.grad` of the loss (the JAX package's `jax.vjp`), and
runs the ops after it (the optimizer) under `torch.no_grad()`.  With the
passes off (PT_OPT=0), a maximal run of consecutive in-place `adam` ops
goes to one multi-tensor kernel launch (ops/optimizer_ops.py::adam_multi),
and so does one of `momentum` ops (`momentum_multi`) and one of each
other update op of ops/optimizer_ops.py GROUPS (`optim_multi`: sgd,
adagrad, decayed_adagrad, adamax, adadelta, rmsprop, ftrl).

CUDA graphs (core/graphs.py) are the port's counterpart of the
reference's one executable per launch signature.  On the card, with
`use_program_cache=True` (the default), a signature's first run is the
interpreter on a side stream (it plans and builds every kernel: nvcc
never runs under capture), its second captures one step and replays it,
and every later run copies the feeds into the graph's static inputs,
seeds its generators and replays.  `run_steps(K)` uploads the stacked
feeds once and replays the one-step graph K times; there is no K-step
graph, so there is no ragged tail to split (the reference's
`PT_TAIL_SPLIT` has no counterpart).  `use_program_cache=False` keeps the
interpreter (the reference's "no cached executable"); on the CPU the
interpreter runs everything and `run_steps` is K runs.

Run counters are keyed, as the reference keys them, by (program, its
version, feed names, fetch names, scope): each such stream draws its own
dropout masks, `run` + `run_steps` consume one stream, and
`rng_state` / `set_rng_state` carry it across a restart.

`check_nan` (or FLAGS_check_nan_inf) adds one fused all-finite verdict
over the fetches and the persistables the program reads or writes,
computed inside the step (so inside the graph), after the write-back;
it is read every `nan_poll` steps (core/async_runtime.py) and a trip
names the culprits (`_raise_non_finite`).

A contiguous run of live ops that share a `recompute_id`
(`framework.recompute_scope`) runs as one group under
`torch.utils.checkpoint` when autograd records it (`_run_group`).

Not ported yet: control flow, the compile cache's disk tier, the lint
gate, `mesh=` (ROADMAP A7).
"""
import contextlib
import itertools
import os

import numpy as np
import torch

from . import async_runtime as _async
from . import passes, registry
from .amp import amp_sub_ins, amp_sub_outs
from .dtypes import torch_dtype
from .framework import (CPUPlace, CUDAPlace, Variable, default_main_program,
                        require_cuda)

_BACKWARD_OP = '__backward__'
_FUSED_OP = 'fused_elementwise'

__all__ = ['Executor', 'Scope', 'scope_guard', 'global_scope']

_ROADMAP_A7 = ('the parallel stack (mesh, data parallelism) is not ported '
               'yet: ROADMAP A7')


class Scope(object):
    """name -> tensor holder for persistable variables.  `_serial` tells
    scopes apart in the executor's run counters and graph entries (an id()
    could be reused)."""

    _serials = itertools.count(1)

    def __init__(self):
        self.vars = {}
        self._serial = next(Scope._serials)

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
        if a.dtype.name == 'bfloat16':  # ml_dtypes: numpy has no bf16
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
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


def _optimizer_run(ops, live, k):
    """(end, runner): the end (exclusive, in `live`) of the run of
    consecutive in-place optimizer ops of live[k]'s type that share its
    group key (every attribute the update reads: adam's betas and
    epsilon, momentum's mu and use_nesterov, ...; ops/optimizer_ops.py
    GROUPS), and the function that runs them as one multi-tensor launch;
    (k, None) when live[k] is no in-place optimizer op the executor
    groups.  An adamax run steps over the `scale` ops that bump its own
    ops' Beta1Pow (adamax_bump); the runner runs them after the launch."""
    from ..ops.optimizer_ops import GROUPS, adamax_bump
    key_of, runner = GROUPS.get(ops[live[k]].type, (None, None))
    key = key_of(ops[live[k]]) if key_of else None
    if key is None:
        return k, None
    j, run = k, []
    while j < len(live):
        op = ops[live[j]]
        if key_of(op) == key:
            run.append(op)
        elif not (op.type == 'scale' and run[0].type == 'adamax' and
                  adamax_bump(op, run)):
            break
        j += 1
    return j, runner


def _raise_if_capturing(ectx, what, e):
    """A CUDA graph capture that fails raises naming the op; it never
    falls back to eager runs (core/graphs.py)."""
    if ectx.device.type == 'cuda' and \
            torch.cuda.is_current_stream_capturing():
        from .graphs import CaptureError
        raise CaptureError('CUDA graph capture failed at op %s: %s: %s'
                           % (what, type(e).__name__, e)) from e


def _exec_ops(ops, env, ectx, keep):
    live, wanted, dead = _plan(ops, keep)
    grad_mode = torch.is_grad_enabled()
    k = 0
    while k < len(live):
        i = live[k]
        op = ops[i]
        rid = op.attrs.get('recompute_id')
        if rid is not None and grad_mode:
            j = k
            while j < len(live) and \
                    ops[live[j]].attrs.get('recompute_id') == rid:
                j += 1
            _run_group(ops, live[k:j], env, ectx, wanted, dead)
            k = j
            continue
        j, runner = _optimizer_run(ops, live, k)
        if j > k:
            try:
                runner([ops[live[x]] for x in range(k, j)], env, ectx)
            except Exception as e:
                _raise_if_capturing(ectx, '%s (%d ops from #%d)'
                                    % (op.type, j - k, i), e)
                raise
            for x in range(k, j):
                for n in dead.get(live[x], ()):
                    env.pop(n, None)
            k = j
            continue
        _run_op(op, i, env, ectx, wanted, grad_mode)
        for n in dead.get(i, ()):
            env.pop(n, None)
        k += 1


def _run_op(op, i, env, ectx, wanted, grad_mode):
    """One op (position `i`) over `env`: its impl on its AMP-cast inputs,
    its outputs bound into `env`."""
    amp = ectx.amp
    impl = registry.get_op(op.type)
    ins = {}
    for slot, names in op.inputs.items():
        vals = [env[n] for n in names]
        ins[slot] = vals if op.input_is_list[slot] else vals[0]
    ins = amp_sub_ins(op.type, ins, amp)
    try:
        outs = impl(ectx.for_op(i, op, wanted), ins, op.attrs) or {}
    except Exception as e:
        _raise_if_capturing(ectx, '#%d "%s"' % (i, op.type), e)
        raise
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


def _run_group(ops, idxs, env, ectx, wanted, dead):
    """The live ops at `idxs`, which share a recompute_id, as one group
    under `torch.utils.checkpoint` (the reference's `jax.checkpoint`
    group): its reads from outside go in, the values read after it (or
    kept) come out, and what the backward needs of the rest is computed
    again from the inputs instead of kept.  Inside the group, in the
    forward and in the recompute, each value is dropped after its last
    reader (`dead`), as the plain loop drops it: the group holds no more
    than the plain program does.

    The recompute runs each op as the forward ran it, at its own position
    `i`, so each draws from the generator of its own stream and run
    (`ctx.generator`: seeded afresh at every call, or under a CUDA graph
    the generator the capture registered for that request, seeded before
    each replay; core/graphs.py) and a dropout mask comes out the same.
    torch's default generators are not used by any op, so the checkpoint
    saves no RNG state (`preserve_rng_state=False`: that state cannot be
    read under a capture).  The recompute runs the whole group, not
    stopping early at the last value the backward needs: the same ops a
    step on every path (early stopping ends a recompute by raising an
    exception through the ops, which a capture would take for a failure).
    While the recompute runs, `ctx.recomputing` is true: an op that
    writes a persistable in place (batch_norm's moving statistics) writes
    it once, in the forward."""
    import torch.utils.checkpoint as checkpoint
    group = [ops[i] for i in idxs]
    reads, produced, writes = [], set(), []
    for op in group:
        for n in op.input_names():
            if n not in produced and n not in reads:
                reads.append(n)
        for n in op.output_names():
            produced.add(n)
            if n not in writes:
                writes.append(n)
    internal = set()
    for i in idxs:
        internal.update(dead.get(i, ()))
    outs = [n for n in writes if n not in internal]
    ext = [n for n in reads if n in env]
    calls = [0]

    def fn(*vals):
        genv = dict(zip(ext, vals))
        recomputing = calls[0] > 0
        calls[0] += 1
        ectx.recomputing = recomputing
        try:
            for i, op in zip(idxs, group):
                _run_op(op, i, genv, ectx, wanted, True)
                for n in dead.get(i, ()):
                    genv.pop(n, None)
        finally:
            ectx.recomputing = False
        return tuple(genv[n] for n in outs)

    with checkpoint.set_checkpoint_early_stop(False):
        res = checkpoint.checkpoint(fn, *[env[n] for n in ext],
                                    use_reentrant=False,
                                    preserve_rng_state=False)
    env.update(zip(outs, res))
    for n in internal:
        env.pop(n, None)


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
        try:
            grads = torch.autograd.grad(
                loss, [leaves[p] for p in pnames],
                grad_outputs=torch.ones_like(loss), allow_unused=True)
        except Exception as e:
            _raise_if_capturing(ectx, '#%d "%s"' % (bw_idx, _BACKWARD_OP), e)
            raise
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
    compiles their sources in one build.  `__backward__` only gives
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


class _Step(object):
    """What runs of one program at one fetch list share: its optimized
    twin's ops, where `__backward__` sits, the persistable names, and the
    ones the ops read or write (the reference's write-back set, which
    check_nan covers)."""
    __slots__ = ('program', 'ops', 'bw_idx', 'persistable', 'used',
                 'fetch_names', 'amp', 'has_fused')

    def __init__(self, program, fetch_names):
        self.program = program
        self.fetch_names = fetch_names
        self.persistable = {n for b in program.blocks
                            for n, v in b.vars.items() if v.persistable}
        opt_program, _ = passes.maybe_optimize(program, list(fetch_names))
        self.ops = opt_program.global_block().ops
        self.bw_idx = next((i for i, op in enumerate(self.ops)
                            if op.type == _BACKWARD_OP), None)
        touched = set()
        for op in self.ops:
            touched.update(op.input_names())
            touched.update(op.output_names())
            if op.type == _BACKWARD_OP:
                touched.update(op.attrs['params'])
        self.used = sorted(self.persistable & touched)
        self.amp = program._amp
        self.has_fused = any(op.type == _FUSED_OP for op in self.ops)


def all_finite(tensors):
    """One bool scalar on the device: every float element of `tensors` is
    finite.  Per dtype, one multi-tensor max-|x| (`_foreach_norm`, which
    carries a NaN through) over the group; no host sync."""
    groups = {}
    for t in tensors:
        if t.is_floating_point() and t.numel():
            groups.setdefault(t.dtype, []).append(t)
    ok = None
    for group in groups.values():
        norms = torch._foreach_norm(group, float('inf'))
        g_ok = torch.isfinite(torch.stack(norms)).all()
        ok = g_ok if ok is None else ok & g_ok
    if ok is None:
        dev = tensors[0].device if tensors else torch.device('cpu')
        ok = torch.ones((), dtype=torch.bool, device=dev)
    return ok


class Executor(object):
    """Runs a Program's global block on `place`'s device.

    place=None means CUDAPlace(0): with no CUDA device that raises instead
    of carrying on on the CPU.  The tests pass CPUPlace().

    check_nan (default: FLAGS_check_nan_inf in the environment) adds the
    fused all-finite verdict to every step; nan_poll (default:
    async_runtime.default_nan_poll(), PT_NAN_POLL / PT_ASYNC) is how many
    steps may pass before it is read.  `mesh=` raises: the parallel stack
    is ROADMAP A7."""

    def __init__(self, place=None, mesh=None, check_nan=None, nan_poll=None):
        if mesh is not None:
            raise NotImplementedError('Executor(mesh=...): ' + _ROADMAP_A7)
        if place is None:
            require_cuda('Executor()')
            place = CUDAPlace(0)
        if not isinstance(place, (CPUPlace, CUDAPlace)):
            raise TypeError('Executor place must be CPUPlace or CUDAPlace, '
                            'got %r' % (place,))
        self.place = place
        self.device = place.device
        if check_nan is None:
            check_nan = os.environ.get('FLAGS_check_nan_inf', '') in (
                '1', 'true', 'True')
        self.check_nan = bool(check_nan)
        self.nan_poll = _async.default_nan_poll() if nan_poll is None \
            else max(1, int(nan_poll))
        self._nan = _async.DeferredNanVerdict(self.nan_poll)
        # (program id, version, feed names, fetch names, scope serial) ->
        # the next run counter
        self._run_counter = {}
        # counters restored by set_rng_state before their stream ran in
        # this process: consumed at the first run of a matching (feed
        # names, fetch names) signature
        self._pending_counters = {}
        # device-side tables impls keep between runs (ops/optimizer_ops.py)
        self._kernel_cache = {}
        # (program, feed signature) pairs whose kernels are planned
        self._planned = set()
        # (program id, version, fetch names, PT_OPT config) -> _Step
        self._steps = {}
        # launch signature -> core/graphs.py GraphEntry (on the card)
        self._graphs = None

    def close(self):
        self._steps.clear()
        self._planned.clear()
        self._graphs = None
        self._nan.reset()

    # ------------------------------------------------ deferred nan verdict
    def nan_clean(self):
        """True when no launch verdict waits for a deferred poll, so that a
        checkpoint taken now cannot hold state a later poll condemns.
        Always True with check_nan off or nan_poll=1."""
        return not self.check_nan or self._nan.pending_steps == 0

    def poll_nan(self):
        """Read the deferred verdict now (end of an epoch, before an
        aligned checkpoint).  Raises the check_nan RuntimeError, with
        `nan_window_steps` set, if a launch since the last poll produced
        non-finite values.  No-op with check_nan off or nothing pending."""
        if not self.check_nan:
            return
        window = self._nan.poll()
        if window:
            e = RuntimeError(_async.DEFERRED_TRIP_MSG % window)
            e.nan_window_steps = window
            e.nan_window_start = self._nan.last_window_start
            raise e

    def reset_nan_window(self):
        """Drop pending verdicts unread: recovery calls this after a
        rollback, since verdicts over the poisoned stream say nothing of
        the restored state."""
        self._nan.reset()

    # ------------------------------------------------------ rng/run state
    @staticmethod
    def _stream_key(feed_names, fetch_names):
        return '|'.join(sorted(feed_names)) + '=>' + '|'.join(fetch_names)

    def rng_state(self):
        """JSON-able run-counter state, keyed by (feed names, fetch names):
        a program id and a scope serial do not survive a restart, the
        launch signature does.  A resumed run that restores it draws the
        masks the uninterrupted run would have drawn (a stream is a pure
        function of the program seed and the counter)."""
        out = {}
        for (_, _, feeds, fetch, _), v in self._run_counter.items():
            k = self._stream_key(feeds, fetch)
            out[k] = max(int(v), out.get(k, 0))
        for k, v in self._pending_counters.items():
            out.setdefault(k, int(v))
        return out

    def set_rng_state(self, state):
        """Restore counters taken by `rng_state`.  Live streams with a
        matching signature are overwritten (rollback in one process);
        unseen signatures are parked and consumed at their first run
        (resume in a fresh process).  A live stream absent from `state`
        had not run when it was taken, so it rewinds to 0."""
        state = {k: int(v) for k, v in (state or {}).items()}
        consumed = set()
        for key in list(self._run_counter):
            k = self._stream_key(key[2], key[3])
            if k in state:
                self._run_counter[key] = state[k]
                consumed.add(k)
            else:
                self._run_counter[key] = 0
        self._pending_counters = {k: v for k, v in state.items()
                                  if k not in consumed}

    def stream_counter(self, feed_names, fetch_names):
        """The next run counter a launch with these feed and fetch names
        would consume."""
        k = self._stream_key(tuple(feed_names), tuple(fetch_names))
        best = None
        for key, v in self._run_counter.items():
            if self._stream_key(key[2], key[3]) == k:
                best = int(v) if best is None else max(best, int(v))
        if best is None:
            best = int(self._pending_counters.get(k, 0))
        return best

    def _take_counters(self, program, feed_names, fetch_names, scope, steps):
        """The first of `steps` consecutive run counters of this launch's
        stream, which advances by `steps`."""
        key = (id(program), program._version, feed_names, fetch_names,
               scope._serial)
        counter = self._run_counter.get(key)
        if counter is None:
            counter = int(self._pending_counters.pop(
                self._stream_key(feed_names, fetch_names), 0)) \
                if self._pending_counters else 0
        self._run_counter[key] = counter + steps
        return counter

    # ------------------------------------------------------------ feeds
    def _feed_tensors(self, block, feed, stacked=False):
        out = {}
        for name, value in normalize_feed(block, feed, stacked).items():
            out[name] = to_device(value, block.var(name).dtype, self.device)
        return out

    @staticmethod
    def _fetch_names(fetch_list):
        names = []
        for f in fetch_list or []:
            if isinstance(f, Variable):
                names.append(f.name)
            elif isinstance(f, str):
                names.append(f)
            else:
                raise TypeError('bad fetch entry: %r' % (f,))
        return tuple(names)

    def _step_of(self, program, fetch_names):
        key = (id(program), program._version, fetch_names,
               passes.config_token())
        step = self._steps.get(key)
        if step is None or step.program is not program:
            step = self._steps[key] = _Step(program, fetch_names)
        return step

    # ---------------------------------------------------------- entries
    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True, use_program_cache=True, as_futures=False):
        """One step.  On the card with `use_program_cache` (the default)
        it runs through the signature's CUDA graph (core/graphs.py);
        `use_program_cache=False` keeps the interpreter.  `as_futures=True`
        returns async_runtime.FetchFuture handles, so the host never waits
        on the device here (`return_numpy` is then ignored)."""
        if program is None:
            program = default_main_program()
        if isinstance(program, _CompiledProgramBase):
            return program._run(self, feed, fetch_list, scope, return_numpy,
                                as_futures=as_futures)
        scope = scope if scope is not None else global_scope()
        feeds = self._feed_tensors(program.global_block(), feed)
        return self._run_impl(program, feeds, fetch_list, scope,
                              return_numpy, use_program_cache, None,
                              as_futures)

    def run_steps(self, program=None, feed_list=None, fetch_list=None,
                  steps=None, scope=None, return_numpy=True,
                  use_program_cache=True, as_futures=False):
        """Run `steps` training iterations in one call.

        feed_list: a list of K per-step feed dicts, or one dict whose
        arrays are stacked on a leading [K] axis (pass `steps` then: e.g.
        a superbatch of data_feeder.FeedPrefetcher).  The stacked feeds go
        to the device once.  On the card the signature's one-step CUDA
        graph is replayed K times, each replay copying step i's slice into
        its static inputs and its fetches into a [K, ...] buffer; on the
        CPU (or with use_program_cache=False) the interpreter runs K
        steps.  Either way the K steps consume K consecutive run counters
        of the stream `run` uses, so they equal K `run` calls bit for bit.
        Returns the fetches stacked per step, [K, ...] each (FetchFuture
        handles with `as_futures=True`)."""
        if program is None:
            program = default_main_program()
        if isinstance(program, _CompiledProgramBase):
            return program._run_steps(self, feed_list, fetch_list, steps,
                                      scope, return_numpy,
                                      as_futures=as_futures)
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        if isinstance(feed_list, dict):
            if steps is None:
                raise ValueError(
                    'run_steps with a pre-stacked feed dict needs steps=K')
            feeds = self._feed_tensors(block, feed_list, stacked=True)
            for k, v in feeds.items():
                if v.dim() == 0 or v.shape[0] != steps:
                    raise ValueError(
                        'stacked feed "%s" has leading dim %s, expected '
                        'steps=%d' % (k, v.shape[0] if v.dim() else None,
                                      steps))
        else:
            per_step = list(feed_list or [])
            if not per_step:
                raise ValueError('run_steps needs a non-empty feed_list')
            if steps is None:
                steps = len(per_step)
            elif steps != len(per_step):
                raise ValueError('steps=%d but feed_list has %d entries'
                                 % (steps, len(per_step)))
            names = set(per_step[0])
            for f in per_step[1:]:
                if set(f) != names:
                    raise ValueError('per-step feeds disagree on keys: '
                                     '%s vs %s' % (sorted(names), sorted(f)))
            per_step = [normalize_feed(block, f) for f in per_step]
            feeds = self._feed_tensors(block, {
                k: np.stack([_host(f[k]) for f in per_step])
                for k in per_step[0]}, stacked=True)
        return self._run_impl(program, feeds, fetch_list, scope,
                              return_numpy, use_program_cache, int(steps),
                              as_futures)

    def prepare(self, program=None, feed=None, fetch_list=None, scope=None):
        """Plan and build every kernel a signature needs without running a
        step: the rewriter's twin, each fused op's generated-kernel plan
        (from `feed`: name -> example array, or a (shape, dtype) spec),
        and on the card the nvcc builds of the generated and hand-written
        kernels.  It captures nothing: the signature's graph is captured
        at a real run (its second; the first is the interpreter's
        warm-up).  The reference's `steps=K` has no counterpart: the port
        replays one one-step graph for every K, so K needs nothing of its
        own.  The scope must hold the initialized persistables."""
        if program is None:
            program = default_main_program()
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        example = {}
        for k, v in (feed or {}).items():
            if isinstance(v, tuple) and len(v) == 2 and \
                    not hasattr(v, 'dtype'):
                shape, dtype = v
                v = torch.empty(tuple(int(d) for d in shape),
                                dtype=torch_dtype(dtype), device='meta')
            elif not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(_host(v)))
            if not block.has_var(k):
                raise KeyError('feed var "%s" is not a variable of this '
                               'program' % k)
            example[k] = _meta(v.to(dtype=torch_dtype(block.var(k).dtype))
                               if v.device.type != 'meta' else v)
        step = self._step_of(program, self._fetch_names(fetch_list))
        if self.device.type != 'cuda':
            return
        env = {n: scope.vars[n] for n in step.persistable if n in scope}
        env.update(example)
        if step.has_fused:
            _plan_kernels(step.ops, env, step.amp)
            sig = (id(step), step.amp, _feed_sig(example))
            self._planned.add(sig)
            from ..ops import kernelgen
            kernelgen.ensure_built()
        from .. import kernels
        kernels.library()

    def _run_impl(self, program, feeds, fetch_list, scope, return_numpy,
                  use_program_cache, steps, as_futures):
        fetch_names = self._fetch_names(fetch_list)
        feed_names = tuple(sorted(feeds))
        k = 1 if steps is None else steps
        counter = self._take_counters(program, feed_names, fetch_names,
                                      scope, k)
        step = self._step_of(program, fetch_names)
        graphed = use_program_cache and self.device.type == 'cuda'
        if graphed:
            entry = self._graph_entry(step, feeds, steps is not None, scope)
        outs = []
        for i in range(k):
            feeds_i = feeds if steps is None else \
                {n: t[i] for n, t in feeds.items()}
            if graphed:
                fetches, updates, ok = entry.run(feeds_i, counter + i, scope)
            else:
                fetches, updates, ok = self._interpret(
                    step, feeds_i, scope, counter + i)
            if steps is None:
                outs = fetches
            else:
                if i == 0:
                    outs = [torch.empty((k,) + tuple(f.shape),
                                        dtype=f.dtype, device=f.device)
                            for f in fetches]
                for buf, f in zip(outs, fetches):
                    buf[i].copy_(f)
            if ok is not None:
                # ANDed on the device into the running verdict, no sync
                self._nan.push(ok, start=counter + i)
        if graphed and steps is None and (as_futures or not return_numpy):
            # the graph's outputs are static: the next replay overwrites
            outs = [f.clone() for f in outs]
        if self.check_nan and self._nan.due():
            window = self._nan.poll()
            if window:
                self._raise_non_finite(
                    fetch_names, outs, {n: scope.vars[n] for n in updates},
                    window)
        if as_futures:
            return [_async.FetchFuture(f) for f in outs]
        if return_numpy:
            with _async.host_block('fetch_sync',
                                   extra_counter='executor.fetch_sync_s'):
                return [to_numpy(f) for f in outs]
        return outs

    def _graph_entry(self, step, feeds, stacked, scope):
        from . import graphs
        if self._graphs is None:
            self._graphs = graphs.GraphCache(self)
        feed_sig = tuple((n, tuple(t.shape[1:] if stacked else t.shape),
                          t.dtype) for n, t in sorted(feeds.items()))
        return self._graphs.entry(step, feed_sig, scope)

    # ------------------------------------------------------ interpreter
    def _interpret(self, step, feeds, scope, counter, res=None):
        """One step by the interpreter.  -> (fetches, names written back,
        all-finite verdict or None).  `res`: a CUDA graph entry's warm-up
        recorder (core/graphs.py), which draws the generators and makes
        the host uploads."""
        env = {}
        for name in step.persistable:
            if name in scope:
                val = scope.vars[name]
                if val.device != self.device:
                    raise ValueError(
                        'scope var %s lives on %s, the executor runs on %s'
                        % (name, val.device, self.device))
                if step.bw_idx is not None and val.is_inference():
                    # written by an inference-mode run (a startup): autograd
                    # and in-place updates outside that mode need a normal
                    # tensor; copied once, then the scope holds the copy
                    val = val.clone()
                env[name] = val
        env.update(feeds)
        if self.device.type == 'cuda' and step.has_fused:
            sig = (id(step), step.amp, _feed_sig(feeds))
            if sig not in self._planned:
                _plan_kernels(step.ops, env, step.amp)
                self._planned.add(sig)
        self._execute(step, env, counter, res)
        for name in step.persistable:
            if name in env:
                scope.vars[name] = env[name]
        fetches = _fetches(step, env)
        updates = [n for n in step.used if n in env]
        ok = all_finite(fetches + [env[n] for n in updates]) \
            if self.check_nan else None
        return fetches, updates, ok

    def _execute(self, step, env, counter, res=None):
        """The step's ops over `env` (persistables and feeds in it)."""
        ectx = registry.ExecCtx(
            self.device, step.program.random_seed, counter,
            self._kernel_cache, step.amp, res)
        keep = step.persistable | set(step.fetch_names)
        if step.bw_idx is None:
            with torch.inference_mode():
                _exec_ops(step.ops, env, ectx, keep)
        else:
            _run_backward(step.ops, step.bw_idx, env, ectx, keep)

    # ---------------------------------------------------------- check_nan
    def _raise_non_finite(self, fetch_names, fetches, updates, window):
        """A verdict poll tripped: name the culprits still visible in the
        latest launch's fetches and written-back persistables, with the
        window's size attached; if none shows there (possible when the
        window spans launches), raise the deferred-window message."""
        try:
            self._assert_finite(itertools.chain(
                zip(fetch_names, fetches), updates.items()))
        except RuntimeError as e:
            e.nan_window_steps = window
            e.nan_window_start = self._nan.last_window_start
            raise
        if window > 1:
            e = RuntimeError(_async.DEFERRED_TRIP_MSG % window)
            e.nan_window_steps = window
            e.nan_window_start = self._nan.last_window_start
            raise e

    @staticmethod
    def _assert_finite(named):
        bad = sorted(n for n, v in named
                     if v.is_floating_point() and not bool(
                         torch.isfinite(v).all()))
        if bad:
            raise RuntimeError(
                'check_nan: non-finite values (nan/inf) detected after this '
                'step in: %s. Typical causes: exploding gradients (try '
                'gradient clipping or a lower LR), log/div of zero, or '
                'uninitialized feeds.' % ', '.join(bad))


def normalize_feed(block, feed, stacked=False):
    """One feed dict -> {name: value}, as the JAX package's
    `_normalize_feed`: a LoDTensor (core/lod.py) feeds its padded data and
    `<name>@LENGTH` (and `<name>@OUTERLEN` where the block has it); a
    dense array fed into a lod var gets full lengths (its axis 1; axis 2
    when `stacked`, a run_steps feed with a leading step axis)."""
    from .lod import LENGTH_SUFFIX, OUTER_SUFFIX, LoDTensor
    out = {}
    for name, value in (feed or {}).items():
        if not block.has_var(name):
            raise KeyError(
                'feed var "%s" is not a variable of this program; data '
                'vars: %s' % (name, sorted(n for n, v in block.vars.items()
                                            if v.is_data)))
        if isinstance(value, LoDTensor):
            out[name] = value.padded
            out[name + LENGTH_SUFFIX] = value.lengths
            if value.outer_lengths is not None and \
                    block.has_var(name + OUTER_SUFFIX):
                out[name + OUTER_SUFFIX] = value.outer_lengths
        else:
            out[name] = value
    for name in list(out):
        lname = name + LENGTH_SUFFIX
        if block.has_var(name) and block.var(name).lod_level > 0 and \
                lname not in out and block.has_var(lname):
            shape = tuple(out[name].shape)
            lead, t = (shape[:2], shape[2]) if stacked else \
                (shape[:1], shape[1])
            out[lname] = np.full(lead, t, dtype=np.int32)
    return out


def _host(v):
    """A feed value as a numpy array (a CPU tensor as its numpy view)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy() if v.dtype != torch.bfloat16 \
            else v.detach().float().cpu().numpy()
    return np.asarray(v)


def _feed_sig(feeds):
    return tuple((n, tuple(t.shape), t.dtype)
                 for n, t in sorted(feeds.items()))


def _fetches(step, env):
    missing = [n for n in step.fetch_names if n not in env]
    if missing:
        raise KeyError('fetch vars %s were not computed by this program'
                       % missing)
    return [env[n] for n in step.fetch_names]


class _CompiledProgramBase(object):
    """Marker base so that Executor.run / run_steps dispatch the
    CompiledProgram wrapper (compiler.py)."""

    def _run(self, exe, feed, fetch_list, scope, return_numpy,
             as_futures=False):
        raise NotImplementedError

    def _run_steps(self, exe, feed_list, fetch_list, steps, scope,
                   return_numpy, as_futures=False):
        raise NotImplementedError
