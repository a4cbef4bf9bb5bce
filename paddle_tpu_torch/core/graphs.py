"""One captured CUDA graph per launch signature: the port's counterpart of
the reference's one XLA executable per signature
(paddle_tpu/core/executor.py `_resolve_entry`, `_launch_signature`).

A signature is the program (its id and version, so its amp flag), the
feed names, shapes and dtypes, the fetch names, check_nan, the scope, and
the shapes and dtypes of the persistables the scope holds.  Its entry
runs:

1. the first time, the interpreter, on a side stream (the warm-up
   PyTorch's whole-network capture asks for).  It plans and builds every
   kernel (nvcc never runs under capture) and records, in order, the
   random streams the step draws and the host constants it uploads;
2. the second time, a capture of one step, then a replay of it;
3. every later time, a replay: the feeds are copied into the graph's
   static inputs, each op stream's generator is seeded as the
   interpreter would seed it for this run counter, and the graph replays.

The graphs of one executor share one memory pool; they never run at
once.  A capture that fails raises naming the op (core/executor.py
`_raise_if_capturing`); nothing falls back to the interpreter.  What
capture needs of the code it runs, where it is handled:

- Persistables replaced rather than updated in place (`increment` gives
  the step counter a new tensor, Adam's columns that are not in place are
  cloned, the interpreter rebinds `scope.vars[name]`): a replay reads the
  captured addresses, so the captured step ends by copying each written
  persistable into the tensor the scope holds (`_captured_step`), and
  the scope keeps that tensor.  A scope tensor replaced between runs by
  one of the same shape and dtype is copied into it before the replay
  (`_replay`);
  any other replacement is another signature, so another capture.
- Dropout generators: the interpreter seeds a fresh `torch.Generator`
  per op stream and run (core/registry.py).  A capture registers one
  generator per stream the warm-up drew (`register_generator_state`,
  before the capture begins, in the warm-up's order), and a replay reads
  each generator's seed and offset when it starts: `manual_seed` to the
  interpreter's value before each replay makes every mask a function of
  (program seed, run counter, stream) on every path.
- Host constants (`assign_value`'s values, `adam_multi`'s tables,
  ops/optimizer_ops.py `_tables`): a capture may not copy from pageable
  memory, and a copy from a pinned buffer would keep a host address the
  caching host allocator reuses.  They go up through the step's
  recorder (`ctx.upload`, `_Resources`): the capture is handed device
  buffers allocated
  before it began, filled after it ended (under the graph the grads sit
  at fixed addresses, so the Adam tables are constant too).
- Host launch counters (`kernels.launches`, `kernelgen.launches`) are
  Python that a replay does not run: the capture's counts are taken back
  and added once per replay.
- The generated kernels' vector width, chosen by pointer alignment
  (ops/kernelgen `_launch`), is fixed at capture with the addresses.
- Threads: captures use `capture_error_mode='thread_local'`, so a serving
  thread capturing under the Predictor's run lock is not failed by what
  other threads do meanwhile.  cuBLAS keeps a handle per thread, and
  creating one under capture fails (CUBLAS_STATUS_NOT_INITIALIZED): a
  thread that captures before it ran a step of this executor first runs
  a few small matrix products on the capture stream
  (`GraphCache.warm_thread`), as a ServingEngine's dispatch thread does
  after a warm-up on the main thread.
- A capture that fails leaves the caching allocator recording into the
  pool, and later captures in the process fail too: so a failure raises
  naming the op and is not retried.
- Per-call host work: a replay skips the rewriter and the planning pass.
"""
import threading
import time

import numpy as np
import torch

from . import registry

__all__ = ['GraphCache', 'GraphEntry']


class GraphCache(object):
    """The graph entries of one executor, with their shared pool and side
    stream."""

    def __init__(self, exe):
        self.exe = exe
        self.entries = {}
        self._last = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(exe.device)
        # threads that ran a step on the side stream: their cuBLAS handles
        # and workspaces exist
        self.warm_threads = set()

    def warm_thread(self):
        """Create this thread's cuBLAS and cuBLASLt handles and their
        workspaces on the side stream, outside any capture."""
        ident = threading.get_ident()
        if ident in self.warm_threads:
            return
        with torch.cuda.stream(self.stream):
            for dt in (torch.float32, torch.bfloat16):
                a = torch.ones((16, 16), dtype=dt, device=self.exe.device)
                torch.mm(a, a)
                torch.addmm(a[0], a, a)
                torch.bmm(a[None], a[None])
        self.warm_threads.add(ident)

    def entry(self, step, feed_sig, scope):
        base = (id(step), feed_sig, self.exe.check_nan, scope._serial)
        e = self._last.get(base)
        if e is not None and e.step is step and e.bound_to(scope):
            return e
        pspec = tuple((n, tuple(scope.vars[n].shape), scope.vars[n].dtype)
                      for n in sorted(step.persistable) if n in scope)
        key = base + (pspec,)
        e = self.entries.get(key)
        if e is None:
            e = self.entries[key] = GraphEntry(self, step)
        self._last[base] = e
        return e


class _Resources(object):
    """The generators and host uploads (constants, `adam_multi`'s tables)
    of one signature's step: recorded in order at the warm-up, handed out
    again in that order at capture, the uploads as device buffers made
    before the capture began and filled after it ended."""

    def __init__(self, generators=None, buffers=None):
        self.capturing = generators is not None
        self.generators = generators or []
        self.buffers = buffers or []
        self.requests = []
        self.uploads = []
        self.fills = []

    def generator(self, device, request, seed):
        k = len(self.requests)
        self.requests.append(request)
        if not self.capturing:
            g = torch.Generator(device=device)
            g.manual_seed(seed)
            return g
        if k >= len(self.generators) or self.generators[k][1] != request:
            raise RuntimeError(
                'CUDA graph capture: random stream %r drawn out of the '
                'warm-up run\'s order' % (request,))
        return self.generators[k][0]

    def upload(self, host, device):
        host = torch.from_numpy(np.ascontiguousarray(host))
        if not self.capturing:
            self.uploads.append((tuple(host.shape), host.dtype))
            return host.to(device)
        k = len(self.fills)
        if k >= len(self.buffers) or (tuple(self.buffers[k].shape),
                                      self.buffers[k].dtype) != \
                (tuple(host.shape), host.dtype):
            raise RuntimeError('CUDA graph capture: a host upload of %s %s '
                               'the warm-up run did not make'
                               % (tuple(host.shape), host.dtype))
        self.fills.append((self.buffers[k], host.clone()))
        return self.buffers[k]


def _launch_counts():
    from .. import kernels
    from ..ops import kernelgen
    return dict(kernels.launches), dict(kernelgen.launches)


def _set_launch_counts(counts):
    from .. import kernels
    from ..ops import kernelgen
    kernels.launches.update(counts[0])
    kernelgen.launches.clear()
    kernelgen.launches.update(counts[1])


class GraphEntry(object):
    """One launch signature on the card (module docstring).

    `run(feeds, counter, scope)` -> (fetches, names of the persistables
    written back, all-finite verdict or None).  After a capture the
    fetches and the verdict are the graph's static outputs: the next
    replay overwrites them, so the caller copies what it keeps.
    `capture_s` is the capture's wall time, `launches_per_replay` what one
    replay adds to the launch counters."""

    def __init__(self, cache, step):
        self.cache = cache
        self.step = step
        self.graph = None
        self.capture_s = None
        self.launches_per_replay = None
        self._warm = None
        self._statics = {}
        self._feeds = {}
        self._fetches = None
        self._updates = None
        self._ok = None
        self._generators = []
        self._buffers = []

    def bound_to(self, scope):
        """The scope still holds every tensor this graph was captured on."""
        return self.graph is not None and all(
            scope.vars.get(n) is t for n, t in self._statics.items())

    def run(self, feeds, counter, scope):
        if self._warm is None:
            return self._warm_up(feeds, counter, scope)
        if self.graph is None:
            self._capture(feeds, scope)
        return self._replay(feeds, counter, scope)

    def _warm_up(self, feeds, counter, scope):
        exe = self.cache.exe
        res = _Resources()
        side = self.cache.stream
        cur = torch.cuda.current_stream(exe.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = exe._interpret(self.step, feeds, scope, counter, res)
        cur.wait_stream(side)
        self._warm = res
        self.cache.warm_threads.add(threading.get_ident())
        return out

    def _capture(self, feeds, scope):
        exe, step = self.cache.exe, self.step
        dev = exe.device
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(dev)
        self.cache.stream.wait_stream(cur)
        self.cache.warm_thread()
        cur.wait_stream(self.cache.stream)
        statics = {}
        for n in sorted(step.persistable):
            if n in scope:
                t = scope.vars[n]
                if step.bw_idx is not None and t.is_inference():
                    t = scope.vars[n] = t.clone()
                statics[n] = t
        self._feeds = {n: torch.empty_like(t) for n, t in feeds.items()}
        graph = torch.cuda.CUDAGraph()
        gens = []
        for request in self._warm.requests:
            g = torch.Generator(device=dev)
            graph.register_generator_state(g)
            gens.append((g, request))
        bufs = [torch.empty(shape, dtype=dtype, device=dev)
                for shape, dtype in self._warm.uploads]
        res = _Resources(gens, bufs)
        before = _launch_counts()
        env = dict(statics)
        env.update(self._feeds)
        err, out = None, None
        try:
            with torch.cuda.graph(graph, pool=self.cache.pool,
                                  stream=self.cache.stream,
                                  capture_error_mode='thread_local'):
                try:
                    out = self._captured_step(env, statics, res)
                except Exception as e:   # re-raised below, once capture ends
                    err = e
        except Exception as e:
            if err is None:
                raise RuntimeError('CUDA graph capture failed: %s' % e) from e
        if err is not None:
            _set_launch_counts(before)
            raise err
        after = _launch_counts()
        self.launches_per_replay = (
            {k: v - before[0].get(k, 0) for k, v in after[0].items()},
            {k: v - before[1].get(k, 0) for k, v in after[1].items()})
        _set_launch_counts(before)
        for buf, host in res.fills:
            buf.copy_(host)
        self._fetches, self._updates, self._ok = out
        self._statics = statics
        self._generators = gens
        self._buffers = bufs
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def _captured_step(self, env, statics, res):
        """The body of the capture: the step, then each written persistable
        copied into the scope's tensor, then the verdict over them."""
        from .executor import _fetches, all_finite
        exe, step = self.cache.exe, self.step
        exe._execute(step, env, 0, res)
        with torch.inference_mode(step.bw_idx is None):
            for n, t in statics.items():
                v = env.get(n)
                if v is None or v is t:
                    continue
                if v.shape != t.shape or v.dtype != t.dtype:
                    raise RuntimeError(
                        'CUDA graph capture: persistable %s written as %s '
                        '%s, the scope holds %s %s' % (
                            n, tuple(v.shape), v.dtype, tuple(t.shape),
                            t.dtype))
                t.copy_(v)
        env.update(statics)
        fetches = _fetches(step, env)
        updates = [n for n in step.used if n in statics]
        ok = all_finite(fetches + [statics[n] for n in updates]) \
            if exe.check_nan else None
        return fetches, updates, ok

    def _replay(self, feeds, counter, scope):
        from .. import kernels
        from ..ops import kernelgen
        step = self.step
        with torch.inference_mode(step.bw_idx is None):
            for n, t in self._statics.items():
                cur = scope.vars.get(n)
                if cur is not t:
                    t.copy_(cur)
                    scope.vars[n] = t
        for n, t in feeds.items():
            self._feeds[n].copy_(t)
        rs = registry.run_seed(step.program.random_seed, counter)
        for g, (seed, stream) in self._generators:
            g.manual_seed(registry.stream_seed(rs, seed, stream))
        self.graph.replay()
        per, seg = self.launches_per_replay
        for k, v in per.items():
            kernels.launches[k] = kernels.launches.get(k, 0) + v
        for k, v in seg.items():
            kernelgen.launches[k] = kernelgen.launches.get(k, 0) + v
        return self._fetches, self._updates, self._ok
