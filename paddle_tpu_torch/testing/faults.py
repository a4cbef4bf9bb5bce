"""Deterministic fault injection, the port's copy of the reference's.

Counterpart of paddle_tpu/testing/faults.py.  A *fault site* is a named
point in the runtime that asks this module "should I fail right now?".
Sites are armed via the ``PT_FAULT`` environment variable (or
`configure()`), one comma-separated entry per site::

    PT_FAULT="decode_step:at=2,kv_oom:at=3:times=2"

Each entry is ``site[:key=value]*`` with fields

  * ``at=N``     fire on the N-th invocation of the site (1-based), or,
                 for step-indexed sites like ``nan_step``/``sigterm``,
                 at global step counter N (0-based, matching the
                 executor's run counter).
  * ``times=K``  keep firing for K consecutive invocations/steps
                 (default 1).
  * ``s=SEC``    sleep duration for stall-type sites (default 0.05).
  * ``row=R``    ``nan_step`` only: poison batch row R alone.

Injection is deterministic: no randomness, no wall-clock dependence, so
the same program with the same ``PT_FAULT`` fails the same way every run.
Every fired fault counts into this module's `counters` (a
serving.counters.Counters; the reference counts into its observability
registry, which is not ported) as ``faults.injected`` and
``faults.injected.<site>``.

The port's modules call two sites, where the reference calls them:

  ===============  ====================================================
  ``decode_step``  one decode window of the streaming generation
                   scheduler raises BEFORE the runtime is touched (on
                   the host, outside every CUDA graph capture and
                   replay): every decoding request gets an error reply,
                   the KV slots free, and the breaker counts a failure
                   (serving/generation/scheduler.py)
  ``kv_oom``       the paged KV pool reports exhaustion on one
                   allocation: at admission the request stays QUEUED
                   (backpressure); mid-stream the stream retires with a
                   terminal ``kv_oom`` reply, never a truncation
                   (serving/generation/kv_cache.py)
  ===============  ====================================================

`SITES` names every site of the reference, so that one ``PT_FAULT`` spec
parses alike in both packages.  The others wait for the modules that call
them in the reference (``ckpt_write``, ``ckpt_io``, ``cache_read``,
``cache_write``, ``io_read``, ``io_write``, ``nan_step``, ``sigterm``,
``prefetch_stall``, ``feed_read``, ``serve_dispatch``,
``serve_slow_batch``, ``queue_overflow``, ``compile_storm``,
``device_loss``, ``host_desync``); the helpers they use (`maybe_sleep`,
`maybe_kill`, `poison_nan`, `forensic_replay`) are here already.
"""
import os
import signal
import threading
import time

from ..serving.counters import Counters

__all__ = ['configure', 'reset', 'any_active', 'active', 'fire', 'fire_in',
           'maybe_fail', 'maybe_sleep', 'maybe_kill', 'poison_nan',
           'forensic_replay', 'spec', 'stats', 'counters', 'InjectedFault',
           'SITES']

SITES = ('ckpt_write', 'ckpt_io', 'cache_read', 'cache_write', 'io_read',
         'io_write', 'nan_step', 'prefetch_stall', 'feed_read', 'sigterm',
         'serve_dispatch', 'serve_slow_batch', 'queue_overflow',
         'compile_storm', 'decode_step', 'device_loss', 'host_desync',
         'kv_oom')


class InjectedFault(OSError):
    """The exception maybe_fail raises — an OSError subclass so every
    transient-I/O handler (and retry_with_backoff) treats it exactly
    like a real disk failure."""


class _Fault(object):
    __slots__ = ('site', 'at', 'times', 'sleep_s', 'row', 'hits', 'fired')

    def __init__(self, site, at=1, times=1, s=0.05, row=None):
        self.site = site
        self.at = int(at)
        self.times = max(1, int(times))
        self.sleep_s = float(s)
        self.row = None if row is None else int(row)
        self.hits = 0       # invocation counter for hit-indexed sites
        self.fired = 0


# the fired faults, process-wide as the armed sites are
counters = Counters()

_ACTIVE = {}
_CONFIGURED = [False]
_REPLAY = [0]          # >0: forensic replay — nan_step ignores its budget
_LOCK = threading.Lock()


def configure(text=None):
    """Arm fault sites from a PT_FAULT-style spec string (None re-reads
    the environment).  Replaces any previous configuration."""
    with _LOCK:
        _ACTIVE.clear()
        if text is None:
            text = os.environ.get('PT_FAULT', '')
        for part in (p.strip() for p in text.split(',')):
            if not part:
                continue
            fields = part.split(':')
            site = fields[0].strip()
            kw = {}
            for f in fields[1:]:
                k, _, v = f.partition('=')
                k = k.strip()
                if k not in ('at', 'times', 's', 'row'):
                    raise ValueError(
                        'PT_FAULT field %r for site %r not understood '
                        '(known: at=N, times=K, s=SEC, row=R)' % (k, site))
                kw[k] = float(v) if k == 's' else int(v)
            _ACTIVE[site] = _Fault(site, **kw)
        _CONFIGURED[0] = True
    return dict(_ACTIVE)


def reset():
    """Disarm everything and forget the cached env parse (the next site
    query re-reads PT_FAULT)."""
    with _LOCK:
        _ACTIVE.clear()
        _CONFIGURED[0] = False


def _ensure():
    if not _CONFIGURED[0]:
        configure()


def any_active():
    """One cheap check for hot paths: is ANY site armed?"""
    _ensure()
    return bool(_ACTIVE)


def active(site):
    _ensure()
    return site in _ACTIVE


def spec(site):
    """The armed _Fault for a site (None if disarmed).  Read-only use:
    tests and soak harnesses compare a forensic verdict against the
    injected ground truth (``spec('nan_step').at`` / ``.row``)."""
    _ensure()
    return _ACTIVE.get(site)


def _count(site):
    counters.inc('faults.injected')
    counters.inc('faults.injected.%s' % site)


def _replaying(site):
    # forensic replay re-runs already-fired steps to localize the poison:
    # nan_step must reproduce the original NaNs without consuming (or
    # being blocked by) the spent budget
    return _REPLAY[0] > 0 and site == 'nan_step'


def fire(site, step=None):
    """Deterministic fire decision.  ``step=None`` counts invocations of
    the site (1-based, fires on hits in [at, at+times)); an explicit
    ``step`` compares the caller's own index (e.g. the executor's run
    counter) against the armed window instead."""
    _ensure()
    spec = _ACTIVE.get(site)
    if spec is None:
        return False
    with _LOCK:
        replay = _replaying(site)
        if spec.fired >= spec.times and not replay:
            # budget spent: a rollback that rewinds the caller's step
            # counter must not re-fire the same fault forever
            return False
        if step is None:
            spec.hits += 1
            idx = spec.hits
        else:
            idx = int(step)
        if spec.at <= idx < spec.at + spec.times:
            if not replay:
                spec.fired += 1
                _count(site)
            return True
    return False


def fire_in(site, start, count):
    """Step-window variant for fused launches: fires when ANY step in
    [start, start+count) falls inside the armed window."""
    _ensure()
    spec = _ACTIVE.get(site)
    if spec is None:
        return False
    with _LOCK:
        replay = _replaying(site)
        if spec.fired >= spec.times and not replay:
            return False
        lo, hi = spec.at, spec.at + spec.times
        if int(start) < hi and int(start) + int(count) > lo:
            if not replay:
                spec.fired += 1
                _count(site)
            return True
    return False


class forensic_replay(object):
    """Context manager: while active, the ``nan_step`` site replays its
    armed window deterministically — firing decisions ignore the spent
    budget and do not consume it, so a forensic re-run of step N poisons
    exactly the feeds the original run poisoned, while post-forensics
    production steps keep the one-shot budget semantics."""

    def __enter__(self):
        with _LOCK:
            _REPLAY[0] += 1
        return self

    def __exit__(self, *exc):
        with _LOCK:
            _REPLAY[0] = max(0, _REPLAY[0] - 1)
        return False


def maybe_fail(site, step=None, exc=None):
    """Raise at an armed site (InjectedFault — an OSError — by default)."""
    if fire(site, step):
        raise (exc or InjectedFault)(
            'PT_FAULT: injected fault at site %r' % site)


def maybe_sleep(site):
    """Stall-type sites: sleep the armed duration instead of raising.
    Returns True when the fault fired (serving's dispatch loop uses this
    to attribute the stall — e.g. count a ``compile_storm`` batch as a
    cold one for the circuit breaker)."""
    _ensure()
    spec = _ACTIVE.get(site)
    if spec is not None and fire(site):
        time.sleep(spec.sleep_s)
        return True
    return False


def maybe_kill(site='sigterm', step=None, count=1, sig=signal.SIGTERM):
    """Preemption rehearsal: deliver a signal to this process when the
    step window [step, step+count) overlaps the armed window.  Sleeps
    briefly after the kill so CPython delivers the (asynchronous) Python
    signal handler HERE — at the instrumented site — instead of a few
    bytecodes later, keeping the test deterministic."""
    if not active(site):
        return
    hit = (fire_in(site, step, count) if step is not None else fire(site))
    if hit:
        os.kill(os.getpid(), sig)
        for _ in range(100):   # a terminating handler exits long before
            time.sleep(0.01)


def poison_nan(feed_vals, step, count=1):
    """``nan_step`` site: when the launch's step window [step, step+count)
    covers the armed step, the float feeds of exactly the armed steps are
    overwritten with NaN — the loss and every gradient blow up, and the
    executor's fused check_nan verdict trips exactly as it would for a
    real numeric divergence.  With ``row=R`` only batch row R of each
    armed step is poisoned (the batch axis is axis 0 of a per-step feed,
    axis 1 of a ``count>1`` stacked launch), giving forensic row
    bisection an exact ground truth.  Shapes/dtypes are preserved so the
    poisoned launch reuses the same executable (no retrace)."""
    if not active('nan_step') or not fire_in('nan_step', step, count):
        return feed_vals
    import numpy as np
    sp = spec('nan_step')
    row = sp.row
    # armed step ids intersected with this launch's [step, step+count)
    lo = max(int(step), sp.at)
    hi = min(int(step) + int(count), sp.at + sp.times)
    out = {}
    for k, v in feed_vals.items():
        a = np.asarray(v)
        if not np.issubdtype(a.dtype, np.floating):
            out[k] = v
            continue
        b = np.array(a, copy=True)
        if int(count) > 1:
            # stacked launch: leading axis is the step axis
            for s in range(lo, hi):
                i = s - int(step)
                if row is not None and b.ndim >= 2 and 0 <= row < b.shape[1]:
                    b[i, row] = np.nan
                else:
                    b[i] = np.nan
        else:
            if row is not None and b.ndim >= 1 and 0 <= row < b.shape[0]:
                b[row] = np.nan
            else:
                b[...] = np.nan
        out[k] = b
    return out


def stats():
    """{site: (hits, fired)} snapshot for tests/diagnostics."""
    _ensure()
    return {s: (f.hits, f.fired) for s, f in _ACTIVE.items()}
