"""The executor's asynchronous runtime: the host reads the device only
where it must, and every such read is metered.

Counterpart of paddle_tpu/core/async_runtime.py.  PyTorch, like JAX,
issues device work asynchronously: the host waits on the card only when
it reads a value (`.cpu()`, `bool()`, a blocking fetch).  The three
pieces the executor's asynchronous mode is built from:

  * `host_block(reason)`: a context manager that adds the seconds of
    every forced host-device sync to `counters['executor.host_blocked_s']`
    (and to a second counter when a site names one);
  * `FetchFuture`: what `run` / `run_steps` return with `as_futures=True`,
    a device tensor with a lazy, cached, metered `.numpy()`;
  * `DeferredNanVerdict`: the fused all-finite verdict of `check_nan`
    kept on the device as a running AND over launches and read (one host
    sync) every `poll_every` steps.  `PT_NAN_POLL=1`, the default unless
    `PT_ASYNC=1`, reads it after every launch.

Environment: `PT_ASYNC=1` makes deferred polling (every 8 steps) the
default; `PT_NAN_POLL=N` sets the cadence and wins over `PT_ASYNC`.  The
reference's spans and gauges (its observability package) are not
ported: `counters` is the port's own.
"""
import contextlib
import os
import time

import torch

__all__ = ['FetchFuture', 'DeferredNanVerdict', 'host_block', 'counters',
           'async_enabled', 'default_nan_poll', 'DEFERRED_TRIP_MSG']

# the poll cadence with PT_ASYNC=1 and no PT_NAN_POLL
_ASYNC_DEFAULT_POLL = 8

# seconds the host spent blocked on the device: every forced sync, and of
# those the blocking fetches of `run` / `run_steps` (return_numpy=True)
counters = {'executor.host_blocked_s': 0.0, 'executor.fetch_sync_s': 0.0}

# a deferred trip cannot always name one step: the running AND says only
# that some step since the last poll went non-finite.  The 'check_nan'
# prefix is what recovery code matches a divergence by: keep it.
DEFERRED_TRIP_MSG = (
    'check_nan: non-finite values (nan/inf) detected by a deferred '
    'verdict poll covering the last %d step(s) — the divergence is '
    'localized to this window, not a single step (set PT_NAN_POLL=1 '
    'for per-step attribution). Roll back to a checkpoint saved before '
    'the window (Executor.nan_clean() aligned saves guarantee one).')


def async_enabled():
    return os.environ.get('PT_ASYNC', '') in ('1', 'true', 'True')


def default_nan_poll():
    """The verdict poll cadence: `PT_NAN_POLL` when set, else 1 (a read
    after every launch) unless `PT_ASYNC=1` asks for deferred polling."""
    env = os.environ.get('PT_NAN_POLL', '')
    if env:
        return max(1, int(env))
    return _ASYNC_DEFAULT_POLL if async_enabled() else 1


@contextlib.contextmanager
def host_block(reason, extra_counter=None):
    """Meter a forced host-device sync: its seconds go to
    `executor.host_blocked_s` and to `extra_counter` when given.
    `reason` names the site for a reader of the code."""
    del reason
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        counters['executor.host_blocked_s'] += dt
        if extra_counter:
            counters[extra_counter] = counters.get(extra_counter, 0.0) + dt


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class FetchFuture(object):
    """One fetch of a non-blocking run (`as_futures=True`).

    Wraps the device tensor; nothing blocks until the caller asks for host
    data.  `numpy()` (and `np.asarray(future)`) syncs once, metered by
    `host_block`, and caches the host copy.  `__getitem__` gives a future
    over a device-side slice, so a stacked `[K, ...]` fetch hands out
    per-step futures without a sync.  `ready()` asks, without blocking,
    whether the work that produced the tensor has finished: a CUDA event
    recorded on the stream when the future was made."""
    __slots__ = ('_device', '_host', '_reason', '_event')

    def __init__(self, device_value, reason='fetch_future', event=None):
        self._device = device_value
        self._host = None
        self._reason = reason
        if event is None and device_value.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device_value.device))
        self._event = event

    def device(self):
        """The device tensor; never blocks."""
        return self._device

    @property
    def shape(self):
        return tuple(self._device.shape)

    @property
    def dtype(self):
        return self._device.dtype

    def ready(self):
        """True once the producing work has finished (non-blocking)."""
        if self._host is not None or self._event is None:
            return True
        return bool(self._event.query())

    def block(self):
        """Wait for the device value without copying it to the host."""
        if self._host is None and self._event is not None:
            with host_block(self._reason):
                self._event.synchronize()
        return self

    def numpy(self):
        if self._host is None:
            with host_block(self._reason):
                self._host = _to_numpy(self._device)
        return self._host

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype, copy=False)

    def __float__(self):
        return float(self.numpy())

    def __getitem__(self, idx):
        return FetchFuture(self._device[idx], reason=self._reason,
                           event=self._event)

    def __len__(self):
        return int(self._device.shape[0])

    def __repr__(self):
        return '<FetchFuture %s %s %s>' % (
            self.shape, self.dtype,
            'synced' if self._host is not None else 'pending')


class DeferredNanVerdict(object):
    """Device-resident running AND of per-launch all-finite verdicts.

    `push` ANDs a launch's verdict (a bool scalar tensor) into the running
    one on the device, without a sync; `poll` reads it (the one host sync
    of a window) and resets.  With `poll_every=1` every push is due at
    once: the verdict is read after every launch."""
    __slots__ = ('poll_every', '_ok', '_pending', '_start',
                 'last_window_start')

    def __init__(self, poll_every=1):
        self.poll_every = max(1, int(poll_every))
        self._ok = None
        self._pending = 0
        self._start = None             # run counter of the window's first step
        self.last_window_start = None  # ... of the last polled window

    @property
    def pending_steps(self):
        """Steps since the last poll: the window a trip at the next poll
        would condemn."""
        return self._pending

    def push(self, ok, steps=1, start=None):
        """`start` is the run counter of the launch's first step."""
        if self._ok is None:
            self._ok = ok.clone()
            if start is not None:
                self._start = int(start)
        else:
            self._ok.logical_and_(ok)
        self._pending += int(steps)

    def due(self):
        return self._pending >= self.poll_every

    def poll(self):
        """Read the accumulated verdict (one host sync).  -> 0 when clean
        or nothing is pending, else the number of steps of the tripped
        window.  The window resets either way."""
        if self._ok is None:
            return 0
        window = self._pending
        with host_block('nan_poll'):
            ok = bool(self._ok)
        self.last_window_start = self._start
        self._ok = None
        self._pending = 0
        self._start = None
        return 0 if ok else window

    def reset(self):
        """Drop pending verdicts unread: after a rollback they say nothing
        about the restored state."""
        self._ok = None
        self._pending = 0
        self._start = None
