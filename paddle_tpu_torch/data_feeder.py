"""FeedBucketer (pad feeds onto a few fixed batch sizes) and
FeedPrefetcher (stack K feeds on a worker thread for `run_steps`).

Counterpart of paddle_tpu/data_feeder.py::FeedBucketer, as the serving
engine uses it: every coalesced batch is padded up to a bucket boundary,
so the device sees a handful of batch shapes; and of its FeedPrefetcher,
without the reference's spans, gauges, fault sites and retry policy (its
observability, testing/faults and core/retry are not ported).  Not
ported yet: the validity-mask feed, sequence-dim padding, LoDTensor
feeds, PT_BUCKETS, the metrics gauges and DataFeeder.
"""
import queue
import threading

import numpy as np
import torch

__all__ = ['FeedBucketer', 'FeedPrefetcher']


def _default_boundaries():
    """Powers of two with 1.5x midpoints: 1, 2, 4, 6, 8, 12, 16, 24, ..."""
    bounds = [1, 2, 4, 6, 8]
    while bounds[-1] < 65536:
        b = bounds[-1]
        bounds.append(b + b // 2 if (b & (b - 1)) == 0 else b + b // 3)
    return bounds


class FeedBucketer(object):
    """Pad the leading batch dim of every batched feed up to the smallest
    boundary >= the true batch by repeating the last row, so pad rows stay
    well-defined for every op."""

    def __init__(self, boundaries=None):
        self.boundaries = sorted(int(b) for b in
                                 (boundaries or _default_boundaries()))
        if not self.boundaries or self.boundaries[0] < 1:
            raise ValueError('bucket boundaries must be positive ints')

    def boundary(self, n):
        """Smallest boundary >= n; beyond the largest, the next multiple
        of it."""
        n = int(n)
        if n < 1:
            raise ValueError('bucket size must be >= 1, got %d' % n)
        for b in self.boundaries:
            if b >= n:
                return b
        top = self.boundaries[-1]
        return ((n + top - 1) // top) * top

    def bucket_feed(self, feed):
        """One feed dict -> (padded feed dict, true batch size).  Arrays
        whose leading dim is not the batch pass through unpadded."""
        arrays = {k: np.asarray(v) for k, v in feed.items()}
        dims = [a.shape[0] for a in arrays.values() if a.ndim]
        if not dims:
            raise ValueError('bucket_feed needs at least one batched feed')
        batch = dims[0]
        target = self.boundary(batch)
        out = {}
        for k, a in arrays.items():
            if a.ndim and a.shape[0] == batch and target > batch:
                widths = [(0, target - batch)] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, widths, mode='edge')
            out[k] = a
        return out, batch

    def wrap(self, feeds):
        """Generator over an iterable of feed dicts, bucketing each; yields
        the padded feeds, so it plugs into FeedPrefetcher / run_steps."""
        for f in feeds:
            yield self.bucket_feed(f)[0]


def _device_of(to_device):
    """The device a superbatch goes to: None for `to_device=False`, the
    current CUDA device for True (raising without one), else the given
    device (a torch.device, a string, or a place)."""
    if to_device is False or to_device is None:
        return None
    if to_device is True:
        from .core.framework import require_cuda
        require_cuda('FeedPrefetcher(to_device=True)')
        return torch.device('cuda', torch.cuda.current_device())
    return getattr(to_device, 'device', None) or torch.device(to_device)


class FeedPrefetcher(object):
    """Bounded background prefetch queue over an iterable of feed dicts.

    A worker thread pulls per-step feed dicts from `feeds`, stacks every
    `steps` of them on a new leading axis with numpy (one upload a
    superbatch instead of one a step), uploads the stack to the consumer's
    device from pinned memory when `to_device` asks (True: the current
    CUDA device; or a device or place), and parks it in a queue of
    `capacity`.  One worker keeps the order; when the reader runs out the
    partial tail is flushed with its true length; a reader exception is
    raised in the consumer where it would have been read.  `bucketer`
    (FeedBucketer) pads each feed first; `skip_steps` fast-forwards past
    feeds a previous run consumed (`cursor()['steps']`).

    Iterating yields (stacked feed dict, k), k == steps but for the tail:

        for superbatch, k in FeedPrefetcher(batches, steps=8):
            losses = exe.run_steps(prog, feed_list=superbatch, steps=k,
                                   fetch_list=[loss])
    """

    def __init__(self, feeds, steps=1, capacity=2, to_device=True,
                 bucketer=None, skip_steps=0):
        if steps < 1:
            raise ValueError('steps must be >= 1, got %r' % (steps,))
        if capacity < 1:
            raise ValueError('capacity must be >= 1, got %r' % (capacity,))
        if skip_steps < 0:
            raise ValueError('skip_steps must be >= 0, got %r'
                             % (skip_steps,))
        self._device = _device_of(to_device)
        self._src = iter(bucketer.wrap(feeds) if bucketer is not None
                         else feeds)
        self._skip = int(skip_steps)
        self._steps_out = 0
        self._superbatches_out = 0
        self._steps = int(steps)
        self._q = queue.Queue(maxsize=int(capacity))
        self._terminal = None   # ('done',) | ('error', exc) | ('closed',)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, name='FeedPrefetcher', daemon=True)
        self._thread.start()

    def _pack(self, buf):
        names = set(buf[0])
        for f in buf[1:]:
            if set(f) != names:
                raise ValueError('per-step feeds disagree on keys: %s vs %s'
                                 % (sorted(names), sorted(f)))
        stacked = {k: np.stack([np.asarray(f[k]) for f in buf])
                   for k in buf[0]}
        if self._device is not None:
            stacked = {k: self._upload(a) for k, a in stacked.items()}
        return stacked, len(buf)

    def _upload(self, a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._device.type != 'cuda':
            return t.to(self._device)
        # a pinned staging copy lets the upload run without blocking the
        # worker; the caching host allocator keeps it until the copy ends
        return t.pin_memory().to(self._device, non_blocking=True)

    def _put(self, item):
        # a bounded put that stays responsive to close(): never blocks
        # for ever on a consumer that went away
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for _ in range(self._skip):
                if self._stop.is_set():
                    return
                try:
                    next(self._src)
                except StopIteration:
                    self._put(('done', None))
                    return
            buf = []
            while not self._stop.is_set():
                try:
                    f = next(self._src)
                except StopIteration:
                    break
                buf.append(f)
                if len(buf) == self._steps:
                    if not self._put(('batch', self._pack(buf))):
                        return
                    buf = []
            if self._stop.is_set():
                return
            if buf and not self._put(('batch', self._pack(buf))):
                return
            self._put(('done', None))
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            self._put(('error', e))

    def __iter__(self):
        while True:
            if self._terminal is not None:
                # exhausted, failed or closed: iterating again yields
                # nothing instead of waiting on a queue no worker fills
                return
            kind, payload = self._q.get()
            if kind == 'done':
                self._terminal = ('done',)
                return
            if kind == 'error':
                self._terminal = ('error', payload)
                raise payload
            self._superbatches_out += 1
            self._steps_out += payload[1]
            yield payload

    def cursor(self):
        """The position in the feed stream: keep it with a checkpoint and
        pass `skip_steps=cursor()['steps']` to the resumed prefetcher."""
        return {'steps': self._skip + self._steps_out,
                'superbatches': self._superbatches_out,
                'skipped': self._skip}

    def close(self):
        """Stop the worker and release the queue (safe to call twice)."""
        if self._terminal is None:
            self._terminal = ('closed',)
        self._stop.set()
        while True:  # unblock a worker parked on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
