"""FeedBucketer (pad feeds onto a few fixed batch sizes and sequence
lengths), FeedPrefetcher (stack K feeds on a worker thread for
`run_steps`) and DataFeeder (rows of a reader -> a feed dict).

Counterpart of paddle_tpu/data_feeder.py's three: every coalesced batch
is padded up to a bucket boundary, and a sequence feed named in
`seq_names` along its time axis too, so the device sees a handful of
shapes (one CUDA graph each); LoDTensor feeds (core/lod.py) keep their
lengths, so sequence ops mask the padding.  Without the reference's
spans, gauges, fault sites and retry policy (its observability,
testing/faults and core/retry are not ported).  Not ported yet: the
validity-mask feed and PT_BUCKETS.
"""
import queue
import threading

import numpy as np
import torch

from .core.dtypes import convert_dtype
from .core.framework import Variable, default_main_program
from .core.lod import LoDTensor, create_lod_tensor

__all__ = ['FeedBucketer', 'FeedPrefetcher', 'DataFeeder']


def _default_boundaries():
    """Powers of two with 1.5x midpoints: 1, 2, 4, 6, 8, 12, 16, 24, ..."""
    bounds = [1, 2, 4, 6, 8]
    while bounds[-1] < 65536:
        b = bounds[-1]
        bounds.append(b + b // 2 if (b & (b - 1)) == 0 else b + b // 3)
    return bounds


def _leading_dim(v):
    if isinstance(v, LoDTensor):
        return v.padded.shape[0]
    return v.shape[0] if v.ndim else None


class FeedBucketer(object):
    """Pad the leading batch dim of every batched feed up to the smallest
    boundary >= the true batch by repeating the last row, so pad rows stay
    well-defined for every op; a LoDTensor's lengths are edge-replicated
    the same way (a zero-length pad row would NaN length-normalizing
    sequence ops).  Feeds named in `seq_names` get axis 1 padded with
    zeros up to a boundary too: their lengths (a LoDTensor's, or the
    `@LENGTH` feed) already mark the padding, which every sequence op
    masks."""

    def __init__(self, boundaries=None, seq_names=()):
        self.boundaries = sorted(int(b) for b in
                                 (boundaries or _default_boundaries()))
        if not self.boundaries or self.boundaries[0] < 1:
            raise ValueError('bucket boundaries must be positive ints')
        self.seq_names = tuple(seq_names)

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

    @staticmethod
    def _pad_axis(arr, axis, target):
        gap = target - arr.shape[axis]
        if gap <= 0:
            return arr
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, gap)
        if axis == 0 and arr.shape[0] > 0:
            return np.pad(arr, widths, mode='edge')
        return np.pad(arr, widths, mode='constant')

    def bucket_feed(self, feed):
        """One feed dict -> (padded feed dict, true batch size).  Arrays
        whose leading dim is not the batch pass through unpadded, and so
        does a two-level LoDTensor (its rows are inner sequences)."""
        arrays = {k: (v if isinstance(v, LoDTensor) else np.asarray(v))
                  for k, v in feed.items()}
        dims = [d for d in (_leading_dim(v) for v in arrays.values())
                if d is not None]
        if not dims:
            raise ValueError('bucket_feed needs at least one batched feed')
        batch = dims[0]
        target = self.boundary(batch)
        out = {}
        for k, v in arrays.items():
            if isinstance(v, LoDTensor):
                if v.outer_lengths is not None:
                    out[k] = v
                    continue
                padded, lengths = v.padded, v.lengths
                if padded.shape[0] == batch:
                    padded = self._pad_axis(padded, 0, target)
                    lengths = self._pad_axis(lengths, 0, target)
                if k in self.seq_names:
                    padded = self._pad_axis(padded, 1,
                                            self.boundary(padded.shape[1]))
                out[k] = LoDTensor(padded, lengths)
                continue
            if v.ndim and v.shape[0] == batch:
                v = self._pad_axis(v, 0, target)
            if k in self.seq_names and v.ndim >= 2:
                v = self._pad_axis(v, 1, self.boundary(v.shape[1]))
            out[k] = v
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


class DataFeeder(object):
    """Rows of a reader -> one feed dict of `feed_list`'s vars: a dense
    slot stacks its elements, each reshaped to the slot's shape; a ragged
    slot (lod_level > 0) becomes a LoDTensor of its sequences, padded to
    the batch's longest (counterpart of paddle_tpu/data_feeder.py
    DataFeeder)."""

    def __init__(self, feed_list, place=None, program=None):
        self.feed_dtypes, self.feed_names = [], []
        self.feed_shapes, self.feed_lod_level = [], []
        if program is None:
            program = default_main_program()
        for var in feed_list:
            if isinstance(var, str):
                var = program.global_block().var(var)
            if not isinstance(var, Variable):
                raise TypeError('feed_list should hold Variables')
            self.feed_dtypes.append(var.dtype)
            self.feed_names.append(var.name)
            self.feed_lod_level.append(var.lod_level)
            # strip the batch (and, for a lod var, the time) dim
            self.feed_shapes.append(
                var.shape[2:] if var.lod_level > 0 else var.shape[1:])
        self.place = place

    def feed(self, iterable):
        rows = list(iterable)
        feed = {}
        for i, name in enumerate(self.feed_names):
            dtype = convert_dtype(self.feed_dtypes[i])
            shape = self.feed_shapes[i]
            col = [row[i] for row in rows]
            if self.feed_lod_level[i] > 0:
                seqs = [np.asarray(c, dtype=dtype) for c in col]
                seqs = [s.reshape(len(s), *shape) if shape else
                        s.reshape(len(s), 1) for s in
                        (s.reshape(-1) if s.ndim == 1 else s for s in seqs)]
                feed[name] = create_lod_tensor(seqs)
            else:
                tshape = tuple(int(abs(d)) for d in shape)
                # each element reshapes to the slot shape on its own: rows
                # may arrive flat or already shaped
                elems = [np.asarray(c, dtype=dtype).reshape(tshape)
                         for c in col]
                feed[name] = (np.stack(elems) if elems else
                              np.zeros((0,) + tshape, dtype))
        return feed
