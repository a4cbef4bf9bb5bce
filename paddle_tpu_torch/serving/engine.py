"""ServingEngine — continuous batching over a Predictor and a FeedBucketer.

Counterpart of paddle_tpu/serving/engine.py:

  * Clients ``submit()`` single feed dicts (leading dim = rows) and get a
    :class:`ServeFuture`.  Every admitted request gets a terminal reply —
    result, deadline-exceeded, shed or error — even through drain and
    engine stop; a request that never resolves is a bug, counted as
    ``serving.deadlocks``.
  * A dispatch thread coalesces queued requests with the same feed
    signature into one batch, pads it onto a FeedBucketer boundary, runs
    the backend once (the Predictor: the device work, kernels included)
    and scatters per-request row slices back out.
  * Admission runs in the client's thread: state gate (a draining engine
    refuses), shape sanity (batch 0 and batches above the largest bucket
    are rejected, never truncated), per-request deadlines (expired ones
    are refused at the door or dropped before dispatch), a token-bucket
    rate limit, and a bounded queue with a ``reject`` / ``block`` /
    ``shed_oldest`` overflow policy.
  * A :class:`~paddle_tpu_torch.serving.breaker.CircuitBreaker` trips on
    consecutive batch failures and drops the engine to one request per
    dispatch until a probe batch succeeds.

Numbers land in the engine's own :class:`Counters` (``engine.counters``).
Not ported yet: the flight recorder, traceparent spans, the /metrics HTTP
exporter, the fault-injection hooks and the SIGTERM drain handler.
"""
import collections
import threading
import time

import numpy as np

from .admission import OVERFLOW_POLICIES, TokenBucket
from .breaker import CLOSED, CircuitBreaker
from .counters import Counters

__all__ = ['ServingConfig', 'ServingEngine', 'ServeFuture', 'ServeResult',
           'STARTING', 'READY', 'DEGRADED', 'DRAINING', 'STOPPED',
           'OK', 'REJECTED', 'SHED', 'DEADLINE_EXCEEDED', 'ERROR']

# engine health states
STARTING, READY, DEGRADED = 'starting', 'ready', 'degraded'
DRAINING, STOPPED = 'draining', 'stopped'
_STATE_GAUGE = {STARTING: 0, READY: 1, DEGRADED: 2, DRAINING: 3, STOPPED: 4}

# terminal reply statuses
OK, REJECTED, SHED = 'ok', 'rejected', 'shed'
DEADLINE_EXCEEDED, ERROR = 'deadline_exceeded', 'error'


class ServingConfig(object):
    def __init__(self, max_queue=64, overflow_policy='reject',
                 block_timeout_s=1.0, max_batch_rows=64,
                 batch_linger_s=0.0, default_timeout_s=None,
                 rate_qps=None, rate_burst=None,
                 breaker_failure_threshold=3, breaker_cooldown_s=0.25,
                 drain_timeout_s=10.0):
        if overflow_policy not in OVERFLOW_POLICIES:
            raise ValueError('overflow_policy must be one of %s, got %r'
                             % (OVERFLOW_POLICIES, overflow_policy))
        if int(max_queue) < 1:
            raise ValueError('max_queue must be >= 1')
        if int(max_batch_rows) < 1:
            raise ValueError('max_batch_rows must be >= 1')
        self.max_queue = int(max_queue)
        self.overflow_policy = overflow_policy
        self.block_timeout_s = float(block_timeout_s)
        self.max_batch_rows = int(max_batch_rows)
        self.batch_linger_s = float(batch_linger_s)
        self.default_timeout_s = default_timeout_s
        self.rate_qps = rate_qps
        self.rate_burst = rate_burst
        self.breaker_failure_threshold = int(breaker_failure_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.drain_timeout_s = float(drain_timeout_s)


class ServeResult(object):
    """One terminal reply: ``status`` is ``ok`` / ``rejected`` / ``shed`` /
    ``deadline_exceeded`` / ``error``; ``outputs`` the per-request fetch
    arrays (``ok`` only); ``error`` the exception or refusal message;
    ``reason`` the machine-readable tag of ``serving.rejected.<reason>``."""
    __slots__ = ('status', 'outputs', 'error', 'reason', 'latency_s')

    def __init__(self, status, outputs=None, error=None, reason=None,
                 latency_s=None):
        self.status = status
        self.outputs = outputs
        self.error = error
        self.reason = reason
        self.latency_s = latency_s

    @property
    def ok(self):
        return self.status == OK

    def __repr__(self):
        return ('ServeResult(%s%s%s)'
                % (self.status,
                   ', reason=%r' % self.reason if self.reason else '',
                   ', latency=%.1fms' % (self.latency_s * 1e3)
                   if self.latency_s is not None else ''))


class ServeFuture(object):
    """Client handle: blocks in ``result()`` until the terminal reply."""
    __slots__ = ('_event', '_result', '_lock')

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._lock = threading.Lock()

    def _resolve(self, result):
        with self._lock:
            if self._result is not None:
                return False
            self._result = result
        self._event.set()
        return True

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError('serving reply not ready within %r s'
                               % timeout)
        return self._result

    @property
    def status(self):
        return self._result.status if self._result is not None else None


class _Request(object):
    __slots__ = ('feed', 'rows', 'signature', 'deadline', 'future',
                 't_submit')

    def __init__(self, feed, rows, signature, deadline, t_submit):
        self.feed = feed
        self.rows = rows
        self.signature = signature
        self.deadline = deadline
        self.future = ServeFuture()
        self.t_submit = t_submit


class ServingEngine(object):
    """See module docstring.  ``backend`` is any callable ``feed_dict ->
    list of per-row output arrays``, usually a Predictor's ``run``; a
    plain function works too.  ``counters`` is the Counters the engine
    writes to (a new one when None; the generation engine passes its
    runtime's)."""

    def __init__(self, backend, bucketer=None, config=None,
                 clock=time.monotonic, counters=None):
        self._backend = backend
        self._bucketer = bucketer
        self._cfg = config or ServingConfig()
        self._clock = clock
        self.counters = counters if counters is not None else Counters()
        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._state = STARTING
        self._stopping = False
        self._thread = None
        self._stopped = threading.Event()
        self._out_lock = threading.Lock()
        self._outstanding = set()
        self._rate = (TokenBucket(self._cfg.rate_qps, self._cfg.rate_burst,
                                  clock=clock)
                      if self._cfg.rate_qps else None)
        self.breaker = CircuitBreaker(
            failure_threshold=self._cfg.breaker_failure_threshold,
            cooldown_s=self._cfg.breaker_cooldown_s, clock=clock,
            counters=self.counters)
        # a request that cannot fit the largest bucket is refused at the
        # door instead of being truncated
        self._row_limit = self._cfg.max_batch_rows
        if bucketer is not None:
            self._row_limit = min(self._row_limit,
                                  int(bucketer.boundaries[-1]))
        self.counters.set('serving.state', _STATE_GAUGE[STARTING])

    @classmethod
    def from_predictor(cls, predictor, bucketer=None, config=None, **kw):
        eng = cls(predictor.run, bucketer=bucketer, config=config, **kw)
        eng._predictor = predictor
        return eng

    # ----------------------------------------------------------- state
    def _set_state(self, state):
        self._state = state
        self.counters.set('serving.state', _STATE_GAUGE[state])

    @property
    def state(self):
        """Health state; READY shows as DEGRADED while the breaker is not
        closed (still serving, on the slow path)."""
        with self._cond:
            s = self._state
        if s == READY and self.breaker.state != CLOSED:
            return DEGRADED
        return s

    def ready(self):
        return self.state in (READY, DEGRADED)

    def health(self):
        with self._cond:
            depth = len(self._queue)
        with self._out_lock:
            outstanding = len(self._outstanding)
        return {'state': self.state, 'queue_depth': depth,
                'outstanding': outstanding, 'breaker': self.breaker.state,
                'accepting': self.ready()}

    # ----------------------------------------------------- lifecycle
    def start(self):
        with self._cond:
            if self._thread is not None:
                return self
            self._thread = threading.Thread(target=self._loop,
                                            name='ServingDispatch',
                                            daemon=True)
            self._set_state(READY)
            self._thread.start()
        return self

    def begin_drain(self):
        """Refuse new requests, keep dispatching until the queue is empty,
        then stop.  Non-blocking."""
        with self._cond:
            if self._state in (DRAINING, STOPPED):
                return
            started = self._thread is not None
            self._set_state(DRAINING)
            self._cond.notify_all()
        if not started:
            self._finish_stop()

    def wait_drained(self, timeout=None):
        return self._stopped.wait(timeout)

    def drain(self, timeout=None):
        """begin_drain + wait; True when fully stopped."""
        self.begin_drain()
        ok = self.wait_drained(self._cfg.drain_timeout_s
                               if timeout is None else timeout)
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        return ok

    def stop(self, timeout=None):
        """Drain, then force the dispatch loop down if the drain budget
        expires; leftover queued requests still get (shed) replies."""
        self.begin_drain()
        budget = self._cfg.drain_timeout_s if timeout is None else timeout
        if not self.wait_drained(budget):
            with self._cond:
                self._stopping = True
                self._cond.notify_all()
            self.wait_drained(5.0)
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        return self._stopped.is_set()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ----------------------------------------------------- admission
    def submit(self, feed, timeout_s=None):
        """Submit one request (dict name -> array with a leading batch
        dim).  Always returns a ServeFuture; refusals come back as an
        already-terminal ``rejected`` result with a named reason."""
        t_submit = self._clock()
        self.counters.inc('serving.submitted')
        try:
            arrays = {k: np.asarray(v) for k, v in dict(feed).items()}
        except (TypeError, ValueError) as e:
            return self._rejected(t_submit, 'bad_request',
                                  'unfeedable request: %r' % (e,))
        if not arrays:
            return self._rejected(t_submit, 'bad_request', 'empty feed dict')
        dims = {a.shape[0] for a in arrays.values() if a.ndim >= 1}
        if len(dims) != 1 or any(a.ndim == 0 for a in arrays.values()):
            return self._rejected(
                t_submit, 'bad_request',
                'request feeds need one shared leading batch dim; got '
                'shapes %s' % {k: a.shape for k, a in arrays.items()})
        rows = dims.pop()
        if rows == 0:
            return self._rejected(
                t_submit, 'empty_batch',
                'batch=0 request rejected: a serving request must carry '
                'at least one row (got leading dim 0)')
        if rows > self._row_limit:
            return self._rejected(
                t_submit, 'too_large',
                'request batch %d exceeds the serving limit %d (largest '
                'bucket boundary / max_batch_rows); split the request — '
                'nothing is silently truncated' % (rows, self._row_limit))
        if timeout_s is None:
            timeout_s = self._cfg.default_timeout_s
        deadline = None
        if timeout_s is not None:
            if timeout_s <= 0:
                return self._rejected(
                    t_submit, 'deadline',
                    'deadline already expired at admission '
                    '(timeout_s=%r)' % timeout_s)
            deadline = t_submit + float(timeout_s)
        if self._rate is not None and not self._rate.try_acquire():
            return self._rejected(t_submit, 'rate',
                                  'token-bucket rate limit exceeded '
                                  '(rate_qps=%r)' % self._cfg.rate_qps)
        signature = tuple(sorted((k, str(a.dtype), a.shape[1:])
                                 for k, a in arrays.items()))
        req = _Request(arrays, int(rows), signature, deadline, t_submit)
        return self._admit(req, t_submit)

    def _admit(self, req, t_submit):
        cfg = self._cfg
        with self._cond:
            if self._state != READY:
                reason = ('not_ready' if self._state == STARTING
                          else 'draining')
                return self._rejected_locked(
                    req, reason, 'engine is %s; request refused'
                    % self._state)
            overflow = len(self._queue) >= cfg.max_queue
            if overflow and cfg.overflow_policy == 'block':
                limit = t_submit + cfg.block_timeout_s
                while len(self._queue) >= cfg.max_queue \
                        and self._state == READY:
                    left = limit - self._clock()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                if self._state != READY:
                    return self._rejected_locked(
                        req, 'draining', 'engine began draining while '
                        'blocked on a full queue')
                overflow = len(self._queue) >= cfg.max_queue
            shed_req = None
            if overflow:
                if cfg.overflow_policy == 'shed_oldest' and self._queue:
                    shed_req = self._queue.popleft()
                elif cfg.overflow_policy != 'shed_oldest':
                    return self._rejected_locked(
                        req, 'full', 'request queue full '
                        '(max_queue=%d, policy=%s)'
                        % (cfg.max_queue, cfg.overflow_policy))
            self._queue.append(req)
            with self._out_lock:
                self._outstanding.add(req)
            self.counters.inc('serving.admitted')
            self.counters.set('serving.queue_depth', len(self._queue))
            self._cond.notify_all()
        if shed_req is not None:
            self._resolve(shed_req, SHED, reason='overflow',
                          error='shed: newest request displaced the '
                                'oldest queued one (shed_oldest policy)')
        return req.future

    def _rejected(self, t_submit, reason, message):
        fut = ServeFuture()
        fut._resolve(ServeResult(REJECTED, error=message, reason=reason,
                                 latency_s=self._clock() - t_submit))
        self.counters.inc('serving.rejected')
        self.counters.inc('serving.rejected.%s' % reason)
        return fut

    def _rejected_locked(self, req, reason, message):
        # refusal of an already-built request that is not yet queued
        req.future._resolve(ServeResult(
            REJECTED, error=message, reason=reason,
            latency_s=self._clock() - req.t_submit))
        self.counters.inc('serving.rejected')
        self.counters.inc('serving.rejected.%s' % reason)
        return req.future

    def infer(self, feed, timeout_s=None, wait_timeout=None):
        """Blocking convenience: ``submit().result()``."""
        return self.submit(feed, timeout_s=timeout_s).result(wait_timeout)

    # ----------------------------------------------------- dispatch
    def _loop(self):
        try:
            while True:
                expired, batch, mode = self._next_batch()
                for r in expired:
                    self._resolve(
                        r, DEADLINE_EXCEEDED, reason='queue_wait',
                        error='deadline expired while queued; dropped '
                              'pre-dispatch (no compute was spent)')
                if batch is None:
                    return
                if batch:
                    self._run_batch(batch, mode)
        finally:
            self._finish_stop()

    def _next_batch(self):
        """(expired_requests, batch | None, mode); batch None means the
        loop should exit (drained or force-stopped)."""
        cfg = self._cfg
        with self._cond:
            while True:
                if self._stopping:
                    return [], None, None
                if self._queue:
                    break
                if self._state == DRAINING:
                    return [], None, None
                self._cond.wait(0.05)
            if cfg.batch_linger_s > 0 and self._state == READY \
                    and sum(r.rows for r in self._queue) \
                    < cfg.max_batch_rows:
                self._cond.wait(cfg.batch_linger_s)
            now = self._clock()
            expired = [r for r in self._queue
                       if r.deadline is not None and r.deadline <= now]
            if expired:
                gone = set(map(id, expired))
                self._queue = collections.deque(
                    r for r in self._queue if id(r) not in gone)
            mode = self.breaker.mode()
            batch, taken_rows = [], 0
            if self._queue:
                if mode == 'slow':
                    batch.append(self._queue.popleft())
                else:
                    sig = self._queue[0].signature
                    keep = collections.deque()
                    for r in self._queue:
                        if r.signature == sig \
                                and taken_rows + r.rows <= cfg.max_batch_rows:
                            batch.append(r)
                            taken_rows += r.rows
                        else:
                            keep.append(r)
                    self._queue = keep
            self.counters.set('serving.queue_depth', len(self._queue))
            self._cond.notify_all()   # wake blocked submitters
        return expired, batch, mode

    def _run_batch(self, batch, mode):
        t0 = time.perf_counter()
        now = self._clock()
        for r in batch:
            self.counters.observe('serving.queue_wait_ms',
                                  max(0.0, (now - r.t_submit) * 1e3))
        total_rows = sum(r.rows for r in batch)
        if len(batch) == 1:
            feed = batch[0].feed
        else:
            feed = {k: np.concatenate([r.feed[k] for r in batch])
                    for k in batch[0].feed}
        if self._bucketer is not None:
            feed, _true = self._bucketer.bucket_feed(feed)
        dispatched_rows = next((int(a.shape[0]) for a in feed.values()
                                if getattr(a, 'ndim', 0) >= 1), total_rows)
        try:
            outs = self._backend(feed)
        except Exception as e:  # noqa: BLE001 - replied to every request
            self.breaker.record_failure()
            self.counters.inc('serving.batch_failures')
            for r in batch:
                self._resolve(r, ERROR, error=e, reason='dispatch')
            return
        self.breaker.record_success()
        outs = [np.asarray(o) for o in outs]
        # scatter: per-row outputs slice back to their request; outputs
        # without the batch leading dim go to every request whole
        off = 0
        for r in batch:
            slices = []
            for o in outs:
                if o.ndim >= 1 and o.shape[0] >= total_rows:
                    slices.append(o[off:off + r.rows])
                else:
                    slices.append(o)
            off += r.rows
            self._resolve(r, OK, outputs=slices)
        self.counters.inc('serving.batches')
        if mode == 'slow':
            self.counters.inc('serving.slow_path_batches')
        self.counters.observe('serving.batch_rows', total_rows)
        self.counters.observe('serving.dispatched_rows', dispatched_rows)
        self.counters.observe('serving.batch_ms',
                              (time.perf_counter() - t0) * 1e3)

    # ----------------------------------------------------- resolution
    def _resolve(self, req, status, outputs=None, error=None, reason=None):
        res = ServeResult(status, outputs=outputs, error=error,
                          reason=reason,
                          latency_s=self._clock() - req.t_submit)
        if not req.future._resolve(res):
            return
        with self._out_lock:
            self._outstanding.discard(req)
        if status == OK:
            self.counters.inc('serving.completed')
            self.counters.observe('serving.latency_ms', res.latency_s * 1e3)
        elif status == SHED:
            self.counters.inc('serving.shed')
        elif status == DEADLINE_EXCEEDED:
            self.counters.inc('serving.deadline_exceeded')
        elif status == ERROR:
            self.counters.inc('serving.errors')

    def _finish_stop(self):
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
            self._set_state(STOPPED)
            self._cond.notify_all()
        for r in leftovers:
            self._resolve(r, SHED, reason='shutdown',
                          error='engine stopped before dispatch; request '
                                'shed during shutdown')
        # every admitted request was batched, expired or shed above;
        # anything still outstanding fell through a crack — reply, loudly
        with self._out_lock:
            stragglers = list(self._outstanding)
            self._outstanding.clear()
        for r in stragglers:
            self.counters.inc('serving.deadlocks')
            self._resolve(r, ERROR, reason='deadlock',
                          error='engine stopped with this request '
                                'unresolved — serving bug (counted in '
                                'serving.deadlocks)')
        self._stopped.set()
