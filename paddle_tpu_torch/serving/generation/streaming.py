"""Token streaming through the engine reply path.

Counterpart of paddle_tpu/serving/generation/streaming.py.  A
:class:`TokenStream` is the ServeFuture of a generation request, extended
with per-token delivery: the scheduler ``_push``es each sampled token as
its decode window completes, and the client iterates ``tokens()`` while
the request is still running.  The terminal reply keeps the engine's
contract: one ServeResult, resolved once (EOS, max-token, cancel,
deadline, error or shutdown shed), which also closes the token iterator.
``cancel()`` is a client-side flag the scheduler sweeps at the next round
boundary, retiring the request as a ``shed`` reply with reason
``cancelled``.  A stream the paged KV pool cannot grow mid-flight closes
with a terminal ``error`` reply, reason ``kv_oom``; the tokens streamed
so far stay readable via ``tokens_so_far()``.
"""
import queue
import threading

from ..engine import ServeFuture

__all__ = ['TokenStream']

_DONE = object()


class TokenStream(ServeFuture):
    """Client handle for one generation request: iterate ``tokens()`` for
    live delivery, then (or instead) block on ``result()`` for the terminal
    reply.  ``ok`` results carry ``reason`` ``'eos'`` or ``'max_tokens'``
    and ``outputs=[generated_ids]``."""
    __slots__ = ('_tokens_q', '_emitted', '_cancelled')

    def __init__(self):
        ServeFuture.__init__(self)
        self._tokens_q = queue.Queue()
        self._emitted = []
        self._cancelled = threading.Event()

    # ------------------------------------------------- scheduler side
    def _push(self, token):
        self._emitted.append(int(token))
        self._tokens_q.put(int(token))

    def _resolve(self, result):
        first = ServeFuture._resolve(self, result)
        if first:
            self._tokens_q.put(_DONE)   # close any live tokens() iterator
        return first

    # ---------------------------------------------------- client side
    def cancel(self):
        """Ask the scheduler to stop decoding this request.  Swept at the
        next round boundary; already-terminal requests ignore it."""
        self._cancelled.set()

    @property
    def cancelled(self):
        return self._cancelled.is_set()

    def tokens(self, timeout=None):
        """Yield token ids as they arrive until the terminal reply.
        ``timeout`` bounds the wait for EACH token (TimeoutError)."""
        while True:
            try:
                item = self._tokens_q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError('no token within %r s' % (timeout,))
            if item is _DONE:
                return
            yield item

    def tokens_so_far(self):
        """Snapshot of everything streamed so far (no blocking)."""
        return list(self._emitted)
