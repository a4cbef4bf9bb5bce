"""GenerationEngine: prefill/decode continuous batching on the serving
engine.

Counterpart of paddle_tpu/serving/generation/scheduler.py.  The
ServingEngine coalesces same-signature one-shot requests into batches;
generation requests are long-lived instead, so this subclass replaces the
dispatch loop with a round-based scheduler over the DecodeRuntime's KV
slots:

  round := sweep (cancel / deadline / TTFT / ITL)
         -> claim queued requests into free slots WITH pages
         -> ONE prefill chunk for the oldest still-prefilling request
         -> ONE decode (or speculative verify) window for ALL decoding
            slots

Memory admission is PAGED (kv_cache.PagePool): a queued request is
claimed only when a slot AND the pages for its prompt plus one decode
window are both available; pool shortage leaves it QUEUED
(``generation.kv_backpressure``), it is never truncated.  A request whose
prompt+max_new could not fit even an idle pool is refused at admission
with reason ``kv_oom``; a stream whose window cannot grow mid-flight
retires with a terminal ``error`` / ``kv_oom`` reply.  Prefix-cache hits
skip straight to their first unshared chunk (`DecodeRuntime.try_begin`)
and completed prompts are published for later requests
(`promote_prefix`).

With ``GenerationConfig.speculative`` (default off; env
``PT_SPEC_DECODE``) the decode window becomes draft-propose + VERIFY: a
host-side n-gram draft proposes K-1 tokens per stream, one batched verify
window samples the target model at every position, and each stream keeps
the longest accepted prefix (``generation.spec_proposed`` /
``spec_accepted``); greedy streams equal non-speculative decode.

Every admitted request gets exactly one terminal reply: ``ok`` (reason
``eos`` / ``max_tokens``), ``deadline_exceeded`` (queue wait, overall
deadline, TTFT or ITL budget), ``shed`` (cancel, shutdown), ``rejected``
(admission) or ``error`` (a failed prefill or decode window, mid-stream
``kv_oom``), through drain and stop alike.

Metrics go to the engine's `Counters` (the runtime's, shared with its
page pool): ``serving.ttft_ms`` (submit to first token) and
``serving.itl_ms`` (the amortized inter-token gap) histograms with
quantiles, ``generation.tokens``, ``generation.kv_pages_in_use``,
``generation.prefix_hits`` and the round counters below.  The decode step
is the ``decode_step`` fault site (testing/faults.py), checked on the host
before the window runs, so a fault never fires inside a CUDA graph's
capture or replay.  Not ported: the flight recorder and trace spans.
"""
import time

import numpy as np

from ...testing import faults as _faults
from ..engine import (DEADLINE_EXCEEDED, DRAINING, ERROR, OK, REJECTED,
                      SHED, ServeResult, ServingEngine, _Request)
from .sampling import SamplingParams, draft_ngram
from .streaming import TokenStream

__all__ = ['GenerationConfig', 'GenerationEngine']


class GenerationConfig(object):
    """Generation-side knobs (the queue, rate and breaker knobs stay on
    ServingConfig).  ``decode_window`` is K, the tokens a decode window
    advances each stream; ``ttft_timeout_s`` / ``itl_timeout_s`` are the
    default per-token SLO budgets (overridable per request);
    ``speculative`` swaps the decode window for draft + verify (default
    off; env ``PT_SPEC_DECODE=1`` turns it on, ``=0`` is a hard kill switch
    over an explicit True)."""

    def __init__(self, decode_window=4, eos_id=None, max_new_default=16,
                 ttft_timeout_s=None, itl_timeout_s=None,
                 speculative=None):
        import os
        if int(decode_window) < 1:
            raise ValueError('decode_window must be >= 1')
        self.decode_window = int(decode_window)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.max_new_default = int(max_new_default)
        self.ttft_timeout_s = ttft_timeout_s
        self.itl_timeout_s = itl_timeout_s
        env = os.environ.get('PT_SPEC_DECODE', '').strip().lower()
        if env in ('0', 'off', 'false'):
            self.speculative = False
        elif speculative is None:
            self.speculative = env in ('1', 'on', 'true')
        else:
            self.speculative = bool(speculative)


class _GenRequest(_Request):
    __slots__ = ('prompt', 'max_new', 'params', 'ttft_timeout',
                 'itl_timeout', 'slot', 'offset', 'produced',
                 't_last_token')

    def __init__(self, prompt, max_new, params, deadline, t_submit,
                 ttft_timeout=None, itl_timeout=None):
        _Request.__init__(self, {'prompt': prompt}, 1, ('generate',),
                          deadline, t_submit)
        self.future = TokenStream()   # streaming reply handle
        self.prompt = prompt
        self.max_new = int(max_new)
        self.params = params
        self.ttft_timeout = ttft_timeout
        self.itl_timeout = itl_timeout
        self.slot = None
        self.offset = 0          # prompt tokens prefilled so far
        self.produced = 0        # tokens streamed so far
        self.t_last_token = None


class GenerationEngine(ServingEngine):
    """Streaming decode server over one :class:`DecodeRuntime`.

        engine = GenerationEngine(runtime).start()
        stream = engine.generate([1, 2, 3], max_new=32, temperature=0.8,
                                 top_k=40, seed=7)
        for tok in stream.tokens():
            ...
        reply = stream.result()       # ServeResult, reason='eos'/...

    Admission (queue bound, overflow policy, rate limit, drain gate) is
    inherited; ``submit()`` is closed off: generation requests go through
    :meth:`generate`.  The engine's counters are the runtime's.
    """

    def __init__(self, runtime, config=None, gen_config=None,
                 clock=time.monotonic):
        ServingEngine.__init__(self, self._no_backend, bucketer=None,
                               config=config, clock=clock,
                               counters=runtime.counters)
        self.runtime = runtime
        self._gen = gen_config or GenerationConfig()
        self._active = []        # slot-holding requests, admission order

    @staticmethod
    def _no_backend(feed):
        raise TypeError('GenerationEngine has no one-shot backend; '
                        'requests go through generate()')

    def submit(self, feed, timeout_s=None):
        raise TypeError('GenerationEngine serves token streams: use '
                        'generate(prompt_ids, ...) instead of submit()')

    # ----------------------------------------------------- admission
    def _rejected_gen(self, t_submit, reason, message):
        # the base _rejected builds a plain ServeFuture; generation
        # refusals still hand back an (already closed) TokenStream
        fut = TokenStream()
        fut._resolve(ServeResult(REJECTED, error=message, reason=reason,
                                 latency_s=self._clock() - t_submit))
        self.counters.inc('serving.rejected')
        self.counters.inc('serving.rejected.%s' % reason)
        return fut

    def generate(self, prompt_ids, max_new=None, temperature=0.0, top_k=0,
                 seed=0, timeout_s=None, ttft_timeout_s=None,
                 itl_timeout_s=None):
        """Admit one generation request; always returns a
        :class:`TokenStream` (refusals come back already terminal with a
        named reason, never an exception and never silence)."""
        t_submit = self._clock()
        self.counters.inc('serving.submitted')
        try:
            prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
            params = SamplingParams(temperature=temperature, top_k=top_k,
                                    seed=seed)
        except (TypeError, ValueError, OverflowError) as e:
            return self._rejected_gen(t_submit, 'bad_request',
                                      'unusable request: %r' % (e,))
        if prompt.size == 0:
            return self._rejected_gen(t_submit, 'bad_request',
                                      'empty prompt')
        if max_new is None:
            max_new = self._gen.max_new_default
        if int(max_new) < 1:
            return self._rejected_gen(t_submit, 'bad_request',
                                      'max_new must be >= 1, got %r'
                                      % (max_new,))
        limit = self.runtime.max_len
        if prompt.size + int(max_new) > limit:
            # the hard context ceiling: refuse with the arithmetic spelled
            # out; a prompt is NEVER silently truncated
            return self._rejected_gen(
                t_submit, 'too_long',
                'prompt of %d tokens + max_new=%d exceeds the runtime '
                'context window max_len=%d; shorten the prompt or lower '
                'max_new; nothing is silently truncated'
                % (prompt.size, int(max_new), limit))
        if self.runtime.never_fits(prompt.size, int(max_new)):
            # transient pool pressure means WAIT (backpressure), but a
            # request bigger than the whole pool can never run
            return self._rejected_gen(
                t_submit, 'kv_oom',
                'prompt of %d tokens + max_new=%d needs more KV pages than '
                'the entire pool holds (%d pages of %d tokens); nothing is '
                'silently truncated'
                % (prompt.size, int(max_new), self.runtime.pool.capacity,
                   self.runtime.cache.page_len))
        if timeout_s is None:
            timeout_s = self._cfg.default_timeout_s
        deadline = None
        if timeout_s is not None:
            if timeout_s <= 0:
                return self._rejected_gen(
                    t_submit, 'deadline',
                    'deadline already expired at admission (timeout_s=%r)'
                    % timeout_s)
            deadline = t_submit + float(timeout_s)
        if self._rate is not None and not self._rate.try_acquire():
            return self._rejected_gen(
                t_submit, 'rate', 'token-bucket rate limit exceeded '
                '(rate_qps=%r)' % self._cfg.rate_qps)
        req = _GenRequest(
            prompt, int(max_new), params, deadline, t_submit,
            ttft_timeout=(self._gen.ttft_timeout_s if ttft_timeout_s is None
                          else ttft_timeout_s),
            itl_timeout=(self._gen.itl_timeout_s if itl_timeout_s is None
                         else itl_timeout_s))
        return self._admit(req, t_submit)

    # ----------------------------------------------------- scheduling
    def _loop(self):
        try:
            while self._round():
                pass
        finally:
            # slot-holding requests get their terminal (shed) reply BEFORE
            # the base deadlock audit counts stragglers
            self._shed_active()
            self._finish_stop()

    def _round(self):
        """One scheduler round; False means the loop should exit."""
        with self._cond:
            while not self._queue and not self._active:
                if self._stopping or self._state == DRAINING:
                    return False
                self._cond.wait(0.05)
            if self._stopping:
                return False
            now = self._clock()
            expired, dropped = [], []
            for r in list(self._queue):
                if r.deadline is not None and r.deadline <= now:
                    expired.append(r)
                elif r.future.cancelled:
                    dropped.append(r)
            if expired or dropped:
                gone = set(map(id, expired + dropped))
                self._queue = type(self._queue)(
                    r for r in self._queue if id(r) not in gone)
            while self._queue:
                nxt = self._queue[0]
                slot = self.runtime.alloc_slot()
                if slot is None:
                    break
                start = self.runtime.try_begin(slot, nxt.prompt,
                                               self._gen.decode_window)
                if start is None:
                    # pool shortage: the request STAYS QUEUED (admission
                    # backpressure) and the slot goes back; retiring
                    # streams free pages and a later round claims again
                    self.runtime.free_slot(slot)
                    self.counters.inc('generation.kv_backpressure')
                    break
                r = self._queue.popleft()
                r.slot = slot
                r.offset = int(start)   # prefix-cache hits skip ahead
                self._active.append(r)
            self.counters.set('serving.queue_depth', len(self._queue))
            self._cond.notify_all()
        for r in expired:
            self._resolve(r, DEADLINE_EXCEEDED, reason='queue_wait',
                          error='deadline expired while queued; dropped '
                                'pre-dispatch (no compute was spent)')
        for r in dropped:
            self.counters.inc('generation.cancelled')
            self._resolve(r, SHED, reason='cancelled',
                          error='cancelled while queued')
        self._sweep_active()
        did_prefill = self._prefill_step()
        did_decode = self._decode_step()
        if did_prefill and did_decode:
            self.counters.inc('generation.mixed_dispatches')
        return True

    def _sweep_active(self):
        """Terminal conditions checked at every round boundary."""
        now = self._clock()
        for r in list(self._active):
            if r.future.cancelled:
                self.counters.inc('generation.cancelled')
                self._retire(r, SHED, reason='cancelled',
                             error='cancelled by the client mid-stream')
            elif r.deadline is not None and r.deadline <= now:
                self._retire(r, DEADLINE_EXCEEDED, reason='deadline',
                             error='overall deadline expired mid-stream')
            elif r.ttft_timeout is not None and r.produced == 0 \
                    and now - r.t_submit > r.ttft_timeout:
                self._retire(r, DEADLINE_EXCEEDED, reason='ttft',
                             error='no first token within the TTFT budget '
                                   '(%gs)' % r.ttft_timeout)
            elif r.itl_timeout is not None and r.produced > 0 \
                    and now - r.t_last_token > r.itl_timeout:
                self._retire(r, DEADLINE_EXCEEDED, reason='itl',
                             error='inter-token gap exceeded the ITL budget '
                                   '(%gs)' % r.itl_timeout)

    def _prefill_step(self):
        """Advance the OLDEST still-prefilling request by one chunk.
        Bounded work per round: long prompts cannot starve the decode
        batch."""
        rt = self.runtime
        pre = [r for r in self._active if r.offset < r.prompt.size]
        if not pre:
            return False
        r = min(pre, key=lambda x: x.t_submit)
        t0 = time.perf_counter()
        try:
            chunk = r.prompt[r.offset:r.offset + rt.prefill_chunk]
            first, _logits = rt.prefill(r.slot, chunk, r.offset, r.params)
            r.offset += int(chunk.size)
        except Exception as e:  # noqa: BLE001 - replied to the request
            self.breaker.record_failure()
            self.counters.inc('serving.batch_failures')
            self._retire(r, ERROR, error=e, reason='prefill')
            return True
        self.counters.inc('generation.prefill_chunks')
        self.counters.observe('generation.prefill_chunk_ms',
                              (time.perf_counter() - t0) * 1e3)
        if r.offset >= r.prompt.size:
            # prompt complete: publish its full pages for later
            # prefix-sharing requests, then emit the final chunk's sample,
            # the first token (TTFT)
            rt.promote_prefix(r.slot, r.prompt)
            self._emit_tokens(r, [int(first)])
        return True

    def _decode_step(self):
        """One K-token window (plain decode or speculative verify) over
        every decoding slot."""
        rt = self.runtime
        dec = [r for r in self._active if r.offset >= r.prompt.size]
        if not dec:
            return False
        S, K = rt.slots, self._gen.decode_window
        # grow every stream's block table to cover this window FIRST: a
        # stream the pool cannot grow gets a terminal kv_oom reply (never
        # truncated, never silently stalled) and its freed pages may
        # rescue the streams after it
        for r in list(dec):
            if rt.ensure_capacity(r.slot, int(rt.host_len[r.slot]) + K):
                continue
            self.counters.inc('generation.kv_oom')
            snap = rt.pool_snapshot()
            dec.remove(r)
            self._retire(
                r, ERROR, reason='kv_oom',
                error='KV page pool exhausted mid-stream (%d/%d pages '
                      'live); partial output is in tokens_so_far()'
                      % (snap['pages_in_use'], snap['pages_capacity']))
        if not dec:
            return False
        active = np.zeros(S, bool)
        seeds = np.zeros(S, np.int64)
        temps = np.zeros(S, np.float32)
        topks = np.zeros(S, np.int64)
        for r in dec:
            active[r.slot] = True
            seeds[r.slot] = r.params.seed
            temps[r.slot] = r.params.temperature
            topks[r.slot] = r.params.top_k
        speculative = self._gen.speculative and K > 1
        t0 = time.perf_counter()
        try:
            if _faults.any_active():
                _faults.maybe_fail('decode_step')
            if speculative:
                emitted = self._verify_step(dec, K, active, seeds, temps,
                                            topks)
            else:
                toks = rt.decode_window(K, active, seeds, temps, topks)
                emitted = {id(r): [int(t) for t in toks[r.slot]]
                           for r in dec}
        except Exception as e:  # noqa: BLE001 - replied to every request
            self.breaker.record_failure()
            self.counters.inc('serving.batch_failures')
            for r in dec:
                self._retire(r, ERROR, error=e, reason='decode_step')
            return False
        self.breaker.record_success()
        self.counters.inc('generation.decode_windows')
        self.counters.observe('generation.decode_window_ms',
                              (time.perf_counter() - t0) * 1e3)
        for r in list(dec):
            self._emit_tokens(r, emitted[id(r)])
        return True

    def _verify_step(self, dec, K, active, seeds, temps, topks):
        """One speculative window: build each stream's fed row (last
        emitted token + n-gram draft), run the verify window, keep the
        longest accepted prefix per stream, and roll the runtime back to
        the committed lengths.  Returns {id(request): tokens}."""
        rt = self.runtime
        fed = np.zeros((rt.slots, K), np.int64)
        for r in dec:
            fed[r.slot, 0] = rt.host_tok[r.slot]
            ctx = np.concatenate([
                r.prompt, np.asarray(r.future.tokens_so_far(), np.int32)])
            fed[r.slot, 1:] = draft_ngram(ctx, K - 1)
        g = rt.verify_window(K, fed, active, seeds, temps, topks)
        emitted, accepted, kept = {}, {}, 0
        for r in dec:
            row = g[r.slot]
            m = 1
            while m < K and fed[r.slot, m] == row[m - 1]:
                m += 1
            accepted[r.slot] = (m, int(row[m - 1]))
            emitted[id(r)] = [int(t) for t in row[:m]]
            kept += m - 1
        self.counters.inc('generation.spec_proposed', (K - 1) * len(dec))
        self.counters.inc('generation.spec_accepted', kept)
        # commit BEFORE emitting: finishing streams retire (and free their
        # pages) with the runtime already consistent
        rt.commit_speculation(accepted)
        return emitted

    # ----------------------------------------------------- token path
    def _emit_tokens(self, r, toks):
        """Stream tokens to the client; finish on EOS / max_tokens."""
        now = self._clock()
        if r.produced == 0:
            self.counters.observe('serving.ttft_ms',
                                  max(0.0, (now - r.t_submit) * 1e3))
        elif toks:
            # a window delivers K tokens at once: observe the amortized
            # per-token gap once per token, so the ITL histogram weighs
            # every token, not every window
            gap_ms = max(0.0, (now - r.t_last_token) * 1e3) / len(toks)
            for _ in range(min(len(toks), r.max_new - r.produced)):
                self.counters.observe('serving.itl_ms', gap_ms)
        finish = None
        for tok in toks:
            r.future._push(tok)
            r.produced += 1
            self.counters.inc('generation.tokens')
            if self._gen.eos_id is not None and tok == self._gen.eos_id:
                finish = 'eos'
                break
            if r.produced >= r.max_new:
                finish = 'max_tokens'
                break
        r.t_last_token = now
        if finish is not None:
            ids = np.asarray(r.future.tokens_so_far(), np.int64)
            self._retire(r, OK, outputs=[ids], reason=finish)

    def _retire(self, r, status, outputs=None, error=None, reason=None):
        """Terminal resolution for a slot-holding request: drop it from the
        active list, release its KV slot, resolve the stream."""
        if r in self._active:
            self._active.remove(r)
        if r.slot is not None:
            self.runtime.free_slot(r.slot)
            r.slot = None
        self._resolve(r, status, outputs=outputs, error=error,
                      reason=reason)

    def _shed_active(self):
        for r in list(self._active):
            self._retire(r, SHED, reason='shutdown',
                         error='engine stopped mid-stream; partial output '
                               'is in tokens_so_far()')
