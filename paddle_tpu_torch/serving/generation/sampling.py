"""Per-request sampling parameters for the streaming decode runtime.

Counterpart of paddle_tpu/serving/generation/sampling.py.  The math lives
in ops/sampling.py (position-keyed Gumbel-max draws); this module carries
the per-request knobs through the scheduler, which packs them into the
fixed-width per-slot vectors the decode window takes, and the n-gram
draft of speculative decode.

Determinism contract: the token at absolute position ``p`` of a request
with seed ``s`` is drawn with ``token_key(s, p)``, independent of the
window size K, scheduler interleaving and reruns.
"""
import numpy as np

from ...ops.sampling import (sample_logits, sample_tokens_at,  # noqa: F401
                             token_key)

__all__ = ['SamplingParams', 'draft_ngram', 'sample_logits',
           'sample_tokens_at', 'token_key']


def draft_ngram(context, k):
    """Prompt-lookup draft for speculative decode: propose the ``k`` tokens
    that followed the most recent PRIOR occurrence of the context's last
    token (padding with that token when history runs out).  Host-side and
    deterministic; the proposal only moves the accept rate, never the
    stream: the verify window samples the target model at every position
    and the stream keeps exactly the tokens the target would have produced
    anyway."""
    context = np.asarray(context, np.int32).reshape(-1)
    k = int(k)
    if k <= 0:
        return np.zeros(0, np.int32)
    out = np.full(k, context[-1] if context.size else 0, np.int32)
    if context.size >= 2:
        last = context[-1]
        hits = np.flatnonzero(context[:-1] == last)
        if hits.size:
            start = int(hits[-1]) + 1
            follow = context[start:start + k]
            out[:follow.size] = follow
    return out


class SamplingParams(object):
    """One request's sampling knobs.  ``temperature <= 0`` is greedy;
    ``top_k > 0`` restricts the draw to the k highest logits; ``seed`` is
    the request's whole entropy (same seed, same stream)."""
    __slots__ = ('temperature', 'top_k', 'seed')

    def __init__(self, temperature=0.0, top_k=0, seed=0):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        if self.top_k < 0:
            raise ValueError('top_k must be >= 0, got %r' % (top_k,))
        self.seed = int(seed)

    def __repr__(self):
        return ('SamplingParams(temperature=%g, top_k=%d, seed=%d)'
                % (self.temperature, self.top_k, self.seed))
