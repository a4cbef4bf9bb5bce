"""paddle_tpu_torch.serving.generation: streaming autoregressive decode.

Counterpart of paddle_tpu/serving/generation, turning the ServingEngine
into a streaming decode server:

  * `kv_cache`: PAGED KV storage, one shared page pool
    ``[pages, layers, kv_heads, page_len, head_dim]`` plus per-slot block
    tables, refcounted free-list page allocation (`PagePool`), optional
    int8 rows (``PT_KV_QUANT``) and a fingerprinted shared-prefix page
    cache (`PrefixCache`, ``PT_PREFIX_CACHE``).
  * `decode`: chunked prefill, K-step decode windows (a loop of steps
    whose carry stays on the device) and speculative verify windows over
    the pool (`DecodeRuntime`), and `dense_reference`, the page-free
    oracle.
  * `sampling`: greedy / temperature / top-k draws keyed by (request
    seed, absolute position) only (ops/sampling.py).
  * `scheduler`: mixed prefill + decode continuous batching on the
    ServingEngine (`GenerationEngine`), with page-pool backpressure and a
    terminal ``kv_oom``.
  * `streaming`: per-token delivery (`TokenStream`) with EOS / max-token /
    cancel / deadline termination, each resolving exactly once.

    from paddle_tpu_torch.serving import generation
    rt = generation.DecodeRuntime(weights, cfg, slots=8)   # on the card
    engine = generation.GenerationEngine(rt).start()
    stream = engine.generate(prompt_ids, max_new=32, temperature=0.8,
                             top_k=40, seed=7)
    for tok in stream.tokens():
        ...
    result = stream.result()          # ServeResult, reason='eos'/...
"""
from .kv_cache import (CacheConfig, PagePool, PrefixCache,  # noqa: F401
                       SlotAllocator, default_page_len, init_state)
from .decode import (DecodeRuntime, dense_reference,  # noqa: F401
                     random_weights, weight_names)
from .sampling import SamplingParams, draft_ngram  # noqa: F401
from .streaming import TokenStream  # noqa: F401
from .scheduler import GenerationConfig, GenerationEngine  # noqa: F401

__all__ = ['CacheConfig', 'PagePool', 'PrefixCache', 'SlotAllocator',
           'default_page_len', 'init_state', 'DecodeRuntime',
           'dense_reference', 'random_weights', 'weight_names',
           'SamplingParams', 'draft_ngram', 'TokenStream',
           'GenerationConfig', 'GenerationEngine']
