"""LLaMA-family decoder built on the port's fluid layers.

Counterpart of paddle_tpu/models/llama.py: the same configurations, layer
functions and parameter names, so `generation_program` builds the same
program desc in both packages and a scope trained or initialized by one
serves in the other.  RMSNorm pre-norm, rotary position embeddings,
grouped-query attention (flash_attention, the hand-written CUDA kernel on
the card), SwiGLU FFN, no biases.  `llama` builds the training forward and
loss, `build` adds Adam behind a global-norm gradient clip (1.0 by default),
`make_batch` packs next-token batches.  `make_decoder`,
`generation_weights` and `make_streaming_runtime` decode over the weights
a llama program left in the port's scope (serving/generation), so a scope
the training program wrote serves unchanged.  Single device only: the
ring attention (`use_ring=True`) and `shard`'s tensor-parallel layout
raise (ROADMAP A7).
"""
import numpy as np
import torch

from .. import layers
from ..initializer import Normal
from ..param_attr import ParamAttr

__all__ = ['CONFIGS', 'llama', 'build', 'make_batch', 'shard',
           'generation_program', 'decoder_layer', 'attention', 'swiglu_ffn',
           'make_decoder', 'generation_weights', 'make_streaming_runtime']

_ROADMAP_A7 = 'the parallel stack is not ported yet: ROADMAP A7'

CONFIGS = {
    'llama3_8b': dict(vocab=128256, d_model=4096, n_layer=32, n_head=32,
                      n_kv_head=8, d_ffn=14336, theta=500000.0,
                      max_len=8192),
    'llama_1b': dict(vocab=32000, d_model=2048, n_layer=16, n_head=16,
                     n_kv_head=8, d_ffn=5504, theta=500000.0, max_len=2048),
    'tiny': dict(vocab=256, d_model=64, n_layer=2, n_head=4, n_kv_head=2,
                 d_ffn=128, theta=10000.0, max_len=32),
}


def _linear(x, size, name):
    # bias-free projections named <name>_w, as in the JAX package
    return layers.fc(x, size, num_flatten_dims=2,
                     param_attr=ParamAttr(name=name + '_w'), bias_attr=False)


def _split_heads(x, n_head, max_len, d_head):
    x = layers.reshape(x, [0, max_len, n_head, d_head])
    return layers.transpose(x, perm=[0, 2, 1, 3])        # [B, H, T, Dh]


def attention(x, cfg, name):
    d_model, H = cfg['d_model'], cfg['n_head']
    Hkv, T = cfg['n_kv_head'], cfg['max_len']
    d_head = d_model // H
    q = _linear(x, H * d_head, name + '_q')
    k = _linear(x, Hkv * d_head, name + '_k')
    v = _linear(x, Hkv * d_head, name + '_v')
    q = _split_heads(q, H, T, d_head)
    k = _split_heads(k, Hkv, T, d_head)
    v = _split_heads(v, Hkv, T, d_head)
    q = layers.rope(q, theta=cfg['theta'])
    k = layers.rope(k, theta=cfg['theta'])
    # K/V stay at Hkv width: the kernel serves GQA by its row map
    ctxv = layers.flash_attention(q, k, v, causal=True)
    ctxv = layers.transpose(ctxv, perm=[0, 2, 1, 3])
    ctxv = layers.reshape(ctxv, [0, T, d_model])
    return _linear(ctxv, d_model, name + '_o')


def swiglu_ffn(x, cfg, name):
    gate = _linear(x, cfg['d_ffn'], name + '_fc1')
    up = _linear(x, cfg['d_ffn'], name + '_fc3')
    h = layers.elementwise_mul(layers.swish(gate, beta=1.0), up)
    return _linear(h, cfg['d_model'], name + '_fc2')


def decoder_layer(x, cfg, name):
    h = layers.rms_norm(x, param_attr=ParamAttr(name=name + '_att_norm'))
    x = layers.elementwise_add(x, attention(h, cfg, name + '_att'))
    h = layers.rms_norm(x, param_attr=ParamAttr(name=name + '_ffn_norm'))
    return layers.elementwise_add(x, swiglu_ffn(h, cfg, name + '_ffn'))


def llama(config='tiny', use_ring=False, dtype='float32', **overrides):
    """Build the forward + loss.  Feeds: tokens [B, T, 1] int64 (inputs),
    labels [B, T, 1] int64 (shifted targets), loss_mask [B, T] float32.
    `dtype='bfloat16'` makes every parameter bf16 (the embedding table's
    dtype flows through the layers); the logits are cast to float32 for
    the loss."""
    if use_ring:
        raise NotImplementedError('llama(use_ring=True): ' + _ROADMAP_A7)
    cfg = _config(config, overrides)
    T, V, D = cfg['max_len'], cfg['vocab'], cfg['d_model']

    tokens = layers.data('tokens', shape=[T, 1], dtype='int64')
    labels = layers.data('labels', shape=[T, 1], dtype='int64')
    loss_mask = layers.data('loss_mask', shape=[T], dtype='float32')

    x = layers.embedding(
        tokens, size=[V, D],
        param_attr=ParamAttr(name='tok_emb', initializer=Normal(0., 0.02)),
        dtype=dtype)
    for i in range(cfg['n_layer']):
        x = decoder_layer(x, cfg, 'layer_%d' % i)
    x = layers.rms_norm(x, param_attr=ParamAttr(name='final_norm'))
    logits = _linear(x, V, 'lm_proj')                    # [B, T, V]
    if dtype != 'float32':
        logits = layers.cast(logits, 'float32')

    per_tok = layers.softmax_with_cross_entropy(logits, labels)  # [B,T,1]
    per_tok = layers.elementwise_mul(
        layers.squeeze(per_tok, axes=[2]), loss_mask)
    sum_cost = layers.reduce_sum(per_tok)
    token_num = layers.reduce_sum(loss_mask)
    loss = layers.elementwise_div(sum_cost, token_num)
    return {'loss': loss, 'logits': logits, 'sum_cost': sum_cost,
            'token_num': token_num,
            'feeds': [tokens, labels, loss_mask], 'config': cfg}


def build(config='tiny', use_ring=False, dtype='float32', lr=3e-4,
          grad_clip=1.0, is_train=True, **overrides):
    """`llama` plus, when training, Adam (beta2 0.95) behind a gradient
    clip by global norm `grad_clip` (none when 0)."""
    from .. import clip
    from ..optimizer import Adam
    out = llama(config, use_ring, dtype, **overrides)
    opt = None
    if is_train:
        if grad_clip:
            clip.set_gradient_clip(clip.GradientClipByGlobalNorm(grad_clip))
        opt = Adam(learning_rate=lr, beta1=0.9, beta2=0.95, epsilon=1e-8)
        opt.minimize(out['loss'])
    out['optimizer'] = opt
    return out


def shard(main_program):
    """The tensor-parallel layout of the JAX package's `shard`."""
    raise NotImplementedError('llama.shard: ' + _ROADMAP_A7)


def make_batch(token_rows, max_len):
    """Pack next-token-prediction batches from rows of token ids."""
    B = len(token_rows)
    toks = np.zeros((B, max_len, 1), 'int64')
    lbls = np.zeros((B, max_len, 1), 'int64')
    mask = np.zeros((B, max_len), 'float32')
    for i, row in enumerate(token_rows):
        row = np.asarray(row)[:max_len + 1]
        n = len(row) - 1
        toks[i, :n, 0] = row[:-1]
        lbls[i, :n, 0] = row[1:]
        mask[i, :n] = 1.0
    return {'tokens': toks, 'labels': lbls, 'loss_mask': mask}


def generation_program(config='tiny', mode='decode', temperature=0.0,
                       top_k=0, kv_slots=4, **overrides):
    """The serving-side llama program:

      * mode='prefill': full-window forward, fetch [B, T, V] logits
      * mode='decode': forward + last-position slice + `sample_tokens`,
        fetch [B] next token ids

    decode mode also declares the slotted KV pool on the program
    (`set_kv_plan`), as the JAX package does for its memplan lint.
    Weights use the training parameter names."""
    cfg = dict(CONFIGS[config] if isinstance(config, str) else config)
    cfg.update(overrides)
    T, V, D = cfg['max_len'], cfg['vocab'], cfg['d_model']

    tokens = layers.data('tokens', shape=[T, 1], dtype='int64')
    x = layers.embedding(
        tokens, size=[V, D],
        param_attr=ParamAttr(name='tok_emb', initializer=Normal(0., 0.02)))
    for i in range(cfg['n_layer']):
        x = decoder_layer(x, cfg, 'layer_%d' % i)
    x = layers.rms_norm(x, param_attr=ParamAttr(name='final_norm'))
    logits = _linear(x, V, 'lm_proj')                    # [B, T, V]
    out = {'logits': logits, 'feeds': [tokens], 'config': cfg,
           'fetches': [logits]}
    if mode == 'decode':
        last = layers.slice(logits, axes=[1], starts=[T - 1], ends=[T])
        last = layers.squeeze(last, axes=[1])            # [B, V]
        nxt = layers.sample_tokens(last, temperature=temperature,
                                   top_k=top_k)
        out['last_logits'] = last
        out['next_token'] = nxt
        out['fetches'] = [nxt]
        tokens.block.program.set_kv_plan(
            slots=kv_slots, layers=cfg['n_layer'],
            kv_heads=cfg['n_kv_head'], max_len=T,
            head_dim=D // cfg['n_head'])
    return out


# ----------------------------------------------------------- decoding

def _config(config, overrides):
    cfg = dict(CONFIGS[config] if isinstance(config, str) else config)
    cfg.update(overrides)
    return cfg


def make_decoder(scope, config='tiny', temperature=0.0, **overrides):
    """A KV-cache autoregressive decoder over the weights a llama program
    left in `scope` (same parameter names), on the device the scope's
    tensors live on.

    The graph program is the scoring path; decode is a separate torch path
    because its structure differs (a per-step KV cache, not teacher
    forcing).  The cache is dense, [n_layer, B, Hkv, Tmax, Dh], and
    attention masks by position.  Greedy decode (temperature 0) is the
    reference's; with temperature > 0 each token is drawn for (seed,
    absolute position) by ops/sampling.py, which cannot match the JAX
    package's split keys.

    Returns generate(prompt_ids [B, Tp] int, max_new, seed=0) -> numpy
    [B, Tp + max_new]."""
    import numpy as np
    from ..ops.attention import cached_attention
    from ..ops.sampling import sample_tokens_at
    from ..serving.generation.decode import (_embed, _ffn, _mm, _qkv, _rms,
                                             _rope, _rope_freqs,
                                             _rope_tables, weight_names)

    cfg = _config(config, overrides)
    L, H, Hkv = cfg['n_layer'], cfg['n_head'], cfg['n_kv_head']
    D, theta, Tmax = cfg['d_model'], float(cfg['theta']), cfg['max_len']
    dh = D // H
    w = {n: scope.vars[n] for n in weight_names(cfg)}
    dev = w['tok_emb'].device
    freqs = _rope_freqs(dh, theta, dev)

    def forward(tokens, kc, vc, start):
        """tokens [B, T] at positions start.. -> logits [B, T, V]; writes
        the new K/V into the caches in place."""
        B, T = tokens.shape
        pos = (start + torch.arange(T, device=dev))[None].expand(B, T)
        cos, sin = _rope_tables(pos, freqs)
        x = _embed(w, tokens)
        for i in range(L):
            q, k, v = _qkv(w, cfg, _rms(x, w['layer_%d_att_norm' % i]), i)
            q = _rope(q, cos, sin)
            kc[i, :, :, start:start + T] = _rope(k, cos, sin)
            vc[i, :, :, start:start + T] = v
            att = cached_attention(q, kc[i], vc[i], pos)
            x = x + _mm(att.transpose(1, 2).reshape(B, T, D),
                        w['layer_%d_att_o_w' % i])
            x = _ffn(w, x, i)
        return _mm(_rms(x, w['final_norm']), w['lm_proj_w'])

    def pick(logits, seed, position):
        B = logits.shape[0]
        if not temperature or temperature <= 0:
            return torch.argmax(logits, dim=-1)
        full = lambda v: torch.full((B,), v, device=dev)  # noqa: E731
        return sample_tokens_at(logits, full(int(seed)), full(int(position)),
                                full(float(temperature)), full(0)).long()

    def run(prompt_ids, max_new, seed=0):
        prompt = np.asarray(prompt_ids)
        if max_new <= 0:
            # prefill would still emit one token; zero requested: no-op
            return prompt
        B, Tp = prompt.shape
        if Tp + max_new > Tmax:
            raise ValueError('prompt+max_new exceeds max_len=%d' % Tmax)
        with torch.inference_mode():
            tokens = torch.as_tensor(prompt.astype(np.int64), device=dev)
            kc = torch.zeros((L, B, Hkv, Tmax, dh), dtype=w['tok_emb'].dtype,
                             device=dev)
            vc = torch.zeros_like(kc)
            nxt = pick(forward(tokens, kc, vc, 0)[:, -1], seed, Tp)
            out = [nxt]
            for t in range(max_new - 1):
                logits = forward(nxt[:, None], kc, vc, Tp + t)
                nxt = pick(logits[:, 0], seed, Tp + t + 1)
                out.append(nxt)
            gen = torch.stack(out, dim=1).cpu().numpy()
        return np.concatenate([prompt, gen.astype(prompt.dtype)], axis=1)

    return run


# ------------------------------------------------- streaming generation

def generation_weights(scope, config='tiny', **overrides):
    """The decode-side weights a llama program left in `scope` (tensors,
    on the scope's device, by llama parameter name): the input of
    serving.generation.DecodeRuntime."""
    from ..serving.generation.decode import weight_names
    return {n: scope.vars[n] for n in weight_names(_config(config,
                                                           overrides))}


def make_streaming_runtime(scope, config='tiny', slots=4, prefill_chunk=8,
                           device=None, **overrides):
    """A serving.generation.DecodeRuntime over a llama scope: the streaming
    counterpart of `make_decoder` (same weights, but a slotted paged KV
    cache, K-token decode windows and chunked prefill: the device half of
    GenerationEngine).  ``device`` defaults to CUDA, as DecodeRuntime's.

        rt = llama.make_streaming_runtime(scope, 'tiny', slots=8)
        engine = GenerationEngine(rt).start()
    """
    from ..serving.generation.decode import DecodeRuntime
    cfg = _config(config, overrides)
    return DecodeRuntime(generation_weights(scope, cfg), cfg, slots=slots,
                         prefill_chunk=prefill_chunk, device=device)
