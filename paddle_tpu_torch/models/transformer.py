"""Transformer for NMT, the training step `bench.py` headlines.

Counterpart of paddle_tpu/models/transformer.py: `transformer`, `build`,
`synthetic_batch` and `make_batch` with the JAX package's names, ops and
parameter names, so both packages build the same program.  Fixed max_len
padded batches with suffix-padding lengths, pre-norm residual blocks, the
fused QKV / KV projections, attention either composed (scale, matmul,
mask add, softmax, dropout, matmul: `build`'s default, and the only path
with attention dropout) or through `flash_attention` (`use_flash=True`
with dropout 0), dropout after the embeddings, attention weights and FFN
activations, the logits projection kept bf16 under AMP, and the fused
label-smoothed cross-entropy.
"""
import numpy as np

from .. import layers
from ..optimizer import Adam
from ..param_attr import ParamAttr
from ..initializer import Normal, Xavier


def _linear(x, size, name, bias=True, amp_keep_bf16=False, init=None):
    return layers.fc(x, size, num_flatten_dims=2,
                     param_attr=ParamAttr(name=name + '_w',
                                          initializer=init),
                     bias_attr=ParamAttr(name=name + '_b') if bias else False,
                     amp_keep_bf16=amp_keep_bf16)


def multi_head_attention(q_in, kv_in, mask, d_model, n_head, dropout,
                         is_train, name, use_flash=False, causal=False,
                         kv_lengths=None):
    """mask: [B, 1, Tq, Tk] additive (-1e9 on invalid); kv_lengths int [B]
    (suffix-padding lengths, what the flash path masks with)."""
    d_head = d_model // n_head
    # the fused [d, 3d] weight pins Xavier fans to the separate
    # projections' (d, d), so each q/k/v slice keeps the init of one fc
    per_proj = Xavier(fan_in=d_model, fan_out=d_model)
    if q_in is kv_in:
        qkv = _linear(q_in, 3 * d_model, name + '_qkv', bias=False,
                      init=per_proj)
        q, k, v = layers.split(qkv, 3, dim=-1)
    else:
        q = _linear(q_in, d_model, name + '_q', bias=False)
        kv = _linear(kv_in, 2 * d_model, name + '_kv', bias=False,
                     init=per_proj)
        k, v = layers.split(kv, 2, dim=-1)

    def split_heads(x):
        x = layers.reshape(x, [0, 0, n_head, d_head])
        return layers.transpose(x, perm=[0, 2, 1, 3])  # [B, H, T, Dh]

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    # the fused kernel has no attention-weight dropout: use it only when
    # dropout is off; else compose the ops
    if use_flash and dropout and is_train:
        use_flash = False
    if use_flash:
        if mask is not None and kv_lengths is None:
            raise ValueError('use_flash with a padding mask requires '
                             'kv_lengths (suffix-padding lengths); got None')
        ctx = layers.flash_attention(q, k, v, causal=causal,
                                     k_lengths=kv_lengths)
    else:
        q = layers.scale(q, scale=d_head ** -0.5)
        scores = layers.matmul(q, k, transpose_y=True)  # [B, H, Tq, Tk]
        if mask is not None:
            scores = layers.elementwise_add(scores, mask)
        weights = layers.softmax(scores)
        if dropout and is_train:
            weights = layers.dropout(
                weights, dropout, is_test=not is_train,
                dropout_implementation='upscale_in_train')
        ctx = layers.matmul(weights, v)  # [B, H, Tq, Dh]
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, d_model])
    return _linear(ctx, d_model, name + '_o', bias=False)


def ffn(x, d_model, d_inner, dropout, is_train, name):
    h = _linear(x, d_inner, name + '_fc1')
    h = layers.relu(h)
    if dropout and is_train:
        h = layers.dropout(h, dropout, is_test=not is_train,
                           dropout_implementation='upscale_in_train')
    return _linear(h, d_model, name + '_fc2')


def _prenorm(x, sub, name):
    ln = layers.layer_norm(x, begin_norm_axis=2,
                           param_attr=ParamAttr(name=name + '_ln_w'),
                           bias_attr=ParamAttr(name=name + '_ln_b'))
    return layers.elementwise_add(x, sub(ln))


def encoder_layer(x, mask, cfg, is_train, name, lengths=None):
    x = _prenorm(x, lambda h: multi_head_attention(
        h, h, mask, cfg['d_model'], cfg['n_head'], cfg['dropout'], is_train,
        name + '_att', cfg.get('use_flash', False),
        kv_lengths=lengths), name + '_att')
    x = _prenorm(x, lambda h: ffn(
        h, cfg['d_model'], cfg['d_inner'], cfg['dropout'], is_train,
        name + '_ffn'), name + '_ffn')
    return x


def decoder_layer(x, enc, self_mask, cross_mask, cfg, is_train, name,
                  src_lengths=None, trg_lengths=None):
    x = _prenorm(x, lambda h: multi_head_attention(
        h, h, self_mask, cfg['d_model'], cfg['n_head'], cfg['dropout'],
        is_train, name + '_satt', cfg.get('use_flash', False), causal=True,
        kv_lengths=trg_lengths), name + '_satt')
    x = _prenorm(x, lambda h: multi_head_attention(
        h, enc, cross_mask, cfg['d_model'], cfg['n_head'], cfg['dropout'],
        is_train, name + '_xatt', cfg.get('use_flash', False),
        kv_lengths=src_lengths), name + '_xatt')
    x = _prenorm(x, lambda h: ffn(
        h, cfg['d_model'], cfg['d_inner'], cfg['dropout'], is_train,
        name + '_ffn'), name + '_ffn')
    return x


def _embed(ids, vocab, d_model, max_len, dropout, is_train, name):
    emb = layers.embedding(
        ids, size=[vocab, d_model],
        param_attr=ParamAttr(name=name + '_emb',
                             initializer=Normal(0., d_model ** -0.5)))
    emb = layers.scale(emb, scale=d_model ** 0.5)
    emb = layers.add_position_encoding(emb, alpha=1.0, beta=1.0)
    if dropout and is_train:
        emb = layers.dropout(emb, dropout, is_test=not is_train,
                             dropout_implementation='upscale_in_train')
    return emb


def _pad_mask(pad_flags, neg=-1e9):
    """pad_flags: [B, T] float 1.0 where PAD.  -> [B, 1, 1, T] additive."""
    m = layers.scale(pad_flags, scale=neg)
    return layers.unsqueeze(m, axes=[1, 2])


def _causal_mask_const(max_len):
    tri = np.triu(np.full((max_len, max_len), -1e9, 'float32'), k=1)
    return tri.reshape(1, 1, max_len, max_len)


def transformer(src_vocab, trg_vocab, max_len=64, n_layer=6, n_head=8,
                d_model=512, d_inner=2048, dropout=0.1, is_train=True,
                use_flash=False, label_smooth_eps=0.1):
    """Returns dict with loss/feeds/fetches.  Feeds (all dense, [B, T]):
    src_word, trg_word (shifted-in), lbl_word (shifted-out), plus float
    pad masks src_pad [B, T], trg_pad [B, T]."""
    cfg = {'d_model': d_model, 'n_head': n_head, 'd_inner': d_inner,
           'dropout': dropout, 'use_flash': use_flash}
    src = layers.data('src_word', shape=[max_len, 1], dtype='int64')
    trg = layers.data('trg_word', shape=[max_len, 1], dtype='int64')
    lbl = layers.data('lbl_word', shape=[max_len, 1], dtype='int64')
    src_pad = layers.data('src_pad', shape=[max_len], dtype='float32')
    trg_pad = layers.data('trg_pad', shape=[max_len], dtype='float32')

    src_mask = _pad_mask(src_pad)                       # [B,1,1,Ts]
    cross_mask = src_mask
    ones = layers.fill_constant_batch_size_like(src_pad, [-1, max_len],
                                                'float32', 1.0)
    src_len = layers.cast(layers.reduce_sum(
        layers.elementwise_sub(ones, src_pad), dim=1), 'int32')
    trg_len = layers.cast(layers.reduce_sum(
        layers.elementwise_sub(ones, trg_pad), dim=1), 'int32')
    causal = layers.assign(_causal_mask_const(max_len))  # [1,1,Tt,Tt]
    trg_mask = layers.elementwise_add(_pad_mask(trg_pad), causal)

    enc = _embed(src, src_vocab, d_model, max_len, dropout, is_train,
                 'src')
    for i in range(n_layer):
        enc = encoder_layer(enc, src_mask, cfg, is_train, 'enc_%d' % i,
                            lengths=src_len)
    enc = layers.layer_norm(enc, begin_norm_axis=2,
                            param_attr=ParamAttr(name='enc_post_ln_w'),
                            bias_attr=ParamAttr(name='enc_post_ln_b'))

    dec = _embed(trg, trg_vocab, d_model, max_len, dropout, is_train,
                 'trg')
    for i in range(n_layer):
        dec = decoder_layer(dec, enc, trg_mask, cross_mask, cfg, is_train,
                            'dec_%d' % i, src_lengths=src_len,
                            trg_lengths=trg_len)
    dec = layers.layer_norm(dec, begin_norm_axis=2,
                            param_attr=ParamAttr(name='dec_post_ln_w'),
                            bias_attr=ParamAttr(name='dec_post_ln_b'))

    # the [B, T, V] logits stay bf16 under AMP: their only consumer is the
    # cross-entropy, whose reductions are float32 inside
    logits = _linear(dec, trg_vocab, 'proj', amp_keep_bf16=True)
    # the label-smoothing closed form needs only reductions over V
    per_tok = layers.softmax_with_cross_entropy(
        logits, lbl, label_smooth_eps=label_smooth_eps)
    # mask out PAD target positions: weight = 1 - trg_pad
    w = layers.elementwise_sub(
        layers.fill_constant_batch_size_like(trg_pad, [-1, max_len],
                                             'float32', 1.0), trg_pad)
    per_tok = layers.elementwise_mul(layers.squeeze(per_tok, axes=[2]), w)
    sum_cost = layers.reduce_sum(per_tok)
    token_num = layers.reduce_sum(w)
    avg_cost = layers.elementwise_div(sum_cost, token_num)
    return {'loss': avg_cost, 'sum_cost': sum_cost, 'token_num': token_num,
            'feeds': [src, trg, lbl, src_pad, trg_pad], 'logits': logits}


def build(src_vocab=10000, trg_vocab=10000, max_len=64, n_layer=6, n_head=8,
          d_model=512, d_inner=2048, dropout=0.1, lr=2.0,
          warmup_steps=8000, is_train=True, use_flash=False):
    out = transformer(src_vocab, trg_vocab, max_len, n_layer, n_head,
                      d_model, d_inner, dropout, is_train, use_flash)
    opt = None
    if is_train:
        lr_var = layers.noam_decay(d_model, warmup_steps)
        lr_var = layers.scale(lr_var, scale=float(lr))
        opt = Adam(learning_rate=lr_var, beta1=0.9, beta2=0.997,
                   epsilon=1e-9)
        opt.minimize(out['loss'])
    out['optimizer'] = opt
    return out


def synthetic_batch(rng, batch_size, max_len, vocab=32000):
    """Full-length synthetic (src, trg_in, trg_out) feeds, the ones bench.py
    uses."""
    rows = []
    for _ in range(batch_size):
        s = rng.randint(3, vocab, (max_len - 1,))
        rows.append((np.concatenate([s, [1]]), np.concatenate([[0], s]),
                     np.concatenate([s, [1]])))
    return make_batch(rows, max_len)


def make_batch(reader_batch, max_len, rng=None):
    """Convert wmt16-style (src, trg_in, trg_out) rows into dense feeds."""
    B = len(reader_batch)
    src = np.zeros((B, max_len, 1), 'int64')
    trg = np.zeros((B, max_len, 1), 'int64')
    lbl = np.zeros((B, max_len, 1), 'int64')
    src_pad = np.ones((B, max_len), 'float32')
    trg_pad = np.ones((B, max_len), 'float32')
    for i, (s, t, l) in enumerate(reader_batch):
        s = s[:max_len]
        t = t[:max_len]
        l = l[:max_len]
        src[i, :len(s), 0] = s
        trg[i, :len(t), 0] = t
        lbl[i, :len(l), 0] = l
        src_pad[i, :len(s)] = 0.0
        trg_pad[i, :len(t)] = 0.0
    return {'src_word': src, 'trg_word': trg, 'lbl_word': lbl,
            'src_pad': src_pad, 'trg_pad': trg_pad}
