"""CTR models: DeepFM and Wide&Deep.

Counterpart of paddle_tpu/models/ctr.py (PaddleRec CTR, as BASELINE.json
names it): `deepfm` (first-order 1-wide embeddings + a dense fc, the FM
second order over 8-wide embeddings, a deep fc stack over the embeddings
concatenated with the dense features; Adam 1e-3) and `wide_deep` (a wide
part of 1-wide embeddings and a dense fc, a deep fc stack; Adagrad 1e-2),
both a sigmoid cross-entropy over one logit, and `synthetic_reader`, the
reference's seeded rows.  The tables are dense `lookup_table`s (K4 on the
card), as the reference keeps them.
"""
from .. import layers, optimizer


def deepfm(sparse_slots=26, dense_dim=13, vocab_size=10000, embed_dim=8,
           fc_sizes=(400, 400, 400), is_train=True):
    dense = layers.data('dense_input', shape=[dense_dim], dtype='float32')
    sparse = layers.data('sparse_input', shape=[sparse_slots],
                         dtype='int64')
    label = layers.data('label', shape=[1], dtype='int64')

    # ---- first order
    emb_1 = layers.embedding(layers.unsqueeze(sparse, axes=[2]),
                             size=[vocab_size, 1])        # [B, S, 1]
    first_sparse = layers.reduce_sum(layers.squeeze(emb_1, axes=[2]), dim=1,
                                     keep_dim=True)
    first_dense = layers.fc(dense, 1)
    first = layers.elementwise_add(first_sparse, first_dense)

    # ---- second order (FM):
    emb_k = layers.embedding(layers.unsqueeze(sparse, axes=[2]),
                             size=[vocab_size, embed_dim])  # [B, S, K]
    sum_sq = layers.square(layers.reduce_sum(emb_k, dim=1))
    sq_sum = layers.reduce_sum(layers.square(emb_k), dim=1)
    second = layers.scale(layers.reduce_sum(
        layers.elementwise_sub(sum_sq, sq_sum), dim=1, keep_dim=True),
        scale=0.5)

    # ---- deep
    deep = layers.reshape(emb_k, [-1, sparse_slots * embed_dim])
    deep = layers.concat([deep, dense], axis=1)
    for s in fc_sizes:
        deep = layers.fc(deep, s, act='relu')
    deep_out = layers.fc(deep, 1)

    logit = layers.elementwise_add(layers.elementwise_add(first, second),
                                   deep_out)
    pred = layers.sigmoid(logit)
    labelf = layers.cast(label, 'float32')
    cost = layers.sigmoid_cross_entropy_with_logits(logit, labelf)
    avg_cost = layers.mean(cost)
    opt = None
    if is_train:
        opt = optimizer.Adam(learning_rate=1e-3)
        opt.minimize(avg_cost)
    return {'loss': avg_cost, 'predict': pred,
            'feeds': [dense, sparse, label], 'optimizer': opt}


def wide_deep(sparse_slots=26, dense_dim=13, vocab_size=10000, embed_dim=8,
              fc_sizes=(256, 128, 64), is_train=True):
    dense = layers.data('dense_input', shape=[dense_dim], dtype='float32')
    sparse = layers.data('sparse_input', shape=[sparse_slots],
                         dtype='int64')
    label = layers.data('label', shape=[1], dtype='int64')
    # wide: linear over dense + per-slot 1-dim embeddings
    wide_emb = layers.embedding(layers.unsqueeze(sparse, axes=[2]),
                                size=[vocab_size, 1])
    wide = layers.elementwise_add(
        layers.reduce_sum(layers.squeeze(wide_emb, axes=[2]), dim=1,
                          keep_dim=True),
        layers.fc(dense, 1))
    # deep
    emb = layers.embedding(layers.unsqueeze(sparse, axes=[2]),
                           size=[vocab_size, embed_dim])
    deep = layers.concat(
        [layers.reshape(emb, [-1, sparse_slots * embed_dim]), dense], axis=1)
    for s in fc_sizes:
        deep = layers.fc(deep, s, act='relu')
    deep = layers.fc(deep, 1)
    logit = layers.elementwise_add(wide, deep)
    pred = layers.sigmoid(logit)
    labelf = layers.cast(label, 'float32')
    cost = layers.sigmoid_cross_entropy_with_logits(logit, labelf)
    avg_cost = layers.mean(cost)
    opt = None
    if is_train:
        opt = optimizer.Adagrad(learning_rate=1e-2)
        opt.minimize(avg_cost)
    return {'loss': avg_cost, 'predict': pred,
            'feeds': [dense, sparse, label], 'optimizer': opt}


def synthetic_reader(n=4096, sparse_slots=26, dense_dim=13,
                     vocab_size=10000, seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    w = rng.normal(size=(dense_dim,)).astype('float32')

    def reader():
        for _ in range(n):
            d = rng.normal(size=(dense_dim,)).astype('float32')
            s = rng.randint(0, vocab_size, (sparse_slots,)).astype('int64')
            y = int((d.dot(w) + (s % 7).sum() * 0.05 +
                     rng.normal(0, 0.1)) > 0)
            yield d, s, [y]
    return reader
