"""Word2vec n-gram language model (the book's imikolov model).

Counterpart of paddle_tpu/models/word2vec.py (`build`): n - 1 context
words through one shared embedding table, concatenated, a sigmoid fc and
a softmax fc over the dictionary (K5 on the card), cross-entropy, SGD.
"""
from .. import layers, optimizer
from ..param_attr import ParamAttr


def build(dict_size=2073, embed_size=32, hidden_size=256, n=5, lr=1e-3,
          is_train=True):
    words = [layers.data('word_%d' % i, shape=[1], dtype='int64')
             for i in range(n - 1)]
    next_word = layers.data('next_word', shape=[1], dtype='int64')
    embs = [layers.embedding(
        w, size=[dict_size, embed_size],
        param_attr=ParamAttr(name='shared_emb'))
        for w in words]
    concat = layers.concat(embs, axis=1)
    hidden = layers.fc(concat, hidden_size, act='sigmoid')
    predict = layers.fc(hidden, dict_size, act='softmax')
    cost = layers.cross_entropy(input=predict, label=next_word)
    avg_cost = layers.mean(cost)
    opt = None
    if is_train:
        opt = optimizer.SGD(learning_rate=lr)
        opt.minimize(avg_cost)
    return {'loss': avg_cost, 'predict': predict,
            'feeds': words + [next_word], 'optimizer': opt}
