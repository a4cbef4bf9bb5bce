"""Small book models: fit_a_line (linear regression).

Counterpart of paddle_tpu/models/simple.py's `fit_a_line` (book chapter
1): one fc over 13 features, square_error_cost, SGD.  The reference's
`recommender` needs LoD sequences, which the port has not yet.
"""
from .. import layers, optimizer


def fit_a_line(lr=0.01, is_train=True):
    x = layers.data('x', shape=[13], dtype='float32')
    y = layers.data('y', shape=[1], dtype='float32')
    y_predict = layers.fc(input=x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    avg_cost = layers.mean(cost)
    opt = None
    if is_train:
        opt = optimizer.SGD(learning_rate=lr)
        opt.minimize(avg_cost)
    return {'loss': avg_cost, 'predict': y_predict, 'feeds': [x, y],
            'optimizer': opt}
