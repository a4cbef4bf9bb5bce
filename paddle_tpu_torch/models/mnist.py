"""The MNIST CNN.

Counterpart of paddle_tpu/models/mnist.py (`cnn_model`, `build`): two
conv + relu + max-pool stages (nets.simple_img_conv_pool, 20 and 50
filters of 5 x 5), a softmax fc of 10 classes, cross-entropy, accuracy
and Adam, float32.  The reference's `get_model` reads its dataset and
batches it; the port has no dataset readers yet.
"""
from .. import layers, nets, optimizer


def cnn_model(data):
    conv_pool_1 = nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act='relu')
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act='relu')
    return layers.fc(input=conv_pool_2, size=10, act='softmax')


def build(batch_size=None, lr=0.001, is_train=True):
    images = layers.data(name='pixel', shape=[1, 28, 28], dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    predict = cnn_model(images)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    batch_acc = layers.accuracy(input=predict, label=label)
    opt = None
    if is_train:
        opt = optimizer.AdamOptimizer(learning_rate=lr)
        opt.minimize(avg_cost)
    return {'loss': avg_cost, 'accuracy': batch_acc,
            'feeds': [images, label], 'predict': predict, 'optimizer': opt}
