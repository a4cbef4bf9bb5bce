"""ResNet-18/34/50/101/152 for ImageNet and the CIFAR-10 ResNets.

Counterpart of paddle_tpu/models/resnet.py: the same layers, names and
ops, NCHW, conv + batch-norm blocks, a softmax fc head, cross-entropy,
accuracy and Momentum.  `bench_program` is the reference's ResNet-50
training step (224 x 224, 1000 classes, B = 128, bf16 AMP, Momentum lr 0.1
mu 0.9) with its synthetic feed.  Under AMP the convolutions compute in
bf16 and their outputs stay bf16 through the batch norms, relus and
residual adds (core/amp.py); the batch-norm statistics are float32.
"""
import numpy as np

from .. import layers, optimizer
from ..core import unique_name
from ..core.framework import Program, program_guard


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act='relu',
                  is_train=True):
    conv1 = layers.conv2d(input=input, filter_size=filter_size,
                          num_filters=ch_out, stride=stride,
                          padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(input=conv1, act=act, is_test=not is_train)


def shortcut(input, ch_out, stride, is_train=True):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             is_train=is_train)
    return input


def basicblock(input, ch_out, stride, is_train=True):
    short = shortcut(input, ch_out, stride, is_train=is_train)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_train=is_train)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None,
                          is_train=is_train)
    return layers.elementwise_add(x=short, y=conv2, act='relu')


def bottleneck(input, ch_out, stride, is_train=True):
    short = shortcut(input, ch_out * 4, stride, is_train=is_train)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_train=is_train)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_train=is_train)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_train=is_train)
    return layers.elementwise_add(x=short, y=conv3, act='relu')


def layer_warp(block_func, input, ch_out, count, stride, is_train=True):
    res_out = block_func(input, ch_out, stride, is_train=is_train)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_train=is_train)
    return res_out


def resnet_imagenet(input, class_dim=1000, depth=50, is_train=True):
    cfg = {18: ([2, 2, 2, 1], basicblock),
           34: ([3, 4, 6, 3], basicblock),
           50: ([3, 4, 6, 3], bottleneck),
           101: ([3, 4, 23, 3], bottleneck),
           152: ([3, 8, 36, 3], bottleneck)}
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_train=is_train)
    pool1 = layers.pool2d(input=conv1, pool_type='max', pool_size=3,
                          pool_stride=2, pool_padding=1)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1, is_train)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2, is_train)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2, is_train)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2, is_train)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type='avg',
                          global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act='softmax')


def resnet_cifar10(input, class_dim=10, depth=32, is_train=True):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input=input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_train=is_train)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_train)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_train)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_train)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type='avg',
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act='softmax')


def build(data_shape=(3, 224, 224), class_dim=1000, depth=50, lr=0.1,
          is_train=True, data_set='imagenet'):
    images = layers.data(name='data', shape=list(data_shape),
                         dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    if data_set == 'cifar10':
        predict = resnet_cifar10(images, class_dim, depth, is_train)
    else:
        predict = resnet_imagenet(images, class_dim, depth, is_train)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    batch_acc = layers.accuracy(input=predict, label=label)
    opt = None
    if is_train:
        opt = optimizer.Momentum(learning_rate=lr, momentum=0.9)
        opt.minimize(avg_cost)
    return {'loss': avg_cost, 'accuracy': batch_acc,
            'feeds': [images, label], 'predict': predict, 'optimizer': opt}


def bench_program(B=128, side=224, classes=1000, depth=50, lr=0.1,
                  seed=0):
    """The ResNet-50 training step and its synthetic feed: (main, startup,
    out, feed), bf16 AMP on."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        with unique_name.guard():
            out = build(data_shape=(3, side, side), class_dim=classes,
                        depth=depth, lr=lr)
    main.set_amp(True)
    rng = np.random.RandomState(seed)
    feed = {'data': rng.rand(B, 3, side, side).astype('float32'),
            'label': rng.randint(0, classes, (B, 1)).astype('int64')}
    return main, startup, out, feed
