"""SE-ResNeXt-50, -101 and -152.

Counterpart of paddle_tpu/models/se_resnext.py: bottleneck blocks whose
3 x 3 conv is grouped (cardinality 32, or 64 at depth 152), each with a
squeeze-and-excitation gate (global average pool, fc + relu to C / 16,
fc + sigmoid back to C, the block's output scaled per channel by an
`axis=0` multiply), a softmax fc head, cross-entropy, accuracy, and
Momentum 0.9 on a piecewise learning rate (boundaries 1000 and 2000
steps, 1, 0.1, 0.01 times lr) with L2 decay 1e-4.
"""
from .. import layers, optimizer, regularizer

# `SE_ResNeXt`'s argument `layers` (the depth, the reference's name)
# hides the module inside it
_layers = layers


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_train=True):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=not is_train)


def squeeze_excitation(input, num_channels, reduction_ratio):
    pool = layers.pool2d(input=input, pool_type='avg', global_pooling=True)
    squeeze = layers.fc(input=pool, size=num_channels // reduction_ratio,
                        act='relu')
    excitation = layers.fc(input=squeeze, size=num_channels, act='sigmoid')
    return layers.elementwise_mul(x=input, y=excitation, axis=0)


def shortcut(input, ch_out, stride, is_train=True):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_train=is_train)
    return input


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio, is_train=True):
    conv0 = conv_bn_layer(input, num_filters, 1, act='relu',
                          is_train=is_train)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, cardinality,
                          act='relu', is_train=is_train)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_train=is_train)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = shortcut(input, num_filters * 2, stride, is_train=is_train)
    return layers.elementwise_add(x=short, y=scale, act='relu')


def SE_ResNeXt(input, class_dim, layers=50, is_train=True):
    supported = {50: ([3, 4, 6, 3], 32, 16),
                 101: ([3, 4, 23, 3], 32, 16),
                 152: ([3, 8, 36, 3], 64, 16)}
    depth, cardinality, reduction_ratio = supported[layers]
    num_filters = [128, 256, 512, 1024]
    if layers == 152:
        conv = conv_bn_layer(input, 64, 3, 2, act='relu', is_train=is_train)
        conv = conv_bn_layer(conv, 64, 3, act='relu', is_train=is_train)
        conv = conv_bn_layer(conv, 128, 3, act='relu', is_train=is_train)
    else:
        conv = conv_bn_layer(input, 64, 7, 2, act='relu', is_train=is_train)
    conv = _layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                          pool_padding=1, pool_type='max')
    for block in range(len(depth)):
        for i in range(depth[block]):
            conv = bottleneck_block(
                conv, num_filters[block], 2 if i == 0 and block != 0 else 1,
                cardinality, reduction_ratio, is_train=is_train)
    pool = _layers.pool2d(input=conv, pool_type='avg', global_pooling=True)
    drop = _layers.dropout(x=pool, dropout_prob=0.5, is_test=not is_train)
    return _layers.fc(input=drop, size=class_dim, act='softmax')


def build(data_shape=(3, 224, 224), class_dim=1000, depth=50, lr=0.1,
          is_train=True):
    images = layers.data(name='data', shape=list(data_shape),
                         dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    predict = SE_ResNeXt(images, class_dim, depth, is_train)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    batch_acc = layers.accuracy(input=predict, label=label)
    opt = None
    if is_train:
        opt = optimizer.Momentum(
            learning_rate=layers.piecewise_decay(
                boundaries=[1000, 2000], values=[lr, lr * 0.1, lr * 0.01]),
            momentum=0.9, regularization=regularizer.L2Decay(1e-4))
        opt.minimize(avg_cost)
    return {'loss': avg_cost, 'accuracy': batch_acc,
            'feeds': [images, label], 'predict': predict, 'optimizer': opt}
