"""VGG-16 with batch norm and dropout.

Counterpart of paddle_tpu/models/vgg.py (`vgg16_bn_drop`, `build`): five
conv groups (nets.img_conv_group: 3 x 3 convs, each followed by batch
norm + relu and the group's dropout, then a 2 x 2 max pool), dropout 0.5,
fc 512, batch norm + relu on the 2-D fc output, dropout 0.5, fc 512, and
a softmax fc head; cross-entropy, accuracy and Adam.
"""
from .. import layers, nets, optimizer


def vgg16_bn_drop(input, is_train=True):
    def conv_block(inp, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=inp, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act='relu', conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type='max')

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act='relu', is_test=not is_train)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    return layers.fc(input=drop2, size=512, act=None)


def build(data_shape=(3, 32, 32), class_dim=10, lr=1e-3, is_train=True):
    images = layers.data(name='data', shape=list(data_shape),
                         dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    net = vgg16_bn_drop(images, is_train)
    predict = layers.fc(input=net, size=class_dim, act='softmax')
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    batch_acc = layers.accuracy(input=predict, label=label)
    opt = None
    if is_train:
        opt = optimizer.Adam(learning_rate=lr)
        opt.minimize(avg_cost)
    return {'loss': avg_cost, 'accuracy': batch_acc,
            'feeds': [images, label], 'predict': predict, 'optimizer': opt}
