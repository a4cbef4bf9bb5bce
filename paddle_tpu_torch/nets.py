"""Composite network helpers.

Counterpart of paddle_tpu/nets.py: `simple_img_conv_pool`,
`img_conv_group`, `sequence_conv_pool`, `glu` and
`scaled_dot_product_attention`, op for op.
"""
from . import layers

__all__ = ['simple_img_conv_pool', 'sequence_conv_pool', 'glu',
           'scaled_dot_product_attention', 'img_conv_group']


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type='max',
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         pool_padding=pool_padding,
                         global_pooling=global_pooling)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act='sigmoid', pool_type='max'):
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type='max', use_cudnn=True):
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _expand(v):
        return [v] * len(conv_num_filter) if not isinstance(
            v, (list, tuple)) else list(v)
    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)
    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(input=tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    from .layers.ops import sigmoid
    return layers.elementwise_mul(x=a, y=sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention, composed of matmul, softmax
    (K5 on the card) and dropout ops; models/transformer.py's flash path is
    ops/attention.py."""
    assert queries.shape[-1] == keys.shape[-1]

    def _split_heads(x):
        if num_heads == 1:
            return x
        hidden = x.shape[-1]
        r = layers.reshape(x, [0, 0, num_heads, hidden // num_heads])
        return layers.transpose(r, perm=[0, 2, 1, 3])

    def _combine_heads(x):
        if num_heads == 1:
            return x
        t = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(t, [0, 0, t.shape[2] * t.shape[3]])

    q, k, v = _split_heads(queries), _split_heads(keys), _split_heads(values)
    key_dim = float(keys.shape[-1] // num_heads) if num_heads > 1 else \
        float(keys.shape[-1])
    scaled_q = layers.scale(x=q, scale=key_dim ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    ctx_multiheads = layers.matmul(weights, v)
    return _combine_heads(ctx_multiheads)
