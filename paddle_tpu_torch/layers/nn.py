"""fluid.layers.nn functions that the llama serving program, the
transformer training program, the conv models and the sequence models
use.  Sequence layers take padded [B, T, ...] vars with an int32
`<name>@LENGTH` companion (layers/io.py data(lod_level > 0)).

Counterpart of paddle_tpu/layers/nn.py.  Each function emits the same op
types, slots and attrs as the JAX package, so a model built through either
package serializes to the same desc.
"""
import numpy as np

from ..core.framework import Variable
from ..core.layer_helper import LayerHelper
from ..core.lod import LENGTH_SUFFIX
from ..initializer import Constant, Normal, Xavier
from ..param_attr import ParamAttr

__all__ = [
    'fc', 'embedding', 'transpose', 'reshape', 'squeeze', 'unsqueeze',
    'slice', 'split', 'scale', 'relu', 'reduce_sum', 'elementwise_add',
    'elementwise_sub', 'elementwise_mul', 'elementwise_div',
    'elementwise_min', 'elementwise_pow', 'elementwise_max', 'clip',
    'clip_by_norm', 'swish', 'flash_attention',
    'rms_norm', 'rope', 'sample_tokens', 'layer_norm',
    'softmax_with_cross_entropy', 'add_position_encoding',
    'autoincreased_step_counter', 'softmax', 'dropout', 'matmul',
    'conv2d', 'pool2d', 'batch_norm', 'cross_entropy', 'mean',
    'sigmoid_cross_entropy_with_logits', 'square_error_cost',
    'dynamic_lstm', 'dynamic_gru', 'cos_sim', 'sequence_conv',
    'sequence_pool', 'sequence_first_step', 'sequence_last_step',
    'sequence_softmax',
]


def _prod(xs):
    return int(np.prod([int(x) for x in xs])) if len(xs) else 1


def _copy_lod(x, out):
    """`out` carries x's LoD level and lengths companion."""
    if isinstance(x, Variable) and x.lod_level > 0:
        out.lod_level = x.lod_level
        out.lod_length_name = getattr(x, 'lod_length_name', None)


def _len_var(x):
    """The companion int32 lengths Variable of a lod var, or None."""
    name = getattr(x, 'lod_length_name', None)
    if name is None and x.lod_level > 0:
        name = x.name + LENGTH_SUFFIX
    if name is None:
        return None
    try:
        return x.block.var(name)
    except (KeyError, ValueError):
        return None


def _seq_inputs(x, extra=None):
    ins = {'X': x}
    lv = _len_var(x)
    if lv is not None:
        ins['Length'] = lv
    if extra:
        ins.update(extra)
    return ins


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None, amp_keep_bf16=False):
    """y = act(x W + b).  On a padded sequence [B, T, D] (a lod input)
    the weight applies per token: `num_flatten_dims` counts one more."""
    helper = LayerHelper('fc', input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    inputs = helper.multiple_input()
    param_attrs = helper.multiple_param_attr(len(inputs))
    mul_results = []
    ncd_final = num_flatten_dims
    for input_var, p_attr in zip(inputs, param_attrs):
        ncd = num_flatten_dims + (1 if input_var.lod_level > 0 else 0)
        ncd_final = ncd
        param_shape = [_prod(input_var.shape[ncd:]), size]
        w = helper.create_parameter(p_attr, param_shape, dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type='mul', inputs={'X': input_var, 'Y': w},
                         outputs={'Out': tmp},
                         attrs={'x_num_col_dims': ncd,
                                'y_num_col_dims': 1,
                                'amp_keep_bf16': amp_keep_bf16})
        _copy_lod(input_var, tmp)
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type='sum', inputs={'X': mul_results},
                         outputs={'Out': pre_bias}, attrs={})
        _copy_lod(inputs[0], pre_bias)
    pre_act = helper.append_bias_op(pre_bias, dim_start=ncd_final)
    _copy_lod(inputs[0], pre_act)
    out = helper.append_activation(pre_act)
    _copy_lod(inputs[0], out)
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype='float32'):
    """Row lookup of `input` ids in a [V, D] table (lookup_table op)."""
    helper = LayerHelper('embedding', param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, size, dtype,
                                default_initializer=Xavier())
    out = helper.create_variable_for_type_inference(dtype)
    padding_idx = -1 if padding_idx is None else \
        (padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(type='lookup_table',
                     inputs={'W': w, 'Ids': input},
                     outputs={'Out': out},
                     attrs={'padding_idx': padding_idx,
                            'is_sparse': is_sparse})
    _copy_lod(input, out)
    return out


# ------------------------------------------------------------------ RNN

def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation='sigmoid', cell_activation='tanh',
                 candidate_activation='tanh', dtype='float32', name=None):
    """The `lstm` op over a pre-projected [B, T, 4D] input (size = 4 D):
    Weight [D, 4D], Bias [1, 4D] or, with peepholes, [1, 7D]; gate layout
    [i, f, g, o] (ops/sequence.py).  -> (hidden, cell), [B, T, D] each."""
    helper = LayerHelper('lstm', param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    D = size // 4
    weight = helper.create_parameter(helper.param_attr, [D, 4 * D], dtype)
    bias_size = [1, 7 * D] if use_peepholes else [1, 4 * D]
    bias = helper.create_parameter(helper.bias_attr, bias_size, dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    ins = {'Input': input, 'Weight': weight, 'Bias': bias}
    lv = _len_var(input)
    if lv is not None:
        ins['Length'] = lv
    if h_0 is not None:
        ins['H0'] = h_0
    if c_0 is not None:
        ins['C0'] = c_0
    helper.append_op(type='lstm', inputs=ins,
                     outputs={'Hidden': hidden, 'Cell': cell},
                     attrs={'use_peepholes': use_peepholes,
                            'is_reverse': is_reverse,
                            'gate_activation': gate_activation,
                            'cell_activation': cell_activation,
                            'candidate_activation': candidate_activation})
    _copy_lod(input, hidden)
    _copy_lod(input, cell)
    return hidden, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation='sigmoid',
                candidate_activation='tanh', h_0=None, name=None):
    """The `gru` op over a pre-projected [B, T, 3D] input (size = D):
    Weight [D, 3D] as [update | reset | candidate], Bias [1, 3D]."""
    helper = LayerHelper('gru', param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = input.dtype
    weight = helper.create_parameter(helper.param_attr, [size, 3 * size],
                                     dtype)
    bias = helper.create_parameter(helper.bias_attr, [1, 3 * size], dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    ins = {'Input': input, 'Weight': weight, 'Bias': bias}
    lv = _len_var(input)
    if lv is not None:
        ins['Length'] = lv
    if h_0 is not None:
        ins['H0'] = h_0
    helper.append_op(type='gru', inputs=ins, outputs={'Hidden': hidden},
                     attrs={'is_reverse': is_reverse,
                            'gate_activation': gate_activation,
                            'activation': candidate_activation})
    _copy_lod(input, hidden)
    return hidden


def _simple(op_type, x, attrs=None, name=None, outs=('Out',),
            extra_ins=None):
    helper = LayerHelper(op_type, name=name)
    out_vars = {o: helper.create_variable_for_type_inference(x.dtype)
                for o in outs}
    ins = {'X': x}
    if extra_ins:
        ins.update(extra_ins)
    helper.append_op(type=op_type, inputs=ins, outputs=out_vars,
                     attrs=attrs or {})
    if len(outs) == 1:
        return out_vars[outs[0]]
    return tuple(out_vars[o] for o in outs)


def transpose(x, perm, name=None):
    return _simple('transpose', x, {'axis': list(perm)}, name)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper('reshape', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='reshape', inputs={'X': x}, outputs={'Out': out},
                     attrs={'shape': list(shape)})
    return helper.append_activation(out, act)


def squeeze(input, axes, name=None):
    return _simple('squeeze', input, {'axes': list(axes)}, name)


def unsqueeze(input, axes, name=None):
    return _simple('unsqueeze', input, {'axes': list(axes)}, name)


def relu(x, name=None):
    return _simple('relu', x, name=name)


def softmax(input, use_cudnn=True, name=None, axis=-1):
    """Softmax over `axis` (the hand-written CUDA row kernel on the card,
    see ops/nn.py)."""
    return _simple('softmax', input, {'axis': axis}, name)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None,
           amp_keep_bf16=False):
    return _simple('matmul', x, {'transpose_X': transpose_x,
                                 'transpose_Y': transpose_y,
                                 'alpha': float(alpha),
                                 'amp_keep_bf16': amp_keep_bf16}, name,
                   extra_ins={'Y': y})


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation='downgrade_in_infer'):
    return _simple('dropout', x,
                   {'dropout_prob': dropout_prob, 'is_test': is_test,
                    'seed': seed if seed is not None else 0,
                    'dropout_implementation': dropout_implementation},
                   name, outs=('Out', 'Mask'))[0]


def add_position_encoding(input, alpha, beta, name=None):
    return _simple('add_position_encoding', input,
                   {'alpha': float(alpha), 'beta': float(beta)}, name)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    if dim is None:
        attrs = {'reduce_all': True, 'keep_dim': keep_dim}
    else:
        attrs = {'dim': [dim] if isinstance(dim, int) else list(dim),
                 'keep_dim': keep_dim}
    return _simple('reduce_sum', input, attrs, name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper('scale', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='scale', inputs={'X': x}, outputs={'Out': out},
                     attrs={'scale': float(scale), 'bias': float(bias),
                            'bias_after_scale': bias_after_scale})
    return helper.append_activation(out, act)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper('split', name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
    else:
        num, sections = 0, list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(max(num, len(sections)) or 1)]
    helper.append_op(type='split', inputs={'X': input}, outputs={'Out': outs},
                     attrs={'axis': dim, 'num': num, 'sections': sections})
    return outs


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-05, param_attr=None, bias_attr=None, act=None,
               name=None):
    """LayerNorm over the dims from `begin_norm_axis` on (the hand-written
    CUDA kernel on the card, see ops/nn.py)."""
    helper = LayerHelper('layer_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    param_shape = [_prod(input.shape[begin_norm_axis:])]
    inputs = {'X': input}
    if scale:
        inputs['Scale'] = helper.create_parameter(
            helper.param_attr, param_shape, dtype,
            default_initializer=Constant(1.0))
    if shift:
        inputs['Bias'] = helper.create_parameter(
            helper.bias_attr, param_shape, dtype, is_bias=True)
    mean_out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='layer_norm', inputs=inputs,
                     outputs={'Y': out, 'Mean': mean_out,
                              'Variance': var_out},
                     attrs={'epsilon': epsilon,
                            'begin_norm_axis': begin_norm_axis})
    return helper.append_activation(out)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, label_smooth_eps=0.0):
    """Hard-label cross-entropy over the last axis with a fused
    `label_smooth_eps` (ops/loss.py)."""
    if soft_label and label_smooth_eps:
        raise ValueError(
            'label_smooth_eps applies to hard labels only — with '
            'soft_label=True smooth the labels yourself (label_smooth)')
    helper = LayerHelper('softmax_with_cross_entropy')
    loss = helper.create_variable_for_type_inference(logits.dtype)
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(type='softmax_with_cross_entropy',
                     inputs={'Logits': logits, 'Label': label},
                     outputs={'Loss': loss, 'Softmax': softmax_out},
                     attrs={'soft_label': soft_label,
                            'ignore_index': ignore_index,
                            'label_smooth_eps': float(label_smooth_eps)})
    if return_softmax:
        return loss, softmax_out
    return loss


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    helper = LayerHelper('global_step_counter')
    counter_name = counter_name or '@STEP_COUNTER@'
    counter = helper.create_or_get_global_variable(
        name=counter_name, dtype='int64', shape=[1], persistable=True)
    if counter.op is None:
        Constant(value=float(begin - 1))(counter)
        helper.append_op(type='increment', inputs={'X': counter},
                         outputs={'Out': counter},
                         attrs={'step': float(step)})
        counter.stop_gradient = True
    return counter


def _elementwise(op, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op, inputs={'X': x, 'Y': y},
                     outputs={'Out': out}, attrs={'axis': axis})
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_add', x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_sub', x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_mul', x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_div', x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_min', x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_pow', x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_max', x, y, axis, act, name)


def clip(x, min, max, name=None):
    return _simple('clip', x, {'min': float(min), 'max': float(max)}, name)


def clip_by_norm(x, max_norm, name=None):
    return _simple('clip_by_norm', x, {'max_norm': float(max_norm)}, name)


def swish(x, beta=1.0, name=None):
    return _simple('swish', x, {'beta': beta}, name)


def slice(input, axes, starts, ends):
    helper = LayerHelper('slice')
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='slice', inputs={'Input': input},
                     outputs={'Out': out},
                     attrs={'axes': list(axes), 'starts': list(starts),
                            'ends': list(ends)})
    return out


def flash_attention(q, k, v, causal=False, k_lengths=None, name=None):
    """Fused online-softmax attention over [B, H, T, D] tensors (the
    hand-written CUDA kernel on the card, see ops/attention.py).
    `k_lengths` (int [B]) masks suffix padding of K/V."""
    helper = LayerHelper('flash_attention', name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    ins = {'Q': q, 'K': k, 'V': v}
    if k_lengths is not None:
        ins['KLength'] = k_lengths
    helper.append_op(type='flash_attention', inputs=ins,
                     outputs={'Out': out}, attrs={'causal': causal})
    return out


def rms_norm(input, param_attr=None, epsilon=1e-6, name=None):
    """RMS LayerNorm over the last dim (the LLaMA norm), scale only."""
    helper = LayerHelper('rms_norm', name=name, param_attr=param_attr)
    d = int(input.shape[-1])
    scale = helper.create_parameter(helper.param_attr, [d], input.dtype,
                                    default_initializer=Constant(1.0))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='rms_norm',
                     inputs={'X': input, 'Scale': scale},
                     outputs={'Y': out}, attrs={'epsilon': epsilon})
    return out


def rope(input, theta=10000.0, positions=None, name=None):
    """Rotary position embedding on [B, H, T, D] head tensors."""
    helper = LayerHelper('rope', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {'X': input}
    if positions is not None:
        ins['Positions'] = positions
    helper.append_op(type='rope', inputs=ins, outputs={'Out': out},
                     attrs={'theta': float(theta)})
    return out


def sample_tokens(logits, temperature=0.0, top_k=0, seed=0, name=None):
    """Draw token ids over the last axis of `logits`: greedy when
    temperature <= 0; top_k > 0 restricts the draw to the k highest."""
    helper = LayerHelper('sample_tokens', name=name)
    out = helper.create_variable_for_type_inference('int64')
    helper.append_op(type='sample_tokens', inputs={'Logits': logits},
                     outputs={'Out': out},
                     attrs={'temperature': float(temperature),
                            'top_k': int(top_k), 'seed': int(seed)})
    return out


# ------------------------------------------------------------------ conv

def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """NCHW convolution; the filter draws from Normal(0, sqrt(2 / fan_in))
    (ops/nn.py)."""
    helper = LayerHelper('conv2d', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1

    def pair(v):
        return [v, v] if isinstance(v, int) else list(v)
    filter_size = pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * _prod(filter_size)
    w = helper.create_parameter(helper.param_attr, filter_shape, dtype,
                                default_initializer=Normal(
                                    0.0, (2.0 / fan_in) ** 0.5))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='conv2d',
                     inputs={'Input': input, 'Filter': w},
                     outputs={'Output': pre_bias},
                     attrs={'strides': pair(stride), 'paddings': pair(padding),
                            'dilations': pair(dilation), 'groups': groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type='max', pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper('pool2d', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)

    def pair(v):
        return [v, v] if isinstance(v, int) else list(v)
    helper.append_op(type='pool2d', inputs={'X': input}, outputs={'Out': out},
                     attrs={'pooling_type': pool_type,
                            'ksize': pair(pool_size),
                            'strides': pair(pool_stride),
                            'paddings': pair(pool_padding),
                            'global_pooling': global_pooling,
                            'ceil_mode': ceil_mode, 'exclusive': exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-05,
               param_attr=None, bias_attr=None, data_layout='NCHW',
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               fuse_with_relu=False, use_global_stats=False):
    """Batch norm over every axis but the channel's: Scale (1) and Bias
    (0) trained, the moving mean (0) and variance (1) persistable and
    updated in place by the op (ops/nn.py)."""
    helper = LayerHelper('batch_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    channel_num = input.shape[1] if data_layout == 'NCHW' else \
        input.shape[-1]
    param_shape = [channel_num]
    scale = helper.create_parameter(helper.param_attr, param_shape, dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(helper.bias_attr, param_shape, dtype,
                                   is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, initializer=Constant(0.0),
                  trainable=False), param_shape, dtype)
    mean.stop_gradient = True
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, initializer=Constant(1.0),
                  trainable=False), param_shape, dtype)
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='batch_norm',
                     inputs={'X': input, 'Scale': scale, 'Bias': bias,
                             'Mean': mean, 'Variance': variance},
                     outputs={'Y': out, 'MeanOut': mean,
                              'VarianceOut': variance,
                              'SavedMean': saved_mean,
                              'SavedVariance': saved_var},
                     attrs={'momentum': momentum, 'epsilon': epsilon,
                            'is_test': is_test, 'data_layout': data_layout,
                            'use_global_stats': use_global_stats})
    return helper.append_activation(out)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """-log of the label's probability in `input` (ops/loss.py)."""
    return _simple('cross_entropy', input,
                   {'soft_label': soft_label, 'ignore_index': ignore_index},
                   outs=('Y',), extra_ins={'Label': label})


def mean(x, name=None):
    return _simple('mean', x, name=name)


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    return _simple('sigmoid_cross_entropy_with_logits', x,
                   {'ignore_index': ignore_index, 'normalize': normalize},
                   name, extra_ins={'Label': label})


def square_error_cost(input, label):
    return _simple('square_error_cost', input, extra_ins={'Y': label})


def cos_sim(X, Y):
    """Cosine similarity of the rows of X and Y, [N, 1] (ops/math.py)."""
    return _simple('cos_sim', X, outs=('Out', 'XNorm', 'YNorm'),
                   extra_ins={'Y': Y})[0]


# ------------------------------------------------------- sequence family

def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    """A context window of `filter_size` tokens centred on each token
    (contextStart -(filter_size // 2)), times a [filter_size D,
    num_filters] filter, plus bias and act."""
    helper = LayerHelper('sequence_conv', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    filter_shape = [filter_size * input.shape[-1], num_filters]
    w = helper.create_parameter(helper.param_attr, filter_shape, dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='sequence_conv',
                     inputs=_seq_inputs(input, {'Filter': w}),
                     outputs={'Out': out},
                     attrs={'contextStride': filter_stride,
                            'contextStart': -int(filter_size // 2),
                            'contextLength': filter_size})
    _copy_lod(input, out)
    pre_act = helper.append_bias_op(out, dim_start=2)
    _copy_lod(input, pre_act)
    res = helper.append_activation(pre_act)
    _copy_lod(input, res)
    return res


def sequence_pool(input, pool_type, is_test=False):
    """Each sequence pooled over its valid tokens: sum, average, sqrt,
    max, last or first."""
    helper = LayerHelper('sequence_pool')
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='sequence_pool', inputs=_seq_inputs(input),
                     outputs={'Out': out},
                     attrs={'pooltype': pool_type.upper(),
                            'is_test': is_test})
    return out


def sequence_first_step(input):
    return sequence_pool(input, 'first')


def sequence_last_step(input):
    return sequence_pool(input, 'last')


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper('sequence_softmax', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='sequence_softmax', inputs=_seq_inputs(input),
                     outputs={'Out': out}, attrs={})
    _copy_lod(input, out)
    return out
