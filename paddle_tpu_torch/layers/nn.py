"""fluid.layers.nn functions: those the llama serving program, the
transformer training program, the conv models and the sequence models
use, and the dense layer surface (reductions, indexing and padding,
activations, losses, 3-d and transposed convolutions, pools, norms and
resizes).  Sequence layers take padded [B, T, ...] vars with an int32
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
    # the dense layer surface (ROADMAP A10)
    'reduce_mean', 'reduce_max', 'reduce_min', 'reduce_prod', 'mul',
    'topk', 'sum', 'log', 'elu', 'leaky_relu', 'relu6', 'pow', 'selu',
    'hard_sigmoid', 'brelu', 'soft_relu', 'stanh', 'logical_and',
    'logical_or', 'logical_xor', 'logical_not', 'gaussian_random',
    'gaussian_random_batch_size_like', 'uniform_random_batch_size_like',
    'flatten', 'stack', 'unstack', 'expand', 'gather', 'scatter', 'pad',
    'pad2d', 'pad_constant_like', 'one_hot', 'label_smooth', 'shape',
    'multiplex', 'space_to_depth', 'shuffle_channel', 'prelu',
    'l2_normalize', 'maxout', 'smooth_l1', 'huber_loss', 'log_loss',
    'rank_loss', 'margin_rank_loss', 'bpr_loss', 'conv3d',
    'conv2d_transpose', 'conv3d_transpose', 'pool3d', 'adaptive_pool2d',
    'adaptive_pool3d', 'group_norm', 'lrn', 'image_resize',
    'image_resize_short', 'resize_bilinear', 'resize_nearest',
    'affine_channel',
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


def _simple(op_type, x, attrs=None, name=None, outs=('Out',), ins_name='X',
            extra_ins=None, dtype=None, lod_from=None):
    """One op of `x` (a Variable or a list of them, in slot `ins_name`)
    and `extra_ins`, its outputs of x's dtype (or `dtype`), carrying the
    LoD of `lod_from` (default x), as the reference's `_simple`."""
    helper = LayerHelper(op_type, name=name)
    dtype = dtype or (x[0].dtype if isinstance(x, (list, tuple)) else x.dtype)
    out_vars = {o: helper.create_variable_for_type_inference(dtype)
                for o in outs}
    ins = {ins_name: x}
    if extra_ins:
        ins.update(extra_ins)
    helper.append_op(type=op_type, inputs=ins, outputs=out_vars,
                     attrs=attrs or {})
    src = lod_from if lod_from is not None else (
        x[0] if isinstance(x, (list, tuple)) else x)
    for v in out_vars.values():
        _copy_lod(src, v)
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


def _reduce(op, input, dim, keep_dim, name):
    if dim is None:
        attrs = {'reduce_all': True, 'keep_dim': keep_dim}
    else:
        attrs = {'dim': [dim] if isinstance(dim, int) else list(dim),
                 'keep_dim': keep_dim}
    return _simple(op, input, attrs, name)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_sum', input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_mean', input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_max', input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_min', input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_prod', input, dim, keep_dim, name)



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
                               return_softmax=False, label_smooth_eps=0.0,
                               axis=-1):
    """Cross-entropy of softmax(logits) over `axis` against hard labels
    (with a fused `label_smooth_eps`) or soft ones (ops/loss.py).  The
    op's `axis` attr is written only when it is not -1, so the default
    desc is the reference's."""
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
                     attrs=dict({'soft_label': soft_label,
                                 'ignore_index': ignore_index,
                                 'label_smooth_eps': float(label_smooth_eps)},
                                **({} if axis == -1 else {'axis': axis})))
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


# ----------------------------------------------------- the dense surface

def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _simple('mul', x, {'x_num_col_dims': x_num_col_dims,
                              'y_num_col_dims': y_num_col_dims}, name,
                   extra_ins={'Y': y})


def topk(input, k, name=None):
    helper = LayerHelper('top_k', name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference('int64')
    helper.append_op(type='top_k', inputs={'X': input},
                     outputs={'Out': values, 'Indices': indices},
                     attrs={'k': k})
    return values, indices


def sum(x):
    return _simple('sum', x if isinstance(x, list) else [x])


def log(x, name=None):
    return _simple('log', x, name=name)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _simple('brelu', x, {'t_min': t_min, 't_max': t_max}, name)


def leaky_relu(x, alpha=0.02, name=None):
    return _simple('leaky_relu', x, {'alpha': alpha}, name)


def soft_relu(x, threshold=40.0, name=None):
    return _simple('soft_relu', x, {'threshold': threshold}, name)


def elu(x, alpha=1.0, name=None):
    return _simple('elu', x, {'alpha': alpha}, name)


def relu6(x, threshold=6.0, name=None):
    return _simple('relu6', x, {'threshold': threshold}, name)


def pow(x, factor=1.0, name=None):
    return _simple('pow', x, {'factor': factor}, name)


def stanh(x, scale_a=2.0 / 3.0, scale_b=1.7159, name=None):
    return _simple('stanh', x, {'scale_a': scale_a, 'scale_b': scale_b},
                   name)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _simple('hard_sigmoid', x, {'slope': slope, 'offset': offset},
                   name)


def selu(x, scale=None, alpha=None, name=None):
    attrs = {}
    if scale is not None:
        attrs['scale'] = scale
    if alpha is not None:
        attrs['alpha'] = alpha
    return _simple('selu', x, attrs, name)


def logical_and(x, y, out=None, name=None):
    return _simple('logical_and', x, extra_ins={'Y': y}, dtype='bool')


def logical_or(x, y, out=None, name=None):
    return _simple('logical_or', x, extra_ins={'Y': y}, dtype='bool')


def logical_xor(x, y, out=None, name=None):
    return _simple('logical_xor', x, extra_ins={'Y': y}, dtype='bool')


def logical_not(x, out=None, name=None):
    return _simple('logical_not', x, dtype='bool')


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype='float32'):
    helper = LayerHelper('gaussian_random')
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='gaussian_random', inputs={},
                     outputs={'Out': out},
                     attrs={'shape': list(shape), 'mean': mean, 'std': std,
                            'seed': seed, 'dtype': dtype})
    return out


def uniform_random_batch_size_like(input, shape, dtype='float32',
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _simple('uniform_random_batch_size_like', input,
                   {'shape': list(shape), 'input_dim_idx': input_dim_idx,
                    'output_dim_idx': output_dim_idx, 'min': min, 'max': max,
                    'seed': seed, 'dtype': dtype},
                   ins_name='Input', dtype=dtype)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype='float32'):
    return _simple('gaussian_random_batch_size_like', input,
                   {'shape': list(shape), 'input_dim_idx': input_dim_idx,
                    'output_dim_idx': output_dim_idx, 'mean': mean,
                    'std': std, 'seed': seed, 'dtype': dtype},
                   ins_name='Input', dtype=dtype)


def flatten(x, axis=1, name=None):
    return _simple('flatten', x, {'axis': axis}, name)


def stack(x, axis=0):
    x = x if isinstance(x, list) else [x]
    return _simple('stack', x, {'axis': axis}, outs=('Y',))


def unstack(x, axis=0, num=None):
    helper = LayerHelper('unstack')
    num = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type='unstack', inputs={'X': x}, outputs={'Y': outs},
                     attrs={'axis': axis})
    return outs


def expand(x, expand_times, name=None):
    return _simple('expand', x, {'expand_times': list(expand_times)}, name)


def gather(input, index):
    return _simple('gather', input, extra_ins={'Index': index})


def scatter(input, index, updates, name=None, overwrite=True):
    return _simple('scatter', input, {'overwrite': overwrite}, name,
                   extra_ins={'Ids': index, 'Updates': updates})


def pad(x, paddings, pad_value=0.0, name=None):
    return _simple('pad', x, {'paddings': list(paddings),
                              'pad_value': float(pad_value)}, name)


def pad2d(input, paddings=[0, 0, 0, 0], mode='constant', pad_value=0.0,
          data_format='NCHW', name=None):
    return _simple('pad2d', input, {'paddings': list(paddings),
                                    'mode': mode, 'pad_value': pad_value,
                                    'data_format': data_format}, name)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _simple('pad_constant_like', x, {'pad_value': float(pad_value)},
                   name, extra_ins={'Y': y}, lod_from=y)


def one_hot(input, depth):
    return _simple('one_hot', input, {'depth': depth})


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype='float32',
                 name=None):
    extra = {'PriorDist': prior_dist} if prior_dist is not None else None
    return _simple('label_smooth', label, {'epsilon': float(epsilon)}, name,
                   extra_ins=extra)


def shape(input):
    helper = LayerHelper('shape')
    out = helper.create_variable_for_type_inference('int32')
    helper.append_op(type='shape', inputs={'Input': input},
                     outputs={'Out': out}, attrs={})
    return out


def multiplex(inputs, index):
    return _simple('multiplex', inputs, ins_name='X',
                   extra_ins={'Ids': index})


def space_to_depth(x, blocksize, name=None):
    return _simple('space_to_depth', x, {'blocksize': blocksize}, name)


def shuffle_channel(x, group, name=None):
    return _simple('shuffle_channel', x, {'group': group}, name)


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper('prelu', param_attr=param_attr, name=name)
    alpha_shape = [1]
    if mode == 'channel':
        alpha_shape = [x.shape[1]]
    elif mode == 'element':
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(helper.param_attr, alpha_shape, x.dtype,
                                    default_initializer=Constant(0.25))
    return _simple('prelu', x, {'mode': mode}, name,
                   extra_ins={'Alpha': alpha})


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    return _simple('l2_normalize', x, {'axis': axis, 'epsilon': epsilon},
                   name, outs=('Out', 'Norm'))[0]


def maxout(x, groups, name=None):
    return _simple('maxout', x, {'groups': groups}, name)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    extra = {'Y': y}
    if inside_weight is not None:
        extra['InsideWeight'] = inside_weight
    if outside_weight is not None:
        extra['OutsideWeight'] = outside_weight
    return _simple('smooth_l1_loss', x, {'sigma': sigma or 1.0},
                   outs=('Out', 'Diff'), extra_ins=extra)[0]


def huber_loss(input, label, delta):
    return _simple('huber_loss', input, {'delta': float(delta)},
                   outs=('Out', 'Residual'), extra_ins={'Y': label})[0]


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper('log_loss', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='log_loss',
                     inputs={'Predicted': input, 'Labels': label},
                     outputs={'Loss': out}, attrs={'epsilon': epsilon})
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper('rank_loss', name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(type='rank_loss',
                     inputs={'Label': label, 'Left': left, 'Right': right},
                     outputs={'Out': out}, attrs={})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper('margin_rank_loss', name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(type='margin_rank_loss',
                     inputs={'Label': label, 'X1': left, 'X2': right},
                     outputs={'Out': out, 'Activated': act},
                     attrs={'margin': margin})
    return out


def bpr_loss(input, label, name=None):
    return _simple('bpr_loss', input, name=name, outs=('Y',),
                   extra_ins={'Label': label})


def _triple(v):
    return [v] * 3 if isinstance(v, int) else list(v)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    helper = LayerHelper('conv3d', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1
    filter_size = _triple(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * _prod(filter_size)
    w = helper.create_parameter(helper.param_attr, filter_shape, dtype,
                                default_initializer=Normal(
                                    0.0, (2.0 / fan_in) ** 0.5))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='conv3d',
                     inputs={'Input': input, 'Filter': w},
                     outputs={'Output': pre_bias},
                     attrs={'strides': _triple(stride),
                            'paddings': _triple(padding),
                            'dilations': _triple(dilation), 'groups': groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper('conv2d_transpose', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    padding = [padding, padding] if isinstance(padding, int) else \
        list(padding)
    dilation = [dilation] * 2 if isinstance(dilation, int) else list(dilation)
    if filter_size is None:
        h_in, w_in = input.shape[2], input.shape[3]
        out_size = [output_size] * 2 if isinstance(output_size, int) else \
            list(output_size)
        filter_size = [
            (out_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1) //
            dilation[0] + 1,
            (out_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1) //
            dilation[1] + 1]
    elif isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    filter_shape = [num_channels, num_filters // groups] + list(filter_size)
    w = helper.create_parameter(helper.param_attr, filter_shape, dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='conv2d_transpose',
                     inputs={'Input': input, 'Filter': w},
                     outputs={'Output': pre_bias},
                     attrs={'strides': stride, 'paddings': padding,
                            'dilations': dilation, 'groups': groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper('conv3d_transpose', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    filter_shape = [num_channels, num_filters] + _triple(filter_size)
    w = helper.create_parameter(helper.param_attr, filter_shape, dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='conv3d_transpose',
                     inputs={'Input': input, 'Filter': w},
                     outputs={'Output': pre_bias},
                     attrs={'strides': _triple(stride),
                            'paddings': _triple(padding),
                            'dilations': _triple(dilation)})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type='max', pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper('pool3d', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='pool3d', inputs={'X': input}, outputs={'Out': out},
                     attrs={'pooling_type': pool_type,
                            'ksize': _triple(pool_size),
                            'strides': _triple(pool_stride),
                            'paddings': _triple(pool_padding),
                            'global_pooling': global_pooling,
                            'ceil_mode': ceil_mode, 'exclusive': exclusive})
    return out


def _adaptive_pool(op, nd, input, pool_size, pool_type, name):
    helper = LayerHelper(op, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type=op, inputs={'X': input}, outputs={'Out': out},
                     attrs={'ksize': pool_size if isinstance(
                         pool_size, (list, tuple)) else [pool_size] * nd,
                         'pooling_type': pool_type})
    return out


def adaptive_pool2d(input, pool_size, pool_type='max', require_index=False,
                    name=None):
    return _adaptive_pool('adaptive_pool2d', 2, input, pool_size, pool_type,
                          name)


def adaptive_pool3d(input, pool_size, pool_type='max', require_index=False,
                    name=None):
    return _adaptive_pool('adaptive_pool3d', 3, input, pool_size, pool_type,
                          name)


def group_norm(input, groups, epsilon=1e-05, param_attr=None, bias_attr=None,
               act=None, data_layout='NCHW', name=None):
    helper = LayerHelper('group_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    param_shape = [input.shape[1]]
    inputs = {'X': input}
    if param_attr is not False:
        inputs['Scale'] = helper.create_parameter(
            helper.param_attr, param_shape, dtype,
            default_initializer=Constant(1.0))
    if bias_attr is not False:
        inputs['Bias'] = helper.create_parameter(
            helper.bias_attr, param_shape, dtype, is_bias=True)
    mean_out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='group_norm', inputs=inputs,
                     outputs={'Y': out, 'Mean': mean_out,
                              'Variance': var_out},
                     attrs={'epsilon': epsilon, 'groups': groups})
    return helper.append_activation(out)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    return _simple('lrn', input, {'n': n, 'k': k, 'alpha': alpha,
                                  'beta': beta}, name,
                   outs=('Out', 'MidOut'))[0]


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample='BILINEAR', actual_shape=None, align_corners=True,
                 align_mode=1):
    op = 'bilinear_interp' if resample == 'BILINEAR' else 'nearest_interp'
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale), int(input.shape[3] * scale)]
    return _simple(op, input, {'out_h': int(out_shape[0]),
                               'out_w': int(out_shape[1]),
                               'align_corners': align_corners}, name)


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1):
    return image_resize(input, out_shape, scale, name, 'BILINEAR',
                        actual_shape, align_corners, align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True):
    return image_resize(input, out_shape, scale, name, 'NEAREST',
                        actual_shape, align_corners)


def image_resize_short(input, out_short_len, resample='BILINEAR'):
    h, w = input.shape[2], input.shape[3]
    short = min(h, w)
    out_shape = [int(h * out_short_len / short),
                 int(w * out_short_len / short)]
    return image_resize(input, out_shape, resample=resample)


def affine_channel(x, scale=None, bias=None, data_layout='NCHW', name=None):
    return _simple('affine_channel', x, name=name,
                   extra_ins={'Scale': scale, 'Bias': bias})
