"""Tensor creation and manipulation layers.

Counterpart of paddle_tpu/layers/tensor.py: create_tensor,
create_parameter, create_global_var, cast, concat, sums, assign (of a
Variable, or of a numpy array as `assign_value`), fill_constant,
fill_constant_batch_size_like, argmin, argmax, argsort, ones, zeros,
zeros_like, reverse, has_inf, has_nan and isfinite; and of
paddle_tpu/layers/control_flow.py the layers that need no sub-block:
increment, less_than and equal.
"""
import numpy as np

from ..core import unique_name
from ..core.dtypes import dtype_str
from ..core.framework import Variable
from ..core.layer_helper import LayerHelper
from .nn import _copy_lod

__all__ = ['create_tensor', 'create_parameter', 'create_global_var', 'cast',
           'concat', 'sums', 'assign', 'fill_constant',
           'fill_constant_batch_size_like', 'argmin', 'argmax', 'argsort',
           'ones', 'zeros', 'zeros_like', 'reverse', 'has_inf', 'has_nan',
           'isfinite', 'increment', 'less_than', 'equal']


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper('create_tensor', name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr
    helper = LayerHelper('create_parameter', name=name)
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..initializer import Constant
    helper = LayerHelper('global_var', name=name)
    var = helper.create_global_variable(
        name=name or unique_name.generate('global_var'), dtype=dtype,
        shape=shape, persistable=persistable)
    helper.set_variable_initializer(var, Constant(value))
    return var


def cast(x, dtype):
    helper = LayerHelper('cast')
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='cast', inputs={'X': x}, outputs={'Out': out},
                     attrs={'in_dtype': x.dtype,
                            'out_dtype': dtype_str(dtype)})
    _copy_lod(x, out)
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper('concat', name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type='concat', inputs={'X': list(input)},
                     outputs={'Out': out}, attrs={'axis': axis})
    _copy_lod(input[0], out)
    return out


def sums(input, out=None):
    helper = LayerHelper('sum')
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type='sum', inputs={'X': input}, outputs={'Out': out},
                     attrs={})
    return out


def assign(input, output=None):
    helper = LayerHelper('assign')
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(type='assign', inputs={'X': input},
                         outputs={'Out': output}, attrs={})
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                str(arr.dtype))
        helper.append_op(type='assign_value', inputs={},
                         outputs={'Out': output},
                         attrs={'shape': list(arr.shape),
                                'values': arr.reshape(-1).tolist(),
                                'dtype': str(arr.dtype)})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper('fill_constant')
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='fill_constant', inputs={},
                     outputs={'Out': out},
                     attrs={'shape': [int(s) for s in shape],
                            'value': float(value), 'dtype': out.dtype})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper('fill_constant_batch_size_like')
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='fill_constant_batch_size_like',
                     inputs={'Input': input}, outputs={'Out': out},
                     attrs={'shape': list(shape), 'value': float(value),
                            'input_dim_idx': input_dim_idx,
                            'output_dim_idx': output_dim_idx,
                            'dtype': dtype})
    out.stop_gradient = True
    return out


def argmin(x, axis=0):
    helper = LayerHelper('arg_min')
    out = helper.create_variable_for_type_inference('int64')
    helper.append_op(type='arg_min', inputs={'X': x}, outputs={'Out': out},
                     attrs={'axis': axis})
    return out


def argmax(x, axis=0):
    helper = LayerHelper('arg_max')
    out = helper.create_variable_for_type_inference('int64')
    helper.append_op(type='arg_max', inputs={'X': x}, outputs={'Out': out},
                     attrs={'axis': axis})
    return out


def argsort(input, axis=-1, name=None):
    helper = LayerHelper('argsort', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference('int64')
    helper.append_op(type='argsort', inputs={'X': input},
                     outputs={'Out': out, 'Indices': ids},
                     attrs={'axis': axis})
    return out, ids


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def zeros_like(x, out=None):
    helper = LayerHelper('zeros_like')
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='fill_zeros_like', inputs={'X': x},
                     outputs={'Out': out}, attrs={})
    return out


def reverse(x, axis):
    helper = LayerHelper('reverse')
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='reverse', inputs={'X': x}, outputs={'Out': out},
                     attrs={'axis': [axis] if isinstance(axis, int)
                            else list(axis)})
    return out


def _bool_check(op, helper_name, x):
    helper = LayerHelper(helper_name)
    out = helper.create_variable_for_type_inference('bool')
    helper.append_op(type=op, inputs={'X': x}, outputs={'Out': out},
                     attrs={})
    return out


def has_inf(x):
    return _bool_check('has_inf', 'isinf', x)


def has_nan(x):
    return _bool_check('has_nan', 'isnan', x)


def isfinite(x):
    return _bool_check('isfinite', 'isfinite', x)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper('increment')
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type='increment', inputs={'X': x},
                     outputs={'Out': out}, attrs={'step': float(value)})
    return out


def _compare(op, x, y, cond):
    helper = LayerHelper(op)
    if cond is None:
        cond = helper.create_variable_for_type_inference('bool')
    helper.append_op(type=op, inputs={'X': x, 'Y': y},
                     outputs={'Out': cond}, attrs={})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _compare('less_than', x, y, cond)


def equal(x, y, cond=None):
    return _compare('equal', x, y, cond)
