"""Tensor creation layers the training slice uses.

Counterpart of paddle_tpu/layers/tensor.py: create_parameter,
create_global_var, cast,
concat, sums, assign (of a Variable, or of a numpy array as
`assign_value`), fill_constant and fill_constant_batch_size_like.
"""
import numpy as np

from ..core import unique_name
from ..core.dtypes import dtype_str
from ..core.framework import Variable
from ..core.layer_helper import LayerHelper
from .nn import _copy_lod

__all__ = ['create_parameter', 'create_global_var', 'cast', 'concat', 'sums', 'assign',
           'fill_constant', 'fill_constant_batch_size_like']


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
