"""LayerHelper — shared plumbing for the layer functions.

Counterpart of paddle_tpu/core/layer_helper.py: parameter creation with
ParamAttr and a default initializer, temporaries, bias and activation ops.
"""
import copy

from . import unique_name
from .framework import default_main_program, default_startup_program
from ..param_attr import ParamAttr

__all__ = ['LayerHelper']


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        if self.kwargs.get('name', None) is None:
            self.kwargs['name'] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs['name']

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.block.append_op(*args, **kwargs)

    def multiple_input(self, input_param_name='input'):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, (list, tuple)):
            return list(inputs)
        return [inputs]

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get('param_attr', None))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get('bias_attr', None))

    def multiple_param_attr(self, length):
        param_attr = self.param_attr
        if isinstance(param_attr, ParamAttr):
            param_attr = [param_attr]
        if len(param_attr) != 1 and len(param_attr) != length:
            raise ValueError('parameter number mismatch')
        elif len(param_attr) == 1 and length != 1:
            param_attr = [copy.deepcopy(param_attr[0]) for _ in range(length)]
        return param_attr

    def input_dtype(self, input_param_name='input'):
        dtype = None
        for each in self.multiple_input(input_param_name):
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError('data types of inputs must be consistent')
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        from ..initializer import Xavier, Constant
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if default_initializer is None:
            default_initializer = Constant(0.0) if is_bias else Xavier()
        attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate('.'.join(
                [self.kwargs['name'], 'b' if is_bias else 'w']))
        shape = [int(d) for d in shape]
        param = self.block.create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs())
        attr.initializer(param)
        return param

    def create_variable_for_type_inference(self, dtype=None,
                                           stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate('.'.join([self.name, 'tmp'])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_variable(self, *args, **kwargs):
        return self.block.create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def create_or_get_global_variable(self, name, *args, **kwargs):
        gb = self.main_program.global_block()
        if name in gb.vars:
            return gb.vars[name]
        return self.create_global_variable(*args, name=name, **kwargs)

    def set_variable_initializer(self, var, initializer):
        initializer(var)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None and \
                'bias_attr' in self.kwargs and self.kwargs['bias_attr'] is False:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type='elementwise_add',
                       inputs={'X': input_var, 'Y': b},
                       outputs={'Out': tmp},
                       attrs={'axis': dim_start})
        return tmp

    def append_activation(self, input_var, act=None):
        act = act if act is not None else self.kwargs.get('act', None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act_type, act_attrs = act, {}
        else:
            act = dict(act)
            act_type = act.pop('type')
            act_attrs = act
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={'X': input_var},
                       outputs={'Out': tmp}, attrs=act_attrs)
        return tmp
