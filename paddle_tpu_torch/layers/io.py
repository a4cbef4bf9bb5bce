"""Input layers.

Counterpart of paddle_tpu/layers/io.py::data.  A ragged (lod_level > 0)
data var is declared as padded [-1, -1, *feature] plus a companion int32
`<name>@LENGTH` vector (and `<name>@OUTERLEN` at level 2), which the
executor feeds from a LoDTensor (core/lod.py).  The readers are not
ported.
"""
from ..core.framework import default_main_program
from ..core.lod import LENGTH_SUFFIX, OUTER_SUFFIX

__all__ = ['data']


def data(name, shape, dtype='float32', lod_level=0, type=None,
         append_batch_size=True, stop_gradient=True):
    """Declare an input variable."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    shape = [d if (d is None or d >= 0) else -1 for d in shape]
    if lod_level > 0:
        # padded layout: [batch, time, *feature]
        shape = [shape[0], -1] + shape[1:]
    block = default_main_program().global_block()
    var = block.create_var(name=name, shape=shape, dtype=dtype,
                           lod_level=lod_level, is_data=True,
                           stop_gradient=stop_gradient)
    if lod_level > 0:
        block.create_var(name=name + LENGTH_SUFFIX, shape=[-1],
                         dtype='int32', is_data=True, stop_gradient=True)
        var.lod_length_name = name + LENGTH_SUFFIX
    if lod_level > 1:
        # lengths of lengths: the inner sequences of each outer group
        block.create_var(name=name + OUTER_SUFFIX, shape=[-1],
                         dtype='int32', is_data=True, stop_gradient=True)
        var.lod_outer_length_name = name + OUTER_SUFFIX
    return var
