"""Parameter initializers — emit init ops into the startup program.

Counterpart of paddle_tpu/initializer.py (Constant, Uniform, Normal,
TruncatedNormal, Xavier, MSRA, Bilinear, NumpyArray).  The ops they emit
are the JAX package's; the draws come from a torch.Generator
(ops/rand.py), so the random values differ between the packages, while
Bilinear and NumpyArray (an `assign_value` of the array) are exact.
"""
import numpy as np

from .core.framework import default_startup_program

__all__ = ['Constant', 'Uniform', 'Normal', 'TruncatedNormal', 'Xavier',
           'Bilinear', 'MSRA', 'ConstantInitializer', 'UniformInitializer',
           'NormalInitializer', 'TruncatedNormalInitializer',
           'XavierInitializer', 'BilinearInitializer', 'MSRAInitializer',
           'NumpyArrayInitializer']


class Initializer(object):
    def __call__(self, var, block=None):
        raise NotImplementedError

    def _startup_var(self, var):
        """Mirror the param var into the startup program and return the
        startup block to append the init op to."""
        sblock = default_startup_program().global_block()
        if var.name not in sblock.vars:
            sblock.create_var(name=var.name, shape=var.shape,
                              dtype=var.dtype, persistable=True)
        return sblock


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block=None):
        sb = self._startup_var(var)
        sb.append_op(type='fill_constant', inputs={},
                     outputs={'Out': sb.vars[var.name]},
                     attrs={'shape': list(var.shape), 'value': self.value,
                            'dtype': var.dtype})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block=None):
        sb = self._startup_var(var)
        sb.append_op(type='uniform_random', inputs={},
                     outputs={'Out': sb.vars[var.name]},
                     attrs={'shape': list(var.shape), 'min': self.low,
                            'max': self.high, 'seed': self.seed,
                            'dtype': var.dtype})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        sb = self._startup_var(var)
        sb.append_op(type='gaussian_random', inputs={},
                     outputs={'Out': sb.vars[var.name]},
                     attrs={'shape': list(var.shape), 'mean': self.loc,
                            'std': self.scale, 'seed': self.seed,
                            'dtype': var.dtype})


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        sb = self._startup_var(var)
        sb.append_op(type='truncated_gaussian_random', inputs={},
                     outputs={'Out': sb.vars[var.name]},
                     attrs={'shape': list(var.shape), 'mean': self.loc,
                            'std': self.scale, 'seed': self.seed,
                            'dtype': var.dtype})


def _fans(var):
    shape = var.shape
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) >= 3:
        recep = int(np.prod(shape[2:]))
        fan_in, fan_out = shape[1] * recep, shape[0] * recep
    else:
        fan_in = fan_out = int(np.prod(shape))
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block=None):
        fan_in, fan_out = _fans(var)
        fan_in = self.fan_in if self.fan_in is not None else fan_in
        fan_out = self.fan_out if self.fan_out is not None else fan_out
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / (fan_in + fan_out)))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block=None):
        fan_in, _ = _fans(var)
        fan_in = self.fan_in if self.fan_in is not None else fan_in
        if self.uniform:
            limit = float(np.sqrt(6.0 / fan_in))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / fan_in))
            NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """Bilinear upsampling kernel for a conv_transpose weight [C_out, C_in,
    kh, kw], as the reference builds it."""

    def __call__(self, var, block=None):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError('Bilinear init needs a 4-D conv weight')
        c_out, c_in, kh, kw = shape
        f = np.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        w = np.zeros(shape, dtype='float32')
        og = np.ogrid[:kh, :kw]
        filt = (1 - abs(og[0] / f - c)) * (1 - abs(og[1] / f - c))
        w[range(c_out), range(c_in) if c_in == c_out else 0] = filt
        NumpyArrayInitializer(w)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block=None):
        sb = self._startup_var(var)
        sb.append_op(type='assign_value', inputs={},
                     outputs={'Out': sb.vars[var.name]},
                     attrs={'shape': list(self.value.shape),
                            'values': self.value.reshape(-1).tolist(),
                            'dtype': var.dtype})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
