"""Dtype normalization between fluid-style strings, numpy and torch dtypes.

Counterpart of paddle_tpu/core/dtypes.py.  The JAX package runs with x64
disabled, so every 64-bit value it materializes on the device is 32-bit
(`jax_dtype`).  The port keeps that narrowing (`torch_dtype`), so fetched
ids and tokens carry the same dtype in both packages.
"""
import numpy as np
import torch

__all__ = ['convert_dtype', 'dtype_str', 'torch_dtype', 'weak', 'NARROW']

_STR2TORCH = {
    'float32': torch.float32,
    'float64': torch.float64,
    'float16': torch.float16,
    'bfloat16': torch.bfloat16,
    'int64': torch.int64,
    'int32': torch.int32,
    'int16': torch.int16,
    'int8': torch.int8,
    'uint8': torch.uint8,
    'bool': torch.bool,
}
_TORCH2STR = {v: k for k, v in _STR2TORCH.items()}

# 64-bit names and the 32-bit dtype the device computes them in
NARROW = {'int64': 'int32', 'uint64': 'uint32', 'float64': 'float32'}


def dtype_str(dtype):
    """Normalize a dtype spec (str | np.dtype | torch.dtype) to its name."""
    if dtype is None:
        return 'float32'
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH2STR:
            raise ValueError('unsupported torch dtype: %s' % dtype)
        return _TORCH2STR[dtype]
    if isinstance(dtype, str):
        if dtype not in _STR2TORCH and dtype not in NARROW:
            raise ValueError('unsupported dtype string: %s' % dtype)
        return dtype
    name = np.dtype(dtype).name
    if name not in _STR2TORCH and name not in NARROW:
        raise ValueError('unsupported dtype: %s' % name)
    return name


def convert_dtype(dtype):
    """dtype spec -> numpy dtype (host-side arrays keep full widths).
    bfloat16 has no numpy dtype and raises."""
    name = dtype_str(dtype)
    if name == 'bfloat16':
        raise ValueError('bfloat16 has no numpy dtype')
    return np.dtype(name)


def torch_dtype(dtype):
    """dtype spec -> the torch dtype a device value of it has: 64-bit
    names narrow to 32 bits, as the JAX package's `jax_dtype` does."""
    name = dtype_str(dtype)
    return _STR2TORCH[NARROW.get(name, name)]



def weak(v, t):
    """A Python scalar `v` as jnp takes it where it meets the tensor `t`
    (a weak type): rounded to t's dtype where that is a float narrower
    than float32, and returned as the Python float of the rounded value
    (exact in t's dtype, so torch's float32 arithmetic on it computes
    what jnp's bf16 arithmetic does; no tensor, so a CUDA graph capture
    takes it).  Anywhere else `v` itself: torch rounds a Python float
    that meets a float32 tensor to float32, as jnp does."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(float(v), dtype=t.dtype))
    return v
