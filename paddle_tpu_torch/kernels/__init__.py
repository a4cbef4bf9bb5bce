"""The port's hand-written CUDA kernels: build, load, launch counts.

`launches` counts, per kernel, the launches its wrapper made: each wrapper
adds one where it launches its kernel and nowhere else, so a run can show
that its path went through the kernels (chip_smoke.py reads it).
`kernelgen_segment` counts the launches of every generated segment
(ops/kernelgen); `ops.kernelgen.launches` has them by function.
`flash_attention_composed` counts the calls that route a head dim no
flash kernel tiles to the composed attention (ops/attention.py), on any
device: a route, not a kernel.  A CUDA
graph's replay runs no Python: core/graphs.py takes back the counts its
capture made and adds them once a replay, so the counts stay the
launches the device ran.
"""
from .build import library

__all__ = ['library', 'launches', 'reset_launches', 'check']

launches = {'flash_attention_fwd': 0, 'flash_attention_bwd_dq': 0,
            'flash_attention_bwd_dkv': 0, 'embedding_gather': 0,
            'layer_norm': 0, 'adam_multi': 0, 'adam_multi_bf16': 0,
            'momentum_multi': 0, 'momentum_multi_bf16': 0, 'softmax': 0,
            'kernelgen_segment': 0, 'flash_attention_composed': 0}
# csrc/optim_multi.cu: one counter an instance (ops/optimizer_ops.py
# _KINDS), its float32 one and its bf16 one
launches.update({k + s: 0 for k in (
    'sgd', 'adagrad', 'decayed_adagrad', 'adamax', 'adadelta', 'rmsprop',
    'rmsprop_centered', 'ftrl', 'ftrl_pow') for s in ('_multi',
                                                      '_multi_bf16')})


def reset_launches():
    for k in launches:
        launches[k] = 0


def check(rc, name):
    """Raise if a C entry point returned a CUDA error: a launch the device
    refused never runs, and a later synchronize does not report it."""
    if rc != 0:
        msg = library().pt_error_string(rc).decode(errors='replace')
        raise RuntimeError('%s kernel launch failed: CUDA error %d (%s)'
                           % (name, rc, msg))
