"""torch's intra-op threads in a pytest-xdist worker, capped at the
worker's share of the host's cores, and at least two.

Every tests/test_torch_*.py file imports this module.  Each of the n
workers would otherwise start as many OpenMP threads as the host has
cores, and n times that many threads spinning on the cores slow small
torch operations by an order of magnitude.  One thread is too few: on
one thread torch's CPU kernels sum long reductions in one sequential
order, and the reduced SE-ResNeXt's float32 step in
tests/test_torch_conv_models.py then moves away from the JAX package by
more than the float32 noise its bound is calibrated by.  A run without
xdist keeps torch's default."""
import os

import torch

_WORKERS = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT') or 0)
if _WORKERS > 1:
    torch.set_num_threads(max(2, (os.cpu_count() or 1) // _WORKERS))
