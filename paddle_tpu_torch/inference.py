"""Inference engine: load a saved inference model into a Predictor.

Counterpart of paddle_tpu/inference.py (AnalysisConfig, Predictor).  The
JAX Predictor lowers the pruned program to one XLA executable per feed
shape; the port's Predictor runs it through the op-by-op Executor on its
device, so the hand-written kernels run inside each `run`; the Executor
hands the program to the PT_OPT rewriter first (core/passes), as the
reference's Predictor does before lowering.  It runs on CUDA unless
`AnalysisConfig.disable_gpu()` was called (the fluid API's own switch, a
no-op in the JAX package); with no CUDA device and no such call it
raises.  `AnalysisConfig.enable_bf16()` casts every float32 tensor of the
Predictor's scope to bfloat16 before the first run, as the reference's
`_cast_params_bf16` does: the program's ops then compute in bf16 (rms
norm and rope in float32 inside, as in the reference), its matrix
products run on the bf16 tensor cores and its attention on K1's bf16
wgmma kernel, and bf16 fetches come back as numpy arrays of
`ml_dtypes.bfloat16`, the dtype the JAX Predictor returns.  On the card each feed shape (each bucket of
a ServingEngine) is one launch signature of the Executor, so from its
second run `Predictor.run` replays a captured CUDA graph (core/graphs.py):
the reference's one executable per feed shape.  `_cast_params_bf16`
replaces the scope's tensors, and their dtypes are part of the
signature, so a cast after a run captures anew.  Not ported yet: the
lint policy, AOT export and the compile cache's disk tier.
"""
import threading

import torch

from . import io as fluid_io
from .core.executor import Executor, Scope, scope_guard, to_device, to_numpy
from .core.framework import CPUPlace, CUDAPlace, require_cuda

__all__ = ['AnalysisConfig', 'Predictor', 'create_paddle_predictor']


class AnalysisConfig(object):
    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self.use_gpu = True
        self.device_id = 0
        self.use_bf16 = False

    def enable_bf16(self):
        self.use_bf16 = True

    def enable_use_gpu(self, memory_pool_init_size_mb=0, device_id=0):
        self.use_gpu = True
        self.device_id = int(device_id)

    def disable_gpu(self):
        self.use_gpu = False


class Predictor(object):
    """Self-contained inference runner: own Scope + own Executor."""

    def __init__(self, config):
        if isinstance(config, str):
            config = AnalysisConfig(config)
        self._config = config
        if config.use_gpu:
            require_cuda('Predictor')
            place = CUDAPlace(config.device_id)
        else:
            place = CPUPlace()
        self._scope = Scope()
        self._exe = Executor(place)
        with scope_guard(self._scope):
            program, feed_names, fetch_vars = fluid_io.load_inference_model(
                config.model_dir, self._exe,
                model_filename=config.prog_file,
                params_filename=config.params_file)
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_names = [v.name for v in fetch_vars]
        if config.use_bf16:
            self._cast_params_bf16()
        # the serving dispatch thread and direct callers share one scope
        # and one device stream: one run at a time
        self._run_lock = threading.Lock()

    def _cast_params_bf16(self):
        for name, val in list(self._scope.vars.items()):
            if val.dtype == torch.float32:
                self._scope.vars[name] = val.to(torch.bfloat16)

    @property
    def device(self):
        return self._exe.device

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def run(self, feeds, return_numpy=True):
        """feeds: dict name -> array, or list of arrays in input-name order.
        Returns the fetches in output-name order (numpy arrays, or device
        tensors with return_numpy=False)."""
        if isinstance(feeds, (list, tuple)):
            feeds = dict(zip(self._feed_names, feeds))
        block = self._program.global_block()
        feeds = {n: to_device(v, block.var(n).dtype, self.device)
                 for n, v in feeds.items()}
        with self._run_lock:
            out = self._exe.run(self._program, feed=feeds,
                                fetch_list=self._fetch_names,
                                scope=self._scope, return_numpy=False)
        return [_fetch_numpy(o) for o in out] if return_numpy else out

    __call__ = run



def create_paddle_predictor(config):
    """A Predictor over `config` (the fluid CreatePaddlePredictor)."""
    return Predictor(config)


def _fetch_numpy(t):
    """A fetch as the JAX Predictor returns it: bf16 as ml_dtypes.bfloat16
    (its bits unchanged), every other dtype as to_numpy gives it."""
    if t.dtype != torch.bfloat16:
        return to_numpy(t)
    import ml_dtypes
    return t.detach().view(torch.int16).cpu().numpy().view(
        ml_dtypes.bfloat16)
