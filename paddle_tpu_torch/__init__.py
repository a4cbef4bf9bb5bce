"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper.

    import paddle_tpu_torch as fluid

The same fluid-style Program / layers / Executor / io / inference / serving
surface as `paddle_tpu`, running op by op on an explicit device.  Every
TPU kernel on a ported path is a hand-written CUDA kernel for sm_90a
(csrc/, built at first use by kernels/build.py).  Entry points run on the
card unless the caller asks for the CPU (`Executor(CPUPlace())`,
`AnalysisConfig.disable_gpu()`); with no card they raise.

Ported so far: the serving path — `models.llama.generation_program` ->
`io.save_inference_model` -> `inference.Predictor` (float32, or bf16
with `AnalysisConfig.enable_bf16`) -> `serving.ServingEngine.from_predictor`
— streaming generation over a paged KV cache (`serving.generation`,
`models.llama.make_streaming_runtime`), and the transformer training
step — `models.transformer.build` (`append_backward`, Adam with
`noam_decay`, bf16 AMP through `Program.set_amp`) run by
`Executor.run(main, feed, fetch_list=[loss])` — and the executor's
runtime: `Executor.run_steps`, `check_nan` with its deferred verdict,
`as_futures`, `CompiledProgram` and `FeedPrefetcher`, each launch
signature on the card replayed as a captured CUDA graph.  Ragged
sequences feed as LoDTensors (padded data plus `<name>@LENGTH`,
core/lod.py) into the sequence ops and RNNs (ops/sequence.py).
"""
from .core import unique_name  # noqa: F401
from .core.framework import (Program, Block, Operator, Variable,  # noqa: F401
                             Parameter, program_guard, default_main_program,
                             default_startup_program, CPUPlace, CUDAPlace)
from .core.executor import (Executor, Scope, scope_guard,  # noqa: F401
                            global_scope)
from .param_attr import ParamAttr  # noqa: F401
from .data_feeder import (FeedBucketer, FeedPrefetcher,  # noqa: F401
                          DataFeeder)
from .core.lod import (LoDTensor, create_lod_tensor,  # noqa: F401
                       create_random_int_lodtensor)
from .core import lod as lod_tensor  # noqa: F401
from .compiler import (CompiledProgram, BuildStrategy,  # noqa: F401
                       ExecutionStrategy)
from . import (initializer, layers, io, inference, serving,  # noqa: F401
               optimizer, nets, models)
from . import regularizer, clip  # noqa: F401
from .clip import set_gradient_clip  # noqa: F401
from .core.backward import append_backward  # noqa: F401
from .convert import scope_from_numpy, persistable_names  # noqa: F401
