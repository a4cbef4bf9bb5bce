"""CompiledProgram and its strategies.

Counterpart of paddle_tpu/compiler.py.  The reference's BuildStrategy
and ExecutionStrategy tuned the SSA-graph executor; their knobs mean
nothing to an interpreter replayed as CUDA graphs, so the port keeps
none of them and setting one raises rather than being ignored.
`ExecutionStrategy.num_iteration_per_drop_scope` is the one setting kept,
with the reference's meaning: K > 1 routes a list of per-step feeds
through `Executor.run_steps`, K steps a call, the fetches stacked over
all steps.  `with_data_parallel` raises: the parallel stack is ROADMAP A7.
"""
import numpy as np
import torch

from .core.executor import _ROADMAP_A7, _CompiledProgramBase
from .core.async_runtime import FetchFuture

__all__ = ['CompiledProgram', 'BuildStrategy', 'ExecutionStrategy']


class _Strategy(object):
    """Settings object that takes only the fields in `_FIELDS`: any other
    setting of the reference's strategy raises instead of being dropped."""
    _FIELDS = ()

    def __setattr__(self, name, value):
        if name not in self._FIELDS:
            raise AttributeError(
                '%s.%s is not supported: the port runs each launch '
                'signature as a CUDA graph and has nothing it would tune'
                % (type(self).__name__, name))
        object.__setattr__(self, name, value)


class BuildStrategy(_Strategy):
    pass


class ExecutionStrategy(_Strategy):
    _FIELDS = ('num_iteration_per_drop_scope',)

    def __init__(self):
        self.num_iteration_per_drop_scope = 1


class CompiledProgram(_CompiledProgramBase):
    def __init__(self, program, build_strategy=None, exec_strategy=None):
        # a BuildStrategy holds no settings (it takes none), so nothing of
        # it is kept
        self._program = program
        self._exec_strategy = exec_strategy

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        raise NotImplementedError(
            'CompiledProgram.with_data_parallel: ' + _ROADMAP_A7)

    def with_inference_optimize(self, config):
        """The program as it is: an inference program already runs as one
        CUDA graph per signature.  An AnalysisConfig's settings are the
        Predictor's (inference.py) to apply, so a config raises."""
        if config is not None:
            raise NotImplementedError(
                'CompiledProgram.with_inference_optimize: pass the '
                'AnalysisConfig to create_paddle_predictor instead')
        return self

    def prewarm(self, exe, feed, fetch_list, scope=None):
        """Plan and build every kernel this program needs at the feed
        signature of `feed` (name -> example array or (shape, dtype)),
        before the first real batch: `Executor.prepare`.  Nothing is
        captured here: each signature's CUDA graph is captured at a real
        run (its second), and one one-step graph serves every K, so there
        is no K to prewarm."""
        exe.prepare(self._program, feed=feed, fetch_list=fetch_list,
                    scope=scope)

    @property
    def _steps_per_launch(self):
        es = self._exec_strategy
        return 1 if es is None else \
            max(1, int(es.num_iteration_per_drop_scope))

    def _run(self, exe, feed, fetch_list, scope, return_numpy,
             as_futures=False):
        if self._steps_per_launch > 1 and isinstance(feed, (list, tuple)):
            # a list of per-step feeds: K steps a call, the fetches stacked
            # over all of them
            return self._run_steps(exe, list(feed), fetch_list, None, scope,
                                   return_numpy, as_futures=as_futures)
        return exe.run(self._program, feed=feed, fetch_list=fetch_list,
                       scope=scope, return_numpy=return_numpy,
                       as_futures=as_futures)

    def _run_steps(self, exe, feed_list, fetch_list, steps, scope,
                   return_numpy, as_futures=False):
        """The per-step feeds in chunks of num_iteration_per_drop_scope,
        one run_steps call a chunk."""
        k = steps or self._steps_per_launch
        if isinstance(feed_list, dict):   # a pre-stacked superbatch
            return exe.run_steps(self._program, feed_list=feed_list,
                                 fetch_list=fetch_list, steps=k, scope=scope,
                                 return_numpy=return_numpy,
                                 as_futures=as_futures)
        outs = [exe.run_steps(self._program, feed_list=feed_list[i:i + k],
                              fetch_list=fetch_list,
                              steps=len(feed_list[i:i + k]), scope=scope,
                              return_numpy=return_numpy,
                              as_futures=as_futures)
                for i in range(0, len(feed_list), k)]
        if len(outs) == 1:
            return outs[0]
        if as_futures:
            # concatenated on the device: no sync
            return [FetchFuture(torch.cat([o[j].device() for o in outs]))
                    for j in range(len(outs[0]))]
        if return_numpy:
            return [np.concatenate([o[j] for o in outs])
                    for j in range(len(outs[0]))]
        return [torch.cat([o[j] for o in outs]) for j in range(len(outs[0]))]
