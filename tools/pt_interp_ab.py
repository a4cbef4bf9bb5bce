"""Interpreter step time of the port's training paths, tree against tree.

    python3 tools/pt_interp_ab.py [--detail] TREE [TREE ...]

Each TREE is a checkout of this repository (its own `paddle_tpu_torch/`),
for example the parent commit unpacked with `git archive` into a
directory that `.gitignore` lists, and `.` for this one.  The trees run
in the order given, each in a process of its own on the one card (give
them as parent, change, change, parent to compare two on one card).  In
each, transformer-base is built as `chip_smoke.py` builds it for its
`training` phase (flash attention, bf16 AMP) and its `training_composed`
phase (the model's own defaults), both with B=32, T=256, random weights
from the script's seed: 3 warm-up steps (they build the kernels), then 10
timed steps through `Executor.run` by the interpreter:
`use_program_cache=False` where the tree's `run` takes it (it replays
CUDA graphs otherwise), plain `run` where the interpreter is its only
path.  One JSON line per tree and path, then the card's name and power
limit.  `--detail` adds, from one more interpreted step each, the
Python lines that made a synchronizing CUDA call
(`torch.cuda.set_sync_debug_mode`) and the host's top functions by own
time (cProfile).  Needs a CUDA card.
"""
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py, for its configurations."""
    spec = importlib.util.spec_from_file_location(
        '_chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _detail(step):
    """One step(): the synchronizing calls by Python line, and the host's
    top functions by own time."""
    import cProfile
    import pstats
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    syncs = {}
    for w in caught:
        if 'synchroniz' in str(w.message):
            where = '%s:%d' % (os.path.relpath(w.filename, HERE), w.lineno)
            syncs[where] = syncs.get(where, 0) + 1
    prof = cProfile.Profile()
    prof.enable()
    step()
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(((tt, ct, n, '%s:%d(%s)' % (os.path.basename(f), ln, fn))
                  for (f, ln, fn), (_, n, tt, ct, _) in stats.items()),
                 reverse=True)[:12]
    return dict(syncs=syncs, host_top=[
        dict(own_ms=tt * 1e3, cum_ms=ct * 1e3, calls=n, fn=name)
        for tt, ct, n, name in top])


def child(tree, detail=False):
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, tree)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    pkg = os.path.dirname(os.path.abspath(fluid.__file__))
    if os.path.dirname(pkg) != tree:
        raise RuntimeError('paddle_tpu_torch came from %s, not %s'
                           % (pkg, tree))
    smoke = _smoke()
    for path, cfg in (('training', smoke.BENCH_CFG),
                      ('training_composed', smoke.COMPOSED_CFG)):
        main, startup, out = smoke._train_program(fluid, tr, True, **cfg)
        feed = tr.synthetic_batch(np.random.RandomState(0), 32,
                                  cfg['max_len'], cfg['trg_vocab'])
        scope, exe = fluid.Scope(), fluid.Executor()
        kw = {}
        if 'use_program_cache' in inspect.signature(exe.run).parameters:
            kw['use_program_cache'] = False
        losses, ms = [], []
        with fluid.scope_guard(scope):
            exe.run(startup)
            for i in range(13):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = exe.run(main, feed=feed, fetch_list=[out['loss']],
                               **kw)[0]
                dt = (time.perf_counter() - t0) * 1e3
                losses.append(float(loss.reshape(-1)[0]))
                if i >= 3:
                    ms.append(dt)
            extra = _detail(lambda: exe.run(
                main, feed=feed, fetch_list=[out['loss']], **kw)) \
                if detail else {}
        print(json.dumps(dict(tree=tree, path=path, interpreter_kw=kw,
                              step_ms=ms, median_step_ms=float(
                                  np.median(ms)), losses=losses,
                              **extra)),
              flush=True)
        del scope, exe
        torch.cuda.empty_cache()


def main(argv):
    detail = argv[:1] == ['--detail']
    argv = argv[1:] if detail else argv
    if argv[:1] == ['--child']:
        return child(os.path.abspath(argv[1]), detail)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        rc = subprocess.call([sys.executable, os.path.abspath(__file__)] +
                             ['--detail'] * detail +
                             ['--child', os.path.abspath(tree)])
        if rc:
            return rc
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
