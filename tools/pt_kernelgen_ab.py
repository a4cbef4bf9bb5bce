"""The generated elementwise kernels (K7's segments), tree against tree.

    python3 tools/pt_kernelgen_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository (its own `paddle_tpu_torch/`),
for example the parent commit unpacked with `git archive` into a
directory that `.gitignore` lists, and `.` for this one.  The trees run
in the order given, each in a process of its own on the one card (give
them as parent, change, change, parent to compare two on one card).  In
each, with this checkout's `chip_smoke.py` driving that tree's package:

- every generated segment function of the timed paths
  (`chip_smoke.path_segments`: the flash, float32 and composed
  transformer steps, the training llamas, ResNet-50, SE-ResNeXt-50,
  VGG-16, MNIST, the served llama in float32 and bf16) is planned and
  built by that tree's generator, and timed on positive random inputs
  (`chip_smoke.time_ms`: 50 launches behind a spin kernel, after a
  warm-up), beside its bytes bound (each input read and each output
  written once at 3.35 TB/s);
- SE-ResNeXt-50's AMP step and the composed transformer step (an
  interpreted step, the capture, 10 graph steps: the median step ms) and
  the bf16 served llama_1b's 4-row batch (5 `Predictor.run` calls after
  a warm-up: the median ms).

One JSON line per tree ({"tree", "segments": {name: {ms, bound_ms, ops,
paths, ...}}, "steps": {...}}) on stdout, then the card's name and power
limit; each tree's whole output also goes to
`chiprun_out/kernelgen_ab_<n>.log`.  Needs a CUDA card.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_STEPS = 10
SERVED_RUNS = 5


def _smoke():
    """This checkout's chip_smoke.py, for its paths, timer and phases."""
    spec = importlib.util.spec_from_file_location(
        '_chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def segments(cs):
    """name -> the timing of each generated segment function."""
    import torch
    from paddle_tpu_torch.ops import kernelgen
    t0 = time.perf_counter()
    specs = cs.path_segments()
    kernelgen.ensure_built()
    res = {'_build_s': time.perf_counter() - t0}
    for name, (spec, ops, paths) in sorted(specs.items()):
        ents = _inputs(cs, spec)
        with torch.no_grad():
            outs = kernelgen._launch(spec, ents)
            nbytes = sum(t.numel() * t.element_size()
                         for t in list(ents) + list(outs))
            ms = cs.time_ms(lambda: kernelgen._launch(spec, ents), 50)
        bound_ms = cs._bound(0.0, nbytes, 'float32')[0]
        row = dict(ops=ops if len(ops) < 120 else
                   '%s... (%d ops)' % (ops[:100], ops.count('+') + 1),
                   paths=paths, groups=len(spec.groups), bytes=nbytes,
                   ms=ms, bound_ms=bound_ms, share_of_bound=bound_ms / ms)
        lay = getattr(spec, 'layout', None)
        if lay is not None:
            row.update(tiles=lay.grid, threads=lay.threads,
                       streaming=lay.streaming)
        res[name] = row
    return res


def steps(cs, smi):
    """The steps' and the served batch's ms."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    out = {}
    main, startup, o, feed, amp = cs.conv_program('se_resnext50')
    launches, _, _ = cs._conv_step_phase(
        'kernelgen_ab', 'se_resnext50', main, startup, o, feed, amp, smi,
        profile=False)
    out['se_resnext50_launches'] = launches
    main, startup, o = cs._train_program(fluid, tr, amp=True,
                                         **cs.COMPOSED_CFG)
    feed = tr.synthetic_batch(np.random.RandomState(0), 32,
                              cs.COMPOSED_CFG['max_len'],
                              cs.COMPOSED_CFG['trg_vocab'])
    scope, exe = fluid.Scope(), fluid.Executor()
    with fluid.scope_guard(scope):
        exe.run(startup)
        ms = []
        for _ in range(GRAPH_STEPS + 2):
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[o['loss']])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    out['composed_step_ms'] = ms[2:]
    out['composed_median_step_ms'] = float(np.median(ms[2:]))
    from paddle_tpu_torch.models import llama
    with cs._model_dir() as d:
        cfg = cs._build_and_save(fluid, llama, d, cs.SERVED_FETCHES)[0]
        conf = fluid.inference.AnalysisConfig(d)
        conf.enable_bf16()
        pred = fluid.inference.Predictor(conf)
    rng = np.random.RandomState(cs.SEED)
    feed = {'tokens': cs._tokens(rng, 4, cfg['max_len'], cfg['vocab'])}
    pred.run(feed)
    torch.cuda.synchronize()
    ms = []
    for _ in range(SERVED_RUNS):
        t0 = time.perf_counter()
        pred.run(feed)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out['served_bf16_batch_ms'] = ms
    out['served_bf16_median_batch_ms'] = float(np.median(ms))
    return out


def one(tree):
    sys.path.insert(0, os.path.abspath(tree))
    cs = _smoke()
    cs.ROOT = os.path.abspath(tree)
    smi = cs.smi_line()
    res = {'tree': tree, 'segments': segments(cs)}
    res['steps'] = steps(cs, smi)
    res['package'] = sys.modules['paddle_tpu_torch'].__file__
    res['card'] = smi
    return res


def _inputs(cs, spec):
    import torch
    from paddle_tpu_torch.core.dtypes import torch_dtype
    g = torch.Generator(device='cuda').manual_seed(cs.SEED + 11)
    ents = []
    for shape, dt in spec.entry_avals:
        if dt == 'int32':
            ents.append(torch.randint(1, 100, shape, generator=g,
                                      device='cuda', dtype=torch.int32))
        else:
            ents.append((torch.rand(shape, generator=g, device='cuda')
                         + 0.5).to(torch_dtype(dt)))
    return ents


def main():
    if len(sys.argv) == 3 and sys.argv[1] == '--one':
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2 or sys.argv[1].startswith('-'):
        sys.exit(__doc__)
    out_dir = os.path.join(HERE, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    for k, tree in enumerate(sys.argv[1:]):
        log = os.path.join(out_dir, 'kernelgen_ab_%d.log' % k)
        with open(log, 'w') as f:
            rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                                  '--one', tree], stdout=f,
                                 stderr=subprocess.STDOUT)
        with open(log) as f:
            lines = [ln for ln in f if ln.startswith('{"tree"')]
        if rc or not lines:
            print('tree %s failed (rc %d), see %s' % (tree, rc, log),
                  flush=True)
            return rc or 1
        print(lines[-1].rstrip(), flush=True)
    print(_smoke().smi_line(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
