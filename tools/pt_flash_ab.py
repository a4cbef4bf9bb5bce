"""The flash kernels' times, tree against tree.

    python3 tools/pt_flash_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository (its own `paddle_tpu_torch/`),
for example the parent commit unpacked with `git archive` into a
directory that `.gitignore` lists, and `.` for this one.  The trees run
in the order given, each in a process of its own on the one card (give
them as parent, change, change, parent to compare two on one card).  In
each, the forward (`flash_forward`), dQ (`_launch_bwd_dq`) and dK/dV
(`_launch_bwd_dkv`) are timed with CUDA events (`chip_smoke.py`'s
`time_ms`: 20 calls behind a spin kernel, after a warm-up) at the shapes
of the flash training step (B 32, H 8, T 256, D 64, bf16), of the
training llama (B 2, H 16 / 8, T 2048, D 128, causal; bf16 and float32)
and at D = 256 (B 2, H 16 / 8, T 1024, causal, bf16), inputs from a CUDA
generator seeded 11.  One JSON line per tree, then the card's name and
power limit.  Needs a CUDA card.
"""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: B, H, Hkv, T, D, causal, dtype
SHAPES = {
    'flash_step': (32, 8, 8, 256, 64, False, 'bfloat16'),
    'llama': (2, 16, 8, 2048, 128, True, 'bfloat16'),
    'llama_f32': (2, 16, 8, 2048, 128, True, 'float32'),
    'd256': (2, 16, 8, 1024, 256, True, 'bfloat16'),
}


def _smoke():
    """This checkout's chip_smoke.py, for its timer."""
    spec = importlib.util.spec_from_file_location(
        '_chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(tree):
    """The times of `tree`'s kernels -> {shape: {kernel: ms}}."""
    import torch
    sys.path.insert(0, os.path.abspath(tree))
    from paddle_tpu_torch.ops import attention as att
    time_ms = _smoke().time_ms
    res = {}
    for name, (B, H, Hkv, T, D, causal, dtype) in SHAPES.items():
        g = torch.Generator(device='cuda').manual_seed(11)

        def randn(*shape):
            return torch.randn(*shape, generator=g, device='cuda').to(
                getattr(torch, dtype))
        q, do = randn(B, H, T, D), randn(B, H, T, D)
        k, v = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
        kl = torch.full((B,), T, dtype=torch.int32, device='cuda')
        scale = D ** -0.5
        out, lse = att.flash_forward(q, k, v, causal, scale, kl)
        delta = att._bwd_delta(out, do)
        args = (q, k, v, kl, lse, delta, do, causal, scale)
        res[name] = dict(
            fwd_ms=time_ms(lambda: att.flash_forward(q, k, v, causal, scale,
                                                     kl), 20),
            dq_ms=time_ms(lambda: att._launch_bwd_dq(*args), 20),
            dkv_ms=time_ms(lambda: att._launch_bwd_dkv(*args), 20))
    return res


def main():
    if len(sys.argv) == 3 and sys.argv[1] == '--one':
        print(json.dumps({'tree': sys.argv[2], 'ms': one(sys.argv[2]),
                          'package': sys.modules[
                              'paddle_tpu_torch'].__file__}), flush=True)
        return 0
    if len(sys.argv) < 2 or sys.argv[1].startswith('-'):
        sys.exit(__doc__)
    for tree in sys.argv[1:]:
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              '--one', tree])
        if rc:
            return rc
    print(_smoke().smi_line(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
