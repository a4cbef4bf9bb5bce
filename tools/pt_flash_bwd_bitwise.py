"""The flash backward's gradients of one tree, saved, and two trees'
compared bit for bit, on the card.

    python3 tools/pt_flash_bwd_bitwise.py --root tmp/parent --save a.pt
    python3 tools/pt_flash_bwd_bitwise.py --root . --save b.pt
    python3 tools/pt_flash_bwd_bitwise.py --compare a.pt b.pt

`--save` imports `paddle_tpu_torch` from ROOT (so it builds and runs that
tree's kernels), runs its flash forward and backward (`flash_backward`,
the wrappers the training paths call) on the cases below, inputs from a
CUDA generator seeded 11, and saves dq, dk and dv by case.  `--compare`
prints one JSON line: for each case and gradient, whether the two files
hold the same bits, and `all_equal`; it exits non-zero when any differ.
The cases are the head dims 64 and 128 in both dtypes, at the paths'
shapes (the flash training step's, the training llama's) and at ragged
ones.  Needs a CUDA card for `--save`.
"""
import argparse
import json
import os
import sys

import torch

# name: B, H, Hkv, Tq, Tk, D, causal, k_len (None: Tk), dtype
CASES = {
    'train_bf16_d64': (32, 8, 8, 256, 256, 64, False, None, 'bfloat16'),
    'train_f32_d64': (32, 8, 8, 256, 256, 64, False, None, 'float32'),
    'llama_f32_d128': (2, 16, 8, 2048, 2048, 128, True, None, 'float32'),
    'llama_bf16_d128': (2, 16, 8, 2048, 2048, 128, True, None, 'bfloat16'),
    'ragged_f32_d64': (3, 8, 2, 150, 150, 64, True, [150, 0, 1], 'float32'),
    'ragged_bf16_d128': (2, 8, 4, 37, 161, 128, True, [161, 100],
                         'bfloat16'),
    'ragged_f32_d128': (2, 8, 4, 97, 161, 128, False, [161, 1], 'float32'),
}


def save(root, path):
    sys.path.insert(0, os.path.abspath(root))
    from paddle_tpu_torch.ops import attention as att
    res = {}
    for name, (B, H, Hkv, Tq, Tk, D, causal, klen, dtype) in CASES.items():
        g = torch.Generator(device='cuda').manual_seed(11)
        dt = getattr(torch, dtype)

        def randn(*shape):
            return torch.randn(*shape, generator=g, device='cuda').to(dt)
        q, do = randn(B, H, Tq, D), randn(B, H, Tq, D)
        k, v = randn(B, Hkv, Tk, D), randn(B, Hkv, Tk, D)
        kl = torch.tensor([Tk] * B if klen is None else klen,
                          dtype=torch.int32, device='cuda')
        out, lse = att.flash_forward(q, k, v, causal, None, kl)
        grads = att.flash_backward(q, k, v, kl, out, lse, do, causal)
        res[name] = [t.cpu() for t in (out, lse) + tuple(grads)]
    torch.save(res, path)
    print(json.dumps({'saved': path, 'root': root,
                      'package': att.__file__}), flush=True)


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    equal = {name: {n: bool(torch.equal(x, y)) for n, x, y in zip(
        ('out', 'lse', 'dq', 'dk', 'dv'), a[name], b[name])} for name in a}
    ok = all(all(v.values()) for v in equal.values()) and set(a) == set(b)
    print(json.dumps({'compare': [a_path, b_path], 'equal': equal,
                      'all_equal': ok}), flush=True)
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default='.')
    ap.add_argument('--save')
    ap.add_argument('--compare', nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        sys.exit('pt_flash_bwd_bitwise: needs a CUDA card')
    save(args.root, args.save)
    return 0


if __name__ == '__main__':
    sys.exit(main())
