"""The flash kernels' outputs of one tree, saved, and two trees' compared
bit for bit, on the card.

    python3 tools/pt_flash_bwd_bitwise.py --root tmp/parent --save a.pt
    python3 tools/pt_flash_bwd_bitwise.py --root . --save b.pt
    python3 tools/pt_flash_bwd_bitwise.py --compare a.pt b.pt

`--save` imports `paddle_tpu_torch` from ROOT (so it builds and runs that
tree's kernels) and runs, on the cases below, inputs from a CUDA
generator seeded 11: its flash forward (`flash_forward`), and its flash
backward (`flash_backward`, the wrappers the training paths call) on the
output and LSE of the plain forward (`_ref_attention`, the same in both
trees, so a forward that changes does not move the backward's inputs);
it saves out, lse, dq, dk and dv by case.  `--compare` prints one JSON
line: for each case and tensor, whether the two files hold the same bits;
`held`, the tensors that must not move (`is_held`), and `all_held_equal`;
`changed`, the others that moved.  It exits non-zero when a held tensor
differs.  The cases are the head dims 64 and 128 in both dtypes, at the
paths' shapes (the flash training step's, the training llama's) and at
ragged ones, and the other head dims (padded instances up to 128; above
it the instances of width 256, the float32 backward's as clusters of
two blocks).
Needs a CUDA card for `--save`.
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
    'pad_f32_d16': (3, 8, 2, 100, 100, 16, True, [100, 0, 1], 'float32'),
    'pad_f32_d40': (2, 8, 4, 37, 161, 40, True, [161, 100], 'float32'),
    'pad_f32_d96': (2, 16, 8, 1024, 1024, 96, True, None, 'float32'),
    'pad_f32_d120': (1, 4, 2, 97, 161, 120, False, [130], 'float32'),
    'pad_bf16_d16': (3, 8, 2, 100, 100, 16, True, [100, 0, 1], 'bfloat16'),
    'pad_bf16_d96': (2, 16, 8, 1024, 1024, 96, True, None, 'bfloat16'),
    'wide_f32_d136': (2, 8, 2, 70, 90, 136, False, [90, 45], 'float32'),
    'wide_f32_d256': (2, 8, 2, 70, 70, 256, True, [70, 33], 'float32'),
    'wide_bf16_d200': (2, 8, 1, 70, 90, 200, True, [90, 45], 'bfloat16'),
    'wide_bf16_d256': (2, 8, 2, 70, 70, 256, True, [70, 33], 'bfloat16'),
}
NAMES = ('out', 'lse', 'dq', 'dk', 'dv')


def is_held(case, tensor):
    """Whether `tensor` of `case` must keep its bits: the forward at every
    D, the bf16 backward at every D and the float32 backward up to D = 128
    (the kernels they run are unchanged).  What may move: the float32
    backward above 128, which runs new kernels (the tensor-core instances
    of width 256, clusters of two blocks, in place of the CUDA-core ones),
    and which the card checks hold to the plain version instead."""
    _, _, _, _, _, D, _, _, dtype = CASES[case]
    return tensor in ('out', 'lse') or D <= 128 or dtype == 'bfloat16'


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
        scale = D ** -0.5
        out, lse = att.flash_forward(q, k, v, causal, scale, kl)
        pout, plse = att._ref_attention(q, k, v, causal, scale, kl)
        grads = att.flash_backward(q, k, v, kl, pout.contiguous(), plse, do,
                                   causal, scale)
        res[name] = [t.cpu() for t in (out, lse) + tuple(grads)]
    torch.save(res, path)
    print(json.dumps({'saved': path, 'root': root,
                      'package': att.__file__}), flush=True)


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    equal = {name: {n: bool(torch.equal(x, y)) for n, x, y in zip(
        NAMES, a[name], b[name])} for name in a}
    held = {name: [n for n in NAMES if is_held(name, n)] for name in equal}
    ok = set(a) == set(b) == set(CASES) and all(
        equal[c][n] for c in equal for n in held[c])
    changed = {c: [n for n in NAMES if not equal[c][n]] for c in equal}
    print(json.dumps({'compare': [a_path, b_path], 'equal': equal,
                      'held': held, 'all_held_equal': ok,
                      'changed': {c: v for c, v in changed.items() if v}}),
          flush=True)
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
