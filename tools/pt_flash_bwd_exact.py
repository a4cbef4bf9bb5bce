"""The float32 flash backward against its exact gradients, on the card.

    python3 tools/pt_flash_bwd_exact.py

For each case, the inputs `tests/test_torch_cuda_kernels.py` makes for
its float32 backward checks (a CUDA generator seeded 2; B = 2), the
kernel forward's out and LSE, then three gradients of q, k and v: the
kernels' (`flash_backward`), the plain version in float32
(`flash_backward_reference`) and the plain version evaluated in float64
on the same inputs (the exact gradients).  One JSON line a case gives,
for dq, dk and dv, the largest |a - b| / (1e-5 max|b| + 1e-4 |b|) of
kernel against float32 plain, kernel against exact and float32 plain
against exact: a value above 1 misses the float32 check.  At a batch
row with k_len = 1, dS = P (dP - delta) is all rounding and a GQA
group's dK sums it over g x Tq rows.  Then the card's name and power
limit.  Needs a CUDA card.
"""
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from paddle_tpu_torch.ops import attention as att  # noqa: E402

# D, causal, Tq, Tk, H, Hkv, k_len
CASES = [(128, False, 150, 150, 8, 4, [150, 1]),
         (128, False, 150, 150, 8, 2, [1, 150]),
         (64, False, 150, 150, 8, 2, [150, 1]),
         (128, True, 256, 256, 16, 8, [256, 256]),
         (128, True, 37, 161, 8, 2, [161, 100]),
         (64, True, 256, 256, 8, 8, [256, 200])]


def ratio(a, b):
    """Max over elements of |a - b| against the float32 check's allowance
    with b as the reference."""
    a, b = a.double(), b.double()
    allow = 1e-5 * float(b.abs().max()) + 1e-4 * b.abs()
    return float(((a - b).abs() / allow).max())


def main():
    if not torch.cuda.is_available():
        sys.exit('pt_flash_bwd_exact: needs a CUDA card')
    for D, causal, Tq, Tk, H, Hkv, klen in CASES:
        g = torch.Generator(device='cuda').manual_seed(2)

        def randn(*shape):
            return torch.randn(*shape, generator=g, device='cuda')
        q, do = randn(2, H, Tq, D), randn(2, H, Tq, D)
        k, v = randn(2, Hkv, Tk, D), randn(2, Hkv, Tk, D)
        kl = torch.tensor(klen, dtype=torch.int32, device='cuda')
        scale = D ** -0.5
        out, lse = att.flash_forward(q, k, v, causal, scale, kl)
        kern = att.flash_backward(q, k, v, kl, out, lse, do, causal, scale)
        plain = att.flash_backward_reference(q, k, v, kl, out, lse, do,
                                             causal, scale)
        exact = att.flash_backward_reference(
            *(t.double() for t in (q, k, v)), kl, out.double(),
            lse.double(), do.double(), causal, scale)
        names = ('dq', 'dk', 'dv')
        print(json.dumps(dict(
            D=D, causal=causal, Tq=Tq, Tk=Tk, H=H, Hkv=Hkv, k_len=klen,
            kernel_vs_plain=dict(zip(names, map(ratio, kern, plain))),
            kernel_vs_exact=dict(zip(names, map(ratio, kern, exact))),
            plain_vs_exact=dict(zip(names, map(ratio, plain, exact))))),
            flush=True)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, stdout=subprocess.PIPE,
        universal_newlines=True).stdout.strip())


if __name__ == '__main__':
    main()
