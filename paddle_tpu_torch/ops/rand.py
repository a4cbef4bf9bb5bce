"""Random initializer ops on an explicit torch.Generator.

Counterpart of paddle_tpu/ops/rand.py (uniform_random, gaussian_random,
truncated_gaussian_random).
The generator is seeded from the op's `seed` attr when it is non-zero,
else from the program's `random_seed`, the run counter and the op's
position (core/registry.py OpCtx.generator).  The draws are not the JAX
package's threefry draws: weights carried between the packages are copied
(convert.py), never re-drawn.
"""
import math

import torch

from ..core.dtypes import torch_dtype
from ..core.registry import register


def _random_fill(ctx, attrs, fill):
    dtype = torch_dtype(attrs.get('dtype', 'float32'))
    shape = [int(d) for d in attrs['shape']]
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    g = ctx.generator(attrs.get('seed', 0))
    if g is not None:       # shape inference draws nothing
        fill(out, g)
    return {'Out': out.to(dtype)}


@register('uniform_random')
def uniform_random(ctx, ins, attrs):
    lo, hi = attrs.get('min', -1.0), attrs.get('max', 1.0)
    return _random_fill(ctx, attrs,
                        lambda out, g: out.uniform_(lo, hi, generator=g))


@register('gaussian_random')
def gaussian_random(ctx, ins, attrs):
    mean, std = attrs.get('mean', 0.0), attrs.get('std', 1.0)
    return _random_fill(ctx, attrs,
                        lambda out, g: out.normal_(mean, std, generator=g))


@register('truncated_gaussian_random')
def truncated_gaussian_random(ctx, ins, attrs):
    """Normal draws truncated to +-2 std, by the inverse CDF as
    jax.random.truncated_normal draws them: u uniform on (erf(-2 / sqrt 2),
    erf(2 / sqrt 2)), x = sqrt 2 erfinv(u) clamped to [-2, 2], then mean +
    std x."""
    mean, std = attrs.get('mean', 0.0), attrs.get('std', 1.0)
    edge = math.erf(2.0 / math.sqrt(2.0))

    def fill(out, g):
        out.uniform_(-edge, edge, generator=g)
        out.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        out.mul_(std).add_(mean)
    return _random_fill(ctx, attrs, fill)
