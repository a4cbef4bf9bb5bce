"""Common-subexpression elimination within a block.

Counterpart of paddle_tpu/core/passes/cse.py.  Two ops compute the same
value when they have the same type, the same canonical inputs (after
upstream rebinding) and the same attrs, modulo bookkeeping attrs
(`op_role`, `rng_stream`, `recompute_id`).  The duplicate is dropped and
every later read of its outputs rebinds to the first op's outputs.

Skipped: RNG ops (two dropouts are two draws), side-effect and
`__backward__` ops, ops writing persistables or fetched names, and names
written more than once.
"""
import json

from . import walker

__all__ = ['run', 'RNG_OPS']

# ops drawing random numbers: never merged, never folded
RNG_OPS = {
    'dropout', 'uniform_random', 'gaussian_random',
    'truncated_gaussian_random', 'uniform_random_batch_size_like',
    'gaussian_random_batch_size_like', 'sampling_id', 'random_crop',
    'nce',
}

_IGNORED_ATTRS = ('op_role', 'rng_stream', 'recompute_id')


def _attr_key(attrs):
    pruned = {k: v for k, v in attrs.items() if k not in _IGNORED_ATTRS}
    return json.dumps(pruned, sort_keys=True, default=str)


def run(program, ctx):
    stats = {'ops_removed': 0}
    fetch = set(ctx.fetch_names)
    for block in program.blocks:
        seen = {}     # key -> canonical op
        rename = {}   # dup output name -> canonical output name
        kept = []
        block_removed = 0
        for op in block.ops:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [rename.get(n, n) for n in names]
            mergeable = (
                op.type not in RNG_OPS and
                op.type not in walker.SIDE_EFFECT_OPS and
                op.output_names() and
                not any(n in ctx.persistable or n in fetch or
                        n in ctx.multi_written or n in ctx.cf_pinned
                        for n in op.output_names()) and
                not any(n in ctx.multi_written for n in op.input_names()))
            if not mergeable:
                kept.append(op)
                continue
            key = (op.type,
                   tuple(sorted((s, tuple(ns))
                                for s, ns in op.inputs.items())),
                   _attr_key(op.attrs))
            first = seen.get(key)
            if first is None:
                seen[key] = op
                kept.append(op)
                continue
            # same computation: rebind this op's outputs to the first's
            pairs = []
            ok = True
            for slot, names in op.outputs.items():
                fnames = first.outputs.get(slot, [])
                if len(fnames) != len(names):
                    ok = False
                    break
                pairs.extend(zip(names, fnames))
            if not ok:
                kept.append(op)
                continue
            rename.update(dict(pairs))
            block_removed += 1
        if block_removed:
            block.ops = kept
            stats['ops_removed'] += block_removed
            program._bump()
    return stats
