"""paddle_tpu_torch.core.passes: the Program->Program optimizing rewriter.

Counterpart of paddle_tpu/core/passes/__init__.py.  The Executor (and so
the Predictor, which runs through it) hands every program to
`maybe_optimize` and interprets the optimized twin; its caches stay keyed
on the raw program.

Passes, in order (each ``run(program, ctx) -> stats`` mutates a private
clone in place):

  dce               dead-op/dead-var elimination (kill-on-overwrite)
  const_fold        compile-time-constant chains -> one fill_constant,
                    evaluated through the op's own impl (dtype-exact)
  cse               duplicate (type, inputs, attrs) ops rebind to one
  fuse_elementwise  consecutive elementwise/glue runs -> one
                    fused_elementwise op (ops/fused.py; on the card its
                    generated kernels, ops/kernelgen)
  canon             64-bit attr narrowing

The reference's `shard` pass (between cse and fuse_elementwise) belongs to
the parallel stack, which the port has not ported yet.

Environment:
  PT_OPT=1 (default) enables the pipeline; PT_OPT=0 is the kill switch
  and the only way to run a program unfused.
  PT_OPT_SKIP=pass,pass disables individual passes by name.

Invariants: deterministic, idempotent (optimizing an optimized program is
a no-op), `source_loc` kept on surviving, folded and fused ops, and the
same numbers as the unfused program: every op's ORIGINAL position is
stamped into an ``rng_stream`` attr that ``registry.OpCtx.generator``
prefers over the live op index, so rewrites never shift a random draw.
"""
import os
import time

from . import walker  # noqa: F401  (re-exported)
from . import dce, const_fold, cse, fuse, canon

__all__ = ['enabled', 'skip_set', 'config_token', 'optimize_program',
           'maybe_optimize', 'pass_names', 'PASSES', 'walker']

PASSES = (
    ('dce', dce.run),
    ('const_fold', const_fold.run),
    ('cse', cse.run),
    ('fuse_elementwise', fuse.run),
    ('canon', canon.run),
)


def pass_names():
    return [n for n, _ in PASSES]


def enabled():
    return os.environ.get('PT_OPT', '1') not in ('0', 'false', 'False')


def skip_set():
    raw = os.environ.get('PT_OPT_SKIP', '')
    return frozenset(p.strip() for p in raw.split(',') if p.strip())


def config_token():
    """Everything PT_OPT-shaped that changes what the executor runs."""
    if not enabled():
        return ('off',)
    return ('on',) + tuple(sorted(skip_set() & set(pass_names())))


class PassCtx(object):
    """Per-pass view of the program: the liveness roots plus the name sets
    every pass guards on (recomputed between passes)."""

    def __init__(self, program, fetch_names):
        self.program = program
        self.fetch_names = tuple(fetch_names)
        self.persistable = walker.persistable_names(program)
        self.cf_pinned = walker.control_flow_pinned(program)
        counts = {}
        for b in program.blocks:
            for op in b.ops:
                for n in op.output_names():
                    counts[n] = counts.get(n, 0) + 1
        self.multi_written = {n for n, c in counts.items() if c > 1}


def _op_count(program):
    return sum(len(b.ops) for b in program.blocks)


def _stamp_rng_streams(program):
    """Pin every op's RNG stream to its ORIGINAL position (the executor
    derives op streams from the live op index; rewrites shift indices).
    setdefault keeps re-optimization idempotent.  Sub-blocks use the
    reference's offset convention (idx * 4096)."""
    for b in program.blocks:
        offset = 0 if b.idx == 0 else b.idx * 4096
        for i, op in enumerate(b.ops):
            op.attrs.setdefault('rng_stream', offset + i)


def _clone(program):
    p = program.clone(for_test=False)
    p._amp = program._amp
    # clone() never rebuilds producer links: restore them (last writer
    # wins, matching append_op)
    for b in p.blocks:
        for op in b.ops:
            for n in op.output_names():
                v = b._find_var_recursive(n)
                if v is not None:
                    v.op = op
    return p


def optimize_program(program, fetch_names=(), skip=None):
    """Run the pipeline on a CLONE of `program`; returns (program', stats).
    The input program is never mutated."""
    skip = skip_set() if skip is None else frozenset(skip)
    opt = _clone(program)
    _stamp_rng_streams(opt)
    stats = {'op_count_raw': _op_count(program), 'passes': {},
             'pass_ms': 0.0}
    for name, fn in PASSES:
        if name in skip:
            continue
        t0 = time.perf_counter()
        pass_stats = fn(opt, PassCtx(opt, fetch_names)) or {}
        ms = (time.perf_counter() - t0) * 1000.0
        pass_stats['ms'] = round(ms, 3)
        stats['passes'][name] = pass_stats
        stats['pass_ms'] += ms
    stats['pass_ms'] = round(stats['pass_ms'], 3)
    stats['op_count_opt'] = _op_count(opt)
    stats['ops_removed'] = sum(
        p.get('ops_removed', 0) for p in stats['passes'].values())
    stats['ops_fused'] = stats['passes'].get(
        'fuse_elementwise', {}).get('ops_fused', 0)
    opt._bump()
    return opt, stats


_MEMO_MAX = 8


def maybe_optimize(program, fetch_names=()):
    """PT_OPT-gated, memoized entry used by the executor.  Returns
    (program', stats), or (program, None) untouched when disabled."""
    if not enabled():
        return program, None
    key = (program._version, tuple(fetch_names), config_token())
    memo = getattr(program, '_opt_memo', None)
    if memo is None:
        memo = program._opt_memo = {}
    hit = memo.get(key)
    if hit is not None:
        return hit
    opt, stats = optimize_program(program, fetch_names)
    while len(memo) >= _MEMO_MAX:
        memo.pop(next(iter(memo)))
    memo[key] = (opt, stats)
    return opt, stats
