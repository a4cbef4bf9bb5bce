"""Dead-op / dead-var elimination.

Counterpart of paddle_tpu/core/passes/dce.py.  Liveness roots: the fetch
set, persistable writes (the scope writeback), side-effect ops and
sub-block boundaries, with the kill-on-overwrite rule (walker.py).
Removed vars keep the block description in step with the op list.  Feed
vars (``is_data``) and ``@``-companion names (@GRAD, counters) are never
dropped: the executor looks them up by name.
"""
from . import walker

__all__ = ['run', 'sweep_dead']


def sweep_dead(program, fetch_names, stats=None, pinned=None):
    """One DCE sweep over every block; returns ops_removed count."""
    persistable = walker.persistable_names(program)
    if pinned is None:
        pinned = walker.control_flow_pinned(program)
    removed = 0
    for block in program.blocks:
        alive = walker.block_live_mask(
            program, block, set(fetch_names) | pinned,
            persistable=persistable, kill_overwrites=True)
        if all(alive):
            continue
        removed += alive.count(False)
        block.ops = [op for op, a in zip(block.ops, alive) if a]
    if removed:
        program._bump()
    if stats is not None:
        stats['ops_removed'] = stats.get('ops_removed', 0) + removed
    return removed


def _sweep_dead_vars(program, fetch_names):
    """Drop block-local var descriptions nothing references any more."""
    from ..framework import Parameter
    used = set(fetch_names) | walker.control_flow_pinned(program)
    for b in program.blocks:
        for op in b.ops:
            used.update(op.input_names())
            used.update(op.output_names())
            used.update(op.attrs.get('params', ()))
            for sub in op.attrs.get('sub_ops') or ():
                # fused runs reference their internal names through the
                # serialized sub-program, not through input slots
                for ns in sub['inputs'].values():
                    used.update(ns)
                for ns in sub['outputs'].values():
                    used.update(ns)
    removed = 0
    for b in program.blocks:
        keep = {}
        for name, v in b.vars.items():
            if (name in used or '@' in name or v.persistable or
                    v.is_data or isinstance(v, Parameter)):
                keep[name] = v
            else:
                removed += 1
        b.vars = keep
    return removed


def run(program, ctx):
    stats = {'ops_removed': 0, 'vars_removed': 0}
    # cascade: removing an op can orphan its producers
    while sweep_dead(program, ctx.fetch_names, stats,
                     pinned=ctx.cf_pinned):
        pass
    stats['vars_removed'] = _sweep_dead_vars(program, ctx.fetch_names)
    return stats
