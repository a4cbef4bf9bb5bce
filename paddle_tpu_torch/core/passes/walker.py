"""Shared Program-IR reachability machinery of the rewriter.

Counterpart of paddle_tpu/core/passes/walker.py: the liveness walker the
DCE pass removes ops with, the persistable set, and the names pinned by
control flow.  The reference's walker also serves its lint (`analysis/`),
which the port has not ported, so only the DCE rule (kill on overwrite)
is here.  The port runs no control flow yet: no op owns a sub-block, and
`control_flow_pinned` is empty.
"""

__all__ = ['SIDE_EFFECT_OPS', 'persistable_names', 'block_live_mask',
           'control_flow_pinned']

# ops that are alive regardless of dataflow (observable effects)
SIDE_EFFECT_OPS = {'print', 'py_func', '__backward__', 'write_to_array'}


def control_flow_pinned(program):
    """Names the control-flow lowerer pattern-matches on.  The port has no
    control-flow ops, so nothing is pinned."""
    return set()


def persistable_names(program):
    """Every persistable (incl. Parameter) name, program-wide."""
    from ..framework import Parameter
    names = set()
    for b in program.blocks:
        names |= {n for n, v in b.vars.items()
                  if v.persistable or isinstance(v, Parameter)}
    return names


def block_live_mask(program, block, root_names, persistable=None,
                    kill_overwrites=False):
    """Reverse liveness walk over one block's ops.

    Returns a list of booleans parallel to ``block.ops``: True = alive.
    An op is alive when any output (transitively) reaches a root name, a
    persistable write, or a side-effecting op.  kill_overwrites=True
    (DCE): a write KILLS the need above it, so an earlier write that is
    overwritten before any read is dead.
    """
    if persistable is None:
        persistable = persistable_names(program)
    needed = set(root_names)
    alive = [False] * len(block.ops)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        outs = set(op.output_names())
        is_alive = (bool(outs & needed) or
                    bool(outs & persistable) or
                    op.type in SIDE_EFFECT_OPS)
        if is_alive:
            alive[i] = True
            if kill_overwrites:
                needed -= outs
            needed |= set(op.input_names())
            if op.type == '__backward__':
                needed |= set(op.attrs.get('params', ()))
    return alive
