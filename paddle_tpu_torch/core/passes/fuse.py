"""Elementwise-chain fusion: collapse maximal consecutive runs of
elementwise/glue ops into one ``fused_elementwise`` op.

Counterpart of paddle_tpu/core/passes/fuse.py; the op sets are the
reference's, verbatim.  A fused op carries the run as a serialized
sub-program in its attrs and replays it inside ONE registered impl
(ops/fused.py): on the card its generated kernels (ops/kernelgen), on the
CPU each sub-op's own impl in order.

The run is a DAG, not just a linear chain: K consecutive fusable ops fuse
regardless of internal wiring (158 independent per-param `adam` updates
collapse to one op just like a scale->relu->cast chain).  A name written
inside the run ESCAPES, and becomes a fused-op output, when it is
persistable, fetched, read outside the run (`__backward__`'s `params`
count as reads), or also written outside the run.  Everything else stays
internal to the sub-program.  Runs never cross `__backward__`, which is
not fusable.

Parity with the unfused program holds by construction: sub-ops replay
through their own impls in original order; RNG streams are pinned by
the pipeline's `rng_stream` stamping; per-output `stop_gradient` and the
per-op AMP policy are recorded and replayed inside the fused impl.
"""
import numpy as np

__all__ = ['run', 'FUSABLE_OPS', 'FUSED_OP', 'KERNEL_TIER_OPS']

FUSED_OP = 'fused_elementwise'

# reduction/attention ops the kernelgen tier lowers through DEDICATED
# generated kernels (row reductions, flash attention — KERNEL_RULES
# kinds 'row'/'attention').  They fuse like any elementwise op, and
# unlike pure glue they justify a fused group even as a SINGLETON run:
# a lone softmax between two matmuls must still reach the kernel tier.
KERNEL_TIER_OPS = {'softmax', 'layer_norm', 'flash_attention'}

# unary/binary elementwise math + zero-flop glue + per-param optimizer
# updates (elementwise over the param): anything whose kernel is pure,
# rng-stable (via rng_stream), and — KERNEL_TIER_OPS excepted — free of
# cross-element reductions
FUSABLE_OPS = {
    # elementwise binary
    'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'elementwise_pow', 'elementwise_max',
    'elementwise_min', 'elementwise_mod', 'elementwise_floordiv',
    # elementwise unary / activations
    'scale', 'cast', 'clip', 'relu', 'relu6', 'sigmoid', 'tanh', 'exp',
    'log', 'sqrt', 'rsqrt', 'abs', 'square', 'sign', 'floor', 'ceil',
    'round', 'reciprocal', 'pow', 'leaky_relu', 'elu', 'selu',
    'softplus', 'softsign', 'brelu', 'hard_sigmoid', 'swish', 'stanh',
    'logsigmoid', 'soft_relu', 'hard_shrink', 'softshrink',
    'tanh_shrink', 'thresholded_relu', 'erf', 'sin', 'cos', 'increment',
    'label_smooth',
    # comparisons / logicals (elementwise)
    'equal', 'not_equal', 'less_than', 'less_equal', 'greater_than',
    'greater_equal', 'logical_and', 'logical_or', 'logical_not',
    'logical_xor',
    # constants / identities / layout glue (zero-flop)
    'fill_constant', 'fill_zeros_like', 'fill_constant_batch_size_like',
    'assign', 'reshape', 'transpose', 'unsqueeze', 'squeeze', 'flatten',
    # rng glue (streams pinned via rng_stream)
    'dropout', 'uniform_random', 'gaussian_random',
    'truncated_gaussian_random',
    # per-param optimizer updates
    'sgd', 'momentum', 'adam', 'adamax', 'adagrad', 'decayed_adagrad',
    'adadelta', 'rmsprop', 'ftrl',
} | KERNEL_TIER_OPS

# never nest: keeps the pipeline idempotent and the impl non-recursive
assert FUSED_OP not in FUSABLE_OPS


def _plain_attrs(attrs):
    """JSON-safe copy of sub-op attrs (io.py only normalizes np scalars
    at the TOP attr level, not inside nested sub_ops).  Returns None when
    an attr can't be made plain — the op then simply doesn't fuse."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.integer):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        elif isinstance(v, np.bool_):
            v = bool(v)
        elif isinstance(v, tuple):
            v = list(v)
        if not isinstance(v, (str, int, float, bool, list, type(None))):
            return None
        if isinstance(v, list) and not all(
                isinstance(e, (str, int, float, bool)) for e in v):
            return None
        out[k] = v
    return out


def _fusable(op, block, ctx):
    if op.type not in FUSABLE_OPS or op.attrs.get('sub_block') is not None:
        return None
    # control-flow-pinned producers stay visible: the loop lowerer
    # pattern-matches them by op type (see walker.control_flow_pinned)
    if any(n in ctx.cf_pinned for n in op.output_names()):
        return None
    attrs = _plain_attrs(op.attrs)
    if attrs is None:
        return None
    stop_grad = []
    for n in op.output_names():
        v = block._find_var_recursive(n)
        if v is not None and v.stop_gradient:
            stop_grad.append(n)
    return {'type': op.type,
            'inputs': {s: list(ns) for s, ns in op.inputs.items()},
            'outputs': {s: list(ns) for s, ns in op.outputs.items()},
            'input_is_list': dict(op.input_is_list),
            'output_is_list': dict(op.output_is_list),
            'attrs': attrs,
            'stop_grad': stop_grad}


def _fuse_run(block, start, run, readers_outside, ctx):
    """Replace block.ops[start:start+len(run)] with one fused op.
    `run` is [(op, sub_desc)]."""
    from ..framework import Operator
    produced = set()
    ext_in, arg_names = [], set()
    for op, _ in run:
        for n in op.input_names():
            if n not in produced and n not in arg_names:
                arg_names.add(n)
                ext_in.append(n)
        produced.update(op.output_names())
    out_names = []
    for op, _ in run:
        for n in op.output_names():
            if n in out_names:
                continue
            if (n in ctx.persistable or n in ctx.fetch_names or
                    n in readers_outside or n in ctx.multi_written):
                out_names.append(n)
    if not out_names:
        # a run computing nothing observable is DCE's business, not ours
        return None
    first_op = run[0][0]
    fused = Operator(
        block, FUSED_OP,
        inputs={'X': list(ext_in)},
        outputs={'Out': list(out_names)},
        attrs={'sub_ops': [d for _, d in run],
               'arg_names': list(ext_in),
               'out_names': list(out_names),
               'fused_count': len(run),
               # sub-ops draw from their own pinned streams; the op-level
               # stream is inherited so re-stamping on a second pipeline
               # application is a no-op (idempotence)
               'rng_stream': first_op.attrs.get('rng_stream', start),
               'op_role': first_op.attrs.get('op_role', 'forward')})
    rid = first_op.attrs.get('recompute_id')
    if rid is not None:
        fused.attrs['recompute_id'] = rid
    fused.source_loc = first_op.source_loc
    block.ops[start:start + len(run)] = [fused]
    for n in out_names:
        v = block._find_var_recursive(n)
        if v is not None:
            v.op = fused
    return fused


def run(program, ctx):
    stats = {'ops_fused': 0, 'chains': 0, 'max_chain': 0}
    for block in program.blocks:
        # readers by name, positions within THIS block; plus names read
        # from other blocks / sub-block envs / __backward__ params
        pos_readers = {}
        for i, op in enumerate(block.ops):
            for n in set(op.input_names()) | set(
                    op.attrs.get('params', ())):
                pos_readers.setdefault(n, []).append(i)
        # reads from OTHER blocks (control-flow bodies read parent names
        # straight from the env, parents read body results after the
        # loop); a block's own reads are position-tracked in pos_readers
        foreign_reads = set()
        for b in program.blocks:
            if b.idx == block.idx:
                continue
            for op in b.ops:
                foreign_reads |= set(op.input_names())
                foreign_reads |= set(op.attrs.get('params', ()))
        if block.idx != 0:
            # control-flow bodies: writes to outer-visible names are loop
            # carries read by name from the lowering env — always escape
            b = block.parent
            while b is not None:
                foreign_reads |= set(b.vars)
                b = b.parent
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            desc = _fusable(op, block, ctx)
            if desc is None:
                i += 1
                continue
            rid = op.attrs.get('recompute_id')
            run_ops = [(op, desc)]
            j = i + 1
            while j < len(block.ops):
                nxt = block.ops[j]
                if nxt.attrs.get('recompute_id') != rid:
                    break
                ndesc = _fusable(nxt, block, ctx)
                if ndesc is None:
                    break
                run_ops.append((nxt, ndesc))
                j += 1
            if len(run_ops) < 2 and not any(
                    o.type in KERNEL_TIER_OPS for o, _ in run_ops):
                i = j
                continue
            lo, hi = i, j  # [lo, hi) is the run
            readers_outside = set()
            for op_k, _ in run_ops:
                for n in op_k.output_names():
                    if any(p < lo or p >= hi
                           for p in pos_readers.get(n, ())):
                        readers_outside.add(n)
                    if n in foreign_reads:
                        readers_outside.add(n)
            fused = _fuse_run(block, lo, run_ops, readers_outside, ctx)
            if fused is None:
                i = j
                continue
            stats['ops_fused'] += len(run_ops)
            stats['chains'] += 1
            stats['max_chain'] = max(stats['max_chain'], len(run_ops))
            program._bump()
            # positions shifted: rebuild the reader index
            pos_readers = {}
            for k, op_k in enumerate(block.ops):
                for n in set(op_k.input_names()) | set(
                        op_k.attrs.get('params', ())):
                    pos_readers.setdefault(n, []).append(k)
            i = lo + 1
    return stats
