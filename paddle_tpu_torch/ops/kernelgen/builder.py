"""Plan a fused_elementwise sub-program, and generate CUDA C++ for it.

Counterpart of paddle_tpu/ops/kernelgen/builder.py.  The plan is built
once per canonical sub-program signature (alpha-renamed sub-ops, input
shapes and dtypes, AMP), so every layer's identical fused group shares
one plan and one generated function.  Shapes and dtypes of every value
come from an abstract replay of the plain sub-ops on `meta` tensors
(ops/fused.py `run_sub_op`, AMP policy included), not from a
transcription.  The sub-ops partition into steps:

``draw``
    A random draw outside any kernel, by the op's own plain draw on its
    pinned stream: dropout masks, `uniform_random`, `gaussian_random`.
``glue``
    A view (reshape) of a materialized value, or an order-changing
    transpose, done as `permute(...).contiguous()`.
``dstep``
    A dedicated kernel between segments: the registered op, with the
    AMP casts the unfused op would get (softmax -> K5, layer_norm -> K6,
    flash_attention -> K1, each with its own autograd).
``adam``
    Consecutive `adam` sub-ops with the same betas and epsilon: one
    `adam_multi` launch (csrc/adam.cu), in place.
``momentum``
    Consecutive `momentum` sub-ops with the same mu and use_nesterov: one
    `momentum_multi` launch (csrc/momentum.cu), in place.
``sgd``, ``adagrad``, ``decayed_adagrad``, ``adamax``, ``adadelta``, ``rmsprop``, ``ftrl``
    Consecutive sub-ops of one of these types sharing every attribute the
    update reads (ops/optimizer_ops.py `optim_key`: rmsprop's `centered`,
    ftrl's l1, l2 and lr_power, ...): one `optim_multi` launch
    (csrc/optim_multi.cu, the type's instance), in place.  An adamax run
    holds across the `scale` sub-ops AdamaxOptimizer appends after each
    adamax op to bump its Beta1Pow: the plan moves those bumps after the
    run (`_hoist_adamax_bumps`; each adamax op reads its own power before
    its bump, and nothing else reads it), where they form a kernel step.
``kernel``
    A maximal run of `ew` and rng-body sub-ops: ONE generated
    `__global__` function (`_emit_segment`).

A generated kernel, for Hopper (`Layout`, `_emit_segment`):

* values are grouped by flat element count N_g; each group's tile count
  T_g = ceil(N_g / tile_g) and first block are baked into the source, and
  the grid is their sum: block b runs one tile of the one group whose
  blocks hold b (an unrolled comparison chain), so no block runs two
  groups and only that group's pointers are live in it (a loop over
  every group kept ~300 pointers of a global-norm clip live and
  spilled them);
* a thread runs V consecutive elements of its tile: 16 bytes of the
  group's widest operand (4 float32 or int32, 8 bf16, 16 bool), its
  narrower operands in 4- or 8-byte accesses, every access
  warp-contiguous, where the group's pointers are 16-byte aligned (a
  bit of the launch's mask, which a CUDA graph fixes at its capture)
  and the whole vector lies in the group; element by element otherwise
  (a second copy of the group's body), so only the group that does not
  divide runs a scalar remainder, in its last tile;
* 256 threads a block where the largest group fills 256 threads of
  every SM, else 128; a segment that moves 40-256 MiB (STREAM_BYTES)
  reads and writes with the streaming hints (`__ldcs` / `__stcs`);
* size-1 values are computed first by every thread and stored by block
  0's thread 0, so a scalar chain (the noam learning rate, a clip's
  global norm) costs nothing to broadcast;
* a broadcast operand (the (2048,) FFN bias, the [B, 1, 1, T] padding
  mask against [B, H, T, T] scores) is read at an index computed from
  the output's multi-index, with shapes and strides baked into the
  source as constants; the reference had to materialize the non-suffix
  case as glue (`_flat_compatible`);
* intermediates live in registers; only values read after the segment,
  or returned, are stored; an op loads its flat operands where it first
  reads them and stores what escapes right after it, so a thread holds
  about one op's registers at a time (a global-norm clip is one op per
  parameter: 147 in llama_1b's segment);
* each sub-op's result is rounded to the dtype its plain version
  produces before the next sub-op reads it (rules.py), so a generated
  kernel computes what the unfused ops compute.

All functions of the plans a program needs build together: a few .cu
files compiled by parallel nvcc calls, linked into one library
(kernels/build.py `build_generated`).

Autograd: each kernel step is a `torch.autograd.Function` whose backward
replays that segment's sub-ops with their plain torch impls under
`enable_grad` (the drawn masks are saved inputs, as the reference keeps
its keys as residuals) and returns their gradients.  dsteps keep their
own autograd (K5, K6 and K1's Functions), so softmax, LayerNorm and
attention are not recomputed.  Per-output stop_gradient applies as on
the replay path.
"""
import hashlib
import re

import torch

from ...core.amp import amp_match_ins, amp_sub_ins
from ...core.dtypes import dtype_str, torch_dtype
from ...core.registry import InferCtx, get_op
from ..optimizer_ops import OPTIM_SLOTS, optim_key

__all__ = ['KernelgenUnsupported', 'plan_for', 'clear_plans', 'avals_of']


class KernelgenUnsupported(Exception):
    """A sub-op (or shape pattern) the rule table can't lower; carries
    the sub-op's name."""

    def __init__(self, sub_op, why):
        self.sub_op = sub_op
        self.why = why
        super(KernelgenUnsupported, self).__init__(
            "sub-op '%s': %s" % (sub_op, why))


# kernel parameters are at most 4 KB: a segment passes at most this many
# pointers (its inputs and outputs); a longer run starts a new segment
MAX_PTRS = 480
# bool lives in `bool` registers and one byte of memory, as torch stores it
KERNEL_DTYPES = ('float32', 'bfloat16', 'int32', 'bool')
_C_MEM = {'float32': 'float', 'bfloat16': '__nv_bfloat16', 'int32': 'int',
          'bool': 'bool'}
_C_VAL = {'float32': 'float', 'bfloat16': 'float', 'int32': 'int',
          'bool': 'bool'}
_SKIP_ATTRS = ('op_role', 'rng_stream', 'recompute_id')


def avals_of(xs):
    return tuple((tuple(int(d) for d in x.shape), dtype_str(x.dtype))
                 for x in xs)


def _size(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _canon_attrs(attrs):
    """Sub-program signature with var names alpha-renamed to positional
    ids, so every layer's structurally identical group shares a plan."""
    names = {}

    def nid(n):
        if n not in names:
            names[n] = 'v%d' % len(names)
        return names[n]

    for n in attrs['arg_names']:
        nid(n)
    sub = []
    for so in attrs['sub_ops']:
        sub.append((
            so['type'],
            tuple(sorted((s, tuple(nid(n) for n in ns))
                         for s, ns in so['inputs'].items())),
            tuple(sorted((s, tuple(nid(n) for n in ns))
                         for s, ns in so['outputs'].items())),
            tuple(sorted((k, repr(v)) for k, v in so['attrs'].items()
                         if k not in _SKIP_ATTRS)),
            tuple(sorted(so.get('stop_grad') or ())),
        ))
    return ('fused', tuple(sub), tuple(nid(n) for n in attrs['out_names']))


def _bcast_y_shape(xs, ys, axis):
    """ops/math.py _bcast_y, on shapes only."""
    xs, ys = tuple(xs), tuple(ys)
    if xs == ys or len(ys) == 0:
        return ys
    ax = axis if axis >= 0 else len(xs) - len(ys)
    yshape = list(ys)
    while len(yshape) > 1 and yshape[-1] == 1 and ax + len(yshape) > len(xs):
        yshape = yshape[:-1]
    return tuple([1] * ax + yshape + [1] * (len(xs) - ax - len(yshape)))


def _index_expr(eff, out):
    """C++ index into a contiguous operand of shape `eff` broadcast to
    `out`, from the flat output index `i`; None when `eff` does not
    broadcast to `out`."""
    r = len(out)
    if len(eff) > r:
        return None
    eff = [1] * (r - len(eff)) + [int(d) for d in eff]
    dims = []                      # merged [size, kept] runs of out dims
    for e, o in zip(eff, out):
        if o == 1:
            continue
        if e != o and e != 1:
            return None
        kept = e == o
        if dims and dims[-1][1] == kept:
            dims[-1][0] *= o
        else:
            dims.append([o, kept])
    terms, inner_out, inner_eff = [], 1, 1
    for k in range(len(dims) - 1, -1, -1):
        size, kept = dims[k]
        if kept:
            c = 'i' if inner_out == 1 else '(i / %dLL)' % inner_out
            if k > 0:
                c = '(%s %% %dLL)' % (c, size)
            terms.append(c if inner_eff == 1 else
                         '%s * %dLL' % (c, inner_eff))
            inner_eff *= size
        inner_out *= size
    return ' + '.join(reversed(terms)) if terms else '0'


def _abstract_replay(sub_ops, arg_names, in_avals, amp):
    """Per sub-op: (post-AMP input dtypes by slot, {name: (shape, dtype)}
    of every value it writes), from the plain sub-ops on meta tensors."""
    from ..fused import run_sub_op
    env = {n: torch.empty(s, dtype=torch_dtype(d), device='meta')
           for n, (s, d) in zip(arg_names, in_avals)}
    ctx = InferCtx(amp=amp)
    recs = []
    for sub in sub_ops:
        ins = {}
        for slot, names in sub['inputs'].items():
            vals = [env[n] for n in names]
            ins[slot] = vals if sub['input_is_list'].get(slot) else vals[0]
        post = amp_sub_ins(sub['type'], ins, amp)
        in_dts = {slot: [dtype_str(t.dtype) for t in
                         (v if isinstance(v, list) else [v])]
                  for slot, v in post.items()}
        onames = [n for ns in sub['outputs'].values() for n in ns]
        before = {n: env.get(n) for n in onames}
        run_sub_op(ctx, sub, env, amp)
        recs.append((in_dts, {n: (tuple(int(d) for d in env[n].shape),
                                  dtype_str(env[n].dtype))
                              for n in onames
                              if env.get(n) is not before[n]}))
    return recs


class _Seg(object):
    """One kernel segment under construction."""

    def __init__(self):
        self.ops = []          # (sub, rule, in_ops, out_keys, g,
                               #  shapes of shape-only slots)
        self.entries = []      # (mid, kind, dtype, index expr or None)
        self.entry_shape = []  # logical shape of each entry
        self.entry_ix = {}
        self.keys = {}         # value key -> root key (layout aliases)
        self.key_aval = {}     # value key -> (shape, dtype)
        self.groups = set()    # flat sizes > 1 of the ops

    def entry(self, mid, kind, dt, idx, shape):
        ek = (mid, kind, idx)
        ix = self.entry_ix.get(ek)
        if ix is None:
            ix = len(self.entries)
            self.entry_ix[ek] = ix
            self.entries.append((mid, kind, dt, idx))
            self.entry_shape.append(tuple(shape))
        return ix

    def n_ptrs(self):
        return len(self.entries) + sum(len(o[3]) for o in self.ops)


class Plan(object):
    """The steps of one fused signature.  Steps name sub-ops by position:
    the groups that share a plan differ in their sub-ops' pinned random
    streams, which a run reads from its own group's attrs."""

    def __init__(self):
        self.steps = []
        self.finals = []
        self.final_stop = []
        self.n_kernels = self.n_dsteps = self.n_draws = 0
        self.n_glue = self.n_adam = self.n_momentum = 0
        self.n_optim = {}      # optim_multi steps by op type
        self.kernels = []      # the generated functions' names, in order

    def counts(self):
        """Steps by kind; the optim_multi types only where the plan has
        one."""
        c = {'kernels': self.n_kernels, 'dsteps': self.n_dsteps,
             'draws': self.n_draws, 'glue': self.n_glue,
             'adam': self.n_adam, 'momentum': self.n_momentum}
        c.update(self.n_optim)
        return c


_PLANS = {}
# name -> source of every generated function planned in this process
SOURCES = {}


def clear_plans():
    _PLANS.clear()


def plan_for(attrs, in_avals, amp):
    """Build-or-fetch the plan for one canonical fused signature."""
    key = (_canon_attrs(attrs), tuple(in_avals), bool(amp))
    plan = _PLANS.get(key)
    if plan is None:
        plan = _build_plan(attrs, tuple(in_avals), bool(amp))
        _PLANS[key] = plan
    return plan


def _check_dtype(stype, dt):
    if dt not in KERNEL_DTYPES:
        raise KernelgenUnsupported(stype, 'dtype %s in a generated kernel'
                                   % dt)


def _hoist_adamax_bumps(sub_ops):
    """The order the plan takes the sub-ops in: positions, with each run
    of adamax sub-ops sharing their key put before the `scale` sub-ops
    between them that bump their Beta1Pow in place (each scale writes one
    run member's own power, which no other sub-op of the run reads)."""
    order, i, n = [], 0, len(sub_ops)
    while i < n:
        if sub_ops[i]['type'] != 'adamax':
            order.append(i)
            i += 1
            continue
        key = _optim_key(sub_ops[i])
        ups, bumps, pows, j = [], [], set(), i
        while j < n:
            s = sub_ops[j]
            if s['type'] == 'adamax' and _optim_key(s) == key and \
                    s['inputs']['Beta1Pow'][0] not in pows:
                ups.append(j)
                pows.add(s['inputs']['Beta1Pow'][0])
            elif s['type'] == 'scale' and \
                    s['inputs']['X'] == s['outputs']['Out'] and \
                    s['inputs']['X'][0] in pows:
                bumps.append(j)
            else:
                break
            j += 1
        order += ups + bumps
        i = j
    return order


def _build_plan(attrs, in_avals, amp):
    from .rules import KERNEL_RULES
    # positions into attrs['sub_ops']: draw and dstep steps name theirs
    order = _hoist_adamax_bumps(attrs['sub_ops'])
    sub_ops = [attrs['sub_ops'][o] for o in order]
    arg_names = list(attrs['arg_names'])
    out_names = list(attrs['out_names'])
    for sub in sub_ops:
        if sub['type'] not in KERNEL_RULES:
            raise KernelgenUnsupported(sub['type'], 'no KERNEL_RULES entry')
    recs = _abstract_replay(sub_ops, arg_names, in_avals, amp)

    # ---- usage pre-pass: value versions and their last readers
    cur = {n: 0 for n in arg_names}
    lastuse = {}
    for i, sub in enumerate(sub_ops):
        for names in sub['inputs'].values():
            for n in names:
                lastuse[(n, cur.get(n, 0))] = i
        for n in recs[i][1]:
            cur[n] = cur.get(n, 0) + 1
    final_keys = {(n, cur.get(n, 0)) for n in out_names}

    cur = {n: 0 for n in arg_names}
    loc = {}                   # key -> ('mat', mid) | ('sym', seg)
    aval = {}                  # key -> (shape, dtype)
    for i, n in enumerate(arg_names):
        loc[(n, 0)] = ('mat', i)
        aval[(n, 0)] = (tuple(in_avals[i][0]), in_avals[i][1])
    mid_next = [len(arg_names)]
    plan = Plan()
    seg = [None]

    def new_mid():
        mid_next[0] += 1
        return mid_next[0] - 1

    def key_of(n):
        return (n, cur.get(n, 0))

    def bind(n, shape, dt):
        k = (n, cur.get(n, 0) + 1)
        cur[n] = k[1]
        aval[k] = (tuple(shape), dt)
        return k

    def flush(upto):
        s = seg[0]
        seg[0] = None
        if s is None or not s.ops:
            return
        esc = [k for k in s.keys
               if lastuse.get(k, -1) >= upto or k in final_keys]
        if not esc:
            return             # fully dead segment: drop it
        out_mids = []
        for k in esc:
            mid = new_mid()
            loc[k] = ('mat', mid)
            out_mids.append(mid)
        spec = _KernelSpec(s, esc, out_mids, amp)
        plan.steps.append(('kernel', spec))
        plan.kernels.append(spec.name)
        plan.n_kernels += 1

    def as_mat(k, stype):
        where = loc[k]
        if where[0] != 'mat':
            raise KernelgenUnsupported(stype, 'internal: %r not '
                                       'materialized' % (k,))
        return where[1]

    i = 0
    while i < len(sub_ops):
        sub = sub_ops[i]
        stype = sub['type']
        rule = KERNEL_RULES[stype]
        in_dts, written = recs[i]

        # ------------------------------------------------ optimizer
        if rule.kind == 'optimizer':
            out_slots, group_key = _OPTIMIZERS[stype]
            j = i
            gkey = group_key(sub)
            while j < len(sub_ops) and sub_ops[j]['type'] == stype and \
                    group_key(sub_ops[j]) == gkey:
                j += 1
            group = sub_ops[i:j]
            if any(loc[key_of(n)][0] == 'sym' for s in group
                   for ns in s['inputs'].values() for n in ns):
                flush(i)
            ins = [{slot: as_mat(key_of(names[0]), stype)
                    for slot, names in s['inputs'].items()} for s in group]
            outs = []
            for gi, s in enumerate(group):
                ob = {}
                for slot, names in s['outputs'].items():
                    n = names[0]
                    shape, dt = recs[i + gi][1][n]
                    k = bind(n, shape, dt)
                    mid = new_mid()
                    loc[k] = ('mat', mid)
                    ob[slot] = mid
                outs.append(ob)
            in_place = [all(s['outputs'].get(o) == s['inputs'].get(n)
                            for o, n in out_slots.items()
                            if n in s['inputs']) for s in group]
            plan.steps.append((stype, gkey, ins, outs, in_place))
            if stype == 'adam':
                plan.n_adam += 1
            elif stype == 'momentum':
                plan.n_momentum += 1
            else:
                plan.n_optim[stype] = plan.n_optim.get(stype, 0) + 1
            i = j
            continue

        # ------------------------------------------------ layout glue
        if rule.kind == 'layout':
            ik = key_of(sub['inputs']['X'][0])
            out_name = sub['outputs']['Out'][0]
            i += 1
            if out_name not in written:
                continue
            o_shape, o_dt = written[out_name]
            identity = True
            perm = None
            if stype == 'transpose':
                perm = [int(a) for a in sub['attrs']['axis']]
                dims = aval[ik][0]
                nz = [p for p in perm if dims[p] != 1]
                identity = nz == sorted(nz)
            ok = bind(out_name, o_shape, o_dt)
            if identity and loc[ik][0] == 'sym':
                s = loc[ik][1]
                s.keys[ok] = s.keys[ik]        # flat alias, zero cost
                s.key_aval[ok] = (o_shape, o_dt)
                loc[ok] = ('sym', s)
                continue
            if loc[ik][0] == 'sym':
                flush(i - 1)
            mid = new_mid()
            plan.steps.append(('glue', mid, as_mat(ik, stype),
                               None if identity else tuple(perm), o_shape))
            plan.n_glue += 1
            loc[ok] = ('mat', mid)
            continue

        # ------------------------------- whole-op draws (no kernel body)
        if rule.kind == 'rng' and rule.emit is None:
            out_name = sub['outputs']['Out'][0]
            shape, dt = written[out_name]
            mid = new_mid()
            plan.steps.append(('draw', mid, order[i], None))
            plan.n_draws += 1
            k = bind(out_name, shape, dt)
            loc[k] = ('mat', mid)
            i += 1
            continue

        # ------------------ dedicated kernels between segments (dsteps)
        if rule.kind in ('row', 'attention'):
            if any(loc[key_of(n)][0] == 'sym'
                   for ns in sub['inputs'].values() for n in ns):
                flush(i)
            in_mids = {slot: [as_mat(key_of(n), stype) for n in names]
                       for slot, names in sub['inputs'].items()}
            out_bind = {}
            for slot, names in sub['outputs'].items():
                binds = []
                for n in names:
                    if n not in written:
                        binds.append(None)
                        continue
                    k = bind(n, *written[n])
                    mid = new_mid()
                    loc[k] = ('mat', mid)
                    binds.append(mid)
                out_bind[slot] = binds
            plan.steps.append(('dstep', order[i], in_mids, out_bind))
            plan.n_dsteps += 1
            i += 1
            continue

        # --------------------------------------- in-kernel compute op
        if not written:
            i += 1
            continue
        sizes = {n: _size(v[0]) for n, v in written.items()}
        g = max(sizes.values())
        if g == 0:
            raise KernelgenUnsupported(stype, 'zero-size tensor')
        O = next(v[0] for n, v in written.items() if sizes[n] == g)
        for n, sz in sizes.items():
            if sz != g:
                raise KernelgenUnsupported(
                    stype, 'output %s size %d vs group size %d'
                    % (n, sz, g))
        for n, (_, dt) in written.items():
            _check_dtype(stype, dt)
        x_shape = None
        if sub['inputs'].get('X'):
            x_shape = aval[key_of(sub['inputs']['X'][0])][0]

        # classify the operands: a register, or a materialized value
        # read at i ('tile'), at 0 ('scalar') or at an index map
        # ('bcast'); a register that would need an index map forces a
        # flush first
        draws = []
        if rule.kind == 'rng' and not sub['attrs'].get('is_test', False):
            draws = ['Mask']
        operands = []          # (slot, key or None, eff shape, dtype)
        for slot, names in sub['inputs'].items():
            if slot in rule.shape_only:
                continue
            for pos, n in enumerate(names):
                k = key_of(n)
                s_in, _ = aval[k]
                eff = s_in
                if rule.bcast_y and slot == 'Y' and x_shape is not None:
                    eff = _bcast_y_shape(x_shape, s_in,
                                         sub['attrs'].get('axis', -1))
                operands.append((slot, k, eff, in_dts[slot][pos]))

        def needs_index(k, eff):
            sz = _size(aval[k][0])
            return not (sz == g or sz == 1)

        if any(loc[k][0] == 'sym' and needs_index(k, eff)
               for _, k, eff, _ in operands):
            flush(i)
        n_new = len(operands) + len(draws) + len(written)
        if seg[0] is not None and seg[0].n_ptrs() + n_new > MAX_PTRS:
            flush(i)
        s = seg[0]
        if s is None:
            s = seg[0] = _Seg()

        in_ops = {}
        for slot, k, eff, dt in operands:
            _check_dtype(stype, dt)
            where = loc[k]
            sz = _size(aval[k][0])
            frm = aval[k][1]
            if where[0] == 'sym' and where[1] is s:
                od = ('sym', s.keys[k], frm)
            else:
                mid = as_mat(k, stype)
                shape = aval[k][0]
                if sz == g and g > 1:
                    od = ('ref', s.entry(mid, 'tile', frm, None, shape), frm)
                elif sz == 1:
                    od = ('ref', s.entry(mid, 'scalar', frm, None, shape),
                          frm)
                else:
                    idx = _index_expr(eff, O)
                    if idx is None:
                        raise KernelgenUnsupported(
                            stype, 'operand %s of shape %s does not '
                            'broadcast to %s' % (slot, tuple(eff), O))
                    od = ('ref', s.entry(mid, 'bcast', frm, idx, shape), frm)
            in_ops.setdefault(slot, []).append((od, dt, aval[k][0]))
        draw_bind = {}
        for slot in draws:
            xs_, xdt = aval[key_of(sub['inputs']['X'][0])]
            mid = new_mid()
            plan.steps.append(('draw', mid, order[i], (xs_, xdt)))
            plan.n_draws += 1
            kind = 'tile' if _size(xs_) > 1 else 'scalar'
            in_ops[slot] = [(('ref', s.entry(mid, kind, xdt, None, xs_),
                              xdt), xdt, xs_)]
            draw_bind[slot] = mid
        if g > 1:
            s.groups.add(g)
        out_keys = {}
        for slot, names in sub['outputs'].items():
            for n in names:
                if n not in written:
                    continue
                k = bind(n, *written[n])
                if slot in draw_bind:
                    loc[k] = ('mat', draw_bind[slot])
                    continue
                s.keys[k] = k
                s.key_aval[k] = written[n]
                loc[k] = ('sym', s)
                out_keys.setdefault(slot, []).append(k)
        shape_only = {slot: aval[key_of(sub['inputs'][slot][0])]
                      for slot in rule.shape_only if sub['inputs'].get(slot)}
        s.ops.append((sub, rule, in_ops, out_keys, g, shape_only))
        i += 1

    flush(len(sub_ops))
    for n in out_names:
        k = (n, cur.get(n, 0))
        plan.finals.append(as_mat(k, '?'))
        plan.final_stop.append(any(n in (so.get('stop_grad') or ())
                                   for so in sub_ops))
    return plan


_ADAM_OUT = {'ParamOut': 'Param', 'Moment1Out': 'Moment1',
             'Moment2Out': 'Moment2', 'Beta1PowOut': 'Beta1Pow',
             'Beta2PowOut': 'Beta2Pow'}


def _adam_key(sub):
    a = sub['attrs']
    return (a.get('beta1', 0.9), a.get('beta2', 0.999),
            a.get('epsilon', 1e-8))


def _momentum_key(sub):
    a = sub['attrs']
    return (a.get('mu', 0.9), bool(a.get('use_nesterov', False)))


def _optim_key(sub):
    return optim_key(sub['type'], sub['attrs'])


# the optimizer rules: op type -> ({output slot: the input slot it
# updates}, the key a run of them shares); a step takes every input slot
# of its sub-ops
_OPTIMIZERS = {
    'adam': (_ADAM_OUT, _adam_key),
    'momentum': ({'ParamOut': 'Param', 'VelocityOut': 'Velocity'},
                 _momentum_key)}
_OPTIMIZERS.update({t: (spec[1], _optim_key)
                    for t, spec in OPTIM_SLOTS.items()})


# ------------------------------------------------------ CUDA emission

class _KernelSpec(object):
    """One generated segment: its source, its pointers, its tile table,
    and how to replay it in plain PyTorch for the backward."""

    def __init__(self, s, esc, out_mids, amp):
        self.entries = list(s.entries)
        self.entry_avals = [(shape, e[2]) for shape, e in
                            zip(s.entry_shape, s.entries)]
        self.out_mids = list(out_mids)
        self.esc_aval = [s.key_aval[k] for k in esc]
        self.groups = sorted(s.groups)
        self.n_max = max(self.groups) if self.groups else 1
        self.amp = amp
        self.ops = s.ops
        self.keys = dict(s.keys)
        self.esc = list(esc)
        body, self.layout = _emit_segment(s, esc)
        self.name = 'kg_' + hashlib.sha256(body.encode()).hexdigest()[:16]
        SOURCES.setdefault(self.name, body.replace('@NAME@', self.name))

    def replay(self, entry_vals):
        """The segment's outputs from its entries, through the sub-ops'
        plain impls (autograd records it)."""
        from ..nn import dropout_apply
        vals = {}

        def get(od, shape):
            src = vals[od[1]] if od[0] == 'sym' else entry_vals[od[1]]
            return src.reshape(shape)

        ctx = _NoRngCtx(entry_vals[0].device if entry_vals else None)
        for sub, rule, in_ops, out_keys, g, shape_only in self.ops:
            ins = {}
            for slot, ods in in_ops.items():
                vs = [get(od, shape) for od, _, shape in ods]
                ins[slot] = vs if sub['input_is_list'].get(slot) else vs[0]
            for slot, (shape, dt) in shape_only.items():
                ins[slot] = torch.empty(shape, dtype=torch_dtype(dt),
                                        device='meta')
            if self.amp:
                ins = amp_match_ins(sub['type'], ins)
            if 'Mask' in ins:
                outs = {'Out': dropout_apply(ins['X'], ins['Mask'],
                                             sub['attrs'])}
            else:
                outs = get_op(sub['type'])(ctx, ins, sub['attrs'])
            stop = set(sub.get('stop_grad') or ())
            for slot, ks in out_keys.items():
                v = outs[slot]
                v = v if isinstance(v, (list, tuple)) else [v]
                for k, t in zip(ks, v):
                    vals[k] = t.detach() if k[0] in stop else t
        return [vals[self.keys[k]].reshape(shape)
                for k, (shape, _) in zip(self.esc, self.esc_aval)]


class _NoRngCtx(object):
    """ctx of a segment's plain replay: its draws were made before."""
    is_infer = False
    amp = False

    def __init__(self, device):
        self.device = device

    def generator(self, seed=0):
        raise RuntimeError('kernelgen bug: a draw inside a kernel segment')

    def wants(self, slot):
        return True


def _c_ptr(dt, const):
    return '%s%s*' % ('const ' if const else '', _C_MEM[dt])


# bytes of an element of each kernel dtype in memory
_SIZE = {'float32': 4, 'bfloat16': 2, 'int32': 4, 'bool': 1}
# The layout assumes an H100 SXM's 132 streaming multiprocessors.
SMS = 132
# A segment that moves more than STREAM_BYTES[0] and at most
# STREAM_BYTES[1] reads and writes with the streaming hints (__ldcs /
# __stcs: each element is touched once, keep L2 for others).  A smaller
# one, which the 50 MB L2 holds, leaves its outputs there for the next
# kernel; on a larger one, of which L2 keeps nothing, the hints cost
# 1.5-2.5% (the single-group bf16 streams of 294 MB and more on an H100).
STREAM_BYTES = (40 << 20, 256 << 20)


class Layout(object):
    """A generated segment's tile table, baked into its source.

    `threads` a block (256 when the largest group has a vector for each
    of 256 threads of every SM, else 128), `streaming` (STREAM_BYTES),
    `grid` blocks, and per group, in the order of the source (largest
    first), a dict: `n` its flat size, `v` its vector width (16 bytes of
    its widest operand: 4 float32 or int32, 8 bf16, 16 bool), `tile` =
    threads v elements, `tiles`, `start` its first block, and `ptrs`: the
    pointers (the kernel's argument indices) its vector path needs
    16-byte aligned.  Block b runs tile b - start of the one group with
    start <= b < start + tiles.  `groups`: (flat size, widest element
    bytes, pointers) a group."""

    def __init__(self, groups, nbytes):
        vs = [16 // hi for _, hi, _ in groups]
        vecs = [-(-g[0] // v) for g, v in zip(groups, vs)]
        self.threads = 256 if vecs and max(vecs) >= 256 * SMS else 128
        self.streaming = STREAM_BYTES[0] < nbytes <= STREAM_BYTES[1]
        self.groups = []
        start = 0
        for (n, _, ptrs), v in zip(groups, vs):
            tile = self.threads * v
            tiles = -(-n // tile)
            self.groups.append(dict(n=n, v=v, tile=tile, tiles=tiles,
                                    start=start, ptrs=sorted(ptrs)))
            start += tiles
        self.grid = max(start, 1)


def _emit_segment(s, esc):
    """CUDA C++ of one segment, its name left as @NAME@ -> (source,
    Layout)."""
    from .rules import Unsupported, to_dtype
    n_in = len(s.entries)
    ptrs = [(e[2], True) for e in s.entries] + \
        [(s.key_aval[k][1], False) for k in esc]
    reg = {}                   # root key -> register array name
    esc_of = {}                # root key -> positions in esc
    for j, k in enumerate(esc):
        esc_of.setdefault(s.keys[k], []).append(j)

    def reg_of(k):
        if k not in reg:
            reg[k] = 'R%d' % len(reg)
        return reg[k]

    # Size-1 ops come first: every block computes them, block 0's thread 0
    # stores them.  Then each group (its ops read values of its own size
    # or of size 1: _build_plan flushes before any other read) is one
    # branch, run by its own tiles only: a block runs one tile of one
    # group, so only that group's pointers are live in it.  A thread of
    # a tile runs one vector of V elements; each op loads its flat
    # operands where it first reads them and stores what escapes right
    # after it, so a thread holds about one op's registers at a time.
    # The group's body is written twice: for a whole vector on aligned
    # pointers (F: one access an operand, no bounds), and element by
    # element for a vector past the group's end (its last tile) or a
    # group whose pointers are not all 16-byte aligned (the launch's
    # `vec` bit).
    pre, by_g, decl, loaded = [], {}, {}, set()
    g_ptrs = {}                # group size -> its flat pointers
    for ix, e in enumerate(s.entries):
        if e[1] == 'tile':
            g_ptrs.setdefault(_size(s.entry_shape[ix]), set()).add(ix)
    for j, k in enumerate(esc):
        n = _size(s.key_aval[k][0])
        if n > 1:
            g_ptrs.setdefault(n, set()).add(n_in + j)

    def ptr(k, g):
        # declared once in its group's scope (or the size-1 part):
        # outputs are new tensors (kernelgen._launch), so no pointer
        # aliases one that is written
        dst, ind = (decl.setdefault(g, {}), '    ') if g > 1 else \
            (decl.setdefault(1, {}), '  ')
        if k not in dst:
            c = _c_ptr(*ptrs[k])
            dst[k] = '%s%s __restrict__ P%d = (%s)a.p[%d];' % (ind, c, k, c,
                                                                k)
            if g == 1:
                pre.append(dst[k])
        return 'P%d' % k

    for ix, (mid, kind, dt, idx) in enumerate(s.entries):
        if kind == 'scalar':
            pre.append('  const %s S%d = kg_ld(%s, 0);'
                       % (_C_VAL[dt], ix, ptr(ix, 1)))
    for sub, rule, in_ops, out_keys, g, _ in s.ops:
        flat = g > 1
        dst = by_g.setdefault(g, []) if flat else pre
        ind = '      ' if flat else '  '
        at = '[j]' if flat else '[0]'
        ins = {}
        for slot, ods in in_ops.items():
            exprs = []
            for od, dt, _ in ods:
                if od[0] == 'sym':
                    one = _size(s.key_aval[od[1]][0]) == 1
                    e = reg_of(od[1]) + ('[0]' if one else at)
                    frm = od[2]
                else:
                    ix = od[1]
                    _, kind, frm, idx = s.entries[ix]
                    if kind == 'tile':
                        e = 'E%d[j]' % ix
                        if ix not in loaded:
                            loaded.add(ix)
                            dst += ['%s%s E%d[V];' % (ind, _C_VAL[frm], ix),
                                    '%skg_ldv<V, CS, F>(E%d, %s, b0, nv);'
                                    % (ind, ix, ptr(ix, g))]
                    elif kind == 'scalar':
                        e = 'S%d' % ix
                    elif flat:
                        # a vector past the group's end reads nothing;
                        # the index in 32 bits where the group fits (a
                        # 64-bit division by a constant costs several
                        # times a 32-bit one)
                        if g < 2 ** 31:
                            idx = re.sub(r'\bi\b', 'i32',
                                         idx.replace('LL', 'u'))
                        e = 'kg_ldb<F>(%s, %s, j < nv)' % (ptr(ix, g), idx)
                    else:
                        e = 'kg_ld(%s, %s)' % (ptr(ix, g), idx)
                if frm != dt:
                    # the AMP match policy casts this operand first
                    e = to_dtype(e, frm, dt)
                exprs.append((e, dt))
            ins[slot] = exprs
        outs = {slot: [s.key_aval[k][1] for k in ks]
                for slot, ks in out_keys.items()}
        shapes = {slot: [shape for _, _, shape in ods]
                  for slot, ods in in_ops.items()}
        try:
            res = rule.emit(ins, sub['attrs'], outs, shapes)
        except Unsupported as e:
            raise KernelgenUnsupported(sub['type'], str(e))
        stmts = []
        for slot, ks in out_keys.items():
            for k, e in zip(ks, res[slot]):
                dst.append('%s%s %s%s;' % (ind, _C_VAL[s.key_aval[k][1]],
                                           reg_of(k),
                                           '[V]' if flat else '[1]'))
                stmts.append('%s%s = %s;' % (reg_of(k), at, e))
        uses_i = re.search(r'\bi\b', ' '.join(stmts))
        if flat:
            dst += ['#pragma unroll', '%sfor (int j = 0; j < V; ++j) {' % ind]
            if uses_i:
                # the flat index a broadcast operand's index expression
                # reads
                dst.append('%s  const long long i = b0 + j;' % ind)
            if re.search(r'\bi32\b', ' '.join(stmts)):
                dst.append('%s  const unsigned i32 = (unsigned)(b0 + j);'
                           % ind)
            dst += ['%s  %s  // %s' % (ind, ' '.join(stmts), sub['type']),
                    '%s}' % ind]
        else:
            if uses_i:
                dst.append('  { const long long i = 0;')
            dst.append('  %s  // %s' % (' '.join(stmts), sub['type']))
            if uses_i:
                dst.append('  }')
        for ks in out_keys.values():
            for k in ks:
                for j in esc_of.get(k, ()):
                    p = ptr(n_in + j, g)
                    if flat:
                        dst.append('%skg_stv<V, CS, F>(%s, b0, %s, nv);'
                                   % (ind, p, reg_of(k)))
                    else:
                        dst.append('  if (blockIdx.x == 0 && threadIdx.x == '
                                   '0) kg_st(%s, 0, %s[0]);' % (p, reg_of(k)))

    order = sorted(by_g, reverse=True)
    spec = []
    for g in order:
        dts = [ptrs[ix][0] for ix in g_ptrs.get(g, ())] or ['float32']
        spec.append((g, max(_SIZE[d] for d in dts), g_ptrs.get(g, ())))
    nbytes = sum(_size(shape) * _SIZE[e[2]] for shape, e in
                 zip(s.entry_shape, s.entries)) + \
        sum(_size(s.key_aval[k][0]) * _SIZE[s.key_aval[k][1]] for k in esc)
    lay = Layout(spec, nbytes)
    n_words = max(1, (len(order) + 63) // 64)
    lines = ['struct @NAME@_args { void* p[%d]; unsigned long long vec[%d]; };'
             % (max(len(ptrs), 1), n_words),
             '__global__ void __launch_bounds__(%d)' % lay.threads,
             '@NAME@(@NAME@_args a) {',
             '  constexpr bool CS = %s;  // streaming loads and stores'
             % ('true' if lay.streaming else 'false'),
             '  (void)CS;',
             '  const unsigned b = blockIdx.x;',
             '  (void)b;']
    lines += pre
    for gi, (g, lg) in enumerate(zip(order, lay.groups)):
        lines += [
            '  %sif (b < %du) {  // group %d: N %d, V %d, %d tiles from %d'
            % ('} else ' if gi else '', lg['start'] + lg['tiles'], gi, g,
               lg['v'], lg['tiles'], lg['start']),
            '    constexpr int V = %d;' % lg['v'],
            '    const long long b0 = (long long)(b - %du) * %dLL + '
            '(long long)threadIdx.x * V;' % (lg['start'], lg['tile'])]
        lines += [decl[g][k] for k in sorted(decl.get(g, ()))]
        lines += [
            '    if (((a.vec[%d] >> %d) & 1ULL) && b0 + V <= %dLL) {'
            % (gi >> 6, gi & 63, g),
            '      constexpr bool F = true;  // a whole aligned vector',
            '      constexpr int nv = V;']
        lines += by_g[g]
        lines += [
            '    } else {',
            '      constexpr bool F = false;  // element by element',
            '      const long long r = %dLL - b0;' % g,
            '      const int nv = r <= 0 ? 0 : (r >= V ? V : (int)r);']
        lines += by_g[g]
        lines += ['    }']
    if order:
        lines.append('  }')
    lines += ['}', '',
              'extern "C" int @NAME@_launch(void* const* ptrs, '
              'const unsigned long long* vec, void* stream) {',
              '  @NAME@_args a;',
              '  for (int k = 0; k < %d; ++k) a.p[k] = ptrs[k];' % len(ptrs),
              '  for (int k = 0; k < %d; ++k) a.vec[k] = vec[k];' % n_words,
              '  @NAME@<<<%du, %d, 0, (cudaStream_t)stream>>>(a);'
              % (lay.grid, lay.threads),
              '  return (int)cudaGetLastError();',
              '}', '']
    return '\n'.join(lines), lay
