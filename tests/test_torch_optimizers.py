"""The port's other update ops (sgd, adagrad, decayed_adagrad, adamax,
adadelta, rmsprop plain and centered, ftrl, lars_momentum) and optimizer
classes against the JAX package: each op for three steps, the plain
version (`optim_reference`) and the multi-tensor entry (`optim_multi`, the
CPU path of csrc/optim_multi.cu's wrapper) bit for bit against the op,
the group keys, the kernel generator's plan for a fused run (one step a
run; adamax's run across its Beta1Pow bumps), the plan executor's step,
the executor's grouping, the classes' programs, and a small network
trained three steps under each optimizer and under ModelAverage.

Tolerance against JAX: rtol 1e-6 and an atol of one unit in the last place
of the tensor's largest value (the same float32 operations in the same
order; XLA may contract a multiply and an add into one rounding).  Ftrl at
lr_power != -0.5 computes pow, which no implementation rounds correctly:
it is held, step by step from the same inputs, to the bound
`optimizer_ops.ftrl_pow_bound` states.  lars_momentum sums its norms in
another order than XLA.  The network's tensors: NET_RTOL."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as tf
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core.registry import ExecCtx
from paddle_tpu_torch.ops import kernelgen as tkg
from paddle_tpu_torch.ops import optimizer_ops as oo
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

# sizes 1 and 7, one past the kernel's chunk, a 2-D one
SHAPES = [(1,), (7,), (oo._OPTIM_CHUNK + 1,), (3, 50)]

# case -> (op type, attrs)
CASES = {
    'sgd': ('sgd', {}),
    'adagrad': ('adagrad', {'epsilon': 1e-6}),
    'decayed_adagrad': ('decayed_adagrad', {'decay': 0.9, 'epsilon': 1e-6}),
    'adamax': ('adamax', {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}),
    'adadelta': ('adadelta', {'rho': 0.95, 'epsilon': 1e-6}),
    'rmsprop': ('rmsprop', {'decay': 0.9, 'epsilon': 1e-6,
                            'momentum': 0.5, 'centered': False}),
    'rmsprop_centered': ('rmsprop', {'decay': 0.9, 'epsilon': 1e-6,
                                     'momentum': 0.5, 'centered': True}),
    'ftrl': ('ftrl', {'l1': 0.0, 'l2': 0.0, 'lr_power': -0.5}),
    'ftrl_l1_l2': ('ftrl', {'l1': 1e-3, 'l2': 1e-2, 'lr_power': -0.5}),
    'ftrl_pow': ('ftrl', {'l1': 1e-3, 'l2': 1e-2, 'lr_power': -0.6}),
}
KERNEL_CASES = sorted(CASES)
OUT_OF = {o: i for spec in oo.OPTIM_SLOTS.values()
          for o, i in spec[1].items()}


def _close(actual, desired, msg=''):
    np.testing.assert_allclose(
        actual, desired, rtol=1e-6,
        atol=float(np.spacing(np.abs(desired).max())), err_msg=msg)


def _slots(case):
    op_type, attrs = CASES[case]
    return oo.array_slots(op_type, oo.optim_key(op_type, attrs))


def _state(case, seed):
    """{slot: [array a tensor]}: params, the state arrays (non-negative
    where the update takes a root of them; centered rmsprop's mean square
    above its mean grad squared) and adamax's Beta1Pow."""
    rng = np.random.RandomState(seed)
    op_type, _ = CASES[case]
    st = {'Param': [rng.randn(*s).astype('float32') * 0.1 for s in SHAPES]}
    for slot in _slots(case):
        st[slot] = [np.abs(rng.randn(*s)).astype('float32') * 1e-3
                    for s in SHAPES]
    if op_type in ('rmsprop', 'ftrl'):
        # a signed moment / linear accumulator
        slot = 'Moment' if op_type == 'rmsprop' else 'LinearAccumulator'
        st[slot] = [a * np.sign(rng.randn(*a.shape)).astype('float32')
                    for a in st[slot]]
    if case == 'rmsprop_centered':
        st['MeanGrad'] = [rng.randn(*s).astype('float32') * 1e-2
                          for s in SHAPES]
        st['MeanSquare'] = [m * m + a for m, a in zip(st['MeanGrad'],
                                                      st['MeanSquare'])]
    if op_type == 'adamax':
        st['Beta1Pow'] = [np.full((1,), 0.9 ** (i + 1), 'float32')
                          for i in range(len(SHAPES))]
    return st


def _grads(rng):
    return [rng.randn(*s).astype('float32') * 1e-2 for s in SHAPES]


def _ins(op_type, st, i, g, lr, to):
    ins = {slot: to(col[i]) for slot, col in st.items()}
    ins['Grad'] = to(g)
    if op_type != 'adadelta':
        ins['LearningRate'] = to(np.asarray([lr], 'float32'))
    return ins


def _apply(st, outs, i):
    for o, v in outs.items():
        st[OUT_OF.get(o, o)][i] = v


def _jax_step(case, st, grads, lr):
    op_type, attrs = CASES[case]
    impl = jreg.get_op(op_type).impl
    new = {k: list(v) for k, v in st.items()}
    for i, g in enumerate(grads):
        outs = impl(None, _ins(op_type, st, i, g, lr, jnp.asarray), attrs)
        _apply(new, {k: np.asarray(v) for k, v in outs.items()}, i)
    return new


def _port_step(case, st, grads, lr, fn):
    """One step of the port from numpy state -> numpy state."""
    op_type, attrs = CASES[case]
    key = oo.optim_key(op_type, attrs)
    new = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in st.items()}
    tg = [torch.from_numpy(a) for a in grads]
    lrs = None if op_type == 'adadelta' else \
        [torch.tensor([lr])] * len(SHAPES)
    if fn == 'op':
        impl = tf.core.registry.get_op(op_type)
        for i in range(len(SHAPES)):
            outs = impl(None, _ins(op_type, new, i, grads[i], lr,
                                   torch.as_tensor), attrs)
            _apply(new, outs, i)
    else:
        scalar = oo.OPTIM_SLOTS[op_type][2]
        getattr(oo, fn)(op_type, new['Param'], tg,
                        [new[s] for s in _slots(case)],
                        new[scalar] if scalar else None, lrs, key)
    return {k: [t.numpy() for t in v] for k, v in new.items()}


@pytest.mark.parametrize('fn', ['optim_reference', 'optim_multi', 'op'])
@pytest.mark.parametrize('case', [c for c in KERNEL_CASES
                                  if c != 'ftrl_pow'])
def test_three_steps_match_the_jax_op(case, fn):
    st = _state(case, 0)
    want, got = st, st
    rng = np.random.RandomState(1)
    for lr in (0.1, 0.05, 0.2):
        grads = _grads(rng)
        want = _jax_step(case, want, grads, lr)
        got = _port_step(case, got, grads, lr, fn)
    for slot in want:
        for i in range(len(SHAPES)):
            _close(got[slot][i], want[slot][i], '%s %s %d' % (case, slot, i))


@pytest.mark.parametrize('fn', ['optim_reference', 'optim_multi', 'op'])
def test_ftrl_pow_steps_hold_the_stated_bound(fn):
    """Each of three steps from the same inputs: the squared accumulator
    within the usual tolerance (no pow), the param and linear accumulator
    within ftrl_pow_bound of the JAX op."""
    case = 'ftrl_pow'
    key = oo.optim_key(*CASES[case])
    st = _state(case, 0)
    rng = np.random.RandomState(1)
    for lr in (0.1, 0.05, 0.2):
        grads = _grads(rng)
        want = _jax_step(case, st, grads, lr)
        got = _port_step(case, st, grads, lr, fn)
        for i in range(len(SHAPES)):
            t = [torch.from_numpy(a) for a in (
                st['Param'][i], grads[i], st['SquaredAccumulator'][i],
                st['LinearAccumulator'][i])]
            bp, bz = oo.ftrl_pow_bound(*t, torch.tensor([lr]), key)
            for slot, bound in (('Param', bp), ('LinearAccumulator', bz)):
                diff = np.abs(got[slot][i].astype('float64') -
                              want[slot][i].astype('float64'))
                assert (diff <= bound.numpy()).all(), (slot, i, diff.max())
            _close(got['SquaredAccumulator'][i],
                   want['SquaredAccumulator'][i])
        st = got


def test_the_pow_bound_is_not_loose():
    """A pow one part in 10^5 off moves the update past the bound."""
    key = oo.optim_key(*CASES['ftrl_pow'])
    rng = np.random.RandomState(2)
    p, g, sq, lin = (torch.from_numpy(rng.randn(1000).astype('float32') * s)
                     for s in (0.1, 0.01, 1e-3, 1e-3))
    sq = sq.abs()
    lr = torch.tensor([0.1])
    pn, _ = oo._optim_one('ftrl', key, p, g, [sq, lin], None, lr)
    bp, _ = oo.ftrl_pow_bound(p, g, sq, lin, lr, key)
    real = torch.pow

    def off(x, e):
        return real(x, e) * (1 + 1e-5)
    torch.pow = off
    try:
        bad, _ = oo._optim_one('ftrl', key, p, g, [sq, lin], None, lr)
    finally:
        torch.pow = real
    assert ((pn.double() - bad.double()).abs() > bp).any()


@pytest.mark.parametrize('case', KERNEL_CASES)
def test_optim_multi_is_the_op_bit_for_bit(case):
    """The plain version of the kernel computes what the per-op impl does,
    in place, and the named entries are optim_multi."""
    op_type, attrs = CASES[case]
    st = _state(case, 2)
    rng = np.random.RandomState(3)
    grads = _grads(rng)
    by_op = _port_step(case, st, grads, 0.1, 'op')
    key = oo.optim_key(op_type, attrs)
    new = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in st.items()}
    ids = [id(t) for v in new.values() for t in v]
    scalar = oo.OPTIM_SLOTS[op_type][2]
    getattr(oo, op_type + '_multi')(
        new['Param'], [torch.from_numpy(a) for a in grads],
        [new[s] for s in _slots(case)], new[scalar] if scalar else None,
        None if op_type == 'adadelta' else [torch.tensor([0.1])] *
        len(SHAPES), key)
    assert [id(t) for v in new.values() for t in v] == ids
    for slot, col in by_op.items():
        for i, a in enumerate(col):
            assert np.array_equal(new[slot][i].numpy(), a), (slot, i)


def test_optim_multi_checks_its_lists():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match='length'):
        oo.adagrad_multi(p, [], [p], None, [torch.ones(1)], (1e-6,))
    with pytest.raises(ValueError, match='number'):
        oo.adagrad_multi(p, p, [], None, [torch.ones(1)], (1e-6,))
    with pytest.raises(ValueError, match='number'):
        oo.adadelta_multi(p, p, [p, p], None, [torch.ones(1)], (0.9, 1e-6))
    oo.sgd_multi([], [], [], None, [], ())   # nothing to do


# ------------------------------------------------------ group keys

def _op(block, case, i, suffix='', **attrs):
    op_type, base = CASES[case]
    a = dict(base, **attrs)
    key = oo.optim_key(op_type, a)
    ins = {'Param': 'p%d' % i, 'Grad': 'g%d' % i}
    if op_type != 'adadelta':
        ins['LearningRate'] = 'lr'
    outs = {'ParamOut': 'p%d%s' % (i, suffix)}
    for o, slot in oo.OPTIM_SLOTS[op_type][1].items():
        if slot in oo.array_slots(op_type, key):
            ins[slot] = '%s%d' % (slot, i)
            outs[o] = '%s%d' % (slot, i)
    if op_type == 'adamax':
        ins['Beta1Pow'] = 'b1p%d' % i
    return block.append_op(type=op_type, inputs=ins, outputs=outs, attrs=a,
                           infer_shape=False)


def test_group_keys_hold_every_attribute_the_update_reads():
    block = tf.Program().global_block()
    key = oo.optim_group_key
    assert key(_op(block, 'sgd', 0)) == ('sgd',)
    assert key(_op(block, 'rmsprop', 0)) == ('rmsprop', 0.9, 1e-6, 0.5,
                                             False)
    assert key(_op(block, 'rmsprop_centered', 0))[-1] is True
    assert key(_op(block, 'ftrl_pow', 0)) == ('ftrl', 1e-3, 1e-2, -0.6)
    assert key(_op(block, 'adamax', 0)) == ('adamax', 0.9, 0.999, 1e-8)
    # defaults are the reference's
    assert oo.optim_key('adadelta', {}) == (0.95, 1e-6)
    assert oo.optim_key('decayed_adagrad', {}) == (0.95, 1e-6)
    assert oo.optim_key('ftrl', {}) == (0.0, 0.0, -0.5)
    # an op that writes elsewhere is no group member
    assert key(_op(block, 'adagrad', 1, suffix='_new')) is None
    assert set(oo.GROUPS) == set(oo.OPTIM_SLOTS) | {'adam', 'momentum'}


def test_executor_groups_runs_of_each_type_and_key():
    """A changed attribute the math reads (centered, lr_power) ends a
    run; another type ends it; adamax's run holds across its bumps."""
    block = tf.Program().global_block()
    ops = [_op(block, 'rmsprop', 0), _op(block, 'rmsprop', 1),
           _op(block, 'rmsprop_centered', 2), _op(block, 'ftrl', 3),
           _op(block, 'ftrl_pow', 4), _op(block, 'sgd', 5),
           _op(block, 'sgd', 6)]
    live = list(range(len(ops)))
    run = texec._optimizer_run
    assert run(ops, live, 0) == (2, oo.run_optim_group)
    assert run(ops, live, 2) == (3, oo.run_optim_group)
    assert run(ops, live, 3) == (4, oo.run_optim_group)
    assert run(ops, live, 4) == (5, oo.run_optim_group)
    assert run(ops, live, 5) == (7, oo.run_optim_group)


def _adamax_with_bumps(block, n):
    ops = []
    for i in range(n):
        ops.append(_op(block, 'adamax', i))
        ops.append(block.append_op(
            type='scale', inputs={'X': 'b1p%d' % i},
            outputs={'Out': 'b1p%d' % i},
            attrs={'scale': 0.9, 'bias': 0.0, 'bias_after_scale': True},
            infer_shape=False))
    return ops


def test_an_adamax_run_holds_across_its_beta1_pow_bumps():
    block = tf.Program().global_block()
    ops = _adamax_with_bumps(block, 3)
    # a scale of something else ends the run
    ops.append(block.append_op(
        type='scale', inputs={'X': 'x'}, outputs={'Out': 'x'},
        attrs={'scale': 2.0}, infer_shape=False))
    live = list(range(len(ops)))
    assert texec._optimizer_run(ops, live, 0) == (6, oo.run_optim_group)


# ---------------------------------------------------- the generator

def _subs_of(ops):
    from paddle_tpu_torch.core.passes.fuse import _fusable

    class Ctx(object):
        cf_pinned = ()
    return [_fusable(op, op.block, Ctx()) for op in ops]


def _group(subs):
    args = []
    for s in subs:
        for names in s['inputs'].values():
            for n in names:
                if n not in args:
                    args.append(n)
    outs = []
    for s in subs:
        for names in s['outputs'].values():
            outs.extend(n for n in names if n not in outs)
    return {'sub_ops': subs, 'arg_names': args, 'out_names': outs}


def _avals(attrs):
    shape = {'lr': (1,)}
    for i, s in enumerate(SHAPES):
        shape['b1p%d' % i] = (1,)
    for n in attrs['arg_names']:
        if n not in shape:
            shape[n] = SHAPES[int(re.findall(r'\d+', n)[-1])]
    return tuple((tuple(shape[n]), 'float32') for n in attrs['arg_names'])


@pytest.mark.parametrize('case', KERNEL_CASES)
def test_a_run_of_in_place_sub_ops_is_one_plan_step(case):
    block = tf.Program().global_block()
    attrs = _group(_subs_of([_op(block, case, i)
                             for i in range(len(SHAPES))]))
    plan = tkg.plan_for(attrs, _avals(attrs), False)
    op_type = CASES[case][0]
    assert [st[0] for st in plan.steps] == [op_type]
    assert plan.counts()[op_type] == 1
    kind, key, ins, outs, in_place = plan.steps[0]
    assert key == oo.optim_key(*CASES[case])
    assert len(ins) == len(outs) == len(SHAPES) and all(in_place)
    assert tkg.unsupported_sub_ops(attrs) == []


def test_adamax_bumps_follow_the_run_in_the_plan():
    """adamax, scale, adamax, scale, ...: one adamax step, then the bumps
    as one generated kernel step."""
    block = tf.Program().global_block()
    attrs = _group(_subs_of(_adamax_with_bumps(block, len(SHAPES))))
    plan = tkg.plan_for(attrs, _avals(attrs), False)
    assert [st[0] for st in plan.steps] == ['adamax', 'kernel']
    assert plan.counts()['adamax'] == 1 and plan.n_kernels == 1


@pytest.mark.parametrize('case', KERNEL_CASES + ['adamax_bumps'])
def test_the_plan_executor_runs_the_step_as_the_replay(case, monkeypatch):
    """run_fused's optim_multi step (its plain version on the CPU) against
    the fused op's replay of each sub-op; the last op writes a new
    param."""
    from paddle_tpu_torch.ops import fused
    block = tf.Program().global_block()
    if case == 'adamax_bumps':
        ops = _adamax_with_bumps(block, len(SHAPES))
    else:
        ops = [_op(block, case, i) for i in range(len(SHAPES) - 1)] + \
            [_op(block, case, len(SHAPES) - 1, suffix='_new')]
    attrs = _group(_subs_of(ops))
    rng = np.random.RandomState(4)
    xs = [torch.from_numpy(np.abs(rng.randn(*s)).astype('float32') * 0.1)
          for s, _ in _avals(attrs)]
    # the bumps' generated kernel step, as its plain replay
    monkeypatch.setattr(tkg, '_launch', lambda spec, ents: [
        o.detach() for o in spec.replay(list(ents))])
    ctx = ExecCtx('cpu', 0, 0).for_op(0, tf.Program().global_block()
                                      .append_op('fused_elementwise',
                                                 infer_shape=False))
    want = fused.replay(ctx, [x.clone() for x in xs], attrs, False)
    got = tkg.run_fused(ctx, [x.clone() for x in xs], attrs, False)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        # bit for bit; centered rmsprop's roots of these inputs are NaN
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


# ------------------------------------------- the optimizer classes

OPTIMIZERS = {
    'SGD': lambda o: o.SGD(learning_rate=0.1),
    'Adagrad': lambda o: o.Adagrad(learning_rate=0.1,
                                   initial_accumulator_value=0.1),
    'DecayedAdagrad': lambda o: o.DecayedAdagrad(learning_rate=0.1,
                                                 decay=0.9),
    'Adamax': lambda o: o.Adamax(learning_rate=0.01),
    'Adadelta': lambda o: o.Adadelta(learning_rate=0.1, rho=0.9),
    'RMSProp': lambda o: o.RMSProp(learning_rate=0.01, momentum=0.5),
    'RMSPropCentered': lambda o: o.RMSProp(learning_rate=0.01,
                                           centered=True),
    'Ftrl': lambda o: o.Ftrl(learning_rate=0.1, l1=1e-3, l2=1e-2),
    'FtrlPow': lambda o: o.Ftrl(learning_rate=0.1, l1=1e-3, l2=1e-2,
                                lr_power=-0.6),
    'LarsMomentum': lambda o: o.LarsMomentum(learning_rate=0.1,
                                             momentum=0.9),
}


def _mlp(fluid, make_opt, average=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[6], dtype='float32')
        def attr():
            return fluid.ParamAttr(do_model_average=True) if average \
                else None
        h = fluid.layers.fc(x, 8, act='relu', param_attr=attr())
        y = fluid.layers.fc(h, 3, param_attr=attr())
        loss = fluid.layers.mean(fluid.layers.square(y))
        make_opt(fluid.optimizer).minimize(loss)
        avg = fluid.optimizer.ModelAverage(0.15) if average else None
    return main, startup, loss, avg


# the network's tensors against the JAX package after three steps: the
# two backward passes sum their products in other orders, so the gradients
# differ in their last bits, and an update that divides by a root of an
# accumulator takes that to a few 1e-6 of an element (7.3e-6 the most seen,
# RMSProp; 2.3e-6 of a tensor's largest value, centered RMSProp): rtol
# 1e-5, and an atol of 1e-5 of the tensor's largest value
NET_RTOL = 1e-5


def _desc(prog):
    ops = [(op.type, sorted(op.inputs), sorted(op.outputs),
            {k: v for k, v in op.attrs.items() if k != 'op_role'})
           for op in prog.global_block().ops]
    vs = sorted((v.name, tuple(v.shape or ()), v.dtype, v.persistable)
                for v in prog.list_vars())
    return ops, vs


@pytest.mark.parametrize('name', sorted(OPTIMIZERS) + ['ModelAverage'])
def test_each_class_builds_the_references_program(name):
    import paddle_tpu as jf
    make = OPTIMIZERS.get(name, OPTIMIZERS['SGD'])
    avg = name == 'ModelAverage'
    jm, js, _, _ = _mlp(jf, make, avg)
    tm, ts, _, _ = _mlp(tf, make, avg)
    assert _desc(tm) == _desc(jm)
    assert _desc(ts) == _desc(js)


def test_aliases_are_the_references():
    import paddle_tpu as jf
    assert sorted(tf.optimizer.__all__) == sorted(jf.optimizer.__all__)
    for name in jf.optimizer.__all__ + ['RMSProp']:
        assert getattr(tf.optimizer, name).__name__ == \
            getattr(jf.optimizer, name).__name__


def _train(monkeypatch, name, pt_opt, steps=3):
    """Both packages from one carried state; -> (jscope, tscope, main,
    per-step (port, jax) losses, group calls)."""
    import paddle_tpu as jf
    monkeypatch.setenv('PT_CACHE', '0')
    monkeypatch.setenv('PT_OPT', pt_opt)
    make = OPTIMIZERS.get(name, OPTIMIZERS['SGD'])
    avg = name == 'ModelAverage'
    jm, js, jl, javg = _mlp(jf, make, avg)
    tm, _, tl, tavg = _mlp(tf, make, avg)
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(js)
    tscope = tf.scope_from_numpy(
        {n: np.asarray(jscope.vars[n]) for n in tf.persistable_names(tm)},
        tf.Scope(), 'cpu')
    calls = []
    real = oo.run_optim_group

    def spy(ops, env, ectx):
        calls.append(len([o for o in ops if o.type != 'scale']))
        return real(ops, env, ectx)
    for t in oo.OPTIM_SLOTS:
        monkeypatch.setitem(oo.GROUPS, t, (oo.optim_group_key, spy))
    feed = {'x': np.random.RandomState(6).randn(4, 6).astype('float32')}
    texe = tf.Executor(tf.CPUPlace())
    losses = []
    for _ in range(steps):
        with jf.scope_guard(jscope):
            want, = jf.Executor().run(jm, feed=feed, fetch_list=[jl])
        with tf.scope_guard(tscope):
            got, = texe.run(tm, feed=feed, fetch_list=[tl])
        losses.append((got, want))
    return jscope, tscope, tm, losses, calls, (javg, tavg)


@pytest.mark.parametrize('pt_opt', ['0', '1'])
@pytest.mark.parametrize('name', sorted(OPTIMIZERS) + ['ModelAverage'])
def test_a_small_network_trains_as_the_reference(monkeypatch, name, pt_opt):
    """Three steps from one carried state: losses, parameters and every
    accumulator against the JAX package (NET_RTOL).  With the passes off, a run of
    4 update ops is one grouped call a step (lars_momentum: none); with
    them on, the fused group's plan makes it one step."""
    jscope, tscope, tm, losses, calls, _ = _train(monkeypatch, name, pt_opt)
    for got, want in losses:
        _close(got, want, 'loss')
    for n in tf.persistable_names(tm):
        want = np.asarray(jscope.vars[n])
        np.testing.assert_allclose(
            tscope.vars[n].numpy(), want, rtol=NET_RTOL,
            atol=NET_RTOL * float(np.abs(want).max()), err_msg=n)
    grouped = pt_opt == '0' and name != 'LarsMomentum'
    assert calls == ([4] * 3 if grouped else [])


def test_model_average_applies_and_restores(monkeypatch):
    """apply() writes sum / cnt into each averaged parameter (the fc
    weights) in place (the JAX package's values), restore() puts the
    trained ones back."""
    import paddle_tpu as jf
    jscope, tscope, tm, _, _, (javg, tavg) = _train(
        monkeypatch, 'ModelAverage', '0')
    params = [p.name for p in tm.all_parameters()]
    trained = {n: tscope.vars[n].clone() for n in params}
    ids = {n: tscope.vars[n].data_ptr() for n in params}
    with jf.scope_guard(jscope), javg.apply(None):
        want = {n: np.asarray(jscope.vars[n]) for n in params}
    with tf.scope_guard(tscope), tavg.apply(None):
        for n in params:
            assert tscope.vars[n].data_ptr() == ids[n]
            _close(tscope.vars[n].numpy(), want[n], n)
            assert torch.equal(tscope.vars[n], trained[n]) == \
                (n not in tavg._avg_vars)
    for n in params:
        assert torch.equal(tscope.vars[n], trained[n])
