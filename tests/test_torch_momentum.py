"""Port Momentum against the JAX package's `momentum` op: the op itself,
`momentum_reference` and `momentum_multi` (the CPU path of
csrc/momentum.cu's wrapper), the kernel generator's plan for a fused run
of momentum ops (one `momentum` step; Adam's plans as before), the plan
executor's momentum step, and the executor's grouping of consecutive
in-place momentum ops into one `momentum_multi` call.

Tolerance against JAX: rtol 1e-6 and an atol of one unit in the last place
of the tensor's largest value (the same float32 operations in the same
order; XLA may contract a multiply and an add into one rounding, which
moves a result by a unit in the last place).  The port's own paths (the
op, the plain version, the plan executor, the grouped interpreter) are
bit for bit equal to each other."""
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

SHAPES = [(1,), (7,), (oo._MOMENTUM_CHUNK + 1,), (3, 50)]
MU = 0.9


def _close(actual, desired, msg=''):
    np.testing.assert_allclose(
        actual, desired, rtol=1e-6,
        atol=float(np.spacing(np.abs(desired).max())), err_msg=msg)


def _state(seed):
    rng = np.random.RandomState(seed)
    return ([rng.randn(*s).astype('float32') * 0.1 for s in SHAPES],
            [rng.randn(*s).astype('float32') * 1e-3 for s in SHAPES])


def _grads(rng):
    return [rng.randn(*s).astype('float32') * 1e-2 for s in SHAPES]


def _jax_steps(params, vels, grads_per_step, lrs, nesterov):
    impl = jreg.get_op('momentum').impl
    ps, vs = [jnp.asarray(p) for p in params], [jnp.asarray(v) for v in vels]
    for grads, lr in zip(grads_per_step, lrs):
        for i, g in enumerate(grads):
            out = impl(None, {'Param': ps[i], 'Grad': jnp.asarray(g),
                              'Velocity': vs[i],
                              'LearningRate': jnp.asarray([lr], 'float32')},
                       {'mu': MU, 'use_nesterov': nesterov})
            ps[i], vs[i] = out['ParamOut'], out['VelocityOut']
    return [np.asarray(p) for p in ps], [np.asarray(v) for v in vs]


@pytest.mark.parametrize('nesterov', [False, True])
@pytest.mark.parametrize('fn', ['momentum_reference', 'momentum_multi',
                                'op'])
def test_three_steps_match_the_jax_momentum_op(fn, nesterov):
    params, vels = _state(0)
    rng = np.random.RandomState(1)
    grads = [_grads(rng) for _ in range(3)]
    lrs = [0.1, 0.05, 0.2]
    want_p, want_v = _jax_steps(params, vels, grads, lrs, nesterov)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tv = [torch.from_numpy(v.copy()) for v in vels]
    op = tf.core.registry.get_op('momentum')
    for g, lr in zip(grads, lrs):
        lr_t = torch.tensor([lr])
        tg = [torch.from_numpy(a) for a in g]
        if fn == 'op':
            for i in range(len(SHAPES)):
                out = op(None, {'Param': tp[i], 'Grad': tg[i],
                                'Velocity': tv[i], 'LearningRate': lr_t},
                         {'mu': MU, 'use_nesterov': nesterov})
                tp[i], tv[i] = out['ParamOut'], out['VelocityOut']
        else:
            getattr(oo, fn)(tp, tg, tv, [lr_t] * len(SHAPES), MU, nesterov)
    for i in range(len(SHAPES)):
        _close(tp[i].numpy(), want_p[i], 'param %d' % i)
        _close(tv[i].numpy(), want_v[i], 'velocity %d' % i)


def test_momentum_multi_is_the_op_bit_for_bit():
    """The plain version of the kernel computes what the per-op impl does,
    in place."""
    params, vels = _state(2)
    rng = np.random.RandomState(3)
    for nesterov in (False, True):
        g = [torch.from_numpy(a) for a in _grads(rng)]
        lr = torch.tensor([0.1])
        tp = [torch.from_numpy(p.copy()) for p in params]
        tv = [torch.from_numpy(v.copy()) for v in vels]
        ids = [id(t) for t in tp + tv]
        oo.momentum_multi(tp, g, tv, [lr] * len(tp), MU, nesterov)
        assert [id(t) for t in tp + tv] == ids
        op = tf.core.registry.get_op('momentum')
        for i in range(len(SHAPES)):
            out = op(None, {'Param': torch.from_numpy(params[i]),
                            'Grad': g[i],
                            'Velocity': torch.from_numpy(vels[i]),
                            'LearningRate': lr},
                     {'mu': MU, 'use_nesterov': nesterov})
            assert torch.equal(out['ParamOut'], tp[i])
            assert torch.equal(out['VelocityOut'], tv[i])


def test_momentum_multi_checks_its_lists():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match='length'):
        oo.momentum_multi(p, [], p, [torch.ones(1)], MU, False)
    oo.momentum_multi([], [], [], [], MU, False)   # nothing to do


# ------------------------------------------------------- the generator

def _sub(i, mu=MU, nesterov=False, out_suffix=''):
    p, g, v = 'p%d' % i, 'g%d' % i, 'v%d' % i
    return {'type': 'momentum',
            'inputs': {'Param': [p], 'Grad': [g], 'Velocity': [v],
                       'LearningRate': ['lr']},
            'outputs': {'ParamOut': [p + out_suffix], 'VelocityOut': [v]},
            'input_is_list': {k: False for k in ('Param', 'Grad',
                                                  'Velocity',
                                                  'LearningRate')},
            'output_is_list': {'ParamOut': False, 'VelocityOut': False},
            'attrs': {'mu': mu, 'use_nesterov': nesterov},
            'stop_grad': []}


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
    shape = {}
    for i, s in enumerate(SHAPES):
        for n in ('p%d' % i, 'g%d' % i, 'v%d' % i):
            shape[n] = s
    shape['lr'] = (1,)
    return tuple((tuple(shape[n]), 'float32') for n in attrs['arg_names'])


def test_a_run_of_in_place_momentum_sub_ops_is_one_plan_step():
    attrs = _group([_sub(i) for i in range(len(SHAPES))])
    plan = tkg.plan_for(attrs, _avals(attrs), False)
    assert [st[0] for st in plan.steps] == ['momentum']
    assert plan.counts() == {'kernels': 0, 'dsteps': 0, 'draws': 0,
                             'glue': 0, 'adam': 0, 'momentum': 1}
    kind, key, ins, outs, in_place = plan.steps[0]
    assert key == (MU, False)
    assert len(ins) == len(outs) == len(SHAPES) and all(in_place)
    assert 'momentum' in tkg.KERNEL_RULES
    assert tkg.unsupported_sub_ops(attrs) == []


def test_a_changed_mu_or_nesterov_starts_a_new_momentum_step():
    subs = [_sub(0), _sub(1), _sub(2, mu=0.5), _sub(3, nesterov=True)]
    attrs = _group(subs)
    plan = tkg.plan_for(attrs, _avals(attrs), False)
    assert [(st[0], st[1], len(st[2])) for st in plan.steps] == [
        ('momentum', (MU, False), 2), ('momentum', (0.5, False), 1),
        ('momentum', (MU, True), 1)]
    assert plan.n_momentum == 3


def _adam_sub(i):
    names = {s: '%s%d' % (s, i) for s in (
        'Param', 'Grad', 'Moment1', 'Moment2', 'Beta1Pow', 'Beta2Pow')}
    return {'type': 'adam',
            'inputs': dict({k: [v] for k, v in names.items()},
                           LearningRate=['lr']),
            'outputs': {'ParamOut': [names['Param']],
                        'Moment1Out': [names['Moment1']],
                        'Moment2Out': [names['Moment2']],
                        'Beta1PowOut': [names['Beta1Pow']],
                        'Beta2PowOut': [names['Beta2Pow']]},
            'input_is_list': {}, 'output_is_list': {},
            'attrs': {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8},
            'stop_grad': []}


def test_adam_plans_are_as_before():
    """An adam run stays one `adam` step with its key and the in-place
    flags; a momentum run beside it is a step of its own."""
    subs = [_adam_sub(0), _adam_sub(1), _sub(0), _sub(1)]
    attrs = _group(subs)
    avals = []
    for n in attrs['arg_names']:
        avals.append(((1,) if n.startswith(('Beta', 'lr')) else (5,),
                      'float32'))
    plan = tkg.plan_for(attrs, tuple(avals), False)
    assert [st[0] for st in plan.steps] == ['adam', 'momentum']
    kind, key, ins, outs, in_place = plan.steps[0]
    assert key == (0.9, 0.999, 1e-8) and in_place == [True, True]
    assert sorted(ins[0]) == sorted(('Param', 'Grad', 'Moment1', 'Moment2',
                                     'Beta1Pow', 'Beta2Pow',
                                     'LearningRate'))
    assert plan.counts()['adam'] == 1 and plan.counts()['momentum'] == 1


def test_the_plan_executor_runs_the_momentum_step_as_the_replay():
    """run_fused's momentum step (momentum_multi, its plain version on the
    CPU) against the fused op's replay of each sub-op."""
    from paddle_tpu_torch.ops import fused
    subs = [_sub(i) for i in range(len(SHAPES) - 1)] + \
        [_sub(len(SHAPES) - 1, out_suffix='_new')]
    attrs = _group(subs)
    rng = np.random.RandomState(4)
    xs = [torch.from_numpy(rng.randn(*s).astype('float32'))
          for s, _ in _avals(attrs)]
    ctx = ExecCtx('cpu', 0, 0).for_op(0, tf.Program().global_block()
                                      .append_op('fused_elementwise',
                                                 infer_shape=False))
    want = fused.replay(ctx, [x.clone() for x in xs], attrs, False)
    got = tkg.run_fused(ctx, [x.clone() for x in xs], attrs, False)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------ the interpreter

def test_executor_groups_consecutive_in_place_momentum_ops():
    """Momentum ops that write their own inputs and share mu and
    use_nesterov form one group; a differing mu or an op that writes
    elsewhere ends it (the latter runs through the functional op)."""
    prog = tf.Program()
    block = prog.global_block()
    ops = []
    for i, (mu, suffix) in enumerate([(MU, ''), (MU, ''), (0.5, ''),
                                      (0.5, '_new')]):
        ops.append(block.append_op(
            type='momentum',
            inputs={'Param': 'p%d' % i, 'Grad': 'g%d' % i,
                    'Velocity': 'v%d' % i, 'LearningRate': 'lr'},
            outputs={'ParamOut': 'p%d%s' % (i, suffix),
                     'VelocityOut': 'v%d' % i},
            attrs={'mu': mu, 'use_nesterov': False}, infer_shape=False))
    live = list(range(len(ops)))
    assert texec._optimizer_run(ops, live, 0) == (2, oo.run_momentum_group)
    assert texec._optimizer_run(ops, live, 2) == (3, oo.run_momentum_group)
    assert texec._optimizer_run(ops, live, 3) == (3, None)


def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[6], dtype='float32')
        h = fluid.layers.fc(x, 8, act='relu')
        y = fluid.layers.fc(h, 3)
        loss = fluid.layers.mean(y)
        fluid.optimizer.Momentum(learning_rate=0.1, momentum=MU,
                                 use_nesterov=True).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize('pt_opt', ['0', '1'])
def test_a_momentum_program_runs_one_grouped_update_a_step(monkeypatch,
                                                           pt_opt):
    """With the passes off the interpreter hands the 4 momentum ops to one
    run_momentum_group call a step; with them on, the fused group's plan
    has one momentum step; both equal the JAX package's training."""
    import paddle_tpu as jf
    monkeypatch.setenv('PT_CACHE', '0')
    monkeypatch.setenv('PT_OPT', pt_opt)
    jm, js, jl = _mlp(jf)
    tm, _, tl = _mlp(tf)
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(js)
    tscope = tf.scope_from_numpy(
        {n: np.asarray(jscope.vars[n]) for n in tf.persistable_names(tm)},
        tf.Scope(), 'cpu')
    calls = []
    real = oo.run_momentum_group

    def spy(ops, env, ectx):
        calls.append(len(ops))
        return real(ops, env, ectx)
    monkeypatch.setattr(oo, 'run_momentum_group', spy)
    monkeypatch.setitem(oo.GROUPS, 'momentum', (oo.momentum_group_key, spy))
    feed = {'x': np.random.RandomState(6).randn(4, 6).astype('float32')}
    texe = tf.Executor(tf.CPUPlace())
    for _ in range(3):
        with jf.scope_guard(jscope):
            want, = jf.Executor().run(jm, feed=feed, fetch_list=[jl])
        with tf.scope_guard(tscope):
            got, = texe.run(tm, feed=feed, fetch_list=[tl])
        _close(got, want, 'loss')
    assert calls == ([4] * 3 if pt_opt == '0' else [])
    for n in tf.persistable_names(tm):
        _close(tscope.vars[n].numpy(), np.asarray(jscope.vars[n]), n)
