"""Every learning-rate schedule of layers/learning_rate_scheduler.py on the
CPU against the JAX package and against its plain formula in float64:
each built with Momentum on a small fc, the same program in both
packages, run through `Executor.run` over steps that cross its
boundaries, epochs, cycles and warm-up, the rate fetched each step; and
every fused group of each program planned for the card (PT_OPT fuses the
schedule's ops with the step counter: the comparisons' bools stay inside
the generated kernel).

Tolerances: the rate within 2^-20 relative of the JAX package's and of
the float64 formula (a chain of at most ten float32 operations, each
rounding at 2^-24); the parameters after the last step within 1e-6
relative (L2) of the JAX package's (float32 products of the same sizes,
summed in other orders).
"""
import json
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)


@pytest.fixture(autouse=True)
def fresh_port_programs(monkeypatch):
    """Fresh default programs, scope and name generator for the port (the
    root conftest does the same for the JAX package), and the JAX
    package's compile cache off."""
    monkeypatch.setenv('PT_CACHE', '0')
    from paddle_tpu_torch.core import executor, framework, unique_name
    main, startup = framework.Program(), framework.Program()
    old_main = framework.switch_main_program(main)
    old_startup = framework.switch_startup_program(startup)
    old_gen = unique_name.switch()
    old_scope = executor._global_scope
    executor._global_scope = executor.Scope()
    yield
    framework.switch_main_program(old_main)
    framework.switch_startup_program(old_startup)
    unique_name.switch(old_gen)
    executor._global_scope = old_scope


def _poly(k, lr, ds, end, power, cycle):
    if cycle:
        dsv = ds * max(math.ceil(k / ds), 1)
    else:
        k, dsv = min(k, ds), ds
    return (lr - end) * (1 - k / dsv) ** power + end


def _piecewise(k, b, v):
    return next((v[i] for i, bi in enumerate(b) if k < bi), v[-1])


# name -> (build from a layers module, the rate at decay step k)
SCHEDULES = {
    'piecewise': (lambda L: L.piecewise_decay([3, 6], [0.1, 0.01, 0.001]),
                  lambda k: _piecewise(k, [3, 6], [0.1, 0.01, 0.001])),
    'piecewise_one_boundary': (
        lambda L: L.piecewise_decay([2], [0.5, 0.05]),
        lambda k: _piecewise(k, [2], [0.5, 0.05])),
    'exponential': (lambda L: L.exponential_decay(0.1, 3, 0.5),
                    lambda k: 0.1 * 0.5 ** (k / 3)),
    'exponential_staircase': (
        lambda L: L.exponential_decay(0.1, 3, 0.5, staircase=True),
        lambda k: 0.1 * 0.5 ** math.floor(k / 3)),
    'natural_exp': (lambda L: L.natural_exp_decay(0.1, 3, 0.4),
                    lambda k: 0.1 * math.exp(-0.4 * k / 3)),
    'natural_exp_staircase': (
        lambda L: L.natural_exp_decay(0.1, 3, 0.4, staircase=True),
        lambda k: 0.1 * math.exp(-0.4 * math.floor(k / 3))),
    'inverse_time': (lambda L: L.inverse_time_decay(0.1, 2, 0.5),
                     lambda k: 0.1 / (1 + 0.5 * k / 2)),
    'inverse_time_staircase': (
        lambda L: L.inverse_time_decay(0.1, 2, 0.5, staircase=True),
        lambda k: 0.1 / (1 + 0.5 * math.floor(k / 2))),
    'polynomial': (lambda L: L.polynomial_decay(0.1, 4, 0.001, power=2.0),
                   lambda k: _poly(k, 0.1, 4, 0.001, 2.0, False)),
    'polynomial_cycle': (
        lambda L: L.polynomial_decay(0.1, 3, 0.001, power=1.5, cycle=True),
        lambda k: _poly(k, 0.1, 3, 0.001, 1.5, True)),
    'cosine': (lambda L: L.cosine_decay(0.1, 2, 8),
               lambda k: 0.1 * 0.5 * (math.cos(math.floor(k / 2) *
                                               math.pi / 8) + 1)),
    'linear_warmup': (lambda L: L.linear_lr_warmup(0.1, 4, 0.01, 0.05),
                      lambda k: 0.01 + 0.04 * k / 4 if k < 4 else 0.1),
    'linear_warmup_of_a_schedule': (
        lambda L: L.linear_lr_warmup(L.exponential_decay(0.1, 3, 0.5), 3,
                                     0.0, 0.1),
        lambda k: 0.1 * k / 3 if k < 3 else 0.1 * 0.5 ** (k / 3)),
    'noam': (lambda L: L.noam_decay(64, 3),
             lambda k: 64 ** -0.5 * min((k + 1) ** -0.5,
                                        3 ** -1.5 * (k + 1))),
}
STEPS = 10


def _program(fluid, make):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[6], dtype='float32')
        loss = fluid.layers.mean(fluid.layers.fc(x, 4, act='relu'))
        lr = make(fluid.layers)
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(loss)
    return main, startup, lr


def _desc(fluid, program):
    d = json.loads(json.dumps(fluid.io.program_to_desc(program)))
    for b in d['blocks']:
        for op in b['ops']:
            op.pop('source_loc', None)
    return d


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_matches_the_reference_and_its_formula(name):
    make, formula = SCHEDULES[name]
    jm, js, jlr = _program(jf, make)
    tm, ts, tlr = _program(tf, make)
    assert _desc(tf, tm) == _desc(jf, jm)
    assert _desc(tf, ts) == _desc(jf, js)
    feed = {'x': np.random.RandomState(6).randn(4, 6).astype('float32')}
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        exe = jf.Executor()
        exe.run(js)
        init = {n: np.asarray(v).copy() for n, v in jscope.vars.items()}
        want = [float(np.asarray(exe.run(jm, feed=feed,
                                         fetch_list=[jlr])[0])[0])
                for _ in range(STEPS)]
    tscope = tf.scope_from_numpy(init, tf.Scope(), 'cpu')
    with tf.scope_guard(tscope):
        exe = tf.Executor(tf.CPUPlace())
        got = [float(exe.run(tm, feed=feed, fetch_list=[tlr])[0][0])
               for _ in range(STEPS)]
    plain = [formula(k) for k in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=2.0 ** -20, atol=0)
    np.testing.assert_allclose(got, plain, rtol=2.0 ** -20, atol=0)
    params = sorted(p.name for p in tm.all_parameters())
    a = np.concatenate([tscope.vars[n].numpy().ravel() for n in params])
    b = np.concatenate([np.asarray(jscope.vars[n]).ravel() for n in params])
    assert np.linalg.norm(a - b) <= 1e-6 * np.linalg.norm(b)


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_fused_groups_plan_for_the_card(name):
    """Every fused group of the schedule's optimized program plans into
    generated kernels and dedicated steps, no KernelgenUnsupported; the
    schedule and its step counter fuse into one scalar kernel."""
    from paddle_tpu_torch.core import executor as ex, passes
    from paddle_tpu_torch.core.dtypes import torch_dtype
    from paddle_tpu_torch.ops import kernelgen
    main, _, lr = _program(tf, SCHEDULES[name][0])
    opt, _ = passes.maybe_optimize(main, [lr.name])
    env = {v.name: torch.empty(v.shape, dtype=torch_dtype(v.dtype),
                               device='meta')
           for v in main.list_vars() if v.persistable}
    env['x'] = torch.empty((4, 6), device='meta')
    seen, real = [], kernelgen.plan_for

    def spy(attrs, avals, amp):
        plan = real(attrs, avals, amp)
        seen.append((attrs, plan))
        return plan
    kernelgen.plan_for = spy
    try:
        ex._plan_kernels(opt.global_block().ops, env, False)
    finally:
        kernelgen.plan_for = real
    assert seen
    sched = [(a, p) for a, p in seen
             if a['sub_ops'][0]['type'] == 'increment']
    assert len(sched) == 1
    attrs, plan = sched[0]
    specs = [st[1] for st in plan.steps if st[0] == 'kernel']
    assert specs and specs[0].n_max == 1          # a scalar chain
    types = {so['type'] for so in attrs['sub_ops']}
    if 'less_than' in types:
        src = kernelgen.generated_source([s.name for s in specs])
        assert 'bool R' in src


def test_append_lars_raises_as_the_reference():
    with pytest.raises(NotImplementedError):
        jf.layers.append_LARS(None, 0.1, 0.0)
    with pytest.raises(NotImplementedError):
        tf.layers.append_LARS(None, 0.1, 0.0)


def test_every_reference_schedule_is_ported():
    from paddle_tpu.layers import learning_rate_scheduler as j
    from paddle_tpu_torch.layers import learning_rate_scheduler as t
    assert t.__all__ == j.__all__
