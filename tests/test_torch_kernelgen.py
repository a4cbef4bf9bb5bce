"""K7, the kernel generator (paddle_tpu_torch/ops/kernelgen), on the CPU.

- Plans: for every fused group of the 2-layer transformer at its defaults
  (composed attention, dropout 0.1), the port's plan against the JAX
  package's (`paddle_tpu.ops.kernelgen.plan_for`): the same number of
  kernel segments, dedicated steps (softmax, layer_norm) and random draws,
  and the same sub-ops inside kernels.  Two differences are on purpose
  and named where they show: a broadcast that is not a suffix (the
  [B, 1, 1, T] padding mask) is indexed inside the port's kernel where
  the reference materializes it as glue, and an all-adam group is one
  `adam_multi` launch in the port where the reference generates a kernel.
- The plain version (the fused op's replay through each sub-op's impl)
  against the JAX package's replay (`paddle_tpu/ops/fused.py` with its
  kernel tier off) over a sweep of sub-programs of the ops the port
  registers: exact for arithmetic ops, rtol 1e-6 where a transcendental
  (exp, pow, softmax) runs in other implementations.
- The plan executor itself (draws, views and transposes, dedicated steps,
  adam_multi, and the autograd Function around each segment), with each
  generated launch replaced by its segment's plain replay: bit for bit
  the fused op's replay, forward and gradients, and three training steps
  of the transformer.
- The generated CUDA source: deterministic, one function for the
  identical segments of every layer, broadcast index maps that address
  what numpy broadcasting addresses; every fusable op the port registers
  has a rule; an unsupported sub-op raises naming itself.
- The tile table baked into a segment's source (builder.Layout): read
  back from the source of a segment with groups of sizes that divide by
  neither 4 nor 8, over float32, bf16 and bool operands, and each
  block's (group, tile) emulated: every element of every group is run
  exactly once, each group at the vector width of 16 bytes of its
  widest operand.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.core import passes as jpasses
from paddle_tpu.models import transformer as jtr
from paddle_tpu.ops import fused as jfused
from paddle_tpu.ops import kernelgen as jkg
import paddle_tpu_torch as tf
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core import passes as tpasses
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import fused as tfused
from paddle_tpu_torch.ops import kernelgen as tkg
from paddle_tpu_torch.ops.kernelgen import builder as tbuilder
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

SMALL = dict(src_vocab=128, trg_vocab=128, max_len=16, n_layer=2, n_head=4,
             d_model=64, d_inner=128, dropout=0.1, use_flash=False)


@pytest.fixture(autouse=True)
def fresh_port_programs(monkeypatch):
    """Fresh default programs, scope and name generator for the port (the
    root conftest does the same for the JAX package)."""
    from paddle_tpu_torch.core import executor, framework, unique_name
    monkeypatch.setenv('PT_AUTOTUNE', '0')
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


def _build(fluid, tr, **over):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = tr.build(**dict(SMALL, **over))
    return main, startup, out


def _port_fused_groups(amp=False):
    """(attrs, input avals) of every fused group of the port's optimized
    2-layer training program, from the executor's planning pass."""
    tm, ts, tout = _build(tf, ttr)
    tm.set_amp(amp)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        exe.run(ts)
    feed = ttr.synthetic_batch(np.random.RandomState(0), 4, 16, 128)
    env = dict(scope.vars)
    env.update(exe._feed_tensors(tm.global_block(), feed))
    opt, _ = tpasses.optimize_program(tm, [tout['loss'].name])
    seen = []
    real = tkg.plan_for

    def spy(attrs, avals, amp_):
        seen.append((attrs, avals))
        return real(attrs, avals, amp_)

    tkg.plan_for = spy
    try:
        texec._plan_kernels(opt.global_block().ops, env, amp)
    finally:
        tkg.plan_for = real
    return seen


def test_plans_match_the_reference_plans():
    groups = _port_fused_groups()
    jm, _, jout = _build(jf, jtr)
    jopt, _ = jpasses.optimize_program(jm, [jout['loss'].name])
    jgroups = [op for op in jopt.global_block().ops
               if op.type == 'fused_elementwise']
    assert len(groups) == len(jgroups) == 39
    named = {'materialized_broadcast': 0, 'adam_group': 0}
    for (attrs, avals), jop in zip(groups, jgroups):
        assert [s['type'] for s in attrs['sub_ops']] == \
            [s['type'] for s in jop.attrs['sub_ops']]
        tp = tkg.plan_for(attrs, avals, False)
        jp = jkg.plan_for(jop.attrs, tuple(
            (s, np.dtype(d)) for s, d in avals), False)
        kernel_ops = sum(len(spec.ops) for kind, *rest in tp.steps
                         if kind == 'kernel' for spec in rest[:1])
        if tp.n_adam:
            # the reference generates one kernel for the adam group
            named['adam_group'] += 1
            assert (tp.n_kernels, tp.n_adam) == (0, 1)
            assert (jp.n_kernels, jp.kernel_ops) == (1, len(attrs['sub_ops']))
            continue
        assert (tp.n_kernels, tp.n_dsteps, tp.n_draws) == \
            (jp.n_kernels, jp.n_dsteps, jp.n_rng)
        assert kernel_ops == jp.kernel_ops
        if jp.n_glue != tp.n_glue:
            # the [B, 1, 1, T] mask broadcast: glue in the reference, an
            # index map inside the port's kernel
            named['materialized_broadcast'] += 1
            assert jp.n_glue == tp.n_glue + 1
    # 6 attention mask adds and the padding + causal mask
    assert named == {'materialized_broadcast': 7, 'adam_group': 1}


# ------------------------------------------- plain version vs JAX replay

def _sub(type, inputs, outputs, attrs=None):
    return {'type': type, 'inputs': {k: list(v) for k, v in inputs.items()},
            'outputs': {k: list(v) for k, v in outputs.items()},
            'input_is_list': {k: False for k in inputs},
            'output_is_list': {k: False for k in outputs},
            'attrs': dict(attrs or {}), 'stop_grad': []}


def _attrs(subs, args, outs):
    return {'sub_ops': subs, 'arg_names': list(args),
            'out_names': list(outs), 'fused_count': len(subs)}


R = np.random.RandomState(7)
POS = lambda *s: (R.rand(*s) + 0.5).astype('float32')      # noqa: E731
RND = lambda *s: R.randn(*s).astype('float32')             # noqa: E731

# name -> (sub-ops, {arg: value}, out names, rtol): rtol 0 is exact;
# 1e-6 where a transcendental (exp, pow) runs in other implementations;
# 1e-5 (and 1e-5 absolute) where LayerNorm sums in other orders, as in
# tests/test_torch_layer_norm.py
SWEEP = {
    'bias_relu_scale': ([
        _sub('elementwise_add', {'X': ['x'], 'Y': ['b']}, {'Out': ['h']},
             {'axis': 2}),
        _sub('relu', {'X': ['h']}, {'Out': ['r']}),
        _sub('scale', {'X': ['r']}, {'Out': ['o']},
             {'scale': 0.7, 'bias': 0.25, 'bias_after_scale': True})],
        {'x': RND(4, 6, 8), 'b': RND(8)}, ['o'], 0),
    'axis_rule_mul_sub_div_min': ([
        _sub('elementwise_mul', {'X': ['x'], 'Y': ['y']}, {'Out': ['a']},
             {'axis': 0}),
        _sub('elementwise_sub', {'X': ['a'], 'Y': ['z']}, {'Out': ['c']},
             {'axis': -1}),
        _sub('elementwise_div', {'X': ['c'], 'Y': ['x']}, {'Out': ['d']},
             {'axis': -1}),
        _sub('elementwise_min', {'X': ['d'], 'Y': ['c']}, {'Out': ['o']},
             {'axis': -1})],
        {'x': POS(4, 6, 8), 'y': RND(4, 6), 'z': RND(6, 8)}, ['o', 'a'], 0),
    'mask_add_softmax': ([
        _sub('elementwise_add', {'X': ['s'], 'Y': ['m']}, {'Out': ['a']},
             {'axis': -1}),
        _sub('softmax', {'X': ['a']}, {'Out': ['o']}, {'axis': -1})],
        {'s': RND(2, 3, 5, 5), 'm': RND(2, 1, 1, 5)}, ['o'], 1e-6),
    'pad_plus_causal': ([
        _sub('scale', {'X': ['p']}, {'Out': ['q']}, {'scale': -1e9}),
        _sub('unsqueeze', {'X': ['q']}, {'Out': ['u']}, {'axes': [1, 2]}),
        _sub('elementwise_add', {'X': ['u'], 'Y': ['c']}, {'Out': ['o']},
             {'axis': -1})],
        {'p': (R.rand(2, 5) > 0.6).astype('float32'), 'c': RND(1, 1, 5, 5)},
        ['o'], 0),
    'scale_before_cast_increment': ([
        _sub('scale', {'X': ['x']}, {'Out': ['a']},
             {'scale': 3.0, 'bias': 1.5, 'bias_after_scale': False}),
        _sub('cast', {'X': ['a']}, {'Out': ['i']}, {'out_dtype': 'int32'}),
        _sub('increment', {'X': ['i']}, {'Out': ['j']}, {'step': 2.0}),
        _sub('cast', {'X': ['j']}, {'Out': ['o']},
             {'out_dtype': 'float32'})],
        {'x': RND(3, 7) * 4}, ['o', 'j'], 0),
    'noam_chain': ([
        _sub('increment', {'X': ['n']}, {'Out': ['n']}, {'step': 1.0}),
        _sub('cast', {'X': ['n']}, {'Out': ['t']}, {'out_dtype': 'float32'}),
        _sub('fill_constant', {}, {'Out': ['e']},
             {'shape': [1], 'value': -0.5, 'dtype': 'float32'}),
        _sub('elementwise_pow', {'X': ['t'], 'Y': ['e']}, {'Out': ['a']},
             {'axis': -1}),
        _sub('scale', {'X': ['t']}, {'Out': ['b']},
             {'scale': 8000 ** -1.5, 'bias': 0.0}),
        _sub('elementwise_min', {'X': ['a'], 'Y': ['b']}, {'Out': ['m']},
             {'axis': -1}),
        _sub('scale', {'X': ['m']}, {'Out': ['o']},
             {'scale': 64 ** -0.5, 'bias': 0.0})],
        {'n': np.array([6], 'int32')}, ['o', 'n'], 1e-6),
    'increment_float_swish': ([
        _sub('increment', {'X': ['x']}, {'Out': ['a']}, {'step': 0.5}),
        _sub('swish', {'X': ['a']}, {'Out': ['o']}, {'beta': 1.5})],
        {'x': RND(5, 9)}, ['o'], 1e-6),
    'split_heads_scale': ([
        _sub('reshape', {'X': ['x']}, {'Out': ['r']},
             {'shape': [0, 0, 2, 4]}),
        _sub('transpose', {'X': ['r']}, {'Out': ['t']},
             {'axis': [0, 2, 1, 3]}),
        _sub('scale', {'X': ['t']}, {'Out': ['o']}, {'scale': 0.5}),
        _sub('transpose', {'X': ['o']}, {'Out': ['b']},
             {'axis': [0, 2, 1, 3]}),
        _sub('reshape', {'X': ['b']}, {'Out': ['c']}, {'shape': [0, 0, 8]}),
        _sub('unsqueeze', {'X': ['c']}, {'Out': ['u']}, {'axes': [0]}),
        _sub('squeeze', {'X': ['u']}, {'Out': ['v']}, {'axes': [0]})],
        {'x': RND(3, 5, 8)}, ['o', 'v'], 0),
    'dropout_at_test_time': ([
        _sub('dropout', {'X': ['x']}, {'Out': ['a'], 'Mask': ['m']},
             {'dropout_prob': 0.3, 'is_test': True,
              'dropout_implementation': 'downgrade_in_infer'}),
        _sub('dropout', {'X': ['a']}, {'Out': ['o'], 'Mask': ['n']},
             {'dropout_prob': 0.3, 'is_test': True,
              'dropout_implementation': 'upscale_in_train'})],
        {'x': RND(4, 8)}, ['o', 'm'], 0),
    'loss_tail': ([
        _sub('fill_constant_batch_size_like', {'Input': ['p']},
             {'Out': ['one']}, {'shape': [-1, 6], 'value': 1.0,
                                'dtype': 'float32'}),
        _sub('elementwise_sub', {'X': ['one'], 'Y': ['p']}, {'Out': ['w']},
             {'axis': -1}),
        _sub('squeeze', {'X': ['c']}, {'Out': ['s']}, {'axes': [2]}),
        _sub('elementwise_mul', {'X': ['s'], 'Y': ['w']}, {'Out': ['o']},
             {'axis': -1})],
        {'p': (R.rand(3, 6) > 0.7).astype('float32'), 'c': RND(3, 6, 1)},
        ['o', 'w'], 0),
    'residual_layer_norm': ([
        _sub('elementwise_add', {'X': ['x'], 'Y': ['b']}, {'Out': ['a']},
             {'axis': 2}),
        _sub('elementwise_add', {'X': ['r'], 'Y': ['a']}, {'Out': ['h']},
             {'axis': -1}),
        {'type': 'layer_norm',
         'inputs': {'X': ['h'], 'Scale': ['g'], 'Bias': ['be']},
         'outputs': {'Y': ['o'], 'Mean': ['mu'], 'Variance': ['var']},
         'input_is_list': {'X': False, 'Scale': False, 'Bias': False},
         'output_is_list': {'Y': False, 'Mean': False, 'Variance': False},
         'attrs': {'epsilon': 1e-5, 'begin_norm_axis': 2},
         'stop_grad': ['mu', 'var']}],
        {'x': RND(2, 5, 16), 'b': RND(16), 'r': RND(2, 5, 16),
         'g': POS(16), 'be': RND(16)}, ['o', 'h'], 1e-5),
}


class _JaxCtx(object):
    amp = False


def _jax_replay(attrs, vals, amp=False):
    ctx = _JaxCtx()
    ctx.amp = amp
    xs = [jnp.asarray(vals[n]) for n in attrs['arg_names']]
    return [np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                       else v)
            for v in jfused.fused_elementwise(ctx, {'X': xs},
                                              attrs)['Out']]


def _port_ctx(amp=False):
    ectx = treg.ExecCtx('cpu', 11, 0, amp=amp)
    return ectx.for_op(0, tf.Program().global_block().append_op(
        'fused_elementwise', infer_shape=False))


def _port_replay(attrs, vals, amp=False):
    xs = [torch.from_numpy(np.ascontiguousarray(vals[n]))
          for n in attrs['arg_names']]
    return tfused.fused_elementwise(_port_ctx(amp), {'X': xs}, attrs)['Out']


@pytest.mark.parametrize('name', sorted(SWEEP))
def test_plain_version_matches_the_jax_replay(name):
    subs, vals, outs, rtol = SWEEP[name]
    attrs = _attrs(subs, list(vals), outs)
    ref = _jax_replay(attrs, vals)
    got = [t.numpy() for t in _port_replay(attrs, vals)]
    for n, a, b in zip(outs, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, n
        if rtol:
            np.testing.assert_allclose(a, b, rtol=rtol,
                                       atol=1e-5 if rtol >= 1e-5 else 1e-12,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(a, b, err_msg=n)
    # the port plans it for the card without an unsupported sub-op
    plan = tkg.plan_for(attrs, tkg.avals_of(
        [torch.from_numpy(np.asarray(vals[n])) for n in attrs['arg_names']]),
        False)
    assert plan.n_kernels + plan.n_dsteps + plan.n_glue >= 1


def test_amp_match_inside_a_group_matches_jax():
    """Under AMP a bf16 operand pulls the float32 one down to bf16 before
    the add (core/amp.py), in both packages."""
    subs = [_sub('elementwise_add', {'X': ['x'], 'Y': ['b']}, {'Out': ['h']},
                 {'axis': -1}),
            _sub('scale', {'X': ['h']}, {'Out': ['o']}, {'scale': 3.0})]
    attrs = _attrs(subs, ['x', 'b'], ['o'])
    x = RND(4, 8)
    b = RND(8)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ctx = _JaxCtx()
    ctx.amp = True
    ref = jfused.fused_elementwise(ctx, {'X': [jnp.asarray(x, jnp.bfloat16),
                                               jnp.asarray(b)]}, attrs)['Out']
    got = tfused.fused_elementwise(_port_ctx(True), {'X': [
        xb, torch.from_numpy(b)]}, attrs)['Out']
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  np.asarray(ref[0].astype(jnp.float32)))


# ------------------------------------------- the plan executor on the CPU

@pytest.fixture
def segments_by_replay(monkeypatch):
    """Route CPU fused ops through run_fused, with every generated launch
    replaced by its segment's plain replay."""
    monkeypatch.setattr(tkg, '_launch', lambda spec, ents: [
        o.detach() for o in spec.replay(list(ents))])
    monkeypatch.setattr(tfused, 'replay', tkg.run_fused)


@pytest.mark.parametrize('name', sorted(SWEEP))
def test_plan_executor_matches_the_replay(name, segments_by_replay):
    subs, vals, outs, _ = SWEEP[name]
    attrs = _attrs(subs, list(vals), outs)
    ref = [t.numpy() for t in _port_replay(attrs, vals)]
    xs = [torch.from_numpy(np.ascontiguousarray(vals[n])) for n in vals]
    got = tkg.run_fused(_port_ctx(), xs, attrs, False)
    for n, a, b in zip(outs, got, ref):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)


def _train(steps=3):
    main, startup, out = _build(tf, ttr)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    feed = ttr.synthetic_batch(np.random.RandomState(3), 4, 16, 128)
    with tf.scope_guard(scope):
        exe.run(startup)
        losses = [exe.run(main, feed=feed, fetch_list=[out['loss']])[0][0]
                  for _ in range(steps)]
    return losses, {n: t.clone() for n, t in scope.vars.items()}


def test_plan_executor_trains_like_the_replay(monkeypatch):
    """Three steps of the 2-layer transformer (dropout 0.1): losses,
    parameters and Adam moments bit for bit, so the segments' autograd
    Functions, the drawn masks and the adam_multi step are right."""
    ref_losses, ref_state = _train()
    monkeypatch.setattr(tkg, '_launch', lambda spec, ents: [
        o.detach() for o in spec.replay(list(ents))])
    monkeypatch.setattr(tfused, 'replay', tkg.run_fused)
    launches = []
    real = tkg._SegmentFn.apply
    monkeypatch.setattr(tkg._SegmentFn, 'apply',
                        lambda *a: launches.append(1) or real(*a))
    losses, state = _train()
    assert launches, 'no segment ran under autograd'
    assert losses == ref_losses
    for n in ref_state:
        assert torch.equal(state[n], ref_state[n]), n


# ---------------------------------------------------- generated source

def test_generated_source_is_deterministic_and_shared_across_layers():
    groups = _port_fused_groups()
    names = []
    for attrs, avals in groups:
        names += tkg.plan_for(attrs, avals, False).kernels
    first = tkg.generated_source(set(names))
    tbuilder.clear_plans()
    tbuilder.SOURCES.clear()
    names2 = []
    for attrs, avals in _port_fused_groups():
        names2 += tkg.plan_for(attrs, avals, False).kernels
    assert names2 == names
    assert tkg.generated_source(set(names2)) == first
    # 2 layers, each kind of segment once per layer: the identical
    # segments of the layers share one function
    assert len(set(names)) < len(names)
    assert len(set(names)) == first.count('extern "C" int ')
    assert '__fadd_rn' in first and 'kg_ldv<V, CS, F>' in first


@pytest.mark.parametrize('eff,out', [
    ((8,), (4, 6, 8)), ((4, 1, 1, 5), (4, 3, 5, 5)),
    ((1, 1, 5, 5), (2, 1, 5, 5)), ((4, 6, 1), (4, 6, 8)), ((1,), (3, 2)),
    ((3, 1, 2), (3, 4, 2)), ((2, 5), (2, 5))])
def test_broadcast_index_maps(eff, out):
    expr = tbuilder._index_expr(eff, out)
    py = re.sub(r'(\d+)LL', r'\1', expr).replace('/', '//')
    src = np.arange(int(np.prod(eff))).reshape(eff)
    want = np.broadcast_to(src, out).reshape(-1)
    got = np.array([eval(py, {'i': i}) for i in range(want.size)])
    np.testing.assert_array_equal(got, want)
    assert tbuilder._index_expr((3,), (4, 6)) is None


def test_every_registered_fusable_op_has_a_rule():
    from paddle_tpu_torch.core.passes.fuse import FUSABLE_OPS
    registered = {n for n in FUSABLE_OPS if treg.has_op(n)}
    assert registered - set(tkg.KERNEL_RULES) == set()
    assert set(tkg.KERNEL_RULES) <= FUSABLE_OPS


def test_unsupported_sub_op_raises_naming_itself():
    # every fusable op has a rule: a sub-op of another type (top_k, which
    # the fuse pass never fuses) stands for one without
    attrs = _attrs([_sub('top_k', {'X': ['x']}, {'Out': ['o']}, {'k': 1}),
                    _sub('relu', {'X': ['o']}, {'Out': ['p']})],
                   ['x'], ['p'])
    assert tkg.unsupported_sub_ops(attrs) == ['top_k']
    with pytest.raises(tkg.KernelgenUnsupported, match="'top_k'"):
        tkg.plan_for(attrs, (((4,), 'float32'),), False)
    # float16 is no dtype of a generated kernel
    cast = _attrs([_sub('cast', {'X': ['x']}, {'Out': ['o']},
                        {'out_dtype': 'float16'})], ['x'], ['o'])
    with pytest.raises(tkg.KernelgenUnsupported, match="'cast'"):
        tkg.plan_for(cast, (((4,), 'float32'),), False)


def test_no_card_no_build(monkeypatch):
    """Building generated kernels needs nvcc: where there is none the
    build raises, it never falls back."""
    monkeypatch.setenv('PATH', '/nonexistent')
    from paddle_tpu_torch.kernels import build
    if os.path.exists('/usr/local/cuda/bin/nvcc'):
        pytest.skip('this machine has the CUDA toolkit')
    with pytest.raises(RuntimeError, match='nvcc'):
        build.build_generated('// nothing\n')


# ---------------------------------------------------- the tile table

def _multi_group_segment():
    """One segment of five groups, none of a size that divides by 4 or 8
    but the first, over float32, bf16 and bool operands, with a size-1
    chain: float32 add + relu at 40,000 (and an add of the size-1 value),
    a bf16 mul at 1,003, a float32 less_than (a bool out) at 37, an
    int32 add at 4,099, a logical_not of a bool at 777."""
    subs = [
        _sub('elementwise_add', {'X': ['a'], 'Y': ['b']}, {'Out': ['c']}),
        _sub('relu', {'X': ['c']}, {'Out': ['d']}),
        _sub('elementwise_mul', {'X': ['e'], 'Y': ['f']}, {'Out': ['h']}),
        _sub('less_than', {'X': ['k'], 'Y': ['m']}, {'Out': ['q']}),
        _sub('scale', {'X': ['s']}, {'Out': ['t']}, {'scale': 2.0}),
        _sub('elementwise_add', {'X': ['a2'], 'Y': ['t']}, {'Out': ['c2']}),
        _sub('elementwise_add', {'X': ['i1'], 'Y': ['i2']}, {'Out': ['i3']}),
        _sub('logical_not', {'X': ['l1']}, {'Out': ['l2']}),
    ]
    args = ['a', 'b', 'e', 'f', 'k', 'm', 's', 'a2', 'i1', 'i2', 'l1']
    avals = (((40000,), 'float32'),) * 2 + (((1003,), 'bfloat16'),) * 2 + \
        (((37,), 'float32'),) * 2 + (((1,), 'float32'),
                                      ((40000,), 'float32')) + \
        (((4099,), 'int32'),) * 2 + (((777,), 'bool'),)
    attrs = _attrs(subs, args, ['d', 'h', 'q', 't', 'c2', 'i3', 'l2'])
    plan = tkg.plan_for(attrs, avals, False)
    specs = [st[1] for st in plan.steps if st[0] == 'kernel']
    assert len(specs) == 1
    return specs[0]


def _read_tile_table(src):
    """(threads, grid, [(N, V, end block, first block, tile elements)])
    from a segment's generated source."""
    grid, threads = map(int, re.search(r'<<<(\d+)u, (\d+), 0', src).groups())
    heads = re.findall(
        r'if \(b < (\d+)u\) \{  // group \d+: N (\d+), V (\d+),', src)
    bases = re.findall(r'b0 = \(long long\)\(b - (\d+)u\) \* (\d+)LL', src)
    assert len(heads) == len(bases)
    return threads, grid, [(int(n), int(v), int(end), int(s), int(t))
                           for (end, n, v), (s, t) in zip(heads, bases)]


def test_the_tile_table_runs_every_element_of_every_group_once():
    """Each block b takes the first group whose end block exceeds it and
    runs its tile b - first: thread x's vector starts at (b - first)
    tile + x V and holds min(V, N - start) elements."""
    spec = _multi_group_segment()
    src = tkg.generated_source([spec.name])
    threads, grid, table = _read_tile_table(src)
    assert threads == spec.layout.threads
    assert [g[0] for g in table] == sorted(spec.groups, reverse=True)
    runs = {n: np.zeros(n, np.int64) for n, *_ in table}
    x = np.arange(threads)
    for b in range(grid):
        n, v, end, first, tile = next(g for g in table if b < g[2])
        assert first <= b and tile == threads * v
        start = (b - first) * tile + x * v
        for j in range(v):
            idx = start + j
            np.add.at(runs[n], idx[idx < n], 1)
    for n, hits in runs.items():
        assert (hits == 1).all(), (n, hits.min(), hits.max())
    # no block is idle beyond a group's last tile, and the grid is the sum
    assert table[-1][2] == grid == sum(g['tiles'] for g in
                                       spec.layout.groups)


def test_each_group_takes_the_vector_width_of_its_widest_operand():
    """16 bytes of the widest operand a vector: 4 for the float32 and
    int32 groups and for the float32 comparison with a bool out (its bool
    in 4-byte accesses), 8 for the bf16 one, 16 for the bool one; the
    vector path's pointers are the group's own flat ones."""
    spec = _multi_group_segment()
    widths = {g['n']: g['v'] for g in spec.layout.groups}
    assert widths == {40000: 4, 4099: 4, 1003: 8, 37: 4, 777: 16}
    assert tbuilder.Layout([(37, 4, ())], 0).groups[0]['v'] == 4
    assert tbuilder.Layout([(37, 2, ())], 0).groups[0]['v'] == 8
    sizes = [tbuilder._size(s) for s, _ in spec.entry_avals] + \
        [tbuilder._size(s) for s, _ in spec.esc_aval]
    for g in spec.layout.groups:
        assert {sizes[ix] for ix in g['ptrs']} == {g['n']}
    # the launch's vector bits: aligned pointers take the vector path,
    # one pointer off 16 bytes takes its group (and only it) off
    n = len(sizes)
    ptrs = [4096 * (k + 1) for k in range(n)]
    assert tkg.vector_groups(spec, ptrs) == [True] * len(spec.layout.groups)
    off = spec.layout.groups[1]['ptrs'][0]
    ptrs[off] += 4
    assert tkg.vector_groups(spec, ptrs) == [
        gi != 1 for gi in range(len(spec.layout.groups))]


def test_threads_and_vectors_a_thread_follow_the_sizes():
    """A large float32 group runs 256 threads, a small segment 128; a
    segment in STREAM_BYTES' range streams, one past it does not; a
    thread runs one vector, and a group's tiles follow the one before
    it."""
    lay = tbuilder.Layout([(4 << 20, 4, ())], 48 << 20)
    assert (lay.threads, lay.groups[0]['tile'], lay.streaming) == \
        (256, 1024, True)
    assert not tbuilder.Layout([(64 << 20, 4, ())], 512 << 20).streaming
    lay = tbuilder.Layout([(64, 4, ()), (1000, 4, ())], 8000)
    assert lay.threads == 128 and not lay.streaming
    assert [g['tiles'] for g in lay.groups] == [1, 2]
    assert [g['start'] for g in lay.groups] == [0, 1] and lay.grid == 3
