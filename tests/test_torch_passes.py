"""The port's PT_OPT rewriter (paddle_tpu_torch/core/passes) against the
JAX package's: the same programs, built through both packages, optimize
to the same program.  Compared: the optimized op types in order, each
fused group's sub-op types, arg_names and out_names, every op's
rng_stream, and the pass statistics.  Then the port alone: the pipeline
is idempotent, leaves its input alone, honours PT_OPT / PT_OPT_SKIP, and
the rng_stream repair keeps a dropout's mask when the rewriter deletes an
op ahead of it.  The reference's `shard` pass has no counterpart yet; it
is inert without a mesh, so the results agree."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.core import passes as jpasses
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import transformer as jtr
import paddle_tpu_torch as tf
from paddle_tpu_torch.core import passes as tpasses
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models import transformer as ttr
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

SMALL = dict(src_vocab=128, trg_vocab=128, max_len=16, n_layer=2, n_head=4,
             d_model=64, d_inner=128)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    """Fresh default programs, scope and name generator for the port (the
    root conftest does the same for the JAX package)."""
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


def _transformer(fluid, tr, use_flash, dropout):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = tr.build(use_flash=use_flash, dropout=dropout, **SMALL)
    return main, startup, [out['loss'].name]


def _llama(fluid, llama):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = llama.generation_program('tiny', mode='decode')
    return main, startup, [out['logits'].name, out['next_token'].name]


PROGRAMS = {
    'transformer_composed': lambda f, m: _transformer(f, m, False, 0.1),
    'transformer_flash': lambda f, m: _transformer(f, m, True, 0.0),
    'llama_decode': _llama,
}
_MODELS = {'transformer_composed': (jtr, ttr), 'transformer_flash': (jtr, ttr),
           'llama_decode': (jllama, tllama)}


def _both(name):
    jm, tm = _MODELS[name]
    return PROGRAMS[name](jf, jm), PROGRAMS[name](tf, tm)


def _summary(program):
    """What the comparison reads of an optimized program."""
    ops = []
    for op in program.global_block().ops:
        row = {'type': op.type, 'rng_stream': op.attrs.get('rng_stream'),
               'inputs': op.inputs, 'outputs': op.outputs}
        if op.type == 'fused_elementwise':
            row['sub_ops'] = [(s['type'], s['attrs'].get('rng_stream'))
                              for s in op.attrs['sub_ops']]
            row['arg_names'] = list(op.attrs['arg_names'])
            row['out_names'] = list(op.attrs['out_names'])
        ops.append(row)
    return ops


def _stats(stats):
    fuse = stats['passes']['fuse_elementwise']
    return {'ops_fused': stats['ops_fused'], 'chains': fuse['chains'],
            'max_chain': fuse['max_chain'],
            'ops_removed': stats['ops_removed'],
            'op_count_raw': stats['op_count_raw'],
            'op_count_opt': stats['op_count_opt'],
            'ops_folded': stats['passes']['const_fold']['ops_folded']}


@pytest.mark.parametrize('name', sorted(PROGRAMS))
@pytest.mark.parametrize('which', ['main', 'startup'])
def test_optimized_program_matches_the_reference(name, which):
    (jm, js, jfetch), (tm, ts, tfetch) = _both(name)
    jprog, tprog = (jm, tm) if which == 'main' else (js, ts)
    fetch = jfetch if which == 'main' else []
    assert tfetch == jfetch
    jopt, jstats = jpasses.optimize_program(jprog, fetch)
    topt, tstats = tpasses.optimize_program(tprog, fetch)
    assert _summary(topt) == _summary(jopt)
    assert _stats(tstats) == _stats(jstats)
    if which == 'main' and name.startswith('transformer'):
        assert tstats['ops_fused'] > 0 and tstats['ops_removed'] > 0


def test_the_fused_adam_group_and_the_backward_readers():
    """The 2-layer training program: one fused group holds every adam
    update after `__backward__`; no run crosses `__backward__`."""
    _, (tm, _, fetch) = _both('transformer_composed')
    topt, _ = tpasses.optimize_program(tm, fetch)
    ops = topt.global_block().ops
    bw = [i for i, op in enumerate(ops) if op.type == '__backward__']
    assert len(bw) == 1
    after = ops[bw[0] + 1:]
    assert [op.type for op in after] == ['fused_elementwise']
    subs = [s['type'] for s in after[0].attrs['sub_ops']]
    assert subs == ['adam'] * len(tm.all_parameters())
    types = [op.type for op in ops]
    assert 'softmax' not in types and 'dropout' not in types


def _desc(program):
    d = json.loads(json.dumps(tf.io.program_to_desc(program)))
    for b in d['blocks']:
        for op in b['ops']:
            op.pop('source_loc')
    return d


@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_pipeline_is_idempotent_and_leaves_its_input(name):
    _, (tm, _, fetch) = _both(name)
    before = _desc(tm)
    once, _ = tpasses.optimize_program(tm, fetch)
    twice, stats = tpasses.optimize_program(once, fetch)
    assert _desc(tm) == before
    assert _desc(twice) == _desc(once)
    assert stats['ops_fused'] == 0 and stats['ops_removed'] == 0


def test_env_switches_and_memo(monkeypatch):
    _, (tm, _, fetch) = _both('transformer_composed')
    monkeypatch.setenv('PT_OPT', '0')
    assert tpasses.maybe_optimize(tm, fetch) == (tm, None)
    monkeypatch.setenv('PT_OPT', '1')
    a = tpasses.maybe_optimize(tm, fetch)
    assert tpasses.maybe_optimize(tm, fetch)[0] is a[0]   # memoized
    monkeypatch.setenv('PT_OPT_SKIP', 'fuse_elementwise')
    opt, stats = tpasses.maybe_optimize(tm, fetch)
    assert 'fuse_elementwise' not in stats['passes']
    assert 'fused_elementwise' not in [o.type for o in opt.global_block().ops]
    with tf.program_guard(tm, tf.Program()):
        tf.layers.scale(tm.global_block().var(fetch[0]), scale=2.0)
    assert tpasses.maybe_optimize(tm, fetch)[0] is not opt  # version bump


def _dead_op_then_dropout():
    main, startup = tf.Program(), tf.Program()
    main.random_seed = 5
    with tf.program_guard(main, startup), tf.unique_name.guard():
        x = tf.layers.data('x', shape=[64], dtype='float32')
        tf.layers.scale(x, scale=3.0)        # nothing reads it
        h = tf.layers.relu(x)
        y = tf.layers.dropout(h, 0.5,
                              dropout_implementation='upscale_in_train')
    return main, y


def test_deleting_an_op_ahead_of_a_dropout_keeps_its_mask(monkeypatch):
    """The dead scale op sits ahead of the dropout.  PT_OPT=1 deletes it
    (DCE) and fuses relu + dropout into one op at position 0; the pinned
    rng_stream keeps the draw the unfused program makes (PT_OPT=0), bit
    for bit."""
    feed = {'x': np.random.RandomState(0).rand(8, 64).astype('float32') + .1}
    outs = {}
    for mode in ('0', '1'):
        monkeypatch.setenv('PT_OPT', mode)
        main, y = _dead_op_then_dropout()
        outs[mode] = tf.Executor(tf.CPUPlace()).run(main, feed=feed,
                                                    fetch_list=[y])[0]
    np.testing.assert_array_equal(outs['1'], outs['0'])
    main, y = _dead_op_then_dropout()
    opt_prog, stats = tpasses.optimize_program(main, [y.name])
    assert stats['ops_removed'] == 1
    assert [o.type for o in opt_prog.global_block().ops] == \
        ['fused_elementwise']
    kept = (outs['0'] != 0).mean()
    assert 0.35 < kept < 0.65


def test_registry_prefers_the_pinned_stream():
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.framework import Operator
    ectx = registry.ExecCtx('cpu', 3, 0)
    op = Operator(tf.Program().global_block(), 'dropout')
    a = torch.rand(4, generator=ectx.for_op(7, op).generator())
    op.attrs['rng_stream'] = 2
    b = torch.rand(4, generator=ectx.for_op(7, op).generator())
    c = torch.rand(4, generator=ectx.for_op(2, Operator(
        tf.Program().global_block(), 'dropout')).generator())
    assert not torch.equal(a, b) and torch.equal(b, c)
    sub = {'type': 'dropout', 'attrs': {'rng_stream': 2}}
    d = torch.rand(4, generator=ectx.for_op(9, op).sub_ctx(sub).generator())
    assert torch.equal(d, c)


def test_the_predictor_runs_the_optimized_program(tmp_path):
    """The Predictor goes through the Executor, so it runs the rewritten
    program, as the reference's Predictor optimizes before lowering."""
    main, startup, fetch = _llama(tf, tllama)
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup)
    block = main.global_block()
    tf.io.save_inference_model(str(tmp_path), ['tokens'],
                               [block.var(n) for n in fetch], exe, main)
    conf = tf.inference.AnalysisConfig(str(tmp_path))
    conf.disable_gpu()
    pred = tf.inference.Predictor(conf)
    T = int(block.var('tokens').shape[1])
    tokens = np.random.RandomState(0).randint(0, 64, (2, T, 1))
    pred.run({'tokens': tokens})
    memo = pred._program._opt_memo
    assert len(memo) == 1
    (opt, stats), = memo.values()
    assert stats['ops_fused'] > 0
    assert 'fused_elementwise' in [o.type for o in opt.global_block().ops]
