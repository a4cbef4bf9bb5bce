"""bf16 serving (`AnalysisConfig.enable_bf16`) through both packages on
the CPU: the llama `tiny` inference model, saved by each package, loaded
with enable_bf16() into the JAX Predictor and the port's.

Tolerance, derived.  Both Predictors cast every float32 parameter to
bfloat16 and run the same ops, each rounding its output to bf16 (unit
roundoff u = 2^-8).  A logit depends on R = 12 L + 2 such roundings along
its longest path (per layer: the two RMS norms, the q/k/v projection,
rope, attention, the output projection, the two residual adds, the gate /
up projection, swish, the gate product and the down projection; then the
final norm and the LM projection).  The packages round in the same
places but from float32 values that differ in the last bits (summation
order, library pow/sin/cos, XLA's excess precision inside a fusion), so
each rounding may land differently.  Taking each rounding error as an
independent draw, uniform within +-u of the value (variance u^2 / 3),
propagated at the logits' scale M = max|logit| through the normalised
blocks, the two packages' logits differ with standard deviation
sqrt(2 R / 3) u M; the check allows four of them:

    tol = 4 sqrt(2 R / 3) 2^-8 M      (0.065 M for tiny, L = 2)

Greedy tokens must be equal wherever the top-two gap exceeds 2 tol.  The
bound is loose beside the measured difference (about 0.01 M here), so the
parameter and fetch dtype checks, not the bound, are what catch a
Predictor that did not cast."""
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.models import llama as jllama
import paddle_tpu_torch as tf
from paddle_tpu_torch.models import llama as tllama
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

R_PER_LAYER = 12


def _bf16_tol(M, n_layer, packages=2):
    """The derived bound above; packages=1 for one bf16 run against a
    float32 run (only one side rounds)."""
    R = R_PER_LAYER * n_layer + 2
    return 4.0 * np.sqrt(packages * R / 3.0) * 2.0 ** -8 * M


@pytest.fixture(autouse=True)
def fresh_port_programs(monkeypatch):
    """Fresh default programs, scope and name generator for the port (the
    root conftest does the same for the JAX package), and the JAX side's
    compile cache off."""
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


def _save(path, writer):
    """The tiny decode program, initialized and saved by `writer`'s
    package, with the [B, T, V] logits and the next token as targets."""
    fluid, llama = (jf, jllama) if writer == 'jax' else (tf, tllama)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = llama.generation_program('tiny', mode='decode')
    exe = fluid.Executor() if writer == 'jax' else fluid.Executor(
        fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(str(path), ['tokens'],
                                      [out['logits'], out['next_token']],
                                      exe, main)
    return out['config']


def _predictors(path):
    jc = jf.inference.AnalysisConfig(str(path))
    jc.enable_bf16()
    tc = tf.inference.AnalysisConfig(str(path))
    tc.enable_bf16()
    tc.disable_gpu()
    return jf.inference.Predictor(jc), tf.inference.Predictor(tc)


def _feed(cfg, rows, seed):
    rng = np.random.RandomState(seed)
    return {'tokens': rng.randint(0, cfg['vocab'],
                                  (rows, cfg['max_len'], 1)).astype('int64')}


def _agree_bf16(logits, ref, n_layer, tokens=None, ref_tokens=None):
    got, ref = np.asarray(logits, np.float32), np.asarray(ref, np.float32)
    tol = _bf16_tol(float(np.abs(ref).max()), n_layer)
    assert float(np.abs(got - ref).max()) <= tol
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
    assert clear.sum() >= 1
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(ref, -1)[clear])
    if tokens is not None:
        last = clear[:, -1]
        np.testing.assert_array_equal(tokens[last], ref_tokens[last])
    return tol


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_bf16_predictors_agree(tmp_path, writer):
    cfg = _save(tmp_path, writer)
    jpred, tpred = _predictors(tmp_path)
    assert tpred._config.use_bf16 and jpred._config.use_bf16
    # every float parameter is bf16 in both scopes
    tparams = tpred._scope.vars
    assert set(tparams) == set(jpred._scope.vars)
    for n, v in tparams.items():
        assert v.dtype == torch.bfloat16, n
        assert str(jpred._scope.vars[n].dtype) == 'bfloat16', n
        assert v.device.type == 'cpu'
    feed = _feed(cfg, 3, seed=0)
    jlogits, jtok = jpred.run(feed)
    logits, tok = tpred.run(feed)
    # the fetch dtypes are the JAX Predictor's: bf16 logits, int32 tokens
    assert logits.dtype == jlogits.dtype and str(logits.dtype) == 'bfloat16'
    assert tok.dtype == jtok.dtype == np.int32
    assert logits.shape == jlogits.shape == (3, cfg['max_len'],
                                             cfg['vocab'])
    _agree_bf16(logits, jlogits, cfg['n_layer'], tok, jtok)


def test_bf16_fetch_keeps_the_bits():
    t = torch.tensor([1.0, -2.5, 3.140625, 1e-3]).to(torch.bfloat16)
    a = tf.inference._fetch_numpy(t)
    assert str(a.dtype) == 'bfloat16'
    np.testing.assert_array_equal(a.astype(np.float32), t.float().numpy())


def test_bf16_predictor_is_near_the_float32_one(tmp_path):
    """One bf16 run against the float32 run of the same model: within the
    one-package form of the bound (only the bf16 side rounds)."""
    cfg = _save(tmp_path, 'port')
    conf = tf.inference.AnalysisConfig(str(tmp_path))
    conf.disable_gpu()
    f32 = tf.inference.Predictor(conf)
    _, b16 = _predictors(tmp_path)
    feed = _feed(cfg, 2, seed=1)
    ref = f32.run(feed)[0]
    got = np.asarray(b16.run(feed)[0], np.float32)
    assert ref.dtype == np.float32
    err = float(np.abs(got - ref).max())
    assert 0 < err <= _bf16_tol(float(np.abs(ref).max()), cfg['n_layer'],
                                packages=1)


def test_bf16_attention_reaches_flash_as_contiguous_bf16(tmp_path,
                                                         monkeypatch):
    """q, k and v reach flash_forward as contiguous bf16, so on the card
    K1's bf16 kernel (flash_fwd_wgmma_kernel) runs, not the float32 one."""
    from paddle_tpu_torch.ops import attention as att
    seen = []
    real = att.flash_forward

    def spy(q, k, v, *a, **kw):
        seen.append([(t.dtype, t.is_contiguous()) for t in (q, k, v)])
        return real(q, k, v, *a, **kw)

    cfg = _save(tmp_path, 'port')
    _, tpred = _predictors(tmp_path)
    monkeypatch.setattr(att, 'flash_forward', spy)
    tpred.run(_feed(cfg, 1, seed=2))
    assert len(seen) == cfg['n_layer']
    assert all(s == [(torch.bfloat16, True)] * 3 for s in seen)


def test_bf16_program_plans_generated_kernels_for_the_card(tmp_path):
    """The executor's planning pass (the one the card runs before a
    program's first launch) builds a generated-kernel plan for every fused
    group of the bf16 served program: the segment, glue and attention
    rules take bf16."""
    from paddle_tpu_torch.core import executor, passes
    from paddle_tpu_torch.ops import kernelgen
    cfg = _save(tmp_path, 'port')
    _, tpred = _predictors(tmp_path)
    opt, _ = passes.maybe_optimize(tpred._program, tpred._fetch_names)
    ops = opt.global_block().ops
    env = dict(tpred._scope.vars)
    env['tokens'] = torch.zeros((2, cfg['max_len'], 1), dtype=torch.int32)
    kernelgen.clear_plans()
    executor._plan_kernels(ops, env, False)
    plans = kernelgen.builder._PLANS
    assert sum(op.type == 'fused_elementwise' for op in ops) > 0
    assert plans, 'no generated-kernel plan was built'
    dtypes = {dt for key in plans for dt in str(key).split("'")
              if dt in ('bfloat16', 'float32')}
    assert 'bfloat16' in dtypes


def test_bf16_serving_engine_rows_equal_the_predictor_alone(tmp_path):
    cfg = _save(tmp_path, 'port')
    _, pred = _predictors(tmp_path)
    eng = tf.serving.ServingEngine.from_predictor(
        pred, bucketer=tf.FeedBucketer([1, 2, 4]),
        config=tf.serving.ServingConfig(max_batch_rows=4))
    feeds = [_feed(cfg, 1 + i % 2, seed=10 + i) for i in range(4)]
    with eng:
        futs = [eng.submit(f) for f in feeds]
        results = [f.result(60) for f in futs]
    assert all(r.ok for r in results)
    for f, r in zip(feeds, results):
        logits, tok = r.outputs
        assert str(logits.dtype) == 'bfloat16'
        ref_logits, ref_tok = pred.run(f)
        _agree_bf16(logits, ref_logits, cfg['n_layer'], tok, ref_tok)


def test_bf16_predictor_needs_disable_gpu_to_run_here(tmp_path,
                                                      monkeypatch):
    _save(tmp_path, 'port')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    conf = tf.inference.AnalysisConfig(str(tmp_path))
    conf.enable_bf16()
    with pytest.raises(RuntimeError, match='CUDA'):
        tf.inference.Predictor(conf)
    conf.disable_gpu()
    assert tf.inference.Predictor(conf).device.type == 'cpu'
