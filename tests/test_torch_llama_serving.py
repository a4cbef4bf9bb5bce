"""The serving slice end to end on the CPU: the llama generation program
through both packages — program desc, saved model directories in both
directions, weights carried in memory, the serving engine, and the rule
that the port never carries on on the CPU unless asked to.

Logit tolerance: rtol 1e-5 plus atol 1e-5 of the largest |logit|.  Both
packages compute in float32, but XLA and PyTorch sum the matrix products
in other orders, and XLA's pow/sin/cos (rope) differ from PyTorch's by a
few units in the last place, so the error scales with the logits'
magnitude (about 1e-6 of it at these sizes) rather than with each element.
Greedy tokens must be equal wherever the top-two logit gap exceeds the
tolerance: with random weights, near-ties are real."""
import json
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.models import llama as jllama
import paddle_tpu_torch as tf
from paddle_tpu_torch.models import llama as tllama
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)


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


def _build(fluid, llama, mode='decode', **overrides):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = llama.generation_program('tiny', mode=mode, **overrides)
    return main, startup, out


def _desc(fluid, program):
    d = json.loads(json.dumps(fluid.io.program_to_desc(program)))
    for b in d['blocks']:
        for op in b['ops']:
            op.pop('source_loc')
    return d


def _jax_model_dir(path, **overrides):
    main, startup, out = _build(jf, jllama, **overrides)
    exe, scope = jf.Executor(), jf.Scope()
    with jf.scope_guard(scope):
        exe.run(startup)
        jf.io.save_inference_model(str(path), ['tokens'],
                                   [out['logits'], out['next_token']], exe,
                                   main)
    return out['config'], scope


def _port_predictor(path):
    config = tf.inference.AnalysisConfig(str(path))
    config.disable_gpu()
    return tf.inference.Predictor(config)


def _feed(cfg, rows, seed):
    rng = np.random.RandomState(seed)
    return {'tokens': rng.randint(0, cfg['vocab'],
                                  (rows, cfg['max_len'], 1)).astype('int64')}


def _assert_agree(logits, ref, tokens=None, ref_tokens=None):
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(logits, ref, rtol=1e-5, atol=tol)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 4 * tol
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.argmax(logits, -1)[clear],
                                  np.argmax(ref, -1)[clear])
    if tokens is not None:
        last = clear[:, -1]
        assert tokens.dtype == ref_tokens.dtype == np.int32
        np.testing.assert_array_equal(tokens[last], ref_tokens[last])


# ---------------------------------------------------------- (a) program

@pytest.mark.parametrize('mode', ['decode', 'prefill'])
def test_same_program_desc(mode):
    main, startup, _ = _build(jf, jllama, mode=mode)
    tmain, tstartup, _ = _build(tf, tllama, mode=mode)
    assert _desc(tf, tmain) == _desc(jf, main)
    assert _desc(tf, tstartup) == _desc(jf, startup)


def test_jax_desc_round_trips_through_the_port():
    main, _, _ = _build(jf, jllama)
    pruned = main._prune(['tokens'], [main.global_block().var(n) for n in
                                      ('sample_tokens_0.tmp_0',)])
    desc = json.loads(json.dumps(jf.io.program_to_desc(pruned)))
    again = tf.io.program_to_desc(tf.io.desc_to_program(desc))
    assert json.loads(json.dumps(again)) == desc


# ----------------------------------------------- (b) same model directory

def test_port_serves_a_jax_written_model_dir(tmp_path):
    cfg, _ = _jax_model_dir(tmp_path)
    feed = _feed(cfg, 3, seed=0)
    jlogits, jtok = jf.inference.Predictor(str(tmp_path)).run(feed)
    logits, tok = _port_predictor(tmp_path).run(feed)
    assert logits.shape == (3, cfg['max_len'], cfg['vocab'])
    _assert_agree(logits, jlogits, tok, jtok)


def test_jax_serves_a_port_written_model_dir(tmp_path):
    main, startup, out = _build(tf, tllama)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    with tf.scope_guard(scope):
        exe.run(startup)
        tf.io.save_inference_model(str(tmp_path), ['tokens'],
                                   [out['logits'], out['next_token']], exe,
                                   main)
    feed = _feed(out['config'], 2, seed=1)
    logits, tok = _port_predictor(tmp_path).run(feed)
    jlogits, jtok = jf.inference.Predictor(str(tmp_path)).run(feed)
    _assert_agree(logits, jlogits, tok, jtok)


# ------------------------------- (c) the JAX side through its Pallas kernel

def test_same_model_dir_through_jax_pallas_flash_kernel(tmp_path,
                                                        monkeypatch):
    """max_len 512 meets the JAX package's _FWD_PALLAS_MIN_T, so its
    flash_attention op runs the Pallas kernel (interpret mode on the CPU);
    the spy proves it did."""
    from paddle_tpu.ops import attention as jatt
    calls = []
    real = jatt._flash_forward

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(jatt, '_flash_forward', spy)
    cfg, _ = _jax_model_dir(tmp_path, n_layer=1, max_len=512)
    feed = _feed(cfg, 2, seed=2)
    jlogits, jtok = jf.inference.Predictor(str(tmp_path)).run(feed)
    assert calls, 'the JAX side did not reach its Pallas flash kernel'
    logits, tok = _port_predictor(tmp_path).run(feed)
    _assert_agree(logits, jlogits, tok, jtok)


# ------------------------- (c') a head dim of 256, GPT-J-6B's (4096 / 16)

# d_model 512 over 2 heads: the head dim the forward's tensor-core
# instance of width 256 runs on the card (unpadded); GQA 2 / 1
D256 = dict(d_model=512, n_head=2, n_kv_head=1)


def test_port_serves_a_d256_jax_model_dir(tmp_path):
    cfg, _ = _jax_model_dir(tmp_path, **D256)
    assert cfg['d_model'] // cfg['n_head'] == 256
    feed = _feed(cfg, 3, seed=4)
    jlogits, jtok = jf.inference.Predictor(str(tmp_path)).run(feed)
    logits, tok = _port_predictor(tmp_path).run(feed)
    assert logits.shape == (3, cfg['max_len'], cfg['vocab'])
    _assert_agree(logits, jlogits, tok, jtok)


def test_d256_model_dir_through_jax_pallas_flash_kernel(tmp_path,
                                                        monkeypatch):
    """max_len 512 meets the JAX package's _FWD_PALLAS_MIN_T, so at head
    dim 256 its flash_attention op runs the Pallas kernel (interpret mode
    on the CPU); the spy proves it did."""
    from paddle_tpu.ops import attention as jatt
    calls = []
    real = jatt._flash_forward

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(jatt, '_flash_forward', spy)
    cfg, _ = _jax_model_dir(tmp_path, n_layer=1, max_len=512, **D256)
    feed = _feed(cfg, 2, seed=5)
    jlogits, jtok = jf.inference.Predictor(str(tmp_path)).run(feed)
    assert calls and calls[0][-1] == 256, calls
    logits, tok = _port_predictor(tmp_path).run(feed)
    _assert_agree(logits, jlogits, tok, jtok)


# ------------------------------------------ (d) weights carried in memory

def test_scope_from_numpy_carries_jax_weights(tmp_path):
    main, startup, out = _build(jf, jllama)
    jexe, jscope = jf.Executor(), jf.Scope()
    feed = _feed(out['config'], 2, seed=3)
    with jf.scope_guard(jscope):
        jexe.run(startup)
        jlogits, jtok = jexe.run(main, feed=feed,
                                 fetch_list=[out['logits'],
                                             out['next_token']])
    tmain, _, tout = _build(tf, tllama)
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
    tscope = tf.scope_from_numpy(arrays, tf.Scope(), 'cpu')
    # the fluid [in, out] layout is kept: no transpose into nn.Linear's
    w = tscope.vars['layer_0_ffn_fc1_w']
    assert tuple(w.shape) == (64, 128) and w.device.type == 'cpu'
    logits, tok = tf.Executor(tf.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tout['logits'], tout['next_token']],
        scope=tscope)
    _assert_agree(logits, jlogits, tok, jtok)


# --------------------------------------------------------- (e) serving

def test_serving_engine_answers_concurrent_requests(tmp_path):
    cfg, _ = _jax_model_dir(tmp_path)
    pred = _port_predictor(tmp_path)
    eng = tf.serving.ServingEngine.from_predictor(
        pred, bucketer=tf.FeedBucketer([1, 2, 4]),
        config=tf.serving.ServingConfig(max_queue=32, max_batch_rows=4))
    feeds = [_feed(cfg, 1 + i % 2, seed=10 + i) for i in range(8)]
    futs = [None] * len(feeds)

    def client(i):
        futs[i] = eng.submit(feeds[i])

    with eng:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(feeds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        results = [f.result(60) for f in futs]
    assert all(r.ok for r in results), [r.status for r in results]
    for f, r in zip(feeds, results):
        logits, tok = r.outputs
        assert logits.shape[0] == tok.shape[0] == f['tokens'].shape[0]
        ref_logits, ref_tok = pred.run(f)
        _assert_agree(logits, ref_logits, tok, ref_tok)
    c = eng.counters
    assert c.get('serving.completed') == len(feeds)
    assert c.get('serving.deadlocks') == 0
    assert c.histogram('serving.dispatched_rows')['max'] <= 4


# ------------------------------------------------------ (f) no silent CPU

def test_entry_points_refuse_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    _jax_model_dir(tmp_path)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tf.Executor()
    with pytest.raises(RuntimeError, match='CUDA'):
        tf.inference.Predictor(str(tmp_path))
    with pytest.raises(RuntimeError, match='CUDA'):
        tf.inference.Predictor(tf.inference.AnalysisConfig(str(tmp_path)))
    # asked for explicitly, the CPU is fine
    assert tf.Executor(tf.CPUPlace()).device.type == 'cpu'
    assert _port_predictor(tmp_path).device.type == 'cpu'
