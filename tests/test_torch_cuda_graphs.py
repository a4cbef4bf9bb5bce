"""Launch signatures replayed as CUDA graphs (core/graphs.py), on the card.

Marked `cuda`: each test skips without a CUDA device (decided inside the
fixture).  On the card, where the JAX package and its test conftest are
not installed, run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_graphs.py

From the same scope state and run counters, the interpreter
(`use_program_cache=False`), graph runs and `run_steps` must agree bit for
bit: the same kernels on the same inputs, the dropout masks seeded from
(program seed, run counter, stream) on every path.  The launch counters
must count a replay's launches as the interpreter counts its own.

This file imports neither jax nor paddle_tpu."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tf
from paddle_tpu_torch import kernels
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import kernelgen

pytestmark = pytest.mark.cuda

# head dim 64, the flash kernels' width; 2 layers at small width
SMALL = dict(src_vocab=128, trg_vocab=128, max_len=32, n_layer=2, n_head=2,
             d_model=128, d_inner=256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: CUDA graphs run on the card only')
    return torch.device('cuda')


def _program(dropout, use_flash, amp):
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 3
    with tf.program_guard(main, startup), tf.unique_name.guard():
        out = ttr.build(dropout=dropout, use_flash=use_flash, **SMALL)
    main.set_amp(amp)
    return main, startup, out


def _snapshot(scope):
    return {n: t.clone() for n, t in scope.vars.items()}


def _restore(scope, snap):
    for n, t in snap.items():
        scope.vars[n].copy_(t)


def _counts():
    return dict(kernels.launches), dict(kernelgen.launches)


def _delta(before):
    now = _counts()
    return ({k: v - before[0].get(k, 0) for k, v in now[0].items()},
            {k: v - before[1].get(k, 0) for k, v in now[1].items()})


@pytest.mark.parametrize('dropout,use_flash,amp', [
    (0.1, False, True), (0.0, True, True), (0.0, True, False)],
    ids=['composed_dropout_bf16', 'flash_bf16', 'flash_f32'])
def test_graph_runs_equal_the_interpreter_bitwise(cuda, dropout, use_flash,
                                                  amp):
    main, startup, out = _program(dropout, use_flash, amp)
    feeds = [ttr.synthetic_batch(np.random.RandomState(i), 4,
                                 SMALL['max_len'], SMALL['trg_vocab'])
             for i in range(4)]
    fetch = [out['loss']]
    scope, exe = tf.Scope(), tf.Executor()
    with tf.scope_guard(scope):
        exe.run(startup, use_program_cache=False)
        # one interpreter step so that the scope holds normal tensors
        exe.run(main, feed=feeds[0], fetch_list=fetch,
                use_program_cache=False)
        snap, state = _snapshot(scope), exe.rng_state()
        res = {}
        for mode in ('eager', 'graph', 'run_steps'):
            _restore(scope, snap)
            exe.set_rng_state(state)
            before = _counts()
            if mode == 'run_steps':
                losses = exe.run_steps(main, feed_list=feeds,
                                       fetch_list=fetch)[0]
            else:
                losses = np.stack([exe.run(
                    main, feed=f, fetch_list=fetch,
                    use_program_cache=mode == 'graph')[0] for f in feeds])
            res[mode] = (losses, _snapshot(scope), _delta(before))
    eager = res['eager']
    for mode in ('graph', 'run_steps'):
        got = res[mode]
        assert got[0].tobytes() == eager[0].tobytes(), mode
        differ = sorted(n for n, t in eager[1].items()
                        if not torch.equal(got[1][n], t))
        assert not differ, (mode, differ)
        # the capture's own launches are taken back: 4 steps count as 4
        assert got[2] == eager[2], mode
    assert all(v % 4 == 0 for v in eager[2][0].values())
    assert all(np.isfinite(eager[0]).ravel())


def test_a_replaced_scope_tensor_is_copied_into_the_graph(cuda):
    main, startup, out = _program(0.0, True, False)
    feed = ttr.synthetic_batch(np.random.RandomState(0), 4,
                               SMALL['max_len'], SMALL['trg_vocab'])
    scope, exe = tf.Scope(), tf.Executor()
    with tf.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):     # warm-up, capture, replay
            exe.run(main, feed=feed, fetch_list=[out['loss']])
        snap, state = _snapshot(scope), exe.rng_state()
        new_w = scope.vars['proj_w'] * 0.5
        scope.vars['proj_w'] = new_w.clone()
        got = exe.run(main, feed=feed, fetch_list=[out['loss']])[0]
        assert scope.vars['proj_w'] is not new_w
        _restore(scope, snap)
        scope.vars['proj_w'].copy_(new_w)
        exe.set_rng_state(state)
        ref = exe.run(main, feed=feed, fetch_list=[out['loss']],
                      use_program_cache=False)[0]
    assert got.tobytes() == ref.tobytes()


def test_check_nan_trips_through_the_graph(cuda):
    """A NaN in one target pad entry (composed attention: the pads reach
    the loss weights and the additive masks only) trips the verdict: named
    at nan_poll=1, a window of 8 at nan_poll=8."""
    main, startup, out = _program(0.0, False, False)
    feed = ttr.synthetic_batch(np.random.RandomState(0), 4,
                               SMALL['max_len'], SMALL['trg_vocab'])
    bad = dict(feed, trg_pad=feed['trg_pad'].copy())
    bad['trg_pad'][0, -1] = np.nan
    for poll, window in ((1, 1), (8, 8)):
        scope, exe = tf.Scope(), tf.Executor(check_nan=True, nan_poll=poll)
        with tf.scope_guard(scope):
            exe.run(startup)
            exe.poll_nan()
            for _ in range(3):     # warm-up, capture, replay: clean
                exe.run(main, feed=feed, fetch_list=[out['loss']])
            with pytest.raises(RuntimeError, match='check_nan') as e:
                for _ in range(8):
                    exe.run(main, feed=bad, fetch_list=[out['loss']])
        assert e.value.nan_window_steps == window
        assert out['loss'].name in str(e.value)


def test_predictor_replays_equal_the_interpreter(cuda, tmp_path):
    from paddle_tpu_torch.models import llama
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 5
    with tf.program_guard(main, startup), tf.unique_name.guard():
        out = llama.generation_program('tiny', d_model=256, n_head=2,
                                       n_kv_head=1, d_ffn=512, max_len=64)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        exe.run(startup)
        tf.io.save_inference_model(str(tmp_path), ['tokens'],
                                   [out['logits'], out['next_token']], exe,
                                   main)
    pred = tf.inference.Predictor(tf.inference.AnalysisConfig(
        str(tmp_path)))
    tokens = np.random.RandomState(0).randint(0, 256, (2, 64)).astype(
        'int64')
    runs = [pred.run({'tokens': tokens}) for _ in range(3)]
    ref = pred._exe.run(pred._program, feed={'tokens': tokens},
                        fetch_list=pred._fetch_names, scope=pred._scope,
                        use_program_cache=False)
    for r in runs:
        for a, b in zip(r, ref):
            assert a.tobytes() == b.tobytes()
    entries = pred._exe._graphs.entries.values()
    assert sum(e.graph is not None for e in entries) == 1


def test_serving_engine_captures_on_its_own_thread(cuda, tmp_path):
    """A Predictor warmed on the main thread and captured on the
    ServingEngine's dispatch thread: every request ok, rows equal to
    Predictor.run alone."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import llama
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 5
    with tf.program_guard(main, startup), tf.unique_name.guard():
        out = llama.generation_program('tiny', d_model=256, n_head=2,
                                       n_kv_head=1, d_ffn=512, max_len=64)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        exe.run(startup)
        tf.io.save_inference_model(str(tmp_path), ['tokens'],
                                   [out['last_logits'], out['next_token']],
                                   exe, main)
    pred = tf.inference.Predictor(str(tmp_path))
    rng = np.random.RandomState(0)
    feeds = [{'tokens': rng.randint(0, 256, (r, 64)).astype('int64')}
             for r in (2, 2, 2)]
    pred.run(feeds[0])                   # the warm-up, on this thread
    eng = serving.ServingEngine.from_predictor(
        pred, config=serving.ServingConfig(max_queue=8, max_batch_rows=2))
    with eng:
        results = [eng.submit(f).result(300) for f in feeds]
    assert all(r.ok for r in results), [(r.status, r.error)
                                        for r in results]
    for f, r in zip(feeds, results):
        alone = pred.run(f)
        for a, b in zip(r.outputs, alone):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_embedding_backward_sums_in_a_fixed_order(cuda):
    """The lookup's scatter-add gradient (ops/gather.py) is the same on
    every run and equals the CPU's serial sum bit for bit: index_add_'s
    float atomics were neither, and broke the bitwise gates above."""
    from paddle_tpu_torch.ops import gather as ga
    g = torch.Generator(device='cuda').manual_seed(0)
    V, D, N = 128, 512, 8192
    ids = torch.randint(0, V, (N,), generator=g, device='cuda')
    dout = torch.randn(N, D, generator=g, device='cuda')

    def grad(w, i, d):
        w = w.detach().requires_grad_(True)
        return torch.autograd.grad(ga.lookup(w, i), w, d)[0]
    w = torch.randn(V, D, generator=g, device='cuda')
    first = grad(w, ids, dout)
    for _ in range(4):
        assert torch.equal(grad(w, ids, dout), first)
    assert torch.equal(grad(w.cpu(), ids.cpu(), dout.cpu()), first.cpu())
