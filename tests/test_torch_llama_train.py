"""The training llama end to end on the CPU: `models/llama.py::build`
(`llama`, `append_backward`, the gradient clip by global norm 1.0, Adam
with beta2 0.95) and `make_batch` through both packages, from one carried
scope (parameters, moments and beta powers), over 3 Adam steps.

Configurations: `tiny` (head dim 16: on the card the flash op runs
csrc/flash_cc.cu there) and a 2-layer config at head dim 64.

float32.  Both packages compute in float32 in other summation orders.
- losses: rtol 1e-5;
- every gradient after the clip (each `<param>@GRAD`, rewritten in place
  by the clip's ops): within 1e-5 of the tensor's largest entry;
- moments: within 1e-5 of the tensor's largest entry, plus rtol 1e-5;
- parameters: rtol 1e-5 plus 1e-5 of the tensor's largest entry, where
  Adam's step is well conditioned.  A step moves an entry by lr_t m1 /
  (sqrt(m2) + eps), which normalises each entry by its own gradient: a
  gradient difference of 1e-6 of the tensor's largest entry is a
  relative difference of 1e-6 max|g| / |g| in the step, and where the
  gradient changed sign between steps m1 is a difference of nearly
  equal terms while sqrt(m2) is not, which amplifies it by sqrt(m2) /
  |m1|.  Entries whose reference gradient fell below 1% of its tensor's
  largest at some step, or whose |m1| < 0.25 sqrt(m2), are held instead
  to the size of the steps, 2.01 lr per step (the first step is exactly
  lr sign(g); later ones at most ~1.002 lr for these betas); more than
  half of all entries must get the tight check.

bfloat16 (`build(dtype='bfloat16')`).  Both packages take the first step
with bf16 parameters, rounding each operation's output to bf16 (unit
roundoff u = 2^-8) at the same places from float32 values that differ in
the last bits (as tests/test_torch_inference_bf16.py derives): a logit
depends on R = 12 L + 2 roundings, and the two packages' logits differ
with standard deviation sqrt(2 R / 3) u M, M = max |logit|; four of them
give tol_logit = 4 sqrt(2 R / 3) u M.
- step 1: the loss (a mean of lse - target) within 2 tol_logit; a
  gradient depends on the forward's R roundings and as many in the
  backward, so each clipped gradient within 4 sqrt(2 (2R) / 3) u of its
  tensor's largest entry; the moments are 0.1 g and 0.05 g^2 of those
  gradients, so m1 within that bound and m2 within twice it (relative to
  each tensor's largest entry); the parameters within one step's size,
  2.01 lr, since an entry whose gradient lies within the bound may step
  the other way;
- the reference's Adam returns float32 parameters and moments (its
  float32 learning rate and the clip's float32 scale promote them) and
  keeps the beta powers bf16: the dtypes must be equal after every step;
- steps 2-3 then run in float32, held to the float32 bounds above, but
  for one thing: the bias correction lr_t = lr sqrt(1 - b2p) / (1 - b1p)
  is computed from the bf16 beta powers with three bf16 roundings (1 -
  b2p, its sqrt, 1 - b1p).  The port rounds at each, as jnp's ops do one
  by one; XLA may keep any of them in float32 inside the compiled step
  (its excess precision), so lr_t may differ by up to 3 half-units of
  bf16, 3 2^-9, and each step of at most 2.01 lr by that share: the
  parameters get 3 2^-9 2.01 lr more.

Each step is compared from one state: before it, the JAX package's state
is carried into the port's scope, so that one step's differences do not
feed the next.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.models import llama as jllama
import paddle_tpu_torch as tf
from paddle_tpu_torch.models import llama as tllama
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

D64 = dict(vocab=256, d_model=256, n_layer=2, n_head=4, n_kv_head=2,
           d_ffn=512, theta=10000.0, max_len=32)
# head dims 136 (MQA) and 256 at one layer: the bf16 AMP step's flash
# backward at the widths above 128 (the instances of width 256 on the card)
D136 = dict(vocab=256, d_model=272, n_layer=1, n_head=2, n_kv_head=1,
            d_ffn=544, theta=10000.0, max_len=32)
D256 = dict(vocab=256, d_model=512, n_layer=1, n_head=2, n_kv_head=2,
            d_ffn=1024, theta=10000.0, max_len=32)
CONFIGS = {'tiny': dict(jllama.CONFIGS['tiny']), 'd64': D64, 'd136': D136,
           'd256': D256}
LR = 1e-3
U = 2.0 ** -8


@pytest.fixture(autouse=True)
def fresh_port_programs(monkeypatch):
    """Fresh default programs, scope and name generator for the port (the
    root conftest does the same for the JAX package), and the JAX
    package's compile cache and direct emission off (its emitted Adam
    rule refuses the bf16 build's mixed dtypes)."""
    monkeypatch.setenv('PT_CACHE', '0')
    monkeypatch.setenv('PT_EMIT', '0')
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


def _build(fluid, llama, cfg, dtype='float32', **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = llama.build(cfg, dtype=dtype, lr=LR, **kw)
    return main, startup, out


def _desc(fluid, program):
    d = json.loads(json.dumps(fluid.io.program_to_desc(program)))
    for b in d['blocks']:
        for op in b['ops']:
            op.pop('source_loc')
    return d


def _batch(cfg, seed, rows=4):
    rng = np.random.RandomState(seed)
    T = cfg['max_len']
    lines = [rng.randint(0, cfg['vocab'], rng.randint(T // 2, T + 2))
             for _ in range(rows)]
    return tllama.make_batch(lines, T)


def _host(v):
    return np.asarray(v)


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v).astype(np.float32)


def _both(cfg, dtype='float32', amp=False):
    """Both programs (under bf16 AMP with `amp`), the JAX startup run, and
    the JAX scope (parameters and optimizer state) carried into a port
    scope."""
    jmain, jstart, jout = _build(jf, jllama, cfg, dtype)
    tmain, _, tout = _build(tf, tllama, cfg, dtype)
    jmain.set_amp(amp)
    tmain.set_amp(amp)
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jf.Executor().run(jstart)
    names = tf.persistable_names(tmain)
    assert set(names) == set(jscope.vars)
    tscope = tf.scope_from_numpy({n: _host(jscope.vars[n]) for n in names},
                                 tf.Scope(), 'cpu')
    for n in names:
        assert str(tscope.vars[n].dtype).split('.')[-1] == \
            str(jscope.vars[n].dtype), n
    return (jmain, jout, jscope), (tmain, tout, tscope)


def _carry(jscope, tscope):
    tf.scope_from_numpy({n: _host(v) for n, v in jscope.vars.items()},
                        tscope, 'cpu')


def _steps(jax_side, port_side, feed, n, grads):
    """n steps of both packages; before each, the JAX package's state
    (parameters, moments, beta powers) is carried into the port's scope,
    so each step is compared from one state and one step's differences
    do not feed the next."""
    (jmain, jout, jscope), (tmain, tout, tscope) = jax_side, port_side
    texe, jexe = tf.Executor(tf.CPUPlace()), jf.Executor()
    for step in range(n):
        _carry(jscope, tscope)
        with jf.scope_guard(jscope):
            jres = jexe.run(jmain, feed=feed,
                            fetch_list=[jout['loss'], jout['logits']] + grads)
        with tf.scope_guard(tscope):
            tres = texe.run(tmain, feed=feed,
                            fetch_list=[tout['loss'], tout['logits']] + grads)
        yield step, tres, jres


# ---------------------------------------------------------- the program

@pytest.mark.parametrize('config', ['tiny', 'd64', 'llama_1b'])
def test_same_training_program_desc(config):
    cfg = jllama.CONFIGS[config] if config in jllama.CONFIGS else \
        CONFIGS[config]
    main, startup, _ = _build(jf, jllama, cfg)
    tmain, tstartup, _ = _build(tf, tllama, cfg)
    assert _desc(tf, tmain) == _desc(jf, main)
    assert _desc(tf, tstartup) == _desc(jf, startup)
    types = [op.type for op in tmain.global_block().ops]
    n_params = len(tmain.all_parameters())
    assert n_params == 9 * cfg['n_layer'] + 3
    assert types.count('adam') == n_params
    # the global-norm clip: a square and a reduce_sum per parameter, one
    # sum, sqrt, max and div, and one in-place mul per gradient
    assert types.count('square') == types.count('reduce_sum') - 2 == n_params
    assert types.count('sum') == types.count('sqrt') == 1
    assert types.count('elementwise_max') == 1
    muls = [op for op in tmain.global_block().ops
            if op.type == 'elementwise_mul' and
            op.input('X') == op.output('Out')]
    assert len(muls) == n_params
    if config == 'llama_1b':
        assert n_params == 147
        assert sum(int(np.prod(p.shape))
                   for p in tmain.all_parameters()) == 873_531_392


def test_make_batch_is_the_references():
    rows = [np.arange(3, 20), np.arange(40, 48), np.arange(1, 50)]
    got, ref = tllama.make_batch(rows, 32), jllama.make_batch(rows, 32)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_single_device_only():
    with pytest.raises(NotImplementedError, match='ROADMAP A7'):
        tllama.llama('tiny', use_ring=True)
    with pytest.raises(NotImplementedError, match='ROADMAP A7'):
        tllama.shard(tf.Program())


# ----------------------------------------------------- float32 parity

def _close_to_max(a, b, rel, what):
    scale = float(np.abs(b).max())
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * scale,
                               err_msg=what)


def _check_f32_step(step, tres, jres, params, tscope, jscope, step_tol=0.0):
    """One float32 step from one state (the module docstring's bounds;
    `step_tol` more for the parameters).  -> (entries held to 1e-5,
    entries)."""
    np.testing.assert_allclose(tres[0], jres[0], rtol=1e-5,
                               err_msg='loss at step %d' % step)
    tight = total = 0
    for name, ga, gb in zip(params, tres[2:], jres[2:]):
        gb = _f32(gb)
        _close_to_max(ga, gb, 1e-5, '%s@GRAD at step %d' % (name, step))
        a, b = _f32(tscope.vars[name]), _f32(jscope.vars[name])
        m1 = _f32(jscope.vars[name + '_moment1_0'])
        m2 = _f32(jscope.vars[name + '_moment2_0'])
        loose = (np.abs(gb) < 1e-2 * float(np.abs(gb).max())) | \
            (np.abs(m1) < 0.25 * np.sqrt(m2))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2.01 * LR,
                                   err_msg=name)
        np.testing.assert_allclose(a[~loose], b[~loose], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()) +
                                   step_tol, err_msg=name)
        tight += int((~loose).sum())
        total += loose.size
        for mom in ('_moment1_0', '_moment2_0'):
            _close_to_max(_f32(tscope.vars[name + mom]),
                          _f32(jscope.vars[name + mom]), 1e-5, name + mom)
        for pw in ('_beta1_pow_acc_0', '_beta2_pow_acc_0'):
            np.testing.assert_array_equal(_f32(tscope.vars[name + pw]),
                                          _f32(jscope.vars[name + pw]))
    return tight, total


@pytest.mark.parametrize('config', ['tiny', 'd64'])
def test_three_f32_steps_match_the_jax_package(config):
    cfg = CONFIGS[config]
    jax_side, port_side = _both(cfg)
    jscope, tscope = jax_side[2], port_side[2]
    params = [p.name for p in port_side[0].all_parameters()]
    grads = [p + '@GRAD' for p in params]
    tight = total = 0
    for step, tres, jres in _steps(jax_side, port_side, _batch(cfg, 0), 3,
                                   grads):
        a, b = _check_f32_step(step, tres, jres, params, tscope, jscope)
        tight, total = tight + a, total + b
    # the entries held to 1e-5 are most of them
    assert tight > 0.5 * total, (tight, total)


# -------------------------------------------------------- bf16 parity

def _tol_logit(M, n_layer):
    R = 12 * n_layer + 2
    return 4.0 * np.sqrt(2 * R / 3.0) * U * M


def _tol_grad(n_layer):
    R = 12 * n_layer + 2
    return 4.0 * np.sqrt(2 * (2 * R) / 3.0) * U


@pytest.mark.parametrize('config', ['tiny', 'd64'])
def test_three_bf16_steps_match_the_jax_package(config):
    cfg = CONFIGS[config]
    L = cfg['n_layer']
    jax_side, port_side = _both(cfg, 'bfloat16')
    jscope, tscope = jax_side[2], port_side[2]
    tmain = port_side[0]
    params = [p.name for p in tmain.all_parameters()]
    assert all(tscope.vars[p].dtype == torch.bfloat16 for p in params)
    grads = [p + '@GRAD' for p in params]
    for step, tres, jres in _steps(jax_side, port_side, _batch(cfg, 1), 3,
                                   grads):
        for name in tf.persistable_names(tmain):
            assert str(tscope.vars[name].dtype).split('.')[-1] == \
                str(jscope.vars[name].dtype), (name, step)
        if step:
            # float32 parameters and moments from here on; lr_t's three
            # bf16 roundings may each be kept or skipped
            _check_f32_step(step, tres, jres, params, tscope, jscope,
                            step_tol=3 * 2.0 ** -9 * 2.01 * LR)
            continue
        loss_tol = 2 * _tol_logit(float(np.abs(_f32(jres[1])).max()), L)
        assert abs(float(tres[0][0]) - float(jres[0][0])) <= loss_tol
        for name, a, b in zip(params, tres[2:], jres[2:]):
            assert a.dtype == np.float32    # the clip's scale promotes
            _close_to_max(a, _f32(b), _tol_grad(L), name + '@GRAD')
            np.testing.assert_allclose(
                _f32(tscope.vars[name]), _f32(jscope.vars[name]), rtol=1e-5,
                atol=2.01 * LR, err_msg=name)
            for mom, k in (('_moment1_0', 1), ('_moment2_0', 2)):
                _close_to_max(_f32(tscope.vars[name + mom]),
                              _f32(jscope.vars[name + mom]),
                              k * _tol_grad(L), name + mom)
            for pw in ('_beta1_pow_acc_0', '_beta2_pow_acc_0'):
                assert tscope.vars[name + pw].dtype == torch.bfloat16
                np.testing.assert_array_equal(_f32(tscope.vars[name + pw]),
                                              _f32(jscope.vars[name + pw]))


@pytest.mark.parametrize('config', ['d136', 'd256'])
def test_three_amp_steps_match_the_jax_package(config):
    """float32 parameters under `set_amp(True)`: mul, matmul and the flash
    attention take bf16 inputs and return float32 (core/amp.py).  Every
    bf16 rounding of this step is one the bf16 build also makes (a
    product's inputs are the outputs the bf16 build rounds, its output
    the one it rounds), so a logit depends on at most R = 12 L + 2
    roundings and the bf16 bounds hold at each step from one state: the
    loss within 2 tol_logit, each clipped gradient within tol_grad of
    its tensor's largest entry.  Adam then runs in float32 on those
    gradients: m1 = 0.9 m1' + 0.1 g moves by 0.1 of a gradient's
    difference, m2 = 0.95 m2' + 0.05 g^2 by 0.05 |g_a - g_b| |g_a + g_b|
    (G = the largest |g|: within 0.05 tol_grad G (2 + tol_grad) G), and
    a parameter whose gradient lies within the bound may step the other
    way: 2.01 lr."""
    cfg = CONFIGS[config]
    L = cfg['n_layer']
    jax_side, port_side = _both(cfg, amp=True)
    jscope, tscope = jax_side[2], port_side[2]
    tmain = port_side[0]
    params = [p.name for p in tmain.all_parameters()]
    grads = [p + '@GRAD' for p in params]
    tg = _tol_grad(L)
    for step, tres, jres in _steps(jax_side, port_side, _batch(cfg, 8), 3,
                                   grads):
        assert all(tscope.vars[p].dtype == torch.float32 for p in params)
        loss_tol = 2 * _tol_logit(float(np.abs(_f32(jres[1])).max()), L)
        assert np.isfinite(tres[0]).all()
        assert abs(float(tres[0][0]) - float(jres[0][0])) <= loss_tol, step
        for name, a, b in zip(params, tres[2:], jres[2:]):
            b = _f32(b)
            G = float(np.abs(b).max())
            what = '%s at step %d' % (name, step)
            _close_to_max(a, b, tg, what + '@GRAD')
            np.testing.assert_allclose(
                _f32(tscope.vars[name]), _f32(jscope.vars[name]), rtol=1e-5,
                atol=2.01 * LR, err_msg=what)
            for mom, atol in (('_moment1_0', 0.1 * tg * G),
                              ('_moment2_0', 0.05 * tg * G * (2 + tg) * G)):
                np.testing.assert_allclose(
                    _f32(tscope.vars[name + mom]),
                    _f32(jscope.vars[name + mom]), rtol=1e-5, atol=atol,
                    err_msg=what + mom)


# ------------------------------------------ the port's runtime, alone

def _port_only(cfg, dtype='float32'):
    main, startup, out = _build(tf, tllama, cfg, dtype)
    scope = tf.Scope()
    with tf.scope_guard(scope):
        tf.Executor(tf.CPUPlace()).run(startup)
    return main, out, scope


def _snapshot(scope):
    return {k: v.clone() for k, v in scope.vars.items()}


def _restore(scope, snap):
    scope.vars.clear()
    scope.vars.update({k: v.clone() for k, v in snap.items()})


def test_rewriter_on_and_off_agree_bit_for_bit(monkeypatch):
    """PT_OPT=1 runs the clip chains and Adam as fused groups (the
    in-place gradient rewrites included); PT_OPT=0 runs one op at a
    time.  On the CPU both replay the same impls, bit for bit."""
    main, out, scope = _port_only(CONFIGS['tiny'])
    snap = _snapshot(scope)
    feed = _batch(CONFIGS['tiny'], 2)
    res = {}
    for opt in ('1', '0'):
        monkeypatch.setenv('PT_OPT', opt)
        _restore(scope, snap)
        exe = tf.Executor(tf.CPUPlace())
        with tf.scope_guard(scope):
            losses = [exe.run(main, feed=feed,
                              fetch_list=[out['loss']])[0][0]
                      for _ in range(3)]
        res[opt] = (losses, _snapshot(scope))
    assert res['1'][0] == res['0'][0]
    for k, v in res['0'][1].items():
        assert torch.equal(res['1'][1][k], v), k


def test_run_steps_equals_runs_with_in_place_gradients():
    main, out, scope = _port_only(CONFIGS['tiny'])
    snap = _snapshot(scope)
    feeds = [_batch(CONFIGS['tiny'], s) for s in (3, 4, 5)]
    exe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        one = [exe.run(main, feed=f, fetch_list=[out['loss']])[0]
               for f in feeds]
    after = _snapshot(scope)
    _restore(scope, snap)
    exe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        many = exe.run_steps(main, feed_list=feeds,
                             fetch_list=[out['loss']])[0]
    np.testing.assert_array_equal(np.stack(one), many)
    for k, v in after.items():
        assert torch.equal(scope.vars[k], v), k


def test_loss_falls_and_the_trained_scope_serves():
    """A few steps on one repeated batch lower the loss; the scope the
    training program wrote then serves through make_streaming_runtime
    and make_decoder (the same parameter names), greedy tokens equal."""
    cfg = CONFIGS['tiny']
    main, out, scope = _port_only(cfg)
    feed = _batch(cfg, 6)
    exe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        losses = [float(exe.run(main, feed=feed,
                                fetch_list=[out['loss']])[0][0])
                  for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    prompt = np.arange(1, 9)
    rt = tllama.make_streaming_runtime(scope, cfg, device='cpu')
    streamed = list(rt.generate(prompt, 6))
    dense = tllama.make_decoder(scope, cfg)(prompt[None], 6)[0, 8:]
    assert streamed == dense.tolist()


def test_bf16_build_takes_three_steps_with_the_references_dtypes():
    """The port alone: after the first step the parameters and moments
    are float32 and the beta powers bf16, and the later steps keep
    them."""
    main, out, scope = _port_only(CONFIGS['tiny'], 'bfloat16')
    feed = _batch(CONFIGS['tiny'], 7)
    exe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        for _ in range(3):
            loss = exe.run(main, feed=feed, fetch_list=[out['loss']])[0]
            assert np.isfinite(loss).all()
    for p in main.all_parameters():
        assert scope.vars[p.name].dtype == torch.float32
        assert scope.vars[p.name + '_moment1_0'].dtype == torch.float32
        assert scope.vars[p.name + '_beta1_pow_acc_0'].dtype == \
            torch.bfloat16
