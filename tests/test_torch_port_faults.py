"""Faults of the port against the JAX package, each held on the CPU to the
JAX package's own result: mixed float32 x bf16 products (C1), bf16
generation (C2), the flash-attention route for head dims the kernels do
not tile (C3), out-of-range hard labels (C4), `scale` on an integer
tensor (C5), `create_paddle_predictor` (C6), `reduce_sum` over integers
and bools (C8), a float-to-integer `cast` of NaN, infinities and values
out of range (C9), signed zeros and NaN in relu, clip and the elementwise
max and min (C10), `squeeze` / `split`, batch norm's moving
statistics (the reference's momentum convention and biased variance,
which `F.batch_norm` does not follow), and the in-place optimizer
updates on bf16 state (C11: the float32 learning rate promotes, as in
jnp, where torch's 0-dim rule kept bf16), and the Python constants that
meet a bf16 tensor in the activations, scale, clip, increment and
dropout, and in their kernel rules (C12: rounded to bf16 first, as jnp
rounds a weak-typed scalar).

C3's kernels (head dims 16, 32 and 96 on CUDA cores) are checked on the
card in tests/test_torch_cuda_kernels.py; here the route of a head dim
that is not a multiple of 8 is checked, which is the same on both
devices."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.models import llama as tllama


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


def registry_shim(op_type, attrs):
    from paddle_tpu_torch.core.registry import _SubOpShim
    return _SubOpShim(op_type, attrs)


def _run_op(fluid, op_type, ins, attrs, outs=('Out',)):
    """One op of either package on numpy inputs -> {slot: numpy}."""
    from paddle_tpu_torch.core import registry as treg
    if fluid is tf:
        impl = treg.get_op(op_type)
        ctx = treg.ExecCtx(torch.device('cpu'), 0, 0).for_op(
            0, registry_shim(op_type, attrs))
        got = impl(ctx, {k: torch.from_numpy(np.asarray(v))
                         for k, v in ins.items()}, attrs)
        return {k: got[k].numpy() if not isinstance(got[k], list)
                else [t.numpy() for t in got[k]] for k in outs}
    import jax.numpy as jnp
    from paddle_tpu.core import registry as jreg
    got = jreg.get_op(op_type).impl(None, {k: jnp.asarray(v)
                                           for k, v in ins.items()}, attrs)
    return {k: np.asarray(got[k]) if not isinstance(got[k], list)
            else [np.asarray(t) for t in got[k]] for k in outs}


# ---------------------------------------------------------------- C1

def _save_fc(path):
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        x = tf.layers.data('x', shape=[8], dtype='float32')
        h = tf.layers.fc(x, 16, act='relu')
        y = tf.layers.fc(h, 4)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        exe.run(startup)
        tf.io.save_inference_model(str(path), ['x'], [y], exe, main)


def test_c1_bf16_predictor_takes_a_float32_feed(tmp_path):
    """A float32 feed meets bf16 weights in both products: jnp promotes
    them to float32, so the port must too.  Both packages then compute
    float32 products of the same bf16-rounded weights, so they agree to
    float32 accuracy."""
    _save_fc(tmp_path)
    feed = {'x': np.random.RandomState(0).randn(4, 8).astype('float32')}
    jc = jf.inference.AnalysisConfig(str(tmp_path))
    jc.enable_bf16()
    tc = tf.inference.AnalysisConfig(str(tmp_path))
    tc.enable_bf16()
    tc.disable_gpu()
    ref = np.asarray(jf.inference.Predictor(jc).run(feed)[0])
    got = tf.inference.Predictor(tc).run(feed)[0]
    assert ref.dtype == got.dtype == np.float32
    assert got.shape == ref.shape == (4, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize('op_type,ins,attrs', [
    ('mul', {'X': (3, 8), 'Y': (8, 5)}, {}),
    ('matmul', {'X': (2, 3, 8), 'Y': (8, 5)}, {}),
])
def test_c1_products_promote(op_type, ins, attrs):
    rng = np.random.RandomState(1)
    x = rng.randn(*ins['X']).astype(np.float32)
    y = torch.from_numpy(rng.randn(*ins['Y']).astype(np.float32)).to(
        torch.bfloat16)
    from paddle_tpu_torch.core import registry as treg
    ctx = treg.ExecCtx(torch.device('cpu'), 0, 0, {}, False, None)
    out = treg.get_op(op_type)(ctx, {'X': torch.from_numpy(x), 'Y': y},
                               attrs)['Out']
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), x @ y.float().numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- C2

def _prompt():
    return np.arange(1, 9)


def test_c2_bf16_weights_generate_the_references_tokens():
    from paddle_tpu.serving.generation.decode import DecodeRuntime as JRT
    from paddle_tpu_torch.serving.generation.decode import (
        DecodeRuntime, random_weights)
    import jax.numpy as jnp
    cfg = tllama.CONFIGS['tiny']
    w = random_weights(cfg)
    ref = JRT({n: jnp.asarray(a, jnp.bfloat16) for n, a in w.items()},
              cfg).generate(_prompt(), 6)
    rt = DecodeRuntime({n: torch.from_numpy(a).to(torch.bfloat16)
                        for n, a in w.items()}, cfg, device='cpu')
    assert list(rt.generate(_prompt(), 6)) == list(ref)


def test_c2_bf16_pages_generate_the_references_tokens():
    from paddle_tpu.serving.generation.decode import DecodeRuntime as JRT
    from paddle_tpu_torch.serving.generation.decode import (
        DecodeRuntime, random_weights)
    cfg = tllama.CONFIGS['tiny']
    w = random_weights(cfg)
    ref = JRT(w, cfg, cache_dtype='bfloat16').generate(_prompt(), 6)
    rt = DecodeRuntime(w, cfg, device='cpu', cache_dtype='bfloat16')
    assert rt.cache.page_bytes() == JRT(
        w, cfg, cache_dtype='bfloat16').cache.page_bytes()
    assert list(rt.generate(_prompt(), 6)) == list(ref)


def test_c2_page_bytes_of_a_bf16_pool_without_ml_dtypes():
    """The port's own itemsize table: in a process that never imports
    JAX (so numpy knows no 'bfloat16'), a bf16 pool's page costs 2 bytes
    an element."""
    import subprocess
    import sys
    code = ('import sys\n'
            'from paddle_tpu_torch.serving.generation.kv_cache import '
            'CacheConfig\n'
            'c = CacheConfig(2, 3, 2, 32, 16, dtype="bfloat16", page_len=8)\n'
            'assert "ml_dtypes" not in sys.modules\n'
            'print(c.page_bytes(), c.dense_slot_bytes())\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    elems = 3 * 2 * 8 * 16
    assert out.stdout.split() == [str(2 * 2 * elems),
                                  str(2 * 2 * 3 * 2 * 32 * 16)]


def test_c2_streaming_runtime_over_a_bf16_predictor_scope(tmp_path):
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        out = tllama.generation_program('tiny', mode='decode')
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        exe.run(startup)
        tf.io.save_inference_model(str(tmp_path), ['tokens'],
                                   [out['next_token']], exe, main)
    jc = jf.inference.AnalysisConfig(str(tmp_path))
    jc.enable_bf16()
    tc = tf.inference.AnalysisConfig(str(tmp_path))
    tc.enable_bf16()
    tc.disable_gpu()
    jpred, tpred = jf.inference.Predictor(jc), tf.inference.Predictor(tc)
    assert all(v.dtype == torch.bfloat16 for v in tpred._scope.vars.values())
    ref = jllama.make_streaming_runtime(jpred._scope, 'tiny').generate(
        _prompt(), 6)
    rt = tllama.make_streaming_runtime(tpred._scope, 'tiny', device='cpu')
    assert list(rt.generate(_prompt(), 6)) == list(ref)


# ---------------------------------------------------------------- C3

def test_c3_head_dim_off_the_tiling_takes_the_counted_composed_route():
    """D = 12 (not a multiple of 8): the reference computes its composed
    attention; the port routes there on purpose and counts the route,
    forward and gradients matching the JAX package's."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops import attention as jatt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import attention as tatt
    rng = np.random.RandomState(3)
    B, H, Hkv, T, D = 2, 4, 2, 16, 12
    q = rng.randn(B, H, T, D).astype(np.float32)
    k = rng.randn(B, Hkv, T, D).astype(np.float32)
    v = rng.randn(B, Hkv, T, D).astype(np.float32)
    klen = np.array([16, 9], np.int32)
    g = rng.randn(B, H, T, D).astype(np.float32)

    def jloss(q, k, v):
        o = jatt.flash_attention(q, k, v, causal=True,
                                 k_len=jnp.asarray(klen), interpret=True)
        return jnp.sum(o * g), o
    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    kernels.reset_launches()
    to = tatt.flash_attention(tq, tk, tv, causal=True,
                              k_len=torch.from_numpy(klen))
    (to * torch.from_numpy(g)).sum().backward()
    assert kernels.launches['flash_attention_composed'] == 1
    assert kernels.launches['flash_attention_fwd'] == 0
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    for t, ref in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)


def test_c3_head_dim_above_256_raises_naming_the_roadmap():
    from paddle_tpu_torch.ops import attention as tatt
    q = torch.zeros(1, 1, 4, 264)
    with pytest.raises(ValueError, match='ROADMAP C3'):
        tatt.flash_attention(q, q, q)


# ---------------------------------------------------------------- C4

def test_c4_out_of_range_labels_follow_take_along_axis():
    """Logits [1, 4, 6], labels [0, -100, 6, -1] with ignore_index -100:
    the ignored row gives 0, label 6 is out of range (NaN), label -1 wraps
    to 5; the gradient is the reference's custom vjp's."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.loss import _make_hard_ce
    from paddle_tpu_torch.ops.loss import hard_cross_entropy
    rng = np.random.RandomState(4)
    logits = rng.randn(1, 4, 6).astype(np.float32)
    lab = np.array([0, -100, 6, -1], np.int32).reshape(1, 4, 1)
    ce = _make_hard_ce(6, 0.0, -100)
    ref, vjp = jax.vjp(lambda x: ce(x, jnp.asarray(lab)), logits)
    ref_grad, = vjp(jnp.ones_like(ref))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = hard_cross_entropy(x, torch.from_numpy(lab))
    got.sum().backward()
    got = got.detach().numpy().reshape(-1)
    np.testing.assert_allclose(got, np.asarray(ref).reshape(-1), rtol=1e-6,
                               atol=1e-6)
    assert got[1] == 0 and np.isnan(got[2])
    assert np.isfinite(got[[0, 3]]).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-6, atol=1e-6)


def test_c4_the_op_takes_the_labels_too():
    rng = np.random.RandomState(5)
    ins = {'Logits': rng.randn(1, 4, 6).astype(np.float32),
           'Label': np.array([0, -100, 6, -1], np.int64).reshape(1, 4, 1)}
    got = _run_op(tf, 'softmax_with_cross_entropy', ins, {}, ('Loss',))
    ref = _run_op(jf, 'softmax_with_cross_entropy', ins, {}, ('Loss',))
    np.testing.assert_allclose(got['Loss'], ref['Loss'], rtol=1e-6)


# ---------------------------------------------------------------- C5

@pytest.mark.parametrize('after', [True, False])
def test_c5_scale_casts_the_bias_to_an_int_dtype(after):
    ins = {'X': np.array([1, -3, 4], np.int32)}
    attrs = {'scale': 2.5, 'bias': 1.5, 'bias_after_scale': after}
    got = _run_op(tf, 'scale', ins, attrs)['Out']
    ref = _run_op(jf, 'scale', ins, attrs)['Out']
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    if after:
        assert got[0] == 3


# ---------------------------------------------------------------- C6

def test_c6_create_paddle_predictor(tmp_path):
    _save_fc(tmp_path)
    conf = tf.inference.AnalysisConfig(str(tmp_path))
    conf.disable_gpu()
    pred = tf.inference.create_paddle_predictor(conf)
    assert isinstance(pred, tf.inference.Predictor)
    feed = {'x': np.ones((2, 8), np.float32)}
    np.testing.assert_array_equal(pred.run(feed)[0],
                                  tf.inference.Predictor(conf).run(feed)[0])
    with pytest.raises(NotImplementedError,
                       match='create_paddle_predictor'):
        tf.CompiledProgram(tf.Program()).with_inference_optimize(conf)


# ---------------------------------------------------------------- C8

@pytest.mark.parametrize('x', [
    np.array([[1, -2, 3], [4, 5, -6]], np.int32),
    np.array([[True, False, True], [True, True, False]]),
    np.array([[1, -2, 3], [100, 120, -128]], np.int8),
    np.array([[1, -2, 3], [30000, 30000, -7]], np.int16),
], ids=['int32', 'bool', 'int8', 'int16'])
@pytest.mark.parametrize('attrs', [
    {'dim': [1]}, {'dim': [0], 'keep_dim': True}, {'reduce_all': True},
    {'reduce_all': True, 'keep_dim': True}, {'dim': [-1, 0]},
], ids=['dim1', 'dim0_keep', 'all', 'all_keep', 'both'])
def test_c8_reduce_sum_of_integers_and_bools_is_int32(x, attrs):
    """jnp.sum sums integers and bools into int32 (x64 off); torch.sum
    widened them to int64."""
    got = _run_op(tf, 'reduce_sum', {'X': x}, attrs)['Out']
    ref = _run_op(jf, 'reduce_sum', {'X': x}, attrs)['Out']
    assert got.dtype == ref.dtype == np.int32
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- C9

_C9_X = np.array([np.nan, np.inf, -np.inf, 3e10, -3e10, 2147483520.0,
                  -1.7, 300.2, -200.5, 127.9, -128.9, 0.5], np.float32)


@pytest.mark.parametrize('out_dtype', ['int32', 'int64', 'int16', 'int8',
                                       'uint8'])
@pytest.mark.parametrize('in_dtype', ['float32', 'bfloat16'])
def test_c9_float_to_integer_cast_saturates(out_dtype, in_dtype):
    """XLA's convert maps NaN to 0 and clamps every value to the target's
    range (int64 computes as int32 in both packages); Tensor.to gave
    INT32_MIN for NaN, the infinities and 3e10, and wrapped int8, int16
    and uint8 (300.2 -> 44, -1.7 -> 255 as uint8).  bf16 inputs round
    int16's limit up to 2^15, past its range."""
    attrs = {'out_dtype': out_dtype}
    if in_dtype == 'float32':
        got = _run_op(tf, 'cast', {'X': _C9_X}, attrs)['Out']
        ref = _run_op(jf, 'cast', {'X': _C9_X}, attrs)['Out']
    else:
        import jax.numpy as jnp
        from paddle_tpu.core import registry as jreg
        from paddle_tpu_torch.core import registry as treg
        xt = torch.from_numpy(_C9_X).to(torch.bfloat16)
        ctx = treg.ExecCtx(torch.device('cpu'), 0, 0).for_op(
            0, registry_shim('cast', attrs))
        got = treg.get_op('cast')(ctx, {'X': xt}, attrs)['Out'].numpy()
        ref = np.asarray(jreg.get_op('cast').impl(
            None, {'X': jnp.asarray(_C9_X).astype(jnp.bfloat16)},
            attrs)['Out'])
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    if out_dtype in ('int32', 'int64'):
        np.testing.assert_array_equal(
            got[:4], [0, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1])
    if out_dtype == 'uint8':
        np.testing.assert_array_equal(got[6:8], [0, 255])


# ------------------------------------------------------ squeeze, split

def test_squeeze_of_an_axis_not_of_size_one_raises():
    ins = {'X': np.zeros((2, 3, 1), np.float32)}
    with pytest.raises(ValueError):
        _run_op(jf, 'squeeze', ins, {'axes': [1]})
    with pytest.raises(ValueError, match='size 1'):
        _run_op(tf, 'squeeze', ins, {'axes': [1]})
    assert _run_op(tf, 'squeeze', ins, {'axes': [2]})['Out'].shape == (2, 3)


@pytest.mark.parametrize('sections,axis', [([2, -1], 1), ([3, -1], 1),
                                           ([1, 3, 1], -1), ([3, 2], 1)])
def test_split_takes_a_minus_one_section(sections, axis):
    ins = {'X': np.arange(20, dtype=np.float32).reshape(4, 5)}
    attrs = {'axis': axis, 'sections': sections}
    got = _run_op(tf, 'split', ins, attrs)['Out']
    ref = _run_op(jf, 'split', ins, attrs)['Out']
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_split_into_negative_sizes_raises_in_both():
    """A leading -1 makes the JAX package's first cut negative: both
    packages refuse it."""
    ins = {'X': np.arange(20, dtype=np.float32).reshape(4, 5)}
    attrs = {'axis': 1, 'sections': [-1, 2]}
    for fluid in (jf, tf):
        with pytest.raises(ValueError):
            _run_op(fluid, 'split', ins, attrs)


def test_batch_norm_moving_statistics_follow_the_reference():
    """MeanOut = m mean + (1 - m) batch_mean and VarianceOut = m var + (1 -
    m) batch_var with the biased variance, as the JAX op computes them,
    in place.
    torch.nn.functional.batch_norm weighs the other way round (its
    momentum is the new batch's share) and keeps the unbiased variance
    (n / (n - 1)): a port through it would pass a loss check and drift
    the moving statistics, which this test would catch."""
    import jax.numpy as jnp
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    rng = np.random.RandomState(0)
    C = 3
    ins = {'X': rng.randn(2, C, 3, 3).astype('float32') * 2 + 1,
           'Scale': np.ones(C, 'float32'), 'Bias': np.zeros(C, 'float32'),
           'Mean': rng.randn(C).astype('float32'),
           'Variance': rng.rand(C).astype('float32') + 0.5}
    attrs = {'momentum': 0.9, 'epsilon': 1e-5}
    want = jreg.get_op('batch_norm').impl(
        None, {k: jnp.asarray(v) for k, v in ins.items()}, attrs)
    t = {k: torch.from_numpy(v.copy()) for k, v in ins.items()}
    got = treg.get_op('batch_norm')(None, t, attrs)
    for slot in ('MeanOut', 'VarianceOut'):
        np.testing.assert_allclose(got[slot].numpy(), np.asarray(want[slot]),
                                   rtol=1e-6, err_msg=slot)
    # written in place into the persistable statistics
    assert got['MeanOut'] is t['Mean'] and got['VarianceOut'] is \
        t['Variance']
    # what F.batch_norm would have written: far from the reference's
    rm = torch.from_numpy(ins['Mean'].copy())
    rv = torch.from_numpy(ins['Variance'].copy())
    torch.nn.functional.batch_norm(torch.from_numpy(ins['X']), rm, rv,
                                   training=True, momentum=0.9)
    assert not np.allclose(rm.numpy(), np.asarray(want['MeanOut']),
                           rtol=1e-3)
    assert not np.allclose(rv.numpy(), np.asarray(want['VarianceOut']),
                           rtol=1e-3)


_C10_X = np.array([-0.0, 0.0, np.nan, -1.5, 2.5, np.inf, -np.inf, 0.0,
                   -0.0, np.nan, 1.0], np.float32)
_C10_Y = np.array([0.0, -0.0, 1.0, np.nan, -0.0, -0.0, 0.0, 0.0, -0.0,
                   np.nan, 1.0], np.float32)


@pytest.mark.parametrize('op,attrs,binary', [
    ('relu', {}, False), ('clip', {'min': 0.0, 'max': 2.0}, False),
    ('clip', {'min': -1.0, 'max': -0.0}, False),
    ('elementwise_max', {'axis': -1}, True),
    ('elementwise_min', {'axis': -1}, True)],
    ids=['relu', 'clip', 'clip_to_minus_zero', 'max', 'min'])
def test_c10_signed_zeros_and_nan_as_jnp(op, attrs, binary):
    """C10: relu kept -0 (torch.relu), clip kept -0 against a bound of +0
    (torch.clamp), and elementwise_max / min took -0 for +0 (torch.maximum
    / minimum); jnp's maximum and minimum order -0 below +0.  Bit for bit
    the JAX ops, NaN where NaN."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    ins = {'X': _C10_X, 'Y': _C10_Y} if binary else {'X': _C10_X}
    want = np.asarray(jreg.get_op(op).impl(
        None, {k: jnp.asarray(v) for k, v in ins.items()}, attrs)['Out'])
    got = treg.get_op(op)(None, {k: torch.from_numpy(v.copy())
                                 for k, v in ins.items()}, attrs)['Out']
    got = got.numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), (op, got, want)


# ---------------------------------------------------------------- C11
#
# bf16 param, grad and state under each update op but Adam, with a
# float32 learning rate: jnp promotes every operation that meets the
# float32 rate (or a float32 Beta1Pow) to float32, where torch's 0-dim
# rule kept the bf16 tensor bf16.  Held to the JAX op: the same output
# dtypes, and values within rtol 1e-6 and one unit in the last place of
# the output's largest value in its dtype (PyTorch's CPU sqrt is a unit
# off on some float32 values; XLA's is correctly rounded); ftrl at
# lr_power -0.6 computes pow: its param and linear accumulator within
# `optimizer_ops.ftrl_pow_bound`, widened for bf16 state.

_C11_CASES = {
    'sgd': ('sgd', {}),
    'momentum': ('momentum', {'mu': 0.9}),
    'momentum_nesterov': ('momentum', {'mu': 0.9, 'use_nesterov': True}),
    'lars_momentum': ('lars_momentum', {'mu': 0.9, 'lars_coeff': 0.001,
                                        'lars_weight_decay': 0.0005}),
    'adagrad': ('adagrad', {'epsilon': 1e-6}),
    'decayed_adagrad': ('decayed_adagrad', {'decay': 0.9, 'epsilon': 1e-6}),
    'adamax': ('adamax', {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}),
    'adadelta': ('adadelta', {'rho': 0.95, 'epsilon': 1e-6}),
    'rmsprop': ('rmsprop', {'decay': 0.9, 'epsilon': 1e-6,
                            'momentum': 0.5}),
    'rmsprop_centered': ('rmsprop', {'decay': 0.9, 'epsilon': 1e-6,
                                     'momentum': 0.5, 'centered': True}),
    'ftrl': ('ftrl', {'l1': 1e-3, 'l2': 1e-2, 'lr_power': -0.5}),
    'ftrl_pow': ('ftrl', {'l1': 1e-3, 'l2': 1e-2, 'lr_power': -0.6}),
}


def _c11_slots(op_type, attrs):
    from paddle_tpu_torch.ops import optimizer_ops as oo
    if op_type in ('momentum', 'lars_momentum'):
        return ['Velocity']
    return list(oo.array_slots(op_type, oo.optim_key(op_type, attrs)))


def _c11_inputs(op_type, attrs, n, seed):
    """float32 numpy inputs of one update op: the param 0.1 N(0, 1), the
    grad 1e-2 N(0, 1), the state 1e-3 |N(0, 1)| (signed where the update
    takes no root of it; centered rmsprop's mean square above its mean
    grad squared), Beta1Pow 0.9^3, the learning rate 0.1."""
    rng = np.random.RandomState(seed)
    ins = {'Param': rng.randn(n) * 0.1, 'Grad': rng.randn(n) * 1e-2}
    for slot in _c11_slots(op_type, attrs):
        a = np.abs(rng.randn(n)) * 1e-3
        if slot in ('Velocity', 'LinearAccumulator') or \
                (slot == 'Moment' and op_type == 'rmsprop'):
            a = a * np.sign(rng.randn(n))
        ins[slot] = a
    if 'MeanGrad' in ins:
        ins['MeanGrad'] = rng.randn(n) * 1e-2
        ins['MeanSquare'] = ins['MeanGrad'] ** 2 + ins['MeanSquare']
    if op_type == 'adamax':
        ins['Beta1Pow'] = np.array([0.9 ** 3])
    if op_type != 'adadelta':
        ins['LearningRate'] = np.array([0.1])
    return {k: v.astype('float32') for k, v in ins.items()}


def _c11_run(fluid, op_type, ins, attrs):
    """One update op of either package, every input bf16 but the float32
    learning rate -> {slot: (dtype name, float64 numpy)}."""
    def dt(k):
        return 'float32' if k == 'LearningRate' else 'bfloat16'
    if fluid is tf:
        from paddle_tpu_torch.core import registry as treg
        got = treg.get_op(op_type)(None, {
            k: torch.from_numpy(v).to(getattr(torch, dt(k)))
            for k, v in ins.items()}, attrs)
        return {k: (str(t.dtype).replace('torch.', ''),
                    t.double().numpy()) for k, t in got.items()}
    from paddle_tpu.core import registry as jreg
    got = jreg.get_op(op_type).impl(None, {
        k: jnp.asarray(v).astype(dt(k)) for k, v in ins.items()}, attrs)
    return {k: (str(t.dtype), np.asarray(t.astype('float32'))
                .astype('float64')) for k, t in got.items()}


def _unit(x, dtype):
    """One unit in the last place of |x|'s largest value in `dtype`."""
    m = float(np.abs(x).max())
    if m == 0.0:
        return 0.0
    bits = 8 if dtype == 'bfloat16' else 24
    return 2.0 ** (np.floor(np.log2(m)) - bits + 1)


@pytest.mark.parametrize('case', sorted(_C11_CASES))
def test_c11_bf16_state_comes_out_as_jnp_promotes_it(case):
    from paddle_tpu_torch.ops import optimizer_ops as oo
    op_type, attrs = _C11_CASES[case]
    ins = _c11_inputs(op_type, attrs, 4099, 0)
    want = _c11_run(jf, op_type, ins, attrs)
    got = _c11_run(tf, op_type, ins, attrs)
    assert sorted(got) == sorted(want)
    assert got['ParamOut'][0] == ('bfloat16' if op_type == 'adadelta'
                                  else 'float32')
    held = {}
    if case == 'ftrl_pow':
        # each input as the op took it: rounded to bf16
        t = [torch.from_numpy(ins[k]).bfloat16() for k in (
            'Param', 'Grad', 'SquaredAccumulator', 'LinearAccumulator')]
        bp, bz = oo.ftrl_pow_bound(*t, torch.from_numpy(
            ins['LearningRate']), oo.optim_key(op_type, attrs))
        held = {'ParamOut': bp.numpy(), 'LinearAccumOut': bz.numpy()}
    for slot, (dt, w) in want.items():
        assert got[slot][0] == dt, (slot, got[slot][0], dt)
        if slot in held:
            assert (np.abs(got[slot][1] - w) <= held[slot]).all(), slot
            continue
        np.testing.assert_allclose(got[slot][1], w, rtol=1e-6,
                                   atol=_unit(w, dt), err_msg=slot)


def _c11_program(fluid, make_opt, n=4):
    """The program that showed C11: a [n] bf16 parameter w (Constant 0.5),
    loss = mean(cast(cast(x, bf16) * w, float32)), and `make_opt`'s
    update of w."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data('x', shape=[n], dtype='float32',
                              append_batch_size=False)
        w = fluid.layers.create_parameter(
            [n], 'bfloat16', name='w',
            default_initializer=fluid.initializer.Constant(0.5))
        y = fluid.layers.elementwise_mul(fluid.layers.cast(x, 'bfloat16'), w)
        loss = fluid.layers.mean(fluid.layers.cast(y, 'float32'))
        make_opt(fluid.optimizer).minimize(loss)
    return main, startup, loss


def _c11_train(monkeypatch, make_opt, pt_opt):
    """Two steps (x = 1, then 2) of the program through each package from
    its own startup (the reference with PT_EMIT=0) -> the state after the
    startup and after each step, as (port, reference) {persistable:
    (dtype name, numpy)}."""
    monkeypatch.setenv('PT_EMIT', '0')
    monkeypatch.setenv('PT_OPT', pt_opt)
    jm, js, jl = _c11_program(jf, make_opt)
    tm, ts, tl = _c11_program(tf, make_opt)
    jscope, tscope = jf.Scope(), tf.Scope()
    with jf.scope_guard(jscope):
        jexe = jf.Executor()
        jexe.run(js)
    texe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(tscope):
        texe.run(ts)
    names = tf.persistable_names(tm)

    def state():
        return ({n: (str(tscope.vars[n].dtype).replace('torch.', ''),
                     tscope.vars[n].float().numpy().copy()) for n in names},
                {n: (str(jscope.vars[n].dtype),
                     np.asarray(jscope.vars[n]).astype('float32'))
                 for n in names})
    states = [state()]
    for xv in (1.0, 2.0):
        feed = {'x': np.full((4,), xv, 'float32')}
        with jf.scope_guard(jscope):
            jexe.run(jm, feed=feed, fetch_list=[jl])
        with tf.scope_guard(tscope):
            texe.run(tm, feed=feed, fetch_list=[tl])
        states.append(state())
    return states


@pytest.mark.parametrize('pt_opt', ['0', '1'])
def test_c11_two_sgd_steps_of_a_bf16_parameter(monkeypatch, pt_opt):
    """C11 as first seen: the reference gives float32 0.475 and
    0.42499998; the port gave bf16 0.47460938 and 0.42382812."""
    steps = _c11_train(monkeypatch, lambda o: o.SGD(learning_rate=0.1),
                       pt_opt)[1:]
    for (got, want), w in zip(steps, (0.475, 0.42499998)):
        assert want['w'][0] == got['w'][0] == 'float32'
        assert np.array_equal(want['w'][1], np.full(4, w, 'float32'))
        assert np.array_equal(got['w'][1], want['w'][1])


@pytest.mark.parametrize('pt_opt', ['0', '1'])
@pytest.mark.parametrize('name', ['Momentum', 'Adagrad'])
def test_c11_two_steps_under_momentum_and_adagrad(monkeypatch, name,
                                                   pt_opt):
    """Every persistable (the parameter, the velocity or moment, the
    learning rate) after each step: the reference's dtype, and its value
    within 2^-7 of the change the step made and one float32 unit.  The
    port rounds every bf16 operation, as the JAX op does run op by op;
    the reference's jitted step may keep a bf16 intermediate in float32
    (XLA's excess precision: Adagrad's first step gives 0.4000004, its
    sqrt(m) + eps unrounded, where the op gives 0.4)."""
    make = {'Momentum': lambda o: o.Momentum(learning_rate=0.1,
                                             momentum=0.9),
            'Adagrad': lambda o: o.Adagrad(learning_rate=0.1)}[name]
    states = _c11_train(monkeypatch, make, pt_opt)
    for (_, before), (got, want) in zip(states, states[1:]):
        assert sorted(got) == sorted(want)
        for n, (dt, w) in want.items():
            assert got[n][0] == dt, (n, got[n][0], dt)
            tol = 2.0 ** -7 * np.abs(w - before[n][1]) + \
                np.spacing(np.abs(w))
            assert (np.abs(got[n][1] - w) <= tol).all(), (n, got[n][1], w)
        assert want['w'][0] == 'float32'


def _c11_fused(case, n_ops):
    """A fused group of `n_ops` in-place update ops of `case` over [7]
    tensors and its input avals: the param, grad and state bf16, the
    learning rate float32."""
    from paddle_tpu_torch.core.passes.fuse import _fusable
    op_type, attrs = _C11_CASES[case]
    block = tf.Program().global_block()
    ops = []
    for i in range(n_ops):
        ins = {'Param': 'p%d' % i, 'Grad': 'g%d' % i, 'LearningRate': 'lr'}
        outs = {'ParamOut': 'p%d' % i}
        for slot in _c11_slots(op_type, attrs):
            ins[slot] = '%s%d' % (slot, i)
            outs[slot + 'Out'] = '%s%d' % (slot, i)
        ops.append(block.append_op(type=op_type, inputs=ins, outputs=outs,
                                   attrs=attrs, infer_shape=False))

    class Ctx(object):
        cf_pinned = ()
    subs = [_fusable(op, block, Ctx()) for op in ops]
    args, outs = [], []
    for s in subs:
        args += [n for ns in s['inputs'].values() for n in ns
                 if n not in args]
        outs += [n for ns in s['outputs'].values() for n in ns
                 if n not in outs]
    attrs = {'sub_ops': subs, 'arg_names': args, 'out_names': outs}
    avals = tuple(((1,), 'float32') if a == 'lr' else ((7,), 'bfloat16')
                  for a in args)
    return attrs, avals


@pytest.mark.parametrize('case', ['momentum', 'adagrad', 'rmsprop'])
def test_c11_the_plan_step_binds_the_promoted_outputs(case, monkeypatch):
    """The kernel generator's optimizer plan step (run_fused; its update
    the plain version on the CPU) against the fused op's replay of each
    sub-op on bf16 state: the same dtypes, bit for bit."""
    from paddle_tpu_torch.core.registry import ExecCtx
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.ops import kernelgen as tkg
    attrs, avals = _c11_fused(case, 2)
    plan = tkg.plan_for(attrs, avals, False)
    assert [st[0] for st in plan.steps] == [_C11_CASES[case][0]]
    rng = np.random.RandomState(4)
    xs = [torch.from_numpy(np.abs(rng.randn(*s)).astype('float32') * 0.1)
          .to(getattr(torch, d)) for s, d in avals]
    monkeypatch.setattr(tkg, '_launch', lambda spec, ents: [
        o.detach() for o in spec.replay(list(ents))])
    ctx = ExecCtx('cpu', 0, 0).for_op(0, tf.Program().global_block()
                                      .append_op('fused_elementwise',
                                                 infer_shape=False))
    want = fused.replay(ctx, [x.clone() for x in xs], attrs, False)
    got = tkg.run_fused(ctx, [x.clone() for x in xs], attrs, False)
    assert [t.dtype for t in got] == [t.dtype for t in want]
    assert torch.float32 in [t.dtype for t in got]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------- C12

# Each op that takes a Python constant, with constants that bf16 does not
# hold exactly (jnp rounds them to bf16 first, as weak types)
_C12_CASES = {
    'relu6': ('relu6', {'threshold': 5.3}),
    'leaky_relu': ('leaky_relu', {'alpha': 0.3}),
    'elu': ('elu', {'alpha': 0.7}),
    'selu': ('selu', {}),
    'brelu': ('brelu', {'t_min': -1.3, 't_max': 5.3}),
    'soft_relu': ('soft_relu', {'threshold': 3.3}),
    'hard_sigmoid': ('hard_sigmoid', {}),
    'stanh': ('stanh', {}),
    'pow': ('pow', {'factor': 1.3}),
    'thresholded_relu': ('thresholded_relu', {'threshold': 1.006}),
    'hard_shrink': ('hard_shrink', {'threshold': 0.3}),
    'softshrink': ('softshrink', {'lambda': 0.3}),
    'scale': ('scale', {'scale': 0.3, 'bias': 0.1}),
    'scale_bias_first': ('scale', {'scale': 0.3, 'bias': 0.1,
                                   'bias_after_scale': False}),
    'swish': ('swish', {'beta': 0.3}),
    'clip': ('clip', {'min': -1.3, 'max': 2.3}),
    # the sweep's sites: increment's step, dropout's test-time scale and
    # its upscale divisor, the sigmoid (jnp's three bf16 operations)
    'increment': ('increment', {'step': 0.1}),
    'dropout_test': ('dropout', {'dropout_prob': 0.3, 'is_test': True}),
    'dropout_upscale_test': ('dropout', {
        'dropout_prob': 0.3, 'is_test': True,
        'dropout_implementation': 'upscale_in_train'}),
    'sigmoid': ('sigmoid', {}),
}


def _every_bf16():
    """Every bf16 value but the subnormals (XLA on the CPU reads them as
    0; the card keeps them): +-0, +-inf, NaNs and every threshold's
    neighbours included, as uint16 bits."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    exp = (bits >> 7) & 0xff
    return bits[(exp != 0) | ((bits & 0x7f) == 0)]


def _bf16_bits(out):
    """A bf16 result as uint16 bits, every NaN as one pattern."""
    import ml_dtypes
    b = np.asarray(out).view(np.uint16).copy()
    b[np.isnan(b.view(ml_dtypes.bfloat16).astype(np.float32))] = 0x7fc0
    return b


@pytest.mark.parametrize('case', sorted(_C12_CASES))
def test_c12_bf16_op_matches_the_jax_op_bit_for_bit(case):
    """The op on every bf16 value (normal, zero, infinite, NaN) against the
    JAX op: each Python constant meets the tensor as jnp's weak type,
    rounded to bf16 first, so every result is the same bf16."""
    import ml_dtypes
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    op, attrs = _C12_CASES[case]
    bits = _every_bf16()
    want = jreg.get_op(op).impl(None, {'X': jnp.asarray(
        bits.view(ml_dtypes.bfloat16))}, attrs)['Out']
    # XLA on the CPU flushes float32 subnormals, intermediate ones too:
    # torch does as well while this is set, on the thread that sets it,
    # so on one thread (the card keeps them)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        got = treg.get_op(op)(None, {'X': torch.from_numpy(
            bits.view(np.int16)).view(torch.bfloat16)}, attrs)['Out']
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got = _bf16_bits(got.view(torch.int16).numpy())
    want = _bf16_bits(np.asarray(want))
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, [(float(bits[i:i + 1].view(ml_dtypes.bfloat16)[0]),
                            hex(got[i]), hex(want[i])) for i in bad[:6]]


@pytest.mark.parametrize('case', sorted(_C12_CASES))
def test_c12_float32_results_are_unchanged(case, monkeypatch):
    """On float32 the rounding is the identity: the op equals itself with
    every constant left as the Python float, bit for bit."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.ops import math as tmath, nn as tnn, sequence
    op, attrs = _C12_CASES[case]
    rng = np.random.RandomState(12)
    x = torch.from_numpy(np.concatenate([
        (rng.randn(4096) * 4).astype('float32'),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 5.3, 1.006, -1.3, 0.3,
                  -0.3, 2.3, 3.3], 'float32')]))
    got = treg.get_op(op)(None, {'X': x}, attrs)['Out']
    for mod in (tmath, tnn, sequence):
        monkeypatch.setattr(mod, 'weak', lambda v, t: v)
    want = treg.get_op(op)(None, {'X': x}, attrs)['Out']
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _c12_rule_source(op, attrs, dtype):
    from paddle_tpu_torch.ops import kernelgen as tkg
    sub = {'type': op, 'inputs': {'X': ['x']}, 'outputs': {'Out': ['o']},
           'input_is_list': {'X': False}, 'output_is_list': {'Out': False},
           'attrs': dict(attrs), 'stop_grad': []}
    fa = {'sub_ops': [sub], 'arg_names': ['x'], 'out_names': ['o'],
          'fused_count': 1}
    tkg.clear_plan_cache()
    plan = tkg.plan_for(fa, (((5, 8), dtype),), False)
    assert [s[0] for s in plan.steps] == ['kernel']
    return tkg.generated_source([plan.steps[0][1].name])


_C12_RULE_CONSTANTS = {
    'relu6': [5.3], 'leaky_relu': [0.3], 'elu': [0.7],
    'selu': [1.0507009873554805, 1.6732632423543772],
    'brelu': [-1.3, 5.3], 'soft_relu': [3.3, -3.3],
    'hard_sigmoid': [0.2], 'stanh': [1.7159, 2.0 / 3.0], 'pow': [1.3],
    'thresholded_relu': [1.006], 'hard_shrink': [0.3],
    'softshrink': [0.3, -0.3], 'scale': [0.3], 'scale_bias_first': [0.3],
    'swish': [0.3], 'clip': [-1.3, 2.3], 'increment': [0.1],
    'dropout_test': [0.7],
}


@pytest.mark.parametrize('case', sorted(_C12_RULE_CONSTANTS))
def test_c12_rule_writes_each_constant_in_the_tensors_dtype(case):
    """The generated segment of each touched kernel rule carries the
    bf16-rounded constant into a bf16 segment's CUDA source, and the
    float32 constant, as before, into a float32 one (the card holds
    each segment to its plain op bit for bit: chip_smoke.py's kernels
    phase, `kernelgen_rule_bf16`)."""
    from paddle_tpu_torch.ops.kernelgen.rules import float_lit
    op, attrs = _C12_CASES[case]
    for v in _C12_RULE_CONSTANTS[case]:
        r = float(torch.tensor(v, dtype=torch.bfloat16))
        assert r != float(np.float32(v))
        bf16 = _c12_rule_source(op, attrs, 'bfloat16')
        f32 = _c12_rule_source(op, attrs, 'float32')
        assert float_lit(r) in bf16 and float_lit(v) not in bf16, v
        assert float_lit(v) in f32 and float_lit(r) not in f32, v
