"""softmax_with_cross_entropy's soft-label and any-axis branch (ops/loss.py)
against the JAX op on the CPU, from numpy inputs made from a seed: the
loss, the `Softmax` output and the gradient with respect to the logits
(the JAX side through `jax.vjp`, the port's through autograd, under one
random cotangent of the loss).

Tolerances:
- float32: within 1e-5 relative, with an absolute floor of 1e-5 times
  the largest magnitude of the compared array (a gradient entry near 0
  is a difference of two O(1) terms);
- bfloat16 logits: the loss and `Softmax` are float32 on both sides,
  computed from the same exactly widened logits, so the float32 bound
  holds; the gradient comes back in bf16, where two float32 values a few
  units apart may round to neighbouring bf16 values: within one bf16
  unit, 2^-8 of the compared array's largest magnitude.

The chain `one_hot -> label_smooth -> soft-label cross-entropy` equals
the fused `label_smooth_eps` closed form up to float32 summation: per
row |chain - fused| <= (V + 8) 2^-24 sum_j |soft_j logp_j| (V products
summed, against a mean of V values and two scaled terms), in both
packages.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as tf
from paddle_tpu_torch.core import registry as treg
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

_JCTX = types.SimpleNamespace(mesh=None)
_OP = 'softmax_with_cross_entropy'


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


def _close(got, want, rtol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    floor = rtol * max(float(np.nanmax(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def _soft(rng, shape, axis):
    p = rng.rand(*shape).astype('float32') + 0.05
    return p / p.sum(axis=axis, keepdims=True)


def _hard(rng, shape, axis, ignore):
    V = shape[axis]
    lab_shape = list(shape)
    lab_shape[axis] = 1
    lab = rng.randint(0, V, lab_shape).astype('int64')
    flat = lab.reshape(-1)
    flat[::5] = ignore               # every fifth row ignored
    flat[1] = -1                     # a negative label wraps once
    return lab


# case -> (logits shape, attrs)
CASES = {
    'soft_last': ((6, 7), {'soft_label': True}),
    'soft_rank3_last': ((2, 3, 9), {'soft_label': True}),
    'soft_axis1': ((3, 8, 4), {'soft_label': True, 'axis': 1}),
    'hard_axis0': ((7, 3, 4), {'axis': 0, 'ignore_index': 2}),
    'hard_axis1_smooth': ((3, 9, 4), {'axis': 1, 'label_smooth_eps': 0.1,
                                       'ignore_index': -100}),
    'hard_axis0_smooth_ignore': ((8, 2, 5), {'axis': 0,
                                             'label_smooth_eps': 0.2,
                                             'ignore_index': 3}),
}


def _inputs(case, dtype):
    shape, attrs = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    logits = (rng.randn(*shape) * 2).astype('float32')
    axis = attrs.get('axis', -1) % len(shape)
    if attrs.get('soft_label'):
        label = _soft(rng, shape, axis)
    else:
        label = _hard(rng, shape, axis, attrs.get('ignore_index', -100))
    if dtype == 'bfloat16':
        logits = np.asarray(jnp.asarray(logits, jnp.bfloat16))
    g = rng.randn(*[1 if i == axis else d for i, d in enumerate(shape)]
                  ).astype('float32')
    return logits, label, g, attrs


def _jax_side(logits, label, g, attrs):
    lab = jnp.asarray(label if label.dtype != np.int64
                      else label.astype('int32'))

    def f(lg):
        out = jreg.get_op(_OP).impl(_JCTX, {'Logits': lg, 'Label': lab},
                                    attrs)
        return out['Loss'], out['Softmax']
    (loss, sm), vjp = jax.vjp(f, jnp.asarray(logits))
    dlogits, = vjp((jnp.asarray(g), jnp.zeros_like(sm)))
    return (np.asarray(loss, np.float32), np.asarray(sm, np.float32),
            np.asarray(dlogits.astype(jnp.float32)), str(dlogits.dtype))


def _torch_side(logits, label, g, attrs, dtype):
    if dtype == 'bfloat16':
        lg = torch.from_numpy(logits.astype('float32')).to(torch.bfloat16)
    else:
        lg = torch.from_numpy(logits)
    lg.requires_grad_(True)
    lab = torch.from_numpy(label.astype('int32') if label.dtype == np.int64
                           else label)
    out = treg.get_op(_OP)(None, {'Logits': lg, 'Label': lab}, attrs)
    out['Loss'].backward(torch.from_numpy(g))
    return (out['Loss'].detach().float().numpy(),
            out['Softmax'].detach().float().numpy(),
            lg.grad.float().numpy(), lg.grad.dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_general_branch_matches_the_jax_op(case, dtype):
    logits, label, g, attrs = _inputs(case, dtype)
    jl, js, jg, jdt = _jax_side(logits, label, g, attrs)
    tl, ts, tg, tdt = _torch_side(logits, label, g, attrs, dtype)
    assert np.isfinite(tl).all() and np.isfinite(tg).all()
    _close(tl, jl)
    _close(ts, js)
    assert tdt == (torch.bfloat16 if dtype == 'bfloat16' else torch.float32)
    assert jdt == dtype
    _close(tg, jg, rtol=2.0 ** -8 if dtype == 'bfloat16' else 1e-5)


def test_softmax_is_built_only_when_read():
    """`Softmax` (a float32 tensor of the logits' shape) is computed only
    when a later op reads it or the run fetches it (`ctx.wants`)."""
    logits, label, _, attrs = _inputs('soft_axis1', 'float32')
    ctx = types.SimpleNamespace(wants=lambda slot: slot != 'Softmax')
    out = treg.get_op(_OP)(ctx, {'Logits': torch.from_numpy(logits),
                                 'Label': torch.from_numpy(label)}, attrs)
    assert 'Softmax' not in out and out['Loss'].shape == (3, 1, 4)


def _chain_bound(soft, logp, V):
    return (V + 8) * 2.0 ** -24 * np.abs(soft * logp).sum(-1, keepdims=True)


@pytest.mark.parametrize('eps', [0.1, 0.25])
def test_one_hot_label_smooth_soft_ce_equals_the_fused_form(eps):
    """one_hot -> label_smooth -> soft-label CE against the fused
    label_smooth_eps form, in each package, and the port's chain against
    the JAX chain."""
    rng = np.random.RandomState(23)
    B, T, V = 3, 5, 64
    logits = (rng.randn(B, T, V) * 3).astype('float32')
    lab = rng.randint(0, V, (B, T, 1)).astype('int32')

    def chain(reg, conv, ctx):
        op = (lambda n: reg.get_op(n).impl) if reg is jreg else reg.get_op
        oh = op('one_hot')(ctx, {'X': conv(lab)}, {'depth': V})['Out']
        soft = op('label_smooth')(ctx, {'X': oh}, {'epsilon': eps})['Out']
        loss = op(_OP)(ctx, {'Logits': conv(logits), 'Label': soft},
                       {'soft_label': True})['Loss']
        fused = op(_OP)(ctx, {'Logits': conv(logits), 'Label': conv(lab)},
                        {'label_smooth_eps': eps})['Loss']
        return (np.asarray(loss), np.asarray(fused), np.asarray(soft))

    jc, jfu, jsoft = chain(jreg, jnp.asarray, _JCTX)
    tc, tfu, tsoft = chain(treg, torch.from_numpy, None)
    np.testing.assert_array_equal(tsoft, jsoft)
    logp = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    bound = _chain_bound(jsoft, logp, V)
    assert (np.abs(jc - jfu) <= bound).all()
    assert (np.abs(tc - tfu) <= bound).all()
    _close(tc, jc)
    _close(tfu, jfu)


def test_layer_writes_the_reference_desc_and_raises_where_it_raises():
    """The layer's default desc is the reference's (no `axis` attr), a
    non-default axis is written, and soft labels with label_smooth_eps
    raise in both packages."""
    attrs = {}
    for pkg in (jf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data('x', shape=[4, 6], dtype='float32')
            y = pkg.layers.data('y', shape=[4, 6], dtype='float32')
            pkg.layers.softmax_with_cross_entropy(x, y, soft_label=True)
            with pytest.raises(ValueError):
                pkg.layers.softmax_with_cross_entropy(
                    x, y, soft_label=True, label_smooth_eps=0.1)
        attrs[pkg.__name__] = {k: v for k, v in main.global_block().ops[-1]
                               .attrs.items() if k != 'op_role'}
    assert attrs['paddle_tpu'] == attrs['paddle_tpu_torch']
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        x = tf.layers.data('x', shape=[4, 6], dtype='float32')
        y = tf.layers.data('y', shape=[1, 6], dtype='int64')
        tf.layers.softmax_with_cross_entropy(x, y, axis=1)
    assert main.global_block().ops[-1].attrs['axis'] == 1
