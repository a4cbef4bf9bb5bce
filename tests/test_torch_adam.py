"""Port Adam against the JAX package's `adam` op: `adam_reference` (the
per-tensor loop), `adam_multi` (the CPU path of csrc/adam.cu's wrapper),
the single `adam` op, and the executor's grouping of consecutive in-place
adam ops into one `adam_multi` call.

Tolerance: rtol 1e-6, and an atol of one unit in the last place of the
tensor's largest value — the same float32 operations in the same order on
both sides; XLA's and PyTorch's sqrt and divide may round an intermediate
the other way, which moves a result by about a unit in the last place."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.ops import optimizer_ops as oo
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

# sizes 1 and 7, one not a multiple of the kernel's chunk, a 2-D one
SHAPES = [(1,), (7,), (oo._CHUNK + 1,), (3, 50)]
B1, B2, EPS = 0.9, 0.997, 1e-9


def _close(actual, desired, msg=''):
    np.testing.assert_allclose(
        actual, desired, rtol=1e-6,
        atol=float(np.spacing(np.abs(desired).max())), err_msg=msg)


def _state(seed):
    rng = np.random.RandomState(seed)
    return {
        'Param': [rng.randn(*s).astype('float32') * 0.1 for s in SHAPES],
        'Moment1': [np.zeros(s, 'float32') for s in SHAPES],
        'Moment2': [np.zeros(s, 'float32') for s in SHAPES],
        'Beta1Pow': [np.full((1,), B1, 'float32') for _ in SHAPES],
        'Beta2Pow': [np.full((1,), B2, 'float32') for _ in SHAPES],
    }


def _grads(rng):
    return [rng.randn(*s).astype('float32') * 1e-2 for s in SHAPES]


def _jax_steps(state, grads_per_step, lrs):
    st = {k: [jnp.asarray(a) for a in v] for k, v in state.items()}
    impl = jreg.get_op('adam').impl
    for grads, lr in zip(grads_per_step, lrs):
        for i, g in enumerate(grads):
            out = impl(None, {'Param': st['Param'][i], 'Grad': jnp.asarray(g),
                              'LearningRate': jnp.asarray([lr], 'float32'),
                              'Moment1': st['Moment1'][i],
                              'Moment2': st['Moment2'][i],
                              'Beta1Pow': st['Beta1Pow'][i],
                              'Beta2Pow': st['Beta2Pow'][i]},
                       {'beta1': B1, 'beta2': B2, 'epsilon': EPS})
            for slot in st:
                st[slot][i] = out[slot + 'Out' if slot != 'Param'
                                  else 'ParamOut']
    return {k: [np.asarray(a) for a in v] for k, v in st.items()}


@pytest.mark.parametrize('fn', ['adam_reference', 'adam_multi'])
def test_three_steps_match_the_jax_adam_op(fn):
    state = _state(0)
    rng = np.random.RandomState(1)
    grads = [_grads(rng) for _ in range(3)]
    lrs = [1e-3, 2e-3, 5e-4]
    ref = _jax_steps(state, grads, lrs)
    t = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in state.items()}
    for step, (g, lr) in enumerate(zip(grads, lrs)):
        lr_t = torch.tensor([lr])
        getattr(oo, fn)(t['Param'], [torch.from_numpy(a) for a in g],
                        t['Moment1'], t['Moment2'], t['Beta1Pow'],
                        t['Beta2Pow'], [lr_t] * len(SHAPES), B1, B2, EPS)
        # the powers advance once per step, for every tensor
        for b1p, b2p in zip(t['Beta1Pow'], t['Beta2Pow']):
            np.testing.assert_allclose(b1p.numpy(), [B1 ** (step + 2)],
                                       rtol=1e-6)
            np.testing.assert_allclose(b2p.numpy(), [B2 ** (step + 2)],
                                       rtol=1e-6)
    for slot, arrays in ref.items():
        for i, a in enumerate(arrays):
            _close(t[slot][i].numpy(), a, '%s[%d]' % (slot, i))


def test_single_adam_op_is_functional_and_matches_jax():
    """The registered `adam` op leaves its inputs untouched and returns the
    updated state, as the JAX op does."""
    state = _state(2)
    g = _grads(np.random.RandomState(3))
    ref = _jax_steps(state, [g], [1e-3])
    from paddle_tpu_torch.core import registry as treg
    ins = {k: torch.from_numpy(v[2].copy()) for k, v in state.items()}
    before = {k: v.clone() for k, v in ins.items()}
    ins['Grad'] = torch.from_numpy(g[2])
    ins['LearningRate'] = torch.tensor([1e-3])
    out = treg.get_op('adam')(None, ins,
                              {'beta1': B1, 'beta2': B2, 'epsilon': EPS})
    for k, v in before.items():
        assert torch.equal(ins[k], v), k
    for slot in state:
        name = 'ParamOut' if slot == 'Param' else slot + 'Out'
        _close(out[name].numpy(), ref[slot][2], slot)


def test_executor_groups_consecutive_in_place_adam_ops():
    """Adam ops that write their own inputs and share beta1/beta2/epsilon
    form one group; a differing beta2 or an op that writes elsewhere ends
    it (the executor runs the latter through the functional op)."""
    from paddle_tpu_torch.core import executor
    from paddle_tpu_torch.core.framework import Program

    prog = Program()
    block = prog.global_block()
    ops = []
    for i, (b2, out_suffix) in enumerate([(B2, ''), (B2, ''), (0.99, ''),
                                          (0.99, '_new')]):
        names = {s: '%s_%d' % (s, i) for s in (
            'Param', 'Grad', 'Moment1', 'Moment2', 'Beta1Pow', 'Beta2Pow')}
        ops.append(block.append_op(
            type='adam',
            inputs=dict(names, LearningRate='lr'),
            outputs={'ParamOut': names['Param'] + out_suffix,
                     'Moment1Out': names['Moment1'],
                     'Moment2Out': names['Moment2'],
                     'Beta1PowOut': names['Beta1Pow'],
                     'Beta2PowOut': names['Beta2Pow']},
            attrs={'beta1': B1, 'beta2': b2, 'epsilon': EPS},
            infer_shape=False))
    live = list(range(len(ops)))
    assert executor._optimizer_run(ops, live, 0)[0] == 2
    assert executor._optimizer_run(ops, live, 2)[0] == 3
    assert executor._optimizer_run(ops, live, 3) == (3, None)
