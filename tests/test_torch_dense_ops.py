"""The dense op and layer surface (ROADMAP A10) on the CPU against the JAX
package, from numpy inputs made from a seed: each op of ops/{math,
tensor,loss,nn}.py that the port added, its outputs and, where the
reference differentiates, the gradients of one output with respect to
its float inputs (the JAX side through `jax.vjp`, the port's through
autograd, under one random cotangent); each layer's desc against the
reference layer's, and the layers run through both executors; the
kernel rules of label_smooth, fill_zeros_like and flatten.

Tolerances, each with its reason:
- exact ops (layout, indexing, padding, compares, arg, sort, one_hot,
  shape, max / min, the reductions of integers and bools): equal, NaN
  where NaN;
- float ops that sum, divide or call a transcendental (mean, prod, the
  norms, losses, convolutions, pools, resizes, lrn): within 1e-5
  relative, with an absolute floor of 1e-5 times the compared array's
  largest magnitude (both compute in float32, in other orders: XLA's
  reductions and convolutions against ATen's and oneDNN's);
- bf16 label_smooth: bit for bit (each constant rounded to bf16 first,
  as jnp's weak types are: ROADMAP C12);
- gradients: as their op's outputs, 1e-4 relative for the convolutions
  (the backward sums over the batch and the window in other orders).
"""
import json
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as tf
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.ops import kernelgen as tkg
from paddle_tpu_torch.ops.kernelgen.rules import float_lit
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
    tkg.clear_plan_cache()
    yield
    framework.switch_main_program(old_main)
    framework.switch_startup_program(old_startup)
    unique_name.switch(old_gen)
    executor._global_scope = old_scope


_JCTX = types.SimpleNamespace(mesh=None, rng=lambda: jax.random.key(0))


class _TCtx(object):
    """A port op context on the CPU (the draws from one fixed seed)."""
    device = torch.device('cpu')
    recomputing = False

    def generator(self, seed=0):
        return torch.Generator().manual_seed(5)

    def wants(self, slot):
        return True

    def upload(self, host):
        return torch.from_numpy(host)


def _f(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype('float32')


def _t(v):
    if isinstance(v, list):
        return [_t(x) for x in v]
    if v.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(v))


def _np(t):
    if isinstance(t, list):
        return [_np(x) for x in t]
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(t)


# name -> (op, inputs(rng) -> {slot: array or [arrays]}, attrs, outputs
#          compared, tolerance 'exact' | rtol, float inputs differentiated
#          (of the first output))
C = {}


def case(name, op, ins, attrs=None, outs=('Out',), tol='exact', grad=()):
    C[name] = (op, ins, attrs or {}, outs, tol, grad)


SPEC = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 2.0, -3.0, 2.0],
                'float32')


def _with_specials(rng, *shape):
    x = _f(rng, *shape)
    x.reshape(-1)[:SPEC.size] = SPEC
    return x


# -------------------------------------------------------- the reductions
for _op in ('reduce_mean', 'reduce_max', 'reduce_min', 'reduce_prod'):
    _tol = 'exact' if _op in ('reduce_max', 'reduce_min') else 1e-5
    case(_op + '_dim', _op, lambda r: {'X': _f(r, 3, 4, 5)},
         {'dim': [1, -1], 'keep_dim': False}, tol=_tol, grad=('X',))
    case(_op + '_keep', _op, lambda r: {'X': _f(r, 3, 4, 5)},
         {'dim': [0], 'keep_dim': True}, tol=_tol, grad=('X',))
    case(_op + '_all', _op, lambda r: {'X': _f(r, 3, 4)},
         {'reduce_all': True}, tol=_tol, grad=('X',))
    case(_op + '_all_keep', _op, lambda r: {'X': _f(r, 2, 3)},
         {'reduce_all': True, 'keep_dim': True}, tol=_tol)
    case(_op + '_specials', _op, lambda r: {'X': _with_specials(r, 4, 8)},
         {'dim': [1]}, tol=_tol)
    case(_op + '_int32', _op, lambda r: {'X': r.randint(-4, 5, (3, 6))
                                         .astype('int32')}, {'dim': [1]},
         tol='exact' if _op != 'reduce_mean' else 1e-6)
case('reduce_mean_bf16', 'reduce_mean', lambda r: {'X': _f(r, 4, 33).astype(
    ml_dtypes.bfloat16)}, {'dim': [1]})
case('reduce_prod_int8', 'reduce_prod', lambda r: {'X': r.randint(
    -3, 4, (3, 7)).astype('int8')}, {'dim': [1]})
case('reduce_sum_bool', 'reduce_sum', lambda r: {'X': r.rand(4, 5) > 0.5},
     {'dim': [1]})
for _op in ('reduce_all', 'reduce_any'):
    case(_op + '_bool', _op, lambda r: {'X': r.rand(4, 5, 3) > 0.3},
         {'dim': [1, 2]})
    case(_op + '_float', _op, lambda r: {'X': np.where(
        r.rand(3, 4) > 0.5, 0.0, _with_specials(r, 3, 4)).astype(
            'float32')}, {'dim': [1], 'keep_dim': True})
    case(_op + '_all', _op, lambda r: {'X': r.rand(3, 4) > 0.1},
         {'reduce_all': True})

# ------------------------------------------------------------- ops/math
for _mode, _ashape in (('all', (1,)), ('channel', (3,)),
                       ('element', (3, 4, 5))):
    case('prelu_' + _mode, 'prelu',
         (lambda s: lambda r: {'X': _with_specials(r, 2, 3, 4, 5),
                               'Alpha': _f(r, *s)})(_ashape),
         {'mode': _mode}, grad=('X', 'Alpha'))
case('l2_normalize', 'l2_normalize', lambda r: {'X': _f(r, 3, 5, 4)},
     {'axis': 1, 'epsilon': 1e-12}, outs=('Out', 'Norm'), tol=1e-5,
     grad=('X',))
case('l2_normalize_eps', 'l2_normalize', lambda r: {'X': _f(r, 4, 3) * 1e-3},
     {'axis': -1, 'epsilon': 0.03}, outs=('Out', 'Norm'), tol=1e-5)
for _op in ('isfinite', 'has_inf', 'has_nan'):
    case(_op + '_specials', _op, lambda r: {'X': _with_specials(r, 3, 4)})
    case(_op + '_normal', _op, lambda r: {'X': _f(r, 3, 4)})
case('maxout', 'maxout', lambda r: {'X': _f(r, 2, 6, 3, 4)}, {'groups': 3},
     grad=('X',))

# ----------------------------------------------------------- ops/tensor
case('flatten', 'flatten', lambda r: {'X': _f(r, 2, 3, 4, 5)}, {'axis': 2},
     grad=('X',))
case('flatten_0', 'flatten', lambda r: {'X': _f(r, 2, 3)}, {'axis': 0})
case('stack', 'stack', lambda r: {'X': [_f(r, 3, 4) for _ in range(3)]},
     {'axis': 1}, outs=('Y',))
case('unstack', 'unstack', lambda r: {'X': _f(r, 3, 4, 2)}, {'axis': 1},
     outs=('Y',))
case('expand', 'expand', lambda r: {'X': _f(r, 2, 3)},
     {'expand_times': [2, 3]}, grad=('X',))
case('expand_rank_up', 'expand', lambda r: {'X': _f(r, 3)},
     {'expand_times': [2, 2]})
case('expand_as', 'expand_as', lambda r: {'X': _f(r, 2, 1, 3),
                                          'target_tensor': _f(r, 4, 5, 3)},
     grad=('X',))
for _name, _st in (('pos', [1, 2]), ('neg', [-1, -2]), ('mixed', [2, -1])):
    case('strided_slice_' + _name, 'strided_slice',
         (lambda st: lambda r: {'Input': _f(r, 7, 9)})(_st),
         {'axes': [0, 1], 'starts': [1, -2] if _st[1] < 0 else [1, 2],
          'ends': [6, 0] if _st[1] < 0 else [-1, 9], 'strides': _st},
         grad=('Input',))
case('gather', 'gather', lambda r: {'X': _f(r, 5, 3), 'Index': np.array(
    [0, 4, -1, 2, 5, -6], 'int32')}, grad=('X',))
case('gather_col', 'gather', lambda r: {'X': r.randint(0, 9, (5, 2)).astype(
    'int32'), 'Index': np.array([[1], [7], [-2]], 'int32')})
case('scatter_set', 'scatter', lambda r: {'X': _f(r, 6, 3), 'Ids': np.array(
    [4, -1, 0, 9], 'int32'), 'Updates': _f(r, 4, 3)}, {'overwrite': True},
     grad=('X', 'Updates'))
case('scatter_add', 'scatter', lambda r: {'X': _f(r, 6, 3), 'Ids': np.array(
    [[1], [1], [5], [-7]], 'int32'), 'Updates': _f(r, 4, 3)},
     {'overwrite': False}, grad=('X', 'Updates'))
case('gather_nd', 'gather_nd', lambda r: {'X': _f(r, 4, 5, 2),
                                          'Index': np.array(
    [[0, 1], [3, 4], [5, 9], [-1, -1], [-6, 0]], 'int32')}, grad=('X',))
case('pad', 'pad', lambda r: {'X': _f(r, 2, 3)},
     {'paddings': [1, 0, 2, 3], 'pad_value': 0.5}, grad=('X',))
for _mode in ('constant', 'reflect', 'edge'):
    case('pad2d_' + _mode, 'pad2d', lambda r: {'X': _f(r, 2, 3, 4, 5)},
         {'paddings': [1, 2, 3, 1], 'mode': _mode, 'pad_value': -1.0},
         grad=('X',))
case('pad2d_nhwc', 'pad2d', lambda r: {'X': _f(r, 2, 4, 5, 3)},
     {'paddings': [2, 0, 1, 1], 'mode': 'reflect', 'data_format': 'NHWC'})
case('pad_constant_like', 'pad_constant_like', lambda r: {
    'X': _f(r, 4, 5), 'Y': _f(r, 2, 3)}, {'pad_value': 2.5}, grad=('Y',))
case('one_hot', 'one_hot', lambda r: {'X': np.array([[0], [3], [-1], [5],
                                                     [2]], 'int32')},
     {'depth': 4})
case('one_hot_rank3', 'one_hot', lambda r: {'X': r.randint(0, 7, (2, 3, 1))
                                            .astype('int64')}, {'depth': 7})
case('label_smooth', 'label_smooth', lambda r: {'X': r.rand(3, 7).astype(
    'float32')}, {'epsilon': 0.1}, tol=1e-6, grad=('X',))
case('label_smooth_prior', 'label_smooth', lambda r: {
    'X': r.rand(3, 7).astype('float32'),
    'PriorDist': r.rand(1, 7).astype('float32')}, {'epsilon': 0.2},
     tol=1e-6, grad=('X', 'PriorDist'))
case('label_smooth_bf16', 'label_smooth', lambda r: {
    'X': r.rand(4, 9).astype(ml_dtypes.bfloat16)}, {'epsilon': 0.1})
case('label_smooth_bf16_prior', 'label_smooth', lambda r: {
    'X': r.rand(4, 9).astype(ml_dtypes.bfloat16),
    'PriorDist': r.rand(9).astype(ml_dtypes.bfloat16)}, {'epsilon': 0.3})
case('fill_zeros_like', 'fill_zeros_like', lambda r: {'X': _f(r, 3, 2)})
case('fill_zeros_like_int', 'fill_zeros_like', lambda r: {
    'X': np.ones((2, 5), 'int32')})
case('shape', 'shape', lambda r: {'Input': _f(r, 2, 3, 5)})
for _op in ('arg_max', 'arg_min'):
    case(_op, _op, lambda r: {'X': np.round(_f(r, 4, 6))}, {'axis': 1})
    case(_op + '_nan', _op, lambda r: {'X': _with_specials(r, 2, 8)},
         {'axis': -1})
case('argsort', 'argsort', lambda r: {'X': np.round(_with_specials(r, 3, 8))},
     {'axis': -1}, outs=('Out', 'Indices'), grad=('X',))
case('argsort_axis0', 'argsort', lambda r: {'X': _f(r, 5, 3)}, {'axis': 0},
     outs=('Out', 'Indices'))
case('reverse', 'reverse', lambda r: {'X': _f(r, 2, 3, 4)}, {'axis': [0, -1]},
     grad=('X',))
case('multiplex', 'multiplex', lambda r: {
    'X': [_f(r, 4, 3) for _ in range(3)],
    'Ids': np.array([[2], [0], [5], [-1]], 'int32')})
case('space_to_depth', 'space_to_depth', lambda r: {'X': _f(r, 2, 3, 4, 6)},
     {'blocksize': 2}, grad=('X',))
case('shuffle_channel', 'shuffle_channel', lambda r: {'X': _f(r, 2, 6, 3, 2)},
     {'group': 3}, grad=('X',))

# ------------------------------------------------------------- ops/loss
case('smooth_l1_loss', 'smooth_l1_loss', lambda r: {
    'X': _f(r, 4, 3), 'Y': _f(r, 4, 3)}, {'sigma': 1.5},
     outs=('Out', 'Diff'), tol=1e-5, grad=('X', 'Y'))
case('smooth_l1_loss_weights', 'smooth_l1_loss', lambda r: {
    'X': _f(r, 4, 2, 3), 'Y': _f(r, 4, 2, 3),
    'InsideWeight': r.rand(4, 2, 3).astype('float32'),
    'OutsideWeight': r.rand(4, 2, 3).astype('float32')}, {},
     outs=('Out', 'Diff'), tol=1e-5, grad=('X',))
case('huber_loss', 'huber_loss', lambda r: {'X': _f(r, 5, 1, scale=2),
                                            'Y': _f(r, 5, 1)},
     {'delta': 0.7}, outs=('Out', 'Residual'), tol=1e-5, grad=('X', 'Y'))
case('log_loss', 'log_loss', lambda r: {
    'Predicted': r.rand(6, 1).astype('float32'),
    'Labels': (r.rand(6, 1) > 0.5).astype('float32')}, {'epsilon': 1e-4},
     outs=('Loss',), tol=1e-5, grad=('Predicted',))
case('rank_loss', 'rank_loss', lambda r: {
    'Label': (r.rand(5, 1) > 0.5).astype('float32'), 'Left': _f(r, 5, 1),
    'Right': _f(r, 5, 1)}, tol=1e-5, grad=('Left', 'Right'))
case('margin_rank_loss', 'margin_rank_loss', lambda r: {
    'Label': np.sign(_f(r, 6, 1)), 'X1': _f(r, 6, 1), 'X2': _f(r, 6, 1)},
     {'margin': 0.1}, outs=('Out', 'Activated'), tol=1e-6, grad=('X1',))
case('bpr_loss', 'bpr_loss', lambda r: {
    'X': _f(r, 5, 6), 'Label': np.array([[0], [5], [2], [-1], [3]],
                                        'int64')}, outs=('Y',), tol=1e-5,
     grad=('X',))
for _red in ('mean', 'sum', 'batchmean', 'none'):
    case('kldiv_loss_' + _red, 'kldiv_loss', lambda r: {
        'X': np.log(r.rand(4, 5).astype('float32') + 0.1),
        'Target': r.rand(4, 5).astype('float32')}, {'reduction': _red},
         outs=('Loss',), tol=1e-5, grad=('X', 'Target'))

# --------------------------------------------------------------- ops/nn
case('conv3d', 'conv3d', lambda r: {'Input': _f(r, 2, 4, 5, 6, 5),
                                    'Filter': _f(r, 6, 2, 3, 2, 3)},
     {'strides': [1, 2, 1], 'paddings': [1, 0, 1], 'dilations': [1, 1, 2],
      'groups': 2}, outs=('Output',), tol=1e-5, grad=('Input', 'Filter'))
case('conv2d_transpose', 'conv2d_transpose', lambda r: {
    'Input': _f(r, 2, 4, 5, 6), 'Filter': _f(r, 4, 3, 3, 2)},
     {'strides': [2, 1], 'paddings': [1, 0], 'dilations': [1, 2]},
     outs=('Output',), tol=1e-5, grad=('Input', 'Filter'))
case('conv2d_transpose_groups', 'conv2d_transpose', lambda r: {
    'Input': _f(r, 1, 6, 4, 4), 'Filter': _f(r, 6, 2, 3, 3)},
     {'strides': [2, 2], 'paddings': [1, 1], 'groups': 3},
     outs=('Output',), tol=1e-5, grad=('Input', 'Filter'))
case('conv3d_transpose', 'conv3d_transpose', lambda r: {
    'Input': _f(r, 1, 3, 3, 4, 3), 'Filter': _f(r, 3, 2, 2, 3, 2)},
     {'strides': [2, 1, 2], 'paddings': [0, 1, 0]}, outs=('Output',),
     tol=1e-5, grad=('Input', 'Filter'))
for _pt in ('max', 'avg'):
    case('pool3d_' + _pt, 'pool3d', lambda r: {'X': _f(r, 2, 3, 5, 6, 7)},
         {'ksize': [2, 3, 2], 'strides': [2, 2, 3], 'paddings': [1, 0, 1],
          'pooling_type': _pt, 'ceil_mode': True}, tol=1e-5, grad=('X',))
    case('pool3d_global_' + _pt, 'pool3d', lambda r: {'X': _f(r, 2, 3, 3, 4,
                                                                2)},
         {'global_pooling': True, 'pooling_type': _pt}, tol=1e-5)
    case('adaptive_pool2d_' + _pt, 'adaptive_pool2d', lambda r: {
        'X': _f(r, 2, 3, 6, 8)}, {'ksize': [3, 2], 'pooling_type': _pt},
         tol=1e-5, grad=('X',))
    case('adaptive_pool3d_' + _pt, 'adaptive_pool3d', lambda r: {
        'X': _f(r, 1, 2, 4, 6, 4)}, {'ksize': 2, 'pooling_type': _pt},
         tol=1e-5, grad=('X',))
case('pool3d_avg_inclusive', 'pool3d', lambda r: {'X': _f(r, 1, 2, 4, 4, 4)},
     {'ksize': [3, 3, 3], 'strides': [1, 1, 1], 'paddings': [1, 1, 1],
      'pooling_type': 'avg', 'exclusive': False}, tol=1e-5)
case('group_norm', 'group_norm', lambda r: {
    'X': _f(r, 2, 6, 3, 4, scale=3) + 1, 'Scale': _f(r, 6), 'Bias': _f(r, 6)},
     {'groups': 3, 'epsilon': 1e-5}, outs=('Y', 'Mean', 'Variance'),
     tol=1e-5, grad=('X', 'Scale', 'Bias'))
case('group_norm_bf16', 'group_norm', lambda r: {
    'X': _f(r, 2, 4, 5).astype(ml_dtypes.bfloat16)}, {'groups': 2},
     outs=('Y', 'Mean', 'Variance'), tol=1e-5)
case('log_softmax', 'log_softmax', lambda r: {'X': _f(r, 3, 7, scale=3)},
     {'axis': -1}, tol=1e-5, grad=('X',))
case('log_softmax_axis0', 'log_softmax', lambda r: {'X': _f(r, 4, 3)},
     {'axis': 0}, tol=1e-5)
case('lrn', 'lrn', lambda r: {'X': _f(r, 2, 7, 3, 3)},
     {'n': 5, 'k': 1.0, 'alpha': 1e-2, 'beta': 0.75},
     outs=('Out', 'MidOut'), tol=1e-5, grad=('X',))
for _m in ('bilinear', 'nearest'):
    for _ac in (True, False):
        for _sz, _hw in (('up', (7, 9)), ('down', (3, 2))):
            case('%s_interp_%s_%s' % (_m, 'ac' if _ac else 'half', _sz),
                 _m + '_interp', lambda r: {'X': _f(r, 2, 3, 5, 6)},
                 {'out_h': _hw[0], 'out_w': _hw[1], 'align_corners': _ac},
                 tol=1e-5, grad=('X',) if _m == 'bilinear' else ())
case('affine_channel', 'affine_channel', lambda r: {
    'X': _f(r, 2, 3, 4, 2), 'Scale': _f(r, 3), 'Bias': _f(r, 3)}, tol=1e-6,
     grad=('X', 'Scale', 'Bias'))


def _compare(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol == 'exact':
        if want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == want.dtype
            got, want = got.view(np.int16), want.view(np.int16)
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got = got.astype(np.float64)
    want = want.astype(np.float64)
    floor = tol * max(float(np.nanmax(np.abs(want))) if want.size else 0,
                      1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=floor,
                               err_msg=what)


def _dtype_name(a):
    return str(np.asarray(a).dtype)


@pytest.mark.parametrize('name', sorted(C))
def test_op_matches_the_jax_op(name):
    op, make, attrs, outs, tol, grad = C[name]
    ins = make(np.random.RandomState(sum(map(ord, name))))
    jins = {k: [jnp.asarray(a) for a in v] if isinstance(v, list)
            else jnp.asarray(v) for k, v in ins.items()}
    tins = {k: _t(v) for k, v in ins.items()}
    keys = sorted(jins)

    def jfn(*vals):
        return jreg.get_op(op).impl(_JCTX, dict(zip(keys, vals)), attrs)
    if tol != 'exact':
        # one compiled function, not one per jnp call (the exact cases
        # stay eager: a fused bf16 chain need not round each operation)
        jfn = jax.jit(jfn)
    jout = jfn(*[jins[k] for k in keys])
    tout = treg.get_op(op)(_TCtx(), tins, attrs)
    for slot in outs:
        jv, tv = jout[slot], _np(tout[slot])
        if isinstance(jv, (list, tuple)):
            assert len(jv) == len(tv)
            for a, b in zip(tv, jv):
                _compare(a, np.asarray(b), tol, slot)
            continue
        jv = np.asarray(jv)
        # 64-bit results are computed in 32 bits on both sides
        assert _dtype_name(tv) == _dtype_name(jv), (slot, tv.dtype, jv.dtype)
        _compare(tv, jv, tol, slot)
    if not grad:
        return
    g = np.random.RandomState(1).randn(*np.shape(jout[outs[0]])).astype(
        'float32')

    def f(*xs):
        d = dict(jins)
        d.update(zip(grad, xs))
        return jfn(*[d[k] for k in keys])[outs[0]]
    _, vjp = jax.vjp(f, *[jins[k] for k in grad])
    jgrads = vjp(jnp.asarray(g))
    leaves = {k: _t(ins[k]).requires_grad_(True) for k in grad}
    tins.update(leaves)
    treg.get_op(op)(_TCtx(), tins, attrs)[outs[0]].backward(_t(g))
    gtol = 1e-4 if op.startswith('conv') else (1e-5 if tol == 'exact'
                                               else tol)
    for k, jg in zip(grad, jgrads):
        _compare(leaves[k].grad.numpy(), np.asarray(jg), gtol, 'd' + k)


@pytest.mark.parametrize('op', ['uniform_random_batch_size_like',
                                'gaussian_random_batch_size_like'])
def test_batch_size_like_draws(op):
    """The draw's shape and dtype are the JAX op's (the draws themselves
    differ, as the two packages' generators do), from the op's own
    generator: one seed draws the same, another seed another."""
    attrs = {'shape': [-1, 64], 'input_dim_idx': 1, 'output_dim_idx': 0,
             'dtype': 'float32', 'min': -2.0, 'max': 3.0, 'mean': 1.0,
             'std': 2.0}
    x = np.zeros((3, 50), 'float32')
    jv = np.asarray(jreg.get_op(op).impl(_JCTX, {'Input': jnp.asarray(x)},
                                         attrs)['Out'])
    tv = treg.get_op(op)(_TCtx(), {'Input': _t(x)}, attrs)['Out'].numpy()
    assert tv.shape == jv.shape == (50, 64) and tv.dtype == jv.dtype
    if op.startswith('uniform'):
        assert tv.min() >= -2.0 and tv.max() < 3.0
    else:
        assert abs(tv.mean() - 1.0) < 0.1 and abs(tv.std() - 2.0) < 0.1
    again = treg.get_op(op)(_TCtx(), {'Input': _t(x)}, attrs)['Out']
    assert np.array_equal(again.numpy(), tv)


# ---------------------------------------------------------------- layers

def _desc(fluid, program):
    d = json.loads(json.dumps(fluid.io.program_to_desc(program)))
    for b in d['blocks']:
        for op in b['ops']:
            op.pop('source_loc', None)
    return d


def _data(L, name, shape, dtype='float32'):
    return L.data(name, shape=shape, dtype=dtype)


# family -> (builder(L) -> fetched vars, feeds(rng) -> dict, tolerance)
LAYERS = {}


def layer_family(name, feeds, tol=1e-5):
    def deco(fn):
        LAYERS[name] = (fn, feeds, tol)
        return fn
    return deco


@layer_family('activations', lambda r: {'x': _f(r, 3, 6, scale=3),
                                        'y': _f(r, 3, 6)})
def _acts(L):
    x, y = _data(L, 'x', [6]), _data(L, 'y', [6])
    return [L.elu(x, 0.7), L.leaky_relu(x, 0.1), L.relu6(x, 4.0),
            L.pow(L.abs(x), 1.5), L.log(L.abs(x) + 1.0), L.selu(x),
            L.hard_sigmoid(x), L.brelu(x, -1.0, 2.0), L.soft_relu(x, 5.0),
            L.stanh(x), L.sum([x, y, x]), L.mul(x, L.transpose(y, [1, 0])),
            L.topk(x, 2)[0], L.topk(x, 2)[1]]


@layer_family('compare_logical', lambda r: {
    'x': np.round(_f(r, 3, 4)), 'y': np.round(_f(r, 3, 4))}, tol='exact')
def _cmp(L):
    x, y = _data(L, 'x', [4]), _data(L, 'y', [4])
    a, b = L.less_than(x, y), L.equal(x, y)
    c = L.increment(L.scale(x, 1.0), 2.0, in_place=False)
    return [a, b, L.logical_and(a, b), L.logical_or(a, b),
            L.logical_xor(a, b), L.logical_not(a), c,
            L.argmax(x, 1), L.argmin(x, 1), L.argsort(x, 1)[0],
            L.argsort(x, 1)[1], L.reverse(x, 1), L.has_inf(x),
            L.has_nan(x), L.isfinite(x), L.zeros_like(x),
            L.ones([2, 3], 'float32'), L.zeros([3], 'int32'), L.shape(x)]


@layer_family('reduce_shape', lambda r: {'x': _f(r, 2, 3, 4),
                                         'i': r.randint(0, 3, (2, 1))
                                         .astype('int64')})
def _red(L):
    x, i = _data(L, 'x', [3, 4]), _data(L, 'i', [1], 'int64')
    s = L.stack([x, x], axis=1)
    u = L.unstack(x, axis=1)
    return [L.reduce_mean(x, dim=1), L.reduce_max(x, dim=[1, 2],
                                                  keep_dim=True),
            L.reduce_min(x), L.reduce_prod(x, dim=-1), L.flatten(x, 2), s,
            u[0], u[2], L.expand(x, [1, 2, 1]), L.gather(x, i),
            L.pad(x, [0, 0, 1, 0, 0, 2], 1.5),
            L.pad2d(L.unsqueeze(x, [1]), [1, 0, 0, 1], mode='edge'),
            L.one_hot(i, 5), L.label_smooth(L.one_hot(i, 5), epsilon=0.2),
            L.multiplex([x, L.scale(x, 2.0)], L.cast(i, 'int32')),
            L.l2_normalize(x, 2), L.space_to_depth(
                L.reshape(x, [-1, 1, 2, 6]), 2),
            L.shuffle_channel(L.reshape(x, [-1, 3, 2, 2]), 3),
            L.maxout(L.reshape(x, [-1, 4, 3, 1]), 2)]


@layer_family('losses', lambda r: {'x': _f(r, 4, 3), 'y': _f(r, 4, 3),
                                   'p': r.rand(4, 1).astype('float32'),
                                   'l': (r.rand(4, 1) > 0.5).astype(
                                       'float32'),
                                   'c': r.randint(0, 3, (4, 1)).astype(
                                       'int64')})
def _losses(L):
    x, y = _data(L, 'x', [3]), _data(L, 'y', [3])
    p, lab, c = _data(L, 'p', [1]), _data(L, 'l', [1]), \
        _data(L, 'c', [1], 'int64')
    return [L.smooth_l1(x, y, sigma=2.0), L.huber_loss(x, y, 0.5),
            L.log_loss(p, lab), L.rank_loss(lab, p, L.scale(p, 0.5)),
            L.margin_rank_loss(lab, p, L.scale(p, 0.3)), L.bpr_loss(x, c),
            L.softmax_with_cross_entropy(x, L.softmax(y), soft_label=True)]


@layer_family('params', lambda r: {'x': _f(r, 2, 4, 6, 6),
                                   'v': _f(r, 2, 2, 4, 4, 4)})
def _params(L):
    x, v = _data(L, 'x', [4, 6, 6]), _data(L, 'v', [2, 4, 4, 4])
    return [L.prelu(x, 'channel'), L.prelu(x, 'all'),
            L.group_norm(x, 2), L.conv3d(v, 3, 2, padding=1, act='relu'),
            L.conv2d_transpose(x, 3, filter_size=3, stride=2),
            L.conv2d_transpose(x, 2, output_size=[13, 13], stride=2),
            L.conv3d_transpose(v, 2, filter_size=2, stride=2),
            L.pool3d(v, 2, 'avg', 2), L.adaptive_pool2d(x, 3, 'avg'),
            L.adaptive_pool3d(v, [2, 2, 1]), L.lrn(x, 3),
            L.affine_channel(x, L.create_parameter([4], 'float32', 'acs'),
                             L.create_parameter([4], 'float32', 'acb')),
            L.image_resize(x, [9, 7]), L.resize_bilinear(x, scale=1.5),
            L.resize_nearest(x, [3, 4], align_corners=False),
            L.image_resize_short(x, 4)]


@pytest.mark.parametrize('family', sorted(LAYERS))
def test_layers_build_and_run_as_the_reference(family):
    build, feeds, tol = LAYERS[family]
    progs = {}
    for pkg in (jf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetch = build(pkg.layers)
        progs[pkg.__name__] = (main, startup, fetch)
    (jmain, jstart, jfetch), (tmain, tstart, tfetch) = \
        progs['paddle_tpu'], progs['paddle_tpu_torch']
    assert _desc(tf, tmain) == _desc(jf, jmain)
    assert _desc(tf, tstart) == _desc(jf, jstart)
    feed = feeds(np.random.RandomState(7))
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jexe = jf.Executor()
        jexe.run(jstart)
        jres = jexe.run(jmain, feed=feed, fetch_list=jfetch)
    names = tf.persistable_names(tmain)
    tscope = tf.scope_from_numpy({n: np.asarray(jscope.vars[n])
                                  for n in names}, tf.Scope(), 'cpu')
    with tf.scope_guard(tscope):
        tres = tf.Executor(tf.CPUPlace()).run(tmain, feed=feed,
                                              fetch_list=tfetch)
    for k, (t, j) in enumerate(zip(tres, jres)):
        assert np.asarray(t).dtype == np.asarray(j).dtype, k
        _compare(t, j, tol, '%s fetch %d' % (family, k))


def test_the_port_has_the_reference_layer_names_of_this_surface():
    import inspect
    import paddle_tpu.layers as jl
    import paddle_tpu_torch.layers as tl
    for n in ('reduce_mean', 'reduce_max', 'reduce_min', 'reduce_prod',
              'one_hot', 'label_smooth', 'zeros_like', 'increment',
              'create_tensor', 'gaussian_random', 'group_norm',
              'conv3d_transpose', 'image_resize_short', 'affine_channel'):
        assert inspect.signature(getattr(tl, n)) == \
            inspect.signature(getattr(jl, n)), n
    v = tl.create_tensor('float32', name='ct')
    assert v.name == 'ct' and v.dtype == 'float32'
    g = tl.gaussian_random([3, 4], seed=2)
    assert tuple(g.shape) == (3, 4)


# ------------------------------------------------------------ kernel rules

def _sub(type, inputs, outputs, attrs=None):
    return {'type': type, 'inputs': {k: list(v) for k, v in inputs.items()},
            'outputs': {k: list(v) for k, v in outputs.items()},
            'input_is_list': {k: False for k in inputs},
            'output_is_list': {k: False for k in outputs},
            'attrs': dict(attrs or {}), 'stop_grad': []}


def _plan(subs, args, avals, outs=('o',)):
    fa = {'sub_ops': subs, 'arg_names': list(args), 'out_names': list(outs),
          'fused_count': len(subs)}
    return tkg.plan_for(fa, tuple(avals), False)


# rule case -> (sub-ops, arg names, input avals)
RULES = {
    'label_smooth': ([_sub('label_smooth', {'X': ['x']}, {'Out': ['o']},
                           {'epsilon': 0.1})], ['x'], [((6, 7), None)]),
    'label_smooth_prior': ([_sub('label_smooth', {'X': ['x'],
                                                  'PriorDist': ['p']},
                                 {'Out': ['o']}, {'epsilon': 0.3})],
                           ['x', 'p'], [((6, 7), None), ((7,), None)]),
    'fill_zeros_like': ([_sub('fill_zeros_like', {'X': ['x']},
                              {'Out': ['o']})], ['x'], [((5, 4), None)]),
    # a flatten between two kernel ops is a flat alias inside the kernel
    # (of a materialized input it is a view between kernels, as reshape)
    'flatten_scale': ([_sub('scale', {'X': ['x']}, {'Out': ['s']},
                            {'scale': 3.0}),
                       _sub('flatten', {'X': ['s']}, {'Out': ['f']},
                            {'axis': 2}),
                       _sub('scale', {'X': ['f']}, {'Out': ['o']},
                            {'scale': 0.5})], ['x'], [((2, 3, 4, 5), None)]),
}


def _rule_avals(avals, dtype):
    return [(s, dtype) for s, _ in avals]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(RULES))
def test_rule_plans_one_kernel_and_replays_its_plain_op(case, dtype):
    """Each new rule plans as one generated kernel (flatten as a flat alias
    inside it) whose plain replay, the segment's backward and the
    card's reference, is the unfused ops bit for bit."""
    subs, args, avals = RULES[case]
    plan = _plan(subs, args, _rule_avals(avals, dtype))
    assert [s[0] for s in plan.steps] == ['kernel'], plan.steps
    spec = plan.steps[0][1]
    rng = np.random.RandomState(3)
    xs = [torch.from_numpy(rng.rand(*s).astype('float32')).to(
        getattr(torch, dtype)) for s, _ in avals]
    got, = spec.replay(xs)
    env = dict(zip(args, xs))
    for sub in subs:
        ins = {k: env[v[0]] for k, v in sub['inputs'].items()}
        out = treg.get_op(sub['type'])(_TCtx(), ins, sub['attrs'])['Out']
        env[sub['outputs']['Out'][0]] = out
    want = env['o']
    assert got.dtype == want.dtype and torch.equal(
        got.reshape(want.shape).view(torch.int16 if dtype == 'bfloat16'
                                     else torch.int32),
        want.view(torch.int16 if dtype == 'bfloat16' else torch.int32))
    src = tkg.generated_source([spec.name])
    assert '// %s' % subs[-1]['type'] in src


@pytest.mark.parametrize('prior', [False, True])
def test_label_smooth_rule_writes_each_constant_in_the_tensors_dtype(prior):
    """1 - eps and eps / V (or eps against PriorDist) as a bf16 segment
    reads them: rounded to bf16 first (ROADMAP C12); a float32 segment
    keeps the float32 constants."""
    eps, V = 0.1, 7
    case = 'label_smooth_prior' if prior else 'label_smooth'
    consts = [1 - eps] + ([0.3] if prior else [eps / V])
    if prior:
        consts = [1 - 0.3, 0.3]
    subs, args, avals = RULES[case]
    for v in consts:
        r = float(torch.tensor(v, dtype=torch.bfloat16))
        assert r != float(np.float32(v))
        tkg.clear_plan_cache()
        bf16 = tkg.generated_source([_plan(subs, args, _rule_avals(
            avals, 'bfloat16')).steps[0][1].name])
        tkg.clear_plan_cache()
        f32 = tkg.generated_source([_plan(subs, args, _rule_avals(
            avals, 'float32')).steps[0][1].name])
        assert float_lit(r) in bf16 and float_lit(v) not in bf16, v
        assert float_lit(v) in f32 and float_lit(r) not in f32, v


def test_label_smooth_bf16_is_the_jax_op_bit_for_bit():
    """On every finite bf16 value of X, under torch's flush of subnormals
    as XLA's CPU flushes them."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = bits.view(ml_dtypes.bfloat16).reshape(-1, 16)
    x = np.where(np.isfinite(x.astype('float32')), x,
                 np.zeros_like(x)).astype(ml_dtypes.bfloat16)
    want = np.asarray(jreg.get_op('label_smooth').impl(
        _JCTX, {'X': jnp.asarray(x)}, {'epsilon': 0.1})['Out'])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        got = treg.get_op('label_smooth')(_TCtx(), {'X': _t(x)},
                                          {'epsilon': 0.1})['Out']
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got).view(np.int16),
                                  want.view(np.int16))
