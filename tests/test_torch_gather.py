"""Port embedding gather (plain version, the CPU path of its kernel
wrapper) against the JAX package's Pallas DMA gather in interpret mode and
its `embedding_gather` wrapper.  A gather copies rows: equality is exact."""
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.ops import gather as jgather
from paddle_tpu_torch.ops import gather as tgather
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)


@pytest.fixture
def jax_kernel_gate(monkeypatch):
    """The JAX wrapper's `_MIN_ROWS` gate was measured on a TPU; lower it
    so the Pallas kernel path runs at test sizes (as the JAX package's own
    tests/test_gather_kernel.py does)."""
    monkeypatch.setattr(jgather, '_MIN_ROWS', jgather._BLOCK)


def _table(seed, V, D):
    return np.random.RandomState(seed).randn(V, D).astype('float32')


def test_plain_matches_jax_pallas_kernel():
    w = _table(0, 512, 128)
    ids = np.random.RandomState(1).randint(0, 512, (jgather._BLOCK * 2,))
    jout = jgather._pallas_gather(jnp.asarray(w), jnp.asarray(ids, jnp.int32),
                                  interpret=True)
    out = tgather.embedding_gather(torch.from_numpy(w),
                                   torch.from_numpy(ids.astype('int32')))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize('ids_dtype', ['int32', 'int64'])
def test_wrap_and_nan_match_jax_wrapper(jax_kernel_gate, ids_dtype):
    V, D = 300, 128
    w = _table(2, V, D)
    ids = np.random.RandomState(3).randint(0, V, (jgather._BLOCK,))
    # negative ids wrap once by +V; ids still out of range give NaN rows
    ids[:6] = [-1, -V, V, V + 7, -V - 1, 5]
    ids = ids.astype(ids_dtype)
    jout = np.asarray(jgather.embedding_gather(
        jnp.asarray(w), jnp.asarray(ids.astype('int32'))))
    out = tgather.embedding_gather(torch.from_numpy(w),
                                   torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(out, jout)   # NaN positions included
    assert np.isnan(out[2:5]).all() and not np.isnan(out[[0, 1, 5]]).any()
    np.testing.assert_array_equal(out[0], w[V - 1])
    np.testing.assert_array_equal(out[1], w[0])


def test_multi_dim_ids(jax_kernel_gate):
    w = _table(4, 1000, 256)
    ids = np.random.RandomState(5).randint(-1000, 1000, (4, 64, 3))
    jout = np.asarray(jgather.embedding_gather(
        jnp.asarray(w), jnp.asarray(ids, jnp.int32)))
    out = tgather.embedding_gather(torch.from_numpy(w),
                                   torch.from_numpy(ids)).numpy()
    assert out.shape == (4, 64, 3, 256)
    np.testing.assert_array_equal(out, jout)


@pytest.mark.parametrize('padding_idx', [-1, 0, 7])
def test_lookup_table_op_padding_idx(jax_kernel_gate, padding_idx):
    """padding_idx masking stays in the lookup_table op, outside the
    gather, in both packages; ids arrive as [..., 1]."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    V, D = 64, 128
    w = _table(6, V, D)
    ids = np.random.RandomState(7).randint(0, V, (2, 128, 1))
    ids[0, :5, 0] = [0, 7, 7, 0, 3]
    attrs = {'padding_idx': padding_idx, 'is_sparse': False}
    jout = np.asarray(jreg.get_op('lookup_table').impl(
        types.SimpleNamespace(mesh=None),
        {'W': jnp.asarray(w), 'Ids': jnp.asarray(ids, jnp.int32)},
        attrs)['Out'])
    out = treg.get_op('lookup_table')(
        None, {'W': torch.from_numpy(w),
               'Ids': torch.from_numpy(ids.astype('int32'))}, attrs)['Out']
    np.testing.assert_array_equal(out.numpy(), jout)
    if padding_idx >= 0:
        assert np.all(out.numpy()[ids[..., 0] == padding_idx] == 0.0)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The launch wrapper validates before it touches the device."""
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match='float32, bfloat16 or float16'):
        tgather._launch_gather(torch.zeros(4, 4, dtype=torch.float64), ids)
    with pytest.raises(TypeError, match='int32 or int64'):
        tgather._launch_gather(torch.zeros(4, 4), ids.to(torch.int16))
    with pytest.raises(ValueError, match=r'\[V, D\] table and \[N\] ids'):
        tgather._launch_gather(torch.zeros(4, 4), ids.reshape(2, 4))
    with pytest.raises(ValueError, match='contiguous'):
        tgather._launch_gather(torch.zeros(4, 8)[:, ::2], ids)
