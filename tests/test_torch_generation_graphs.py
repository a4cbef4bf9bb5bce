"""Generation's compiled windows (paddle_tpu_torch/serving/generation/
decode.py: `DecodeRuntime._compiled`, `_prefill_exec`, `_window_exec`,
`warmup`) on the CPU, against the JAX runtime (paddle_tpu/serving/
generation/decode.py) where it has a counterpart.

On the card each key is one captured CUDA graph; a capture reads the
addresses of the state and of the static inputs, so the step was
restructured for it: the state updated in place, host inputs as static
device buffers filled before each call, prefill's scalars as device
values, rope's tables made once a step, one QKV product a layer.  On the
CPU the same entries run their bodies eagerly.  Here:

- the restructured prefill, decode and verify against the JAX runtime on
  the same numpy weights: every step's logits, the cache rows, lengths
  and tok, at the tolerance of tests/test_torch_generation.py (rtol 1e-5
  plus 1e-5 of the largest |logit|: both packages compute in float32 but
  sum products in other orders), float32 and int8 KV;
- `warmup` builds the JAX runtime's keys;
- every state tensor keeps its address across every entry point;
- the warm-up a capture runs first (every input zero: every slot
  inactive, a prefill of no tokens) changes nothing outside page 0;
- rope's tables give the parent's per-layer values bit for bit, and the
  q / k / v weights are views of the fused one.

The JAX side runs with PT_CACHE=0 (no disk tier)."""
import numpy as np
import pytest
import torch

import jax

from paddle_tpu.serving import generation as jgen
from paddle_tpu.serving.generation import decode as jdec
from paddle_tpu_torch.serving import generation as tgen
from paddle_tpu_torch.serving.generation import decode as tdec
from paddle_tpu_torch.testing import faults as tfaults
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

CFG = dict(vocab=64, d_model=32, n_layer=2, n_head=4, n_kv_head=2,
           d_ffn=64, theta=10000.0, max_len=32)
PROMPTS = ([1, 5, 9, 2, 7, 3], [4, 4, 9])


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """The JAX side's compile cache off, no fault armed."""
    monkeypatch.setenv('PT_CACHE', '0')
    monkeypatch.delenv('PT_FAULT', raising=False)
    tfaults.reset()
    yield
    tfaults.reset()


def _pair(slots=3, chunk=4, **kw):
    w = jdec.random_weights(CFG, seed=0)
    return (jgen.DecodeRuntime(w, CFG, slots=slots, prefill_chunk=chunk,
                               **kw),
            tgen.DecodeRuntime(w, CFG, slots=slots, prefill_chunk=chunk,
                               device='cpu', **kw))


def _assert_logits(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def _spy(monkeypatch, mod, store, to_numpy):
    real = mod.sample_tokens_at

    def spy(logits, seeds, positions, temps, topks):
        to_numpy(store, positions, logits)
        return real(logits, seeds, positions, temps, topks)

    monkeypatch.setattr(mod, 'sample_tokens_at', spy)


def _jax_rows(store, positions, logits):
    jax.debug.callback(lambda p, lg: store.append(
        (tuple(np.asarray(p)[:2]), np.asarray(lg)[:2].copy())),
        positions, logits)


def _port_rows(store, positions, logits):
    store.append((tuple(positions.numpy()[:2]), logits.numpy()[:2].copy()))


def _state(rt):
    return {n: np.asarray(v).copy() if not isinstance(v, torch.Tensor)
            else v.numpy().copy() for n, v in rt.state.items()}


def _prefilled(rt, SP):
    """Both prompts prefilled into slots 0 and 1 (pages for two windows
    after them); -> the final chunks' (token, logits)."""
    firsts = []
    for p in PROMPTS:
        slot = rt.alloc_slot()
        assert rt.try_begin(slot, p, 8) == 0
        for off in range(0, len(p), rt.prefill_chunk):
            first = rt.prefill(slot, p[off:off + rt.prefill_chunk], off,
                               SP())
        firsts.append(first)
    return firsts


@pytest.mark.parametrize('kv_quant', [None, 'int8'])
def test_restructured_steps_match_the_jax_runtime(monkeypatch, kv_quant):
    """Chunked prefill of two prompts, one decode window of 4 and one
    verify window of 4 (the same fed tokens in both packages), then a
    commit: logits at every step, tokens, the slots' cache rows, lengths
    and tok within the float32 tolerance of the JAX runtime."""
    jstore, tstore = [], []
    _spy(monkeypatch, jdec, jstore, _jax_rows)
    _spy(monkeypatch, tdec, tstore, _port_rows)
    jr, tr = _pair(page_len=4, prefix_cache=False, kv_quant=kv_quant)
    act = np.asarray([True, True, False])
    zi, zf = np.zeros(3, np.int32), np.zeros(3, np.float32)
    fed = np.asarray([[0, 3, 9, 1], [0, 8, 2, 6], [0, 0, 0, 0]], np.int32)
    out = {}
    for name, rt, SP in (('jax', jr, jgen.SamplingParams),
                         ('port', tr, tgen.SamplingParams)):
        firsts = _prefilled(rt, SP)
        dec = rt.decode_window(4, act, zi, zf, zi)
        f = fed.copy()
        f[:2, 0] = dec[:2, -1]
        ver = rt.verify_window(4, f, act, zi, zf, zi)
        rt.commit_speculation({0: (2, int(ver[0, 1])),
                               1: (1, int(ver[1, 0]))})
        out[name] = (firsts, dec, ver, _state(rt),
                     [rt.cache_row(s) for s in (0, 1)])
    (jf, jd, jv, jst, jrows), (tf, td, tv, tst, trows) = out['jax'], \
        out['port']
    for (jt, jl), (tt, tl) in zip(jf, tf):
        _assert_logits(tl, jl)
        assert tt == jt
    np.testing.assert_array_equal(td[:2], jd[:2])
    np.testing.assert_array_equal(tv[:2], jv[:2])
    assert len(jstore) == len(tstore) == 8
    ref = dict(jstore)
    for pos, lg in tstore:
        _assert_logits(lg, ref[pos])
    for n in ('lengths', 'tok'):
        np.testing.assert_array_equal(tst[n], jst[n])
    for (jk, jv_, jl), (tk, tv_, tl) in zip(jrows, trows):
        assert tl == jl
        for a, b in ((tk, jk), (tv_, jv_)):
            np.testing.assert_allclose(a[:, :, :tl], b[:, :, :tl],
                                       rtol=1e-5, atol=1e-5)


def test_warmup_builds_the_reference_keys():
    jr, tr = _pair(slots=2, chunk=4)
    tr.warmup()
    assert set(tr._execs) == {('prefill', 4)}
    jr.warmup(3, speculative=True)
    tr.warmup(3, speculative=True)
    assert set(tr._execs) == set(jr._execs) == {
        ('prefill', 4), ('decode', 3), ('verify', 3)}
    # on the CPU no key holds a graph: the bodies run eagerly
    assert tr._graphs is None
    assert all(e.graph is None for e in tr._execs.values())
    # a key is built once
    entry = tr._execs[('decode', 3)]
    tr.decode_window(3, np.zeros(2, bool), np.zeros(2), np.zeros(2),
                     np.zeros(2))
    assert tr._execs[('decode', 3)] is entry and len(tr._execs) == 3


@pytest.mark.parametrize('kv_quant', [None, 'int8'])
def test_state_tensors_keep_their_addresses(kv_quant):
    tr = _pair(page_len=4, kv_quant=kv_quant)[1]
    ptrs = {n: t.data_ptr() for n, t in tr.state.items()}
    objs = dict(tr.state)

    def same():
        assert {n: t.data_ptr() for n, t in tr.state.items()} == ptrs
        assert all(tr.state[n] is t for n, t in objs.items())

    _prefilled(tr, tgen.SamplingParams)
    same()
    act = np.asarray([True, True, False])
    zi, zf = np.zeros(3, np.int64), np.zeros(3, np.float32)
    tr.decode_window(2, act, zi, zf, zi)
    same()
    g = tr.verify_window(3, np.ones((3, 3), np.int64), act, zi, zf, zi)
    same()
    tr.commit_speculation({0: (1, int(g[0, 0])), 1: (2, int(g[1, 1]))})
    same()
    np.testing.assert_array_equal(tr.state['lengths'].numpy(), tr.host_len)
    np.testing.assert_array_equal(tr.state['tok'].numpy(), tr.host_tok)
    tr.reset()
    same()
    assert all(not t.any() for t in tr.state.values())


@pytest.mark.parametrize('kv_quant', [None, 'int8'])
def test_warm_up_changes_nothing_outside_page_0(kv_quant):
    """`warmup` builds the keys; on the card each is captured after one
    run of its body with every input zero (`_Compiled.warm_up`).  That
    run, here on the CPU, leaves every page but the garbage page 0, and
    lengths and tok, bit for bit as they were; the streams after it equal
    those of a runtime never warmed."""
    tr = _pair(page_len=4, prefix_cache=False, kv_quant=kv_quant)[1]
    fresh = _pair(page_len=4, prefix_cache=False, kv_quant=kv_quant)[1]
    act = np.asarray([True, True, False])
    zi, zf = np.zeros(3, np.int64), np.zeros(3, np.float32)
    for rt in (tr, fresh):
        _prefilled(rt, tgen.SamplingParams)
        rt.decode_window(2, act, zi, zf, zi)
    for t in tr.state.values():
        if t.dim() > 1:
            t[0] = 7                       # page 0: a value no write makes
    before = _state(tr)
    tr.warmup(4, speculative=True)
    assert set(tr._execs) == {('prefill', 4), ('decode', 2), ('decode', 4),
                              ('verify', 4)}
    for entry in tr._execs.values():
        entry.warm_up()
    after = _state(tr)
    for n, t in before.items():
        if t.ndim > 1:
            np.testing.assert_array_equal(after[n][1:], t[1:])
            assert (after[n][0] != 7).any(), n     # the warm-ups wrote there
        else:
            np.testing.assert_array_equal(after[n], t)
    for rt in (tr, fresh):
        rt.ensure_capacity(0, 10)
        rt.ensure_capacity(1, 7)
    np.testing.assert_array_equal(tr.decode_window(4, act, zi, zf, zi)[:2],
                                  fresh.decode_window(4, act, zi, zf, zi)[:2])
    for n in ('lengths', 'tok'):
        assert torch.equal(tr.state[n], fresh.state[n])


def test_rope_tables_give_the_parents_values_bitwise():
    """cos / sin made once a step from the positions, as the parent made
    them twice a layer inside `_rope_at`: the same values bit for bit; and
    within float32 rounding of the JAX function."""
    rng = np.random.RandomState(0)
    dh, theta = 8, 10000.0
    x = torch.from_numpy(rng.randn(3, 4, 5, dh).astype(np.float32))
    pos = torch.from_numpy(rng.randint(0, 30, (3, 5)))

    def parent(x, pos):
        half = torch.arange(0, dh // 2, dtype=torch.float32)
        freqs = torch.pow(theta, -half * 2.0 / dh)
        ang = pos[:, None, :, None].float() * freqs
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(x.shape)

    cos, sin = tdec._rope_tables(pos, tdec._rope_freqs(dh, theta, 'cpu'))
    got = tdec._rope(x, cos, sin)
    assert torch.equal(got, parent(x, pos))
    ref = np.asarray(jdec._rope_at(x.numpy(), pos.numpy(), theta))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_fused_qkv_keeps_the_weights_as_views():
    w = tdec.random_weights(CFG, seed=0)
    rt = tgen.DecodeRuntime(w, CFG, slots=2, device='cpu')
    H, Hkv, D = CFG['n_head'], CFG['n_kv_head'], CFG['d_model']
    for i in range(CFG['n_layer']):
        fused = rt._wqkv[i]
        assert tuple(fused.shape) == (D, (H + 2 * Hkv) * (D // H))
        for x in 'qkv':
            n = 'layer_%d_att_%s_w' % (i, x)
            np.testing.assert_array_equal(rt.w[n].numpy(), w[n])
            assert rt.w[n].untyped_storage().data_ptr() == \
                fused.untyped_storage().data_ptr()
    # one product against the fused weight, three against the views:
    # the same q, k, v within float32 rounding
    h = torch.from_numpy(np.random.RandomState(1).randn(2, 3, D)
                         .astype(np.float32))
    for a, b in zip(tdec._qkv_fused(rt._wqkv[0], CFG, h),
                    tdec._qkv(rt.w, CFG, h, 0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    # the dense reference reads the views as it read the arrays
    for a, b in zip(tdec.dense_reference(rt.w, CFG, PROMPTS[0]),
                    tdec.dense_reference(w, CFG, PROMPTS[0])):
        np.testing.assert_array_equal(a, b)


def test_a_prefill_of_no_tokens_leaves_lengths_and_tok():
    """The prefill warm-up (every input zero) masks every row: its K/V go
    to page 0, and slot 0's lengths and tok stay."""
    tr = _pair(page_len=4, prefix_cache=False)[1]
    _prefilled(tr, tgen.SamplingParams)
    lengths, tok = tr.state['lengths'].clone(), tr.state['tok'].clone()
    assert int(lengths[0]) == len(PROMPTS[0])
    tr._prefill_exec(tr.prefill_chunk).warm_up()
    assert torch.equal(tr.state['lengths'], lengths)
    assert torch.equal(tr.state['tok'], tok)


def test_a_failed_capture_names_the_ports_code():
    """A capture that fails raises naming the op: the innermost frame of
    the port's own code in the error's traceback (core/graphs.py)."""
    from paddle_tpu_torch.core import graphs
    with pytest.raises(RuntimeError) as e:
        tdec._rope(torch.zeros(2, 1, 3, 8), torch.zeros(5), torch.zeros(5))
    where = graphs._port_frame(e.value)
    assert where.startswith(
        'serving/generation/decode.py:'), where
    assert ' in _rope: ' in where
