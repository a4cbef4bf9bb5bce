"""LoDTensor: variable-length sequence batches as padded data plus lengths.

Counterpart of paddle_tpu/core/lod.py (a copy: numpy only).  The
reference framework stores ragged rows contiguously with a host-side
level-of-detail offset table; that layout forces dynamic shapes.  Here a
LoDTensor is a dense padded array `[batch, max_len, ...]` plus an int32
`lengths[batch]` vector.  Sequence ops (ops/sequence.py) consume (data,
lengths) and mask by length, so every shape is static and a CUDA graph
of one T bucket serves every batch of it.

When a LoDTensor is fed to `Executor.run`, the executor feeds `<name>` with
the padded data and `<name>@LENGTH` with the lengths (core/executor.py).
"""
import numpy as np

__all__ = ['LoDTensor', 'create_lod_tensor', 'create_random_int_lodtensor',
           'LENGTH_SUFFIX', 'OUTER_SUFFIX']

LENGTH_SUFFIX = '@LENGTH'
# 2-level LoD companion: number of inner sequences per outer group
OUTER_SUFFIX = '@OUTERLEN'


class LoDTensor(object):
    """Padded+lengths LoD.  lod_level=1: padded [B, T, ...] with
    lengths[B].  lod_level=2 (nested, reference lod_tensor.py:24-76):
    the batch dim enumerates the INNER sequences and `outer_lengths[G]`
    is the lengths-of-lengths companion — group g owns inner rows
    sum(outer[:g]) : sum(outer[:g+1]).  The reference's recursive
    offset tables map to (outer_lengths, lengths) exactly."""

    def __init__(self, padded, lengths, outer_lengths=None):
        self.padded = np.asarray(padded)
        self.lengths = np.asarray(lengths, dtype=np.int32)
        assert self.padded.ndim >= 2, 'LoDTensor padded data needs [B, T, ...]'
        assert self.lengths.shape == (self.padded.shape[0],)
        self.outer_lengths = None
        if outer_lengths is not None:
            self.outer_lengths = np.asarray(outer_lengths, dtype=np.int32)
            assert self.outer_lengths.sum() == self.padded.shape[0], (
                'outer lengths %s must cover all %d inner sequences'
                % (self.outer_lengths.tolist(), self.padded.shape[0]))

    @property
    def shape(self):
        return self.padded.shape

    @property
    def dtype(self):
        return self.padded.dtype

    @property
    def lod_level(self):
        return 2 if self.outer_lengths is not None else 1

    def recursive_sequence_lengths(self):
        if self.outer_lengths is not None:
            return [self.outer_lengths.tolist(), self.lengths.tolist()]
        return [self.lengths.tolist()]

    def lod(self):
        """Reference offset-based LoD ([[0, ...]] per level)."""
        inner = np.concatenate([[0], np.cumsum(self.lengths)]).tolist()
        if self.outer_lengths is None:
            return [inner]
        outer = np.concatenate(
            [[0], np.cumsum(self.outer_lengths)]).tolist()
        return [outer, inner]

    def rows(self):
        """Back to a python list of per-sequence arrays."""
        return [self.padded[i, :l] for i, l in enumerate(self.lengths)]

    def nested_rows(self):
        """lod_level=2 view: list (outer groups) of lists of arrays."""
        assert self.outer_lengths is not None, 'not a 2-level LoDTensor'
        flat = self.rows()
        out, i = [], 0
        for g in self.outer_lengths:
            out.append(flat[i:i + g])
            i += g
        return out

    def flatten_rows(self):
        """Reference-style packed [sum(lens), ...] layout (for numpy-side
        comparisons in tests)."""
        return np.concatenate(self.rows(), axis=0) if len(self.lengths) else \
            self.padded[:0, 0]

    def to_packed(self):
        """(packed [sum(lens), ...] array, recursive_seq_lens) in the
        reference calling convention — the loud converter boundary for
        code that wants the contiguous layout back."""
        return np.asarray(self.flatten_rows()), \
            self.recursive_sequence_lengths()

    def __repr__(self):
        if self.outer_lengths is not None:
            return 'LoDTensor(shape=%s, outer=%s, lengths=%s)' % (
                self.padded.shape, self.outer_lengths.tolist(),
                self.lengths.tolist())
        return 'LoDTensor(shape=%s, lengths=%s)' % (
            self.padded.shape, self.lengths.tolist())


def create_lod_tensor(data, recursive_seq_lens=None, place=None,
                      max_len=None):
    """Build a LoDTensor.  `data` may be:
    - a list of per-sequence numpy arrays / lists (ragged), or
    - a nested list of lists of sequences (2-level), or
    - a packed [sum(lens), ...] array with
      recursive_seq_lens=[[l0, l1, ...]] (1-level) or
      [[g0, g1, ...], [l0, l1, ...]] (2-level) — the reference calling
      convention (lod_tensor.py:create_lod_tensor, 2-level examples in
      its docstrings).
    """
    if isinstance(data, LoDTensor):
        return data
    outer = None
    if isinstance(data, (list, tuple)) and recursive_seq_lens is None:
        # 1-level ragged rows; 2-level list input must state its
        # grouping via recursive_seq_lens (the reference asserts the
        # same — list shape alone is ambiguous)
        rows = [np.asarray(r) for r in data]
        rows = [r.reshape(len(r), -1) if r.ndim == 1 else r for r in rows]
    elif isinstance(data, (list, tuple)) and \
            len(recursive_seq_lens) == 2 and data and \
            isinstance(data[0], (list, tuple)) and \
            np.asarray(data[0][0]).ndim >= 1:
        # nested list (groups of sequences) + explicit 2-level lens
        outer = np.asarray(recursive_seq_lens[0], dtype=np.int32)
        assert [len(g) for g in data] == outer.tolist(), (
            'data grouping and recursive_seq_lens[0] do not match')
        rows = [np.asarray(r) for g in data for r in g]
        assert [len(r) for r in rows] == list(recursive_seq_lens[1]), (
            'data and recursive_seq_lens[1] do not match')
        rows = [r.reshape(len(r), -1) if r.ndim == 1 else r for r in rows]
    else:
        if isinstance(data, (list, tuple)):
            # reference list convention: flat list of sequences,
            # concatenated then re-split by recursive_seq_lens (the
            # reference reshapes word-id rows to [n, 1] the same way)
            arr = np.concatenate(
                [np.asarray(s).reshape(len(s), -1) for s in data], axis=0)
        else:
            arr = np.asarray(data)
        lens = list(recursive_seq_lens[-1])
        if len(recursive_seq_lens) == 2:
            outer = np.asarray(recursive_seq_lens[0], dtype=np.int32)
            assert outer.sum() == len(lens), (
                'level-0 lengths %s must cover the %d level-1 sequences'
                % (outer.tolist(), len(lens)))
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        assert offsets[-1] == arr.shape[0], (
            'sum of seq lens %d != rows %d' % (offsets[-1], arr.shape[0]))
        rows = [arr[offsets[i]:offsets[i + 1]] for i in range(len(lens))]
    lengths = np.array([len(r) for r in rows], dtype=np.int32)
    T = int(max_len or (lengths.max() if len(lengths) else 1))
    T = max(T, 1)
    feat = rows[0].shape[1:] if rows else (1,)
    dtype = rows[0].dtype if rows else np.float32
    padded = np.zeros((len(rows), T) + tuple(feat), dtype=dtype)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = r
    return LoDTensor(padded, lengths, outer_lengths=outer)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    lens = recursive_seq_lens[-1]
    total = int(np.sum(lens))
    data = np.random.randint(low, high + 1,
                             size=[total] + list(base_shape)).astype(np.int64)
    return create_lod_tensor(data, recursive_seq_lens, place)
