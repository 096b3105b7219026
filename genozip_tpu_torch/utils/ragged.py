"""Ragged (arrow-style) byte-column utilities.

genozip_tpu_torch's own copy of the parts of genozip_tpu/utils/ragged.py that
the port uses, on their numpy path only (the JAX package takes its C++ host
runtime where it loads; the bytes are the same). A *column* is (data:
uint8[], offsets: int64[n+1]): row i is data[offsets[i]:offsets[i+1]]. All
operations are whole-column numpy ops (reference src/seg.c:1586
seg_all_data_lines, src/reconstruct.c:671 reconstruct_from_ctx_do).
"""

import numpy as np

_ARANGE = np.arange(0, dtype=np.int64)


def arange(n: int) -> np.ndarray:
    """Cached arange — a read-only slice of one growing buffer (np.arange
    showed up as the single largest host cost in profiles)."""
    global _ARANGE
    if _ARANGE.shape[0] < n:
        _ARANGE = np.arange(max(n, 2 * _ARANGE.shape[0]), dtype=np.int64)
        _ARANGE.setflags(write=False)
    return _ARANGE[:n]


class Col:
    """Ragged byte column."""
    __slots__ = ("data", "offsets", "_lens")

    def __init__(self, data: np.ndarray, offsets: np.ndarray):
        self.data = np.asarray(data, dtype=np.uint8)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self._lens = None

    def __len__(self):
        return self.offsets.shape[0] - 1

    @property
    def lens(self):
        # cached: hot recon loops read .lens many times per million-row
        # column, and offsets are never mutated after construction
        if self._lens is None:
            self._lens = np.diff(self.offsets)
        return self._lens

    def row(self, i: int) -> bytes:
        return self.data[self.offsets[i]:self.offsets[i + 1]].tobytes()

    def to_list(self):
        return [self.row(i) for i in range(len(self))]

    @staticmethod
    def from_list(rows):
        lens = np.fromiter((len(r) for r in rows), dtype=np.int64, count=len(rows))
        offsets = np.concatenate([[0], np.cumsum(lens)])
        data = np.frombuffer(b"".join(rows), dtype=np.uint8).copy() if rows else np.zeros(0, np.uint8)
        return Col(data, offsets)

    @staticmethod
    def from_fixed(mat: np.ndarray):
        """(n, w) byte matrix -> column of n rows of width w."""
        n, w = mat.shape
        return Col(np.ascontiguousarray(mat, dtype=np.uint8).reshape(-1),
                   np.arange(n + 1, dtype=np.int64) * w)


def gather_ranges(data: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> Col:
    """Build a column whose row i is data[starts[i] : starts[i]+lens[i]]."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    total = int(offsets[-1])
    if total == 0:
        return Col(np.zeros(0, np.uint8), offsets)
    # single repeat: src[i] = starts[row] + (i - offsets[row])
    src = np.repeat(starts - offsets[:-1], lens)
    src = src + arange(total)
    return Col(data[src], offsets)


def take(col: Col, idx: np.ndarray) -> Col:
    """Row-gather: new column with rows col[idx[0]], col[idx[1]], ..."""
    idx = np.asarray(idx, dtype=np.int64)
    starts = col.offsets[idx]
    lens = col.offsets[idx + 1] - starts
    return gather_ranges(col.data, starts, lens)


def interleave(cols, sep_after=None) -> Col:
    """Row-wise concatenation of k columns (all length n), each row of column j
    optionally followed by separator bytes sep_after[j] (bytes or None).
    Returns a column of n rows: c0[i] s0 c1[i] s1 ... c_{k-1}[i] s_{k-1}."""
    n = len(cols[0])
    k = len(cols)
    if sep_after is None:
        sep_after = [None] * k
    lens = np.zeros((k, n), dtype=np.int64)
    for j, c in enumerate(cols):
        assert len(c) == n
        lens[j] = c.lens
        if sep_after[j]:
            lens[j] += len(sep_after[j])
    row_lens = lens.sum(axis=0)
    offsets = np.concatenate([[0], np.cumsum(row_lens)])
    out = np.empty(int(row_lens.sum()), dtype=np.uint8)
    # per-column destination start within each row
    intra = np.zeros(n, dtype=np.int64)
    for j, c in enumerate(cols):
        dst = offsets[:-1] + intra
        clens = c.lens
        total = int(clens.sum())
        if total:
            pos = arange(total) - np.repeat(c.offsets[:-1], clens)
            out[np.repeat(dst, clens) + pos] = c.data
        s = sep_after[j]
        if s:
            sb = np.frombuffer(s, dtype=np.uint8)
            base = dst + clens
            for b_i, b in enumerate(sb):
                out[base + b_i] = b
            intra = intra + clens + len(sb)
        else:
            intra = intra + clens
    return Col(out, offsets)


def to_matrix(col: Col, fill: int = 0):
    """Ragged column -> (n, maxlen) padded byte matrix."""
    n = len(col)
    lens = col.lens
    w = int(lens.max()) if n and lens.shape[0] else 0
    if n and w and (lens == w).all():
        # uniform width: rows are adjacent by the Col contract, so the
        # matrix is just a reshaped slice — no index materialization
        o0 = int(col.offsets[0])
        mat = col.data[o0:o0 + n * w].reshape(n, w).copy()
        return mat, lens
    mat = np.full((n, max(w, 1)), fill, dtype=np.uint8)
    total = int(lens.sum())
    if total:
        pos = arange(total) - np.repeat(col.offsets[:-1], lens)
        rows = np.repeat(arange(n), lens)
        mat[rows, pos] = col.data
    return mat, lens


def from_matrix(mat: np.ndarray, lens: np.ndarray) -> Col:
    """Padded byte matrix + row lengths -> ragged column."""
    n, w = mat.shape
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    offsets = np.concatenate([[0], np.cumsum(lens)])
    out = np.empty(total, dtype=np.uint8)
    if total:
        pos = arange(total) - np.repeat(offsets[:-1], lens)
        rows = np.repeat(arange(n), lens)
        out[:] = mat[rows, pos]
    return Col(out, offsets)


def merge_rows(n: int, parts) -> Col:
    """Merge row-subsets into one n-row column. `parts` is a list of
    (row_indices, Col) pairs covering all n rows exactly once."""
    lens = np.zeros(n, dtype=np.int64)
    for idx, c in parts:
        lens[idx] = c.lens
    offsets = np.concatenate([[0], np.cumsum(lens)])
    out = np.empty(int(lens.sum()), dtype=np.uint8)
    for idx, c in parts:
        clens = c.lens
        total = int(clens.sum())
        if not total:
            continue
        pos = arange(total) - np.repeat(c.offsets[:-1], clens)
        out[np.repeat(offsets[:-1][idx], clens) + pos] = c.data
    return Col(out, offsets)


def itoa(vals: np.ndarray) -> Col:
    """Vectorized int64 -> decimal ascii column."""
    vals = np.asarray(vals, dtype=np.int64)
    n = vals.shape[0]
    if n == 0:
        return Col(np.zeros(0, np.uint8), np.zeros(1, np.int64))
    neg = vals < 0
    a = vals.astype(np.uint64)
    a = np.where(neg, np.uint64(0) - a, a)   # exact magnitude, incl INT64_MIN
    # number of digits
    nd = np.ones(n, dtype=np.int64)
    t = a // np.uint64(10)
    while np.any(t > 0):
        nd += (t > 0)
        t //= np.uint64(10)
    lens = nd + neg
    offsets = np.concatenate([[0], np.cumsum(lens)])
    out = np.empty(int(lens.sum()), dtype=np.uint8)
    out[offsets[:-1][neg]] = ord("-")
    # write digits right-to-left
    end = offsets[1:]
    rem = a.copy()
    d = np.ones(n, dtype=np.int64)  # digit position from right
    active = np.ones(n, dtype=bool)
    while active.any():
        pos = end - d
        out[pos[active]] = (rem[active] % np.uint64(10)
                            + np.uint64(ord("0"))).astype(np.uint8)
        rem //= np.uint64(10)
        d += 1
        active = rem > 0
        # ensure at least one digit written for zeros: handled by first pass
    return Col(out, offsets)
