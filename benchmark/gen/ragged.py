"""Ragged byte columns in plain numpy, for the frozen generators.

A column is (data: uint8[], offsets: int64[n + 1]): row i is
data[offsets[i]:offsets[i + 1]]. A frozen copy of the numpy paths of
`genozip_tpu_torch/utils/ragged.py` (`Col`, `gather_ranges`, `take`,
`interleave`, `merge_rows`, `itoa_np`), without the port's host runtime, so
that the benchmark's inputs do not depend on the program under test.
"""

import numpy as np


class Col:
    """Ragged byte column."""
    __slots__ = ("data", "offsets")

    def __init__(self, data: np.ndarray, offsets: np.ndarray):
        self.data = np.asarray(data, dtype=np.uint8)
        self.offsets = np.asarray(offsets, dtype=np.int64)

    def __len__(self):
        return self.offsets.shape[0] - 1

    @property
    def lens(self):
        return np.diff(self.offsets)

    @staticmethod
    def from_list(rows):
        lens = np.fromiter((len(r) for r in rows), dtype=np.int64,
                           count=len(rows))
        offsets = np.concatenate([[0], np.cumsum(lens)])
        data = np.frombuffer(b"".join(rows), np.uint8).copy() if rows \
            else np.zeros(0, np.uint8)
        return Col(data, offsets)

    @staticmethod
    def from_fixed(mat: np.ndarray):
        """(n, w) byte matrix -> column of n rows of width w."""
        n, w = mat.shape
        return Col(np.ascontiguousarray(mat, dtype=np.uint8).reshape(-1),
                   np.arange(n + 1, dtype=np.int64) * w)


def _spread(offsets: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """For every byte of rows of `lens` starting at `offsets`, its index."""
    total = int(lens.sum())
    return np.repeat(offsets - np.concatenate([[0], np.cumsum(lens)[:-1]]),
                     lens) + np.arange(total, dtype=np.int64)


def gather_ranges(data: np.ndarray, starts, lens) -> Col:
    """A column whose row i is data[starts[i] : starts[i] + lens[i]]."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    if not int(offsets[-1]):
        return Col(np.zeros(0, np.uint8), offsets)
    return Col(data[_spread(starts, lens)], offsets)


def take(col: Col, idx) -> Col:
    """Rows col[idx[0]], col[idx[1]], ..."""
    idx = np.asarray(idx, dtype=np.int64)
    starts = col.offsets[idx]
    return gather_ranges(col.data, starts, col.offsets[idx + 1] - starts)


def interleave(cols, sep_after=None) -> Col:
    """Row-wise concatenation of columns of n rows each, column j's row
    followed by the bytes sep_after[j] (or nothing)."""
    n = len(cols[0])
    if any(len(c) != n for c in cols):
        raise ValueError("interleave: columns of different lengths")
    sep_after = sep_after or [None] * len(cols)
    widths = [c.lens + len(s or b"") for c, s in zip(cols, sep_after)]
    offsets = np.concatenate([[0], np.cumsum(np.sum(widths, axis=0))])
    out = np.empty(int(offsets[-1]), np.uint8)
    at = offsets[:-1].copy()
    for c, s in zip(cols, sep_after):
        clens = c.lens
        if int(clens.sum()):
            out[_spread(at, clens)] = c.data
        at += clens
        for b in s or b"":
            out[at] = b
            at += 1
    return Col(out, offsets)


def merge_rows(n: int, parts) -> Col:
    """One n-row column from (row indices, Col) parts that cover every row
    once."""
    lens = np.zeros(n, dtype=np.int64)
    for idx, c in parts:
        lens[idx] = c.lens
    offsets = np.concatenate([[0], np.cumsum(lens)])
    out = np.empty(int(lens.sum()), dtype=np.uint8)
    for idx, c in parts:
        if int(c.lens.sum()):
            out[_spread(offsets[:-1][idx], c.lens)] = c.data
    return Col(out, offsets)


def itoa(vals) -> Col:
    """int64 -> decimal ASCII column."""
    vals = np.asarray(vals, dtype=np.int64)
    neg = vals < 0
    mag = np.where(neg, -vals, vals).astype(np.uint64)
    nd = np.ones(vals.shape[0], dtype=np.int64)
    t = mag // np.uint64(10)
    while np.any(t > 0):
        nd += t > 0
        t //= np.uint64(10)
    offsets = np.concatenate([[0], np.cumsum(nd + neg)])
    out = np.empty(int(offsets[-1]), dtype=np.uint8)
    out[offsets[:-1][neg]] = ord("-")
    end, rem = offsets[1:], mag
    for d in range(1, int(nd.max(initial=1)) + 1):
        live = nd >= d
        out[(end - d)[live]] = (rem[live] % np.uint64(10)
                                + np.uint64(48)).astype(np.uint8)
        rem = rem // np.uint64(10)
    return Col(out, offsets)


def fixed_digits(vals, width: int, base: int = 10) -> Col:
    """Non-negative ints as zero-padded digits of `width` (at least; wider
    values keep every digit, as `%0<width>d` and `%0<width>x` do)."""
    vals = np.asarray(vals, dtype=np.int64)
    nd = np.full(vals.shape[0], 1, np.int64)
    t = vals // base
    while np.any(t > 0):
        nd += t > 0
        t //= base
    nd = np.maximum(nd, width)
    offsets = np.concatenate([[0], np.cumsum(nd)])
    out = np.empty(int(offsets[-1]), dtype=np.uint8)
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    end, rem = offsets[1:], vals
    for d in range(1, int(nd.max(initial=1)) + 1):
        live = nd >= d
        out[(end - d)[live]] = digits[rem[live] % base]
        rem = rem // base
    return Col(out, offsets)
