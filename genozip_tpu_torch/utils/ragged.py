"""Ragged (arrow-style) byte-column utilities.

genozip_tpu_torch's own copy of the parts of genozip_tpu/utils/ragged.py that
the port uses. A *column* is (data: uint8[], offsets: int64[n+1]): row i is
data[offsets[i]:offsets[i+1]]. The operations are whole-column numpy ops
(reference src/seg.c:1586 seg_all_data_lines, src/reconstruct.c:671
reconstruct_from_ctx_do), with the C++ host runtime (`native`) where
genozip_tpu takes its own: the range copies of NATIVE_MIN_BYTES or more,
count_sep_per_row, atoi and itoa (their numpy versions stay as `*_np`,
the tests' oracles).
"""

import numpy as np

from .. import native

# A range copy goes through the host runtime (about 2 us a pointer through
# ctypes) from NATIVE_MIN_BYTES copied; below, numpy's repeat and gather of
# short rows is as fast (`chip_smoke.py` phase 12's threshold lines,
# PERF.md).
NATIVE_MIN_BYTES = 8192

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
    if total >= NATIVE_MIN_BYTES and data.dtype == np.uint8:
        out = np.empty(total, np.uint8)
        native.copy_ranges(data, starts, out, offsets[:-1], lens,
                           packed=True)
        return Col(out, offsets)
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


def rows_equal(a: Col, b: Col) -> np.ndarray:
    """Per-row byte equality of two columns. Rows with differing lens are
    unequal; the flat fast path below requires aligned data, so mixed-lens
    inputs recurse on the equal-lens subset."""
    n = len(a)
    eq = a.lens == b.lens
    if not eq.all():
        idx = np.nonzero(eq)[0]
        out = eq.copy()
        if idx.shape[0]:
            out[idx] = rows_equal(take(a, idx), take(b, idx))
        return out
    mism = np.nonzero(a.data[:b.data.shape[0]] != b.data[:a.data.shape[0]])[0]
    if mism.shape[0]:
        rowm = np.searchsorted(a.offsets[1:], mism, side="right")
        eq = eq.copy()
        eq[np.minimum(rowm, n - 1)] = False
    return eq


def cols_equal_rows(a: Col, b: Col) -> np.ndarray:
    """Per-row equality of two same-length columns (genozip_tpu keeps it in
    deep.py; SAM/BAM seg and the deep FASTQ seg use it)."""
    n = len(a)
    eq_len = a.lens == b.lens
    out = np.zeros(n, dtype=bool)
    idx = np.nonzero(eq_len)[0]
    if idx.shape[0] == 0:
        return out
    sa = take(a, idx)
    sb = take(b, idx)
    neq = sa.data != sb.data
    # rows with zero mismatching bytes
    row_of = np.searchsorted(sa.offsets[1:], np.nonzero(neq)[0], side="right")
    bad = np.zeros(idx.shape[0], dtype=bool)
    bad[row_of] = True
    out[idx[~bad]] = True
    return out


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
        if total >= NATIVE_MIN_BYTES:
            native.copy_ranges(c.data, c.offsets[:-1], out, dst, clens)
        elif total:
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


def split_fields_fixed(line_col: Col, sep: int, num_fields: int):
    """Split every row of a column on `sep` into exactly num_fields columns.
    Rows must all contain exactly num_fields-1 separators (validated).
    Returns a list of Cols."""
    data = line_col.data
    n = len(line_col)
    sep_pos = np.nonzero(data == sep)[0]
    row_of = np.searchsorted(line_col.offsets[1:], sep_pos, side="right")
    counts = np.bincount(row_of, minlength=n)
    if not np.all(counts == num_fields - 1):
        raise ValueError("row with wrong field count")
    sp = sep_pos.reshape(n, num_fields - 1) if num_fields > 1 \
        else np.zeros((n, 0), np.int64)
    bounds = np.empty((n, num_fields + 1), dtype=np.int64)
    bounds[:, 0] = line_col.offsets[:-1]
    bounds[:, 1:-1] = sp + 1
    bounds[:, -1] = line_col.offsets[1:]
    cols = []
    for f in range(num_fields):
        starts = bounds[:, f]
        ends = bounds[:, f + 1] - (1 if f < num_fields - 1 else 0)
        cols.append(gather_ranges(data, starts, ends - starts))
    return cols


def split_first_fields(line_col: Col, sep: int, k: int):
    """Split each row into its first k sep-separated fields plus the raw
    remainder (remainder INCLUDES its leading separator, or is empty for rows
    with exactly k fields). Rows with fewer than k fields are reported in
    `bad_rows` and excluded from the returned columns.

    Returns (field_cols: list[k Col], rest: Col, good_rows: int64[],
    bad_rows: int64[])."""
    data = line_col.data
    n = len(line_col)
    sep_pos = np.nonzero(data == sep)[0]
    row_of = np.searchsorted(line_col.offsets[1:], sep_pos, side="right")
    counts = np.bincount(row_of, minlength=n)
    good = counts >= k - 1
    good_rows = np.nonzero(good)[0]
    bad_rows = np.nonzero(~good)[0]
    ng = good_rows.shape[0]
    if ng == 0:
        return [Col.from_list([]) for _ in range(k)], Col.from_list([]), \
            good_rows, bad_rows
    # first k-1 separator positions of each good row
    first_sep_of_row = np.concatenate([[0], np.cumsum(counts)])[:-1]
    sp = np.empty((ng, k - 1), dtype=np.int64)
    for j in range(k - 1):
        sp[:, j] = sep_pos[first_sep_of_row[good_rows] + j]
    bounds = np.empty((ng, k + 1), dtype=np.int64)
    bounds[:, 0] = line_col.offsets[:-1][good_rows]
    bounds[:, 1:k] = sp + 1
    row_ends = line_col.offsets[1:][good_rows]
    # field k ends at the k-th separator if the row has >= k fields' seps
    has_more = counts[good_rows] >= k
    kth_sep = np.where(has_more,
                       sep_pos[np.minimum(first_sep_of_row[good_rows] + k - 1,
                                          sep_pos.shape[0] - 1)]
                       if sep_pos.shape[0] else 0,
                       row_ends)
    bounds[:, k] = np.where(has_more, kth_sep, row_ends)
    cols = []
    for f in range(k):
        starts = bounds[:, f]
        ends = bounds[:, f + 1] if f == k - 1 else bounds[:, f + 1] - 1
        cols.append(gather_ranges(data, starts, ends - starts))
    rest = gather_ranges(data, bounds[:, k], row_ends - bounds[:, k])
    return cols, rest, good_rows, bad_rows


def count_sep_per_row(line_col: Col, sep: int) -> np.ndarray:
    """Occurrences of byte `sep` in each row."""
    return native.count_eq(line_col.data, line_col.offsets, sep)


def count_sep_per_row_np(line_col: Col, sep: int) -> np.ndarray:
    """count_sep_per_row in numpy: one reduceat over the byte mask."""
    n = len(line_col)
    if n == 0:
        return np.zeros(0, np.int64)
    off = line_col.offsets
    m = (line_col.data[:off[-1]] == sep).view(np.int8)
    a = np.concatenate([m, np.zeros(1, np.int8)])
    res = np.add.reduceat(a, off[:-1], dtype=np.int64)
    res[off[1:] == off[:-1]] = 0   # reduceat returns a[i] for empty rows
    return res


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
        if total >= NATIVE_MIN_BYTES:
            native.copy_ranges(c.data, c.offsets[:-1], out,
                               offsets[:-1][idx], clens)
            continue
        pos = arange(total) - np.repeat(c.offsets[:-1], clens)
        out[np.repeat(offsets[:-1][idx], clens) + pos] = c.data
    return Col(out, offsets)


def atoi(col: Col, dtype=np.int64):
    """Parse every row as a decimal integer (optional leading '-').
    Returns (values, ok_mask). Rows failing strict parse get ok=False."""
    vals, ok = native.atoi(col.data, col.offsets)
    return vals.astype(dtype, copy=False), ok


def atoi_np(col: Col, dtype=np.int64):
    """atoi in numpy: a right-aligned digit matrix."""
    n = len(col)
    lens = col.lens
    if n == 0:
        return np.zeros(0, dtype), np.zeros(0, bool)
    safe_starts = np.minimum(col.offsets[:-1], max(col.data.shape[0] - 1, 0))
    first = np.where(lens > 0, col.data[safe_starts]
                     if col.data.shape[0] else 0, 0)
    neg_mask = (first == ord("-")) & (lens > 1)
    starts = col.offsets[:-1] + neg_mask
    dlens = lens - neg_mask
    maxw = int(dlens.max()) if n else 0
    if maxw == 0 or maxw > 19:
        ok_width = (dlens > 0) & (dlens <= 19)
    else:
        ok_width = dlens > 0
    maxw = min(max(maxw, 1), 19)
    # right-aligned digit matrix
    idx = starts[:, None] + (np.arange(maxw)[None, :] - (maxw - dlens)[:, None])
    valid = np.arange(maxw)[None, :] >= (maxw - dlens)[:, None]
    idx = np.clip(idx, 0, max(col.data.shape[0] - 1, 0))
    digs = np.where(valid, col.data[idx] if col.data.shape[0] else 0, ord("0"))
    is_digit = ((digs >= ord("0")) & (digs <= ord("9"))) | ~valid
    ok = ok_width & is_digit.all(axis=1)
    vals = np.zeros(n, dtype=np.int64)
    for j in range(maxw):
        vals = vals * 10 + (digs[:, j].astype(np.int64) - ord("0"))
    vals = np.where(neg_mask, -vals, vals)
    # leading zeros make the round trip inexact ("007"): flag them not-ok
    first_dig = digs[np.arange(n), np.clip(maxw - dlens, 0, maxw - 1)]
    has_lead0 = (dlens > 1) & (first_dig == ord("0"))
    ok &= ~has_lead0
    return vals.astype(dtype), ok


def itoa(vals: np.ndarray) -> Col:
    """int64 -> decimal ascii column."""
    return Col(*native.itoa(vals))


def itoa_np(vals: np.ndarray) -> Col:
    """itoa in numpy: one digit position a pass."""
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
