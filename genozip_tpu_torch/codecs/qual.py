"""Platform quality-score transforms: channel demux computed from SEQ.

Counterpart of genozip_tpu/codecs/qual.py, unchanged in behaviour.

Reference parity: the platform QUAL codecs (src/codec_longr.c /
codec_longr_alg.c, codec_pacb.c, codec_smux.c, codec_tmpl.c, codec_homp.c)
all share one idea — route each quality byte to a *channel* derived from
its sequence/position context, then entropy-code each channel with its own
(adaptive) model. Their C implementations are serial per-byte state
machines feeding an arithmetic coder.

Design: channels are restricted to functions of SEQ + position
ONLY (never of previous QUAL bytes). Since SEQ always reconstructs before
QUAL, the channel of every byte is recomputable at PIZ *before* any QUAL
byte is decoded — so the transform is a pure permutation (stable sort by
channel id), fully vectorized on both sides, with ZERO side data on disk:
the decoder rebuilds the identical permutation from the reconstructed SEQ.
The grouped stream then goes through normal codec assignment (ARITH1 /
RANS1 / DOMQ...), whose order-1/adaptive models now see per-channel
distributions. The per-read-boundary information the round-1 review asked
for enters through the row structure used to compute positions/neighbors.

Channel classes (each names the reference codec whose role it fills):
  smux  — current base (A/C/G/T/other)                 [codec_smux.c]
  pacb  — homopolymer K-value 0..6 (+-AT, HP2/HP3+)    [codec_pacb.c:19]
  longr — (prev base, cur base) x position bucket      [codec_longr_alg.c]
  tmpl  — machine cycle (position, capped)             [codec_tmpl.c]
  homp  — homopolymer length x base x interior flag    [codec_homp.c]
"""

import numpy as np

from .. import native
from ..utils import ragged
from ..utils.ragged import Col

CLASSES = ("smux", "pacb", "pacbx", "longr", "tmpl", "homp")

_BASE5 = np.full(256, 4, np.int64)   # A=0 C=1 G=2 T=3 other=4
for _i, _b in enumerate(b"ACGT"):
    _BASE5[_b] = _i
    _BASE5[_b + 32] = _i
_IS_AT = np.zeros(256, bool)
for _b in b"ATat":
    _IS_AT[_b] = True


def _flat_layout(seq: Col, qual_lens: np.ndarray):
    """Per-qual-byte flat arrays: (base bytes aligned to qual positions,
    pos-in-row, row-start mask, row-end mask, row index). Rows whose SEQ
    length differs from the QUAL length (SAM '*' SEQ) read as all-'N'."""
    lens = qual_lens.astype(np.int64)
    total = int(lens.sum())
    n = lens.shape[0]
    row = np.repeat(np.arange(n, dtype=np.int64), lens)
    offs = np.concatenate([[0], np.cumsum(lens)])
    pos = np.arange(total, dtype=np.int64) - offs[row]
    usable = seq.lens == lens
    base = np.full(total, ord("N"), np.uint8)
    m = usable[row]
    if m.any():
        base[m] = seq.data[seq.offsets[row[m]] + pos[m]]
    start = pos == 0
    end = np.zeros(total, bool)
    if total:
        end[offs[1:] - 1] = True
    return base, pos, start, end, row


def _hp_runs(base: np.ndarray, start: np.ndarray):
    """Homopolymer run structure on the flat stream (runs never cross row
    boundaries). Returns (run_len per byte, pos_in_run per byte)."""
    total = base.shape[0]
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z
    change = np.ones(total, bool)
    change[1:] = (base[1:] != base[:-1])
    change |= start
    rid = np.cumsum(change) - 1
    starts = np.nonzero(change)[0]
    rl = np.diff(np.concatenate([starts, [total]]))
    run_len = rl[rid]
    pos_in_run = np.arange(total) - starts[rid]
    return run_len, pos_in_run


def n_channels(cls: str) -> int:
    return {"smux": 5, "pacb": 7, "pacbx": 448, "longr": 100, "tmpl": 64,
            "homp": 70}[cls]


def _k_value(base, start):
    """PacBio K-value per byte (codec_pacb.c:19 concept, vectorized)."""
    run_len, pos_in_run = _hp_runs(base, start)
    at = _IS_AT[base].astype(np.int64)
    k = np.full(base.shape[0], 4, np.int64) + at       # not an HP start
    k = np.where(pos_in_run > 0, 6, k)                 # 2nd+ base of HP
    first = pos_in_run == 0
    k = np.where(first & (run_len == 2), 2 + at, k)    # first of HP2
    k = np.where(first & (run_len >= 3), 0 + at, k)    # first of HP3+
    return k


def channel_ids(cls: str, seq: Col, qual_lens: np.ndarray,
                layout=None) -> np.ndarray:
    """Per-qual-byte channel id — pure function of SEQ + row structure,
    identical at ZIP and PIZ. `layout` shares one _flat_layout across
    classes (the choose_class trial loop)."""
    base, pos, start, end, row = layout if layout is not None \
        else _flat_layout(seq, qual_lens)
    b = _BASE5[base]
    if cls == "smux":
        return b
    if cls == "tmpl":
        return np.minimum(pos, 63)
    if cls == "longr":
        prev = np.empty_like(base)
        prev[0:1] = ord("N")
        prev[1:] = base[:-1]
        prev[start] = ord("N")
        pb = np.minimum(np.log2(pos + 1).astype(np.int64) // 2, 3)
        return (_BASE5[prev] * 5 + b) * 4 + pb
    if cls == "pacb":
        return _k_value(base, start)
    if cls == "pacbx":
        # K-value x 64 relative-position buckets (long-read quality tracks
        # both the HP environment and the position along the read)
        k = _k_value(base, start)
        lens_pb = qual_lens.astype(np.int64)[row]
        relb = np.minimum((pos * 64) // np.maximum(lens_pb, 1), 63)
        return k * 64 + relb
    if cls == "homp":
        run_len, pos_in_run = _hp_runs(base, start)
        return (np.minimum(run_len, 7) - 1) * 10 + b * 2 + \
            (pos_in_run > 0).astype(np.int64)
    raise ValueError(cls)


def demux(cls: str, qual: Col, seq: Col) -> np.ndarray:
    """Stable-sort the flat QUAL bytes by channel id -> grouped stream.
    int16 keys make numpy's stable sort a 2-pass radix (O(n))."""
    ch = channel_ids(cls, seq, qual.lens).astype(np.int16)
    perm = np.argsort(ch, kind="stable")
    return qual.data[perm]


def remux(cls: str, grouped: np.ndarray, seq: Col,
          qual_lens: np.ndarray) -> np.ndarray:
    """Invert demux at PIZ using the reconstructed SEQ."""
    ch = channel_ids(cls, seq, qual_lens).astype(np.int16)
    perm = np.argsort(ch, kind="stable")
    out = np.empty_like(grouped)
    out[perm] = grouped
    return out


def choose_class(seq: Col, qual: Col, sample: int = 1 << 18):
    """Trial each channel class on a sample (reference parity:
    codec_assign_best_codec's trial loop, src/codec.c:175): compress the
    grouped sample with order-1 rANS, keep the best if it beats ungrouped
    by >3% (the permutation costs decode work, so demand a real win).
    Returns a class name or None."""
    from . import compress, RANS1
    total = int(qual.lens.sum())
    if total < 4096:
        return None
    if total > sample:
        # whole leading rows up to ~sample bytes
        nrows = int(np.searchsorted(np.cumsum(qual.lens), sample)) + 1
        idx = np.arange(min(nrows, len(qual)))
        qual = ragged.take(qual, idx)
        seq = ragged.take(seq, idx)
    base_size = len(compress(qual.data.tobytes(), RANS1))
    best, best_size = None, base_size * 0.97
    layout = _flat_layout(seq, qual.lens)   # shared across class trials
    for cls in CLASSES:
        ch = channel_ids(cls, seq, qual.lens, layout=layout).astype(np.int16)
        grouped = qual.data[np.argsort(ch, kind="stable")]
        sz = len(compress(grouped.tobytes(), RANS1))
        if sz < best_size:
            best, best_size = cls, sz
    return best


_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTNacgtn", b"TGCANtgcan"):
    _COMP[_a] = _b


def orient(col: Col, rev: np.ndarray, comp: bool = False) -> Col:
    """Reverse (and optionally base-complement) the rows where rev is True —
    the NORMQ role (src/codec_normq.c): restore machine orientation of
    revcomped SAM reads so cycle/context channels line up across strands.
    Involutive: orient(orient(x, m), m) == x. The host runtime reverses the
    rows in place in a copy (`orient_np` is the numpy version)."""
    if not rev.any():
        return Col(col.data.copy() if comp else col.data, col.offsets)
    data = col.data.copy()
    native.reverse_rows(data, col.offsets, np.nonzero(rev)[0],
                        _COMP if comp else None)
    return Col(data, col.offsets)


def orient_np(col: Col, rev: np.ndarray, comp: bool = False) -> Col:
    """orient in numpy: flat index math over the reversed rows' bytes."""
    if not rev.any():
        return Col(col.data.copy() if comp else col.data, col.offsets)
    total = col.data.shape[0]
    it = np.int32 if total < (1 << 31) else np.int64
    lens = col.lens
    # flat index math only over the REVERSED rows' bytes
    ridx = np.nonzero(rev)[0]
    rlens = lens[ridx].astype(it)
    roffs = col.offsets[ridx].astype(it)
    nb = int(rlens.sum())
    byte_row = np.repeat(np.arange(ridx.shape[0], dtype=it), rlens)
    pos = np.arange(nb, dtype=it) - np.repeat(
        np.concatenate([np.zeros(1, it), np.cumsum(rlens, dtype=it)[:-1]]),
        rlens)
    dst = roffs[byte_row] + pos
    src = roffs[byte_row] + rlens[byte_row] - 1 - pos
    data = col.data.copy()
    rb = col.data[src]
    data[dst] = _COMP[rb] if comp else rb
    return Col(data, col.offsets)
