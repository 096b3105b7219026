"""The `bam_wgs_sorted` input: a slice of a coordinate-sorted WGS BAM (cfg5).

150 bp reads at a run's depth (30x by default) over a region of chr1 of a
human-sized genome (`genome.py`; the region's start is drawn from the
seed), each from one of the donor's two haplotypes, in windows of
`window_reads` reads: ~8% multi-mappers (a primary with XA:Z plus a
secondary of the same QNAME elsewhere on chr1), ~4% split reads (a 75M75S
primary with SA:Z plus a 75H75M supplementary whose SEQ/QUAL are the
primary's slice), the rest proper pairs with NM/AS/XS (and XA:Z on ~10%);
0.3% substitution errors; 4-bin quality; the header names GRCh38's 25
primary contigs; BGZF blocks of 65280 bytes at zlib level 6 and htslib's
EOF block. The records follow `genozip_tpu_torch/synth.py`'s `write_bam`
(with `_cfg5_window` and `translate.sam_header_to_bam`), whose reads came at
4.5x off 32 Mbp contigs copied from one 32 Mbp genome instead. A window
depends only on the seed and its index, and windows are made on worker
processes (`pool.py`), BGZF blocks and all.
"""

import contextlib
import os
import struct
import zlib

import numpy as np

from . import genome, pool, ragged
from .fastq import BASES, qual_bins
from .ragged import Col

RL = 150
HALF = RL // 2
BLOCK = 65280
EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
# record kinds: multi-mapper primary / its secondary, split-read primary /
# its supplementary, proper pair
MP, MS, SP, SU, PR = range(5)
CIGAR_BIN = tuple(np.asarray(ops, "<u4").tobytes() for ops in (
    [(150 << 4) | 0], [(75 << 4) | 0, (75 << 4) | 4],
    [(75 << 4) | 5, (75 << 4) | 0]))
BAM_FIXED = np.dtype([
    ("block_size", "<u4"), ("refid", "<i4"), ("pos", "<i4"),
    ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
    ("n_cigar_op", "<u2"), ("flag", "<u2"), ("l_seq", "<u4"),
    ("next_refid", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4")])
NIB_OF = np.zeros(256, np.uint8)
NIB_OF[np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)] = np.arange(16)


def bam_header(sam_text: bytes) -> bytes:
    """SAM header text -> the BAM header blob (SAMv1 4.2)."""
    refs = []
    for line in sam_text.split(b"\n"):
        if line.startswith(b"@SQ"):
            f = dict((t[:3], t[3:]) for t in line.split(b"\t")[1:])
            refs.append((f[b"SN:"], int(f[b"LN:"])))
    parts = [b"BAM\x01", len(sam_text).to_bytes(4, "little"), sam_text,
             len(refs).to_bytes(4, "little")]
    for name, ln in refs:
        parts += [(len(name) + 1).to_bytes(4, "little"), name + b"\x00",
                  ln.to_bytes(4, "little")]
    return b"".join(parts)


def _const(n: int, b: bytes) -> Col:
    return Col.from_fixed(np.tile(np.frombuffer(b, np.uint8), (n, 1)))


def _keep(col: Col, mask: np.ndarray) -> Col:
    """`col` with the rows where `mask` is False emptied."""
    return ragged.gather_ranges(col.data, col.offsets[:-1],
                                np.where(mask, col.lens, 0))


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """UCSC binning (SAM spec 5.3)."""
    end = end - 1
    out = np.zeros(beg.shape[0], np.int64)
    done = np.zeros(beg.shape[0], bool)
    for shift, lvl in ((14, 15), (17, 12), (20, 9), (23, 6), (26, 3)):
        m = ~done & ((beg >> shift) == (end >> shift))
        out[m] = ((1 << lvl) - 1) // 7 + (beg[m] >> shift)
        done |= m
    return out


def _renibble(col: Col) -> Col:
    """ASCII SEQ rows -> 4-bit rows (2-aligned, high nibble first)."""
    nb = (col.lens + 1) // 2
    dst = np.concatenate([[0], np.cumsum(2 * nb)])
    buf = np.zeros(int(dst[-1]), np.uint8)
    if col.data.shape[0]:
        buf[ragged._spread(dst[:-1], col.lens)] = col.data
    codes = NIB_OF[buf]
    return Col((codes[0::2] << 4) | codes[1::2],
               np.concatenate([[0], np.cumsum(nb)]))


def _draws(rng, G: int, lo: int, hi: int, n: int):
    """The random draws of one window of `n` reads in [lo, hi) of a genome
    of `G` bases, in the order they are taken from `rng`."""
    poss = np.sort(rng.integers(lo, hi, n))
    ne = rng.binomial(RL, 0.003, n)
    noise = rng.normal(0, 3.0, (n, RL))
    nerr = rng.binomial(n * RL, 0.003)
    bases = BASES[rng.integers(0, 4, nerr)]
    errs = (bases, rng.integers(0, n, nerr), rng.integers(0, RL, nerr))
    return (poss, ne, noise, errs, rng.random(n),
            rng.integers(0, G - RL, n), rng.integers(5, 30, n))


def _window(draws, reads, chrom: bytes, refid: int, rid0: int):
    """The BAM records of one window from its `_draws`, and the offsets
    where each starts and the last ends; `reads(poss)` gives the (n, RL)
    bases of reads at `poss`."""
    poss, ne, noise, (eb, er, ec), kinds, p2, xs_gap = draws
    n = poss.shape[0]
    quals = qual_bins(noise)
    seqs = reads(poss)
    seqs[er, ec] = eb
    multi, split = kinds < 0.08, (kinds >= 0.08) & (kinds < 0.12)
    nsub = 1 + (multi | split)
    j = np.repeat(np.arange(n), nsub)
    sub = np.arange(j.shape[0]) - np.repeat(np.cumsum(nsub) - nsub, nsub)
    kind = np.where(multi[j], MP + sub, np.where(split[j], SP + sub, PR))
    R = kind.shape[0]
    p, ne_j, as_v = poss[j], ne[j], RL - 2 * ne[j]
    pair_r2 = (j % 2) == 1
    flag = np.choose(kind, [0, 256, 0, 2048, 0]) + \
        (kind == PR) * np.where(pair_r2, 147, 99)
    pos0 = np.choose(kind, [p, p2[j], p, p + 400, p])
    mapq = np.where(kind == MS, 0, 60)
    cig = np.choose(kind, [0, 0, 1, 2, 0])
    is_pr = kind == PR
    pnext0 = np.where(is_pr, p + 199, -1)
    tlen = np.where(is_pr, np.where(pair_r2, -350, 350), 0)
    nm = np.where(kind == MS, ne_j + 1, ne_j)
    has_seq = kind != MS
    seq_off = j * RL + np.where(kind == SU, HALF, 0)
    seq_len = np.where(kind == SU, RL - HALF, np.where(has_seq, RL, 0))
    seq = ragged.gather_ranges(seqs.reshape(-1), seq_off, seq_len)
    qual = ragged.gather_ranges(quals.reshape(-1), seq_off, seq_len)

    # aux values: NM always; AS on multi-mapper records and pairs; XS on
    # pairs; XA on multi-mapper primaries and ~10% of pairs; SA on split
    # reads
    has_as = np.isin(kind, (MP, MS, PR))
    as_val = np.where(kind == MS, as_v - 5, as_v)
    xs_val = as_v - xs_gap[j]
    has_xa = (kind == MP) | (is_pr & (kinds[j] > 0.9))
    chrom_c = _const(R, chrom + b",")
    xa = ragged.interleave(
        [chrom_c, Col.from_fixed(np.where(kind == MP, ord("+"), ord("-"))
                                 .astype(np.uint8).reshape(-1, 1)),
         ragged.itoa(p2[j] + 1), _const(R, b",150M,"), ragged.itoa(ne_j + 1)],
        [None, None, None, None, b";"])
    has_sa = (kind == SP) | (kind == SU)
    sa = ragged.interleave(
        [chrom_c, ragged.itoa(np.where(kind == SP, p + 401, p + 1)),
         ragged.take(Col.from_list([b",+,75H75M,60,", b",+,75M75S,60,"]),
                     (kind == SU).astype(np.int64)),
         ragged.itoa(ne_j)], [None, None, None, b";"])
    qname = ragged.interleave([_const(R, b"b"), ragged.itoa(rid0 + j)])

    def tagged(tag: bytes, vals):
        m = np.zeros((R, 7), np.uint8)
        m[:, :3] = np.frombuffer(tag, np.uint8)
        m[:, 3:] = np.asarray(vals, "<i4").view(np.uint8).reshape(R, 4)
        return Col.from_fixed(m)

    aux = ragged.interleave([
        tagged(b"NMi", nm), _keep(tagged(b"ASi", as_val), has_as),
        _keep(tagged(b"XSi", xs_val), is_pr),
        _keep(_const(R, b"XAZ"), has_xa), _keep(xa, has_xa),
        _keep(_const(R, b"\x00"), has_xa),
        _keep(_const(R, b"SAZ"), has_sa), _keep(sa, has_sa),
        _keep(_const(R, b"\x00"), has_sa)])
    seq_nib = _renibble(seq)
    qual_b = Col(qual.data - np.uint8(33), qual.offsets)
    cig_b = ragged.take(Col.from_list(list(CIGAR_BIN)), cig)
    fixed = np.zeros(R, BAM_FIXED)
    fixed["refid"] = refid
    fixed["pos"] = pos0
    fixed["l_read_name"] = qname.lens + 1
    fixed["mapq"] = mapq
    fixed["bin"] = _reg2bin(pos0, pos0 + np.where(cig == 0, RL, HALF))
    fixed["n_cigar_op"] = np.where(cig == 0, 1, 2)
    fixed["flag"] = flag
    fixed["l_seq"] = seq_len
    fixed["next_refid"] = np.where(is_pr, refid, -1)
    fixed["next_pos"] = pnext0
    fixed["tlen"] = tlen
    fixed["block_size"] = 32 + qname.lens + 1 + cig_b.lens + seq_nib.lens + \
        qual_b.lens + aux.lens
    recs = ragged.interleave(
        [Col.from_fixed(fixed.view(np.uint8).reshape(R, -1)), qname, cig_b,
         seq_nib, qual_b, aux], [None, b"\x00"] + [None] * 4)
    return recs.data.tobytes(), recs.offsets


def _part(seed: int, w: int, n: int, depth: int, start0: int) -> bytes:
    """The BGZF blocks of window `w`: `n` reads over the `n * RL // depth`
    bp from `start0 + w` times that on chr1."""
    rng = np.random.default_rng([genome.seed64(seed), 3, w])
    chrom, clen = genome.CONTIGS[0]
    span = n * RL // depth
    lo = start0 + w * span
    if lo + span > clen - RL:
        raise ValueError(f"window {w} runs past {chrom.decode()}")
    draws = _draws(rng, clen, lo, lo + span, n)
    hap = rng.integers(0, 2, (n, 1))
    g = genome.of(seed)
    data, offsets = _window(draws, lambda poss: g.reads(
        genome.OFFSETS[0] + poss, RL, hap), chrom, 0, w * n)
    return bgzf(data, offsets[1:])


def region_start(seed: int) -> int:
    """The first position of the file's region on chr1."""
    rng = np.random.default_rng([genome.seed64(seed), 4])
    return int(rng.integers(1_000_000, 200_000_000))


def _block(payload: bytes, level: int = 6) -> bytes:
    """One BGZF block: htslib's header, the raw deflate, CRC32 and size."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    head = struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
    return b"".join((head, struct.pack("<BBHH", 0x42, 0x43, 2,
                                       len(comp) + 25),
                     comp, struct.pack("<II", zlib.crc32(payload),
                                       len(payload))))


def bgzf(data: bytes, ends) -> bytes:
    """`data` as BGZF blocks packed as htslib's `bam_write1` packs them: a
    block takes whole records (which end at `ends`) while they fit in
    65280 bytes, and a record that fits in none is split across full
    blocks."""
    ends = np.asarray(ends, np.int64)
    out, at = [], 0
    while at < len(data):
        k = int(np.searchsorted(ends, at + BLOCK, "right")) - 1
        cut = int(ends[k]) if k >= 0 and ends[k] > at else at + BLOCK
        cut = min(cut, len(data))
        out.append(_block(data[at:cut]))
        at = cut
    return b"".join(out)


def write(path: str, nbytes: int, seed: int, window_reads: int = 60000,
          depth: int = 30) -> int:
    """Write a BAM of at least `nbytes` on disk: the header in blocks of its
    own (as htslib flushes it), then whole windows of `window_reads` reads
    at `depth`, then the EOF block. Returns the bytes on disk."""
    text = b"@HD\tVN:1.6\tSO:coordinate\n" + b"".join(
        b"@SQ\tSN:%s\tLN:%d\n" % c for c in genome.CONTIGS)
    head = bam_header(text)
    start0 = region_start(seed)
    done = 0
    with open(path, "wb") as f:

        def wanted():
            """Windows still to make, from the bytes a window so far (None
            before the first)."""
            if not done:
                return None
            return -(-(nbytes - f.tell()) * done // (f.tell() - len(hb)))

        f.write(hb := bgzf(head, [len(head)]))
        with contextlib.closing(pool.parts(_part, lambda i: (
                seed, i, window_reads, depth, start0), wanted)) as windows:
            for blocks in windows:
                f.write(blocks)
                done += 1
                if f.tell() >= nbytes:
                    break
        f.write(EOF_BLOCK)
    return os.path.getsize(path)
