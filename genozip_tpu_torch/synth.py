"""Synthetic inputs in the shape of bench configs cfg1-cfg5 and of the other
datatypes.

cfg3 (`write_fastq`): single-end FASTQ of 150 bp reads sampled off a
repeat-family genome, 0.3% substitution errors, half of them
reverse-complemented, 4-bin Illumina quality with a positional ramp, and
QNAMEs that cycle through four flavours per block of reads (Illumina, BGI
fixed-width, SRA with length=, ONT uuid-like).

cfg4 (`write_fasta` + `write_paired_fastq`): the genome as a FASTA for
--make-reference, and proper pairs off it: R1 forward at p, R2
reverse-complemented at p + 150..350, 150 bp each, 0.3% errors, 4-bin
quality, Illumina QNAMEs with /1 and /2.

cfg5 (`write_bam`, `write_sam`): coordinate-sorted WGS-style alignments of
150 bp reads off 32 Mbp contigs, in 2 Mbp windows of 60000 reads: ~8%
multi-mappers (a primary with XA:Z plus a secondary of the same QNAME), ~4%
split reads (a 75M75S primary with SA:Z plus a 75H75M supplementary whose
SEQ/QUAL are the primary's slice), the rest proper pairs with NM/AS/XS (and
XA:Z on ~10%); 4-bin quality. The BAM is BGZF at zlib level 6.
`write_deep_fastq` writes such a BAM with the R1/R2 FASTQ its primary
alignments came from (for `zip --deep`), and `write_bam`/`write_sam` can
write the other form of the same records beside them.

Long reads (`write_longread_sam`, bench.py's `gen_longread_sam`): 3-20 kb
reads off a genome, CIGARs of 500-3000 bp matches with 1-7 bp insertions
and deletions between them, 2% substitutions, ONT-like quality, minimap2's
NM/ms/AS/nn/tp/cm/s1/s2/de/rl tags.

cfg1 (`write_vcf`, bench.py's `gen_vcf`): a cohort's joint-called VCF, 200
samples of `GT:AD:DP:GQ:PL` (Hardy-Weinberg genotypes, Poisson depths, PL
and GQ from them), dbSNP IDs, AC/AN/AF with GATK's annotator soup and 1-3
VEP CSQ transcripts per row; REF from a genome where one is given. cfg2 is
`write_fasta` of a genome, zipped as a file. `write_gff` (Ensembl-style
genes, transcripts, exons and CDSs with ID/Parent attributes), `write_bed`
(BED6 peaks), `write_me23` (a 23andMe raw-data file), `write_locs`
(Illumina cluster positions) and `write_generic` (a server log) write the
other datatypes.

A vectorized re-implementation of bench.py's generators (its `_genome`,
`_qual_rows`, `gen_fastq`, `gen_fasta`, `gen_paired_fastq`, `gen_bam`,
`gen_longread_sam`, `gen_vcf`), made from a numpy seed, for the port's tests
and chip_smoke.py. The bytes differ from bench.py's; the shapes are its.
"""

import contextlib
import functools
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .ops import pack as packops
from .utils import ragged
from .utils.ragged import Col

_BASES = np.frombuffer(b"ACGT", np.uint8)


def genome(rng, n: int = 4 << 20) -> np.ndarray:
    """iid bases + interspersed repeat families (~10% density, mutated
    200-400 bp prototypes) + tandem repeats + homopolymer runs."""
    g = rng.choice(_BASES, n)
    fams = [rng.choice(_BASES, int(rng.integers(200, 400))) for _ in range(6)]
    budget = n // 10
    while budget > 0:
        proto = fams[int(rng.integers(0, len(fams)))]
        L = proto.shape[0]
        p = int(rng.integers(0, n - L))
        copy = proto.copy()
        k = int(rng.binomial(L, 0.02))
        if k:
            copy[rng.integers(0, L, k)] = _BASES[rng.integers(0, 4, k)]
        g[p:p + L] = copy
        budget -= L
    for _ in range(n // 20000):   # tandem repeats, unit 2-40 bp
        u = int(rng.integers(2, 40))
        reps = int(rng.integers(5, 40))
        unit = rng.choice(_BASES, u)
        p = int(rng.integers(0, n - u * reps))
        g[p:p + u * reps] = np.tile(unit, reps)
    for _ in range(n // 2000):    # homopolymer runs
        p = int(rng.integers(0, n - 40))
        g[p:p + int(rng.integers(5, 30))] = g[p]
    return g


def qual_rows(rng, n: int, rl: int) -> np.ndarray:
    """Illumina-RTA3-style 4-bin quality with a positional ramp."""
    return _qual_bins(rng.normal(0, 3.0, (n, rl)))


def _qual_bins(noise: np.ndarray) -> np.ndarray:
    """`qual_rows` of its (n, rl) normal draws."""
    rl = noise.shape[1]
    pos = np.arange(rl)
    base = 36.0 - 8.0 * (pos / rl) ** 2 - 2.0 * (pos < 3)
    q = base[None, :] + noise
    bins = np.array([2, 12, 23, 37])
    idx = np.abs(q[:, :, None] - bins[None, None, :]).argmin(axis=2)
    return (bins[idx] + 33).astype(np.uint8)


def _qname(flavor: int):
    if flavor == 0:
        return lambda r: b"@SIM:1:FC706VJ:1:%d:%d:%d 1:N:0:ATCACG" % (
            2100 + r // 100000, 15000 + r % 90000, 1000 + (r * 7) % 90000)
    if flavor == 1:
        return lambda r: b"@E100016873L1C%03dR%03d%07d" % (
            r // 10000 % 999 + 1, r // 100 % 999 + 1, r % 9999999)
    if flavor == 2:
        return lambda r: b"@SRR8861483.%d %d length=150" % (r + 1, r + 1)
    return lambda r: b"@%08x-%04x-%04x-%04x-%012x" % (
        r * 2654435761 % (1 << 32), r % (1 << 16), (r * 7) % (1 << 16),
        (r * 13) % (1 << 16), r * 1099511627 % (1 << 48))


def write_fastq(path: str, nbytes: int, seed: int = 2024,
                block: int = 20000, genome_len: int = 4 << 20) -> int:
    """Write at least `nbytes` of cfg3-shaped FASTQ to `path` in blocks of
    `block` reads. Returns the bytes written."""
    rng = np.random.default_rng(seed)
    g = genome(rng, genome_len)
    rl = 150
    size = i = 0
    with open(path, "wb") as f:
        while size < nbytes:
            n = block
            starts = rng.integers(0, g.shape[0] - rl, n)
            mat = g[starts[:, None] + np.arange(rl)[None, :]].copy()
            nerr = rng.binomial(n * rl, 0.003)
            er, ec = rng.integers(0, n, nerr), rng.integers(0, rl, nerr)
            mat[er, ec] = _BASES[rng.integers(0, 4, nerr)]
            rev = rng.random(n) < 0.5
            rc = packops.BASE2BIT[mat] ^ 3
            mat[rev] = packops.ACGT[rc[rev][:, ::-1]]
            quals = qual_rows(rng, n, rl)
            nm = _qname(i % 4)
            body = b"".join(b"%s\n%s\n+\n%s\n" % (nm(i * n + j), mat[j].tobytes(),
                                                  quals[j].tobytes())
                            for j in range(n))
            f.write(body)
            size += len(body)
            i += 1
    return size


def _reads(rng, g: np.ndarray, starts: np.ndarray, rl: int, err: float = 0.003):
    """(n, rl) reads off genome `g` at `starts`, with substitution errors."""
    mat = g[starts[:, None] + np.arange(rl)[None, :]]
    rows, cols, bases = _read_errors(rng, starts.shape[0], rl, err)
    mat[rows, cols] = bases
    return mat


def _read_errors(rng, n: int, rl: int, err: float = 0.003):
    """The (rows, columns, bases) of `_reads`' substitutions."""
    nerr = rng.binomial(n * rl, err)
    bases = _BASES[rng.integers(0, 4, nerr)]
    return rng.integers(0, n, nerr), rng.integers(0, rl, nerr), bases


def write_fasta(path: str, g: np.ndarray, names=None) -> int:
    """Genome `g` (ACGT bytes) as a FASTA with 60-base lines: one contig
    `chrB`, or a copy of `g` under each of `names` (cfg5's BAM places its
    contigs chr1, chr2, ... each on a copy of its genome). Returns the bytes
    written."""
    G = g.shape[0]
    rows = g[: G - G % 60].reshape(-1, 60)
    block = np.empty((rows.shape[0], 61), np.uint8)
    block[:, :60] = rows
    block[:, 60] = ord("\n")
    tail = g[G - G % 60:]
    with open(path, "wb") as f:
        for name in names or [b"chrB test benchmark contig"]:
            f.write(b">%s\n" % name)
            f.write(block.tobytes())
            if tail.shape[0]:
                f.write(tail.tobytes() + b"\n")
        return f.tell()


# ---------------------------------------------------------------------------
# cfg5: sorted alignments with secondary and supplementary records
# ---------------------------------------------------------------------------

_CFG5_GENOME = 32 << 20
_CFG5_WINDOW = 2_000_000
_RL = 150
_GEN_THREADS = min(8, os.cpu_count() or 1)   # cfg5 windows made at once
_HALF = _RL // 2
# record kinds: multi-mapper primary / its secondary, split-read primary /
# its supplementary, proper pair
_MP, _MS, _SP, _SU, _PR = range(5)
_CIGARS = (b"150M", b"75M75S", b"75H75M")
_CIGAR_BIN = tuple(np.asarray(ops, "<u4").tobytes() for ops in (
    [(150 << 4) | 0], [(75 << 4) | 0, (75 << 4) | 4],
    [(75 << 4) | 5, (75 << 4) | 0]))
_BAM_FIXED = np.dtype([
    ("block_size", "<u4"), ("refid", "<i4"), ("pos", "<i4"),
    ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
    ("n_cigar_op", "<u2"), ("flag", "<u2"), ("l_seq", "<u4"),
    ("next_refid", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4")])


def cfg5_genome(genome_len: int = _CFG5_GENOME, seed: int = 2024):
    """The genome `write_bam` and `write_sam` with `seed` place their reads
    on (every contig is a copy of it)."""
    return genome(np.random.default_rng(seed + 1), genome_len)


def cfg5_contigs(nbytes: int, genome_len: int = _CFG5_GENOME):
    """The contig names of a cfg5 file of `nbytes` (bench.py's n_chrom)."""
    return [b"chr%d" % (c + 1)
            for c in range(max(1, nbytes // (genome_len * 5 // 4) + 1))]


def write_paired_fastq(p1: str, p2: str, g: np.ndarray, nbytes: int,
                       seed: int = 2024, block: int = 10000) -> int:
    """Write proper read pairs off genome `g` to `p1` (R1) and `p2` (R2)
    until both files hold at least 2 * `nbytes` together, in blocks of
    `block` pairs. Returns the bytes written to both."""
    rng = np.random.default_rng(seed)
    rl = 150
    G = g.shape[0]
    size = i = 0
    with open(p1, "wb") as f1, open(p2, "wb") as f2:
        while size < 2 * nbytes:
            n = block
            starts = rng.integers(0, G - rl - 400, n)
            gaps = rng.integers(150, 350, n)
            q1, q2 = qual_rows(rng, n, rl), qual_rows(rng, n, rl)
            m1 = _reads(rng, g, starts, rl)
            m2 = _reads(rng, g, starts + gaps, rl)
            m2 = packops.ACGT[(packops.BASE2BIT[m2] ^ 3)[:, ::-1]]
            r = np.arange(i * n, i * n + n)
            names = [b"@SIM:2:FCPAIR:1:%d:%d:%d" % t for t in zip(
                (2100 + r // 100000).tolist(), (15000 + r % 90000).tolist(),
                (1000 + (r * 7) % 90000).tolist())]
            c1 = b"".join(b"%s/1\n%s\n+\n%s\n" % (nm, m1[j].tobytes(),
                                                   q1[j].tobytes())
                          for j, nm in enumerate(names))
            c2 = b"".join(b"%s/2\n%s\n+\n%s\n" % (nm, m2[j].tobytes(),
                                                   q2[j].tobytes())
                          for j, nm in enumerate(names))
            f1.write(c1)
            f2.write(c2)
            size += len(c1) + len(c2)
            i += 1
    return size


def _const(n: int, b: bytes) -> Col:
    return Col.from_fixed(np.tile(np.frombuffer(b, np.uint8), (n, 1)))


def _keep(col: Col, mask: np.ndarray) -> Col:
    """`col` with the rows where `mask` is False emptied."""
    return ragged.gather_ranges(col.data, col.offsets[:-1],
                                np.where(mask, col.lens, 0))


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """UCSC binning (SAM spec 5.3), vectorized `translate.reg2bin`."""
    end = end - 1
    out = np.zeros(beg.shape[0], np.int64)
    done = np.zeros(beg.shape[0], bool)
    for shift, lvl in ((14, 15), (17, 12), (20, 9), (23, 6), (26, 3)):
        m = ~done & ((beg >> shift) == (end >> shift))
        out[m] = ((1 << lvl) - 1) // 7 + (beg[m] >> shift)
        done |= m
    return out


def _cfg5_draws(rng, G: int, lo: int, hi: int, n: int):
    """The random draws of one window of `n` reads in [lo, hi) of a
    genome of `G` bases, in the order they are taken from `rng`."""
    poss = np.sort(rng.integers(lo, hi, n))
    ne = rng.binomial(_RL, 0.003, n)
    noise = rng.normal(0, 3.0, (n, _RL))
    errs = _read_errors(rng, n, _RL)
    return (poss, ne, noise, errs, rng.random(n),
            rng.integers(0, G - _RL, n), rng.integers(5, 30, n))


def _cfg5_window(draws, g, chrom: bytes, refid: int, rid0: int, fq=None):
    """One window of cfg5 records from its `_cfg5_draws` as (SAM text
    lines, BAM records, and the (R1, R2) FASTQ of its primaries from
    `deep_fastq` with draws `fq`, else None), all bytes, the same records
    in the same order."""
    rl = _RL
    poss, ne, noise, (er, ec, eb), kinds, p2, xs_gap = draws
    n = poss.shape[0]
    quals = _qual_bins(noise)
    seqs = g[poss[:, None] + np.arange(rl)[None, :]]
    seqs[er, ec] = eb
    multi, split = kinds < 0.08, (kinds >= 0.08) & (kinds < 0.12)
    nsub = 1 + (multi | split)
    j = np.repeat(np.arange(n), nsub)
    sub = np.arange(j.shape[0]) - np.repeat(np.cumsum(nsub) - nsub, nsub)
    kind = np.where(multi[j], _MP + sub, np.where(split[j], _SP + sub, _PR))
    R = kind.shape[0]
    p, ne_j, as_v = poss[j], ne[j], rl - 2 * ne[j]
    pair_r2 = (j % 2) == 1
    flag = np.choose(kind, [0, 256, 0, 2048, 0]) + \
        (kind == _PR) * np.where(pair_r2, 147, 99)
    pos0 = np.choose(kind, [p, p2[j], p, p + 400, p])
    mapq = np.where(kind == _MS, 0, 60)
    cig = np.choose(kind, [0, 0, 1, 2, 0])
    is_pr = kind == _PR
    pnext0 = np.where(is_pr, p + 199, -1)
    tlen = np.where(is_pr, np.where(pair_r2, -350, 350), 0)
    nm = np.where(kind == _MS, ne_j + 1, ne_j)
    has_seq = kind != _MS
    seq_off = j * rl + np.where(kind == _SU, _HALF, 0)
    seq_len = np.where(kind == _SU, rl - _HALF, np.where(has_seq, rl, 0))
    seq = ragged.gather_ranges(seqs.reshape(-1), seq_off, seq_len)
    qual = ragged.gather_ranges(quals.reshape(-1), seq_off, seq_len)

    # aux values: NM always; AS on multi-mapper records and pairs; XS on
    # pairs; XA on multi-mapper primaries and ~10% of pairs; SA on split
    # reads
    has_as = np.isin(kind, (_MP, _MS, _PR))
    as_val = np.where(kind == _MS, as_v - 5, as_v)
    xs_val = as_v - xs_gap[j]
    has_xa = (kind == _MP) | (is_pr & (kinds[j] > 0.9))
    chrom_c = _const(R, chrom + b",")
    xa = ragged.interleave(
        [chrom_c, Col.from_fixed(np.where(kind == _MP, ord("+"), ord("-"))
                                 .astype(np.uint8).reshape(-1, 1)),
         ragged.itoa(p2[j] + 1), _const(R, b",150M,"), ragged.itoa(ne_j + 1)],
        sep_after=[None, None, None, None, b";"])
    has_sa = (kind == _SP) | (kind == _SU)
    sa = ragged.interleave(
        [chrom_c, ragged.itoa(np.where(kind == _SP, p + 401, p + 1)),
         ragged.take(Col.from_list([b",+,75H75M,60,", b",+,75M75S,60,"]),
                     (kind == _SU).astype(np.int64)),
         ragged.itoa(ne_j)], sep_after=[None, None, None, b";"])

    qname = ragged.interleave([_const(R, b"b"), ragged.itoa(rid0 + j)])

    # SAM text
    def nz(c, m):
        """`c`, with '*' in the rows where `m` is False."""
        return ragged.merge_rows(R, [
            (np.nonzero(m)[0], ragged.take(c, np.nonzero(m)[0])),
            (np.nonzero(~m)[0], _const(int((~m).sum()), b"*"))])

    aux_t = ragged.interleave([
        _const(R, b"\tNM:i:"), ragged.itoa(nm),
        _keep(_const(R, b"\tAS:i:"), has_as), _keep(ragged.itoa(as_val), has_as),
        _keep(_const(R, b"\tXS:i:"), is_pr), _keep(ragged.itoa(xs_val), is_pr),
        _keep(_const(R, b"\tXA:Z:"), has_xa), _keep(xa, has_xa),
        _keep(_const(R, b"\tSA:Z:"), has_sa), _keep(sa, has_sa)])
    text = ragged.interleave(
        [qname, ragged.itoa(flag), _const(R, chrom), ragged.itoa(pos0 + 1),
         ragged.itoa(mapq), ragged.take(Col.from_list(list(_CIGARS)), cig),
         ragged.take(Col.from_list([b"*", b"="]), is_pr.astype(np.int64)),
         ragged.itoa(pnext0 + 1), ragged.itoa(tlen), nz(seq, has_seq),
         nz(qual, has_seq), aux_t],
        sep_after=[b"\t"] * 10 + [None, b"\n"])

    # BAM records (SAMv1 §4.2): the same fields, binary
    def tagged(tag: bytes, vals):
        m = np.zeros((R, 7), np.uint8)
        m[:, :3] = np.frombuffer(tag, np.uint8)
        m[:, 3:] = np.asarray(vals, "<i4").view(np.uint8).reshape(R, 4)
        return Col.from_fixed(m)

    aux_b = ragged.interleave([
        tagged(b"NMi", nm), _keep(tagged(b"ASi", as_val), has_as),
        _keep(tagged(b"XSi", xs_val), is_pr),
        _keep(_const(R, b"XAZ"), has_xa), _keep(xa, has_xa),
        _keep(_const(R, b"\x00"), has_xa),
        _keep(_const(R, b"SAZ"), has_sa), _keep(sa, has_sa),
        _keep(_const(R, b"\x00"), has_sa)])
    from .datatypes.bam import BamDT
    seq_nib = BamDT._renibble(seq)
    qual_b = Col(qual.data - np.uint8(33), qual.offsets)
    cig_b = ragged.take(Col.from_list(list(_CIGAR_BIN)), cig)
    fixed = np.zeros(R, _BAM_FIXED)
    fixed["refid"] = refid
    fixed["pos"] = pos0
    fixed["l_read_name"] = qname.lens + 1
    fixed["mapq"] = mapq
    fixed["bin"] = _reg2bin(pos0, pos0 + np.where(cig == 0, rl, _HALF))
    fixed["n_cigar_op"] = np.where(cig == 0, 1, 2)
    fixed["flag"] = flag
    fixed["l_seq"] = seq_len
    fixed["next_refid"] = np.where(is_pr, refid, -1)
    fixed["next_pos"] = pnext0
    fixed["tlen"] = tlen
    fixed["block_size"] = 32 + qname.lens + 1 + cig_b.lens + seq_nib.lens + \
        qual_b.lens + aux_b.lens
    recs = ragged.interleave(
        [Col.from_fixed(fixed.view(np.uint8).reshape(R, -1)), qname, cig_b,
         seq_nib, qual_b, aux_b], sep_after=[None, b"\x00"] + [None] * 4)
    text = text.data.tobytes()
    return (text, recs.data.tobytes(),
            deep_fastq(text, *fq) if fq is not None else None)


def _cfg5_windows(g, nbytes: int, seed: int, window_reads: int, ahead,
                  fastq: bool = False):
    """(SAM header, per window (SAM text, BAM records, (R1, R2) FASTQ of its
    primaries or None)), with bench.py's contig count for a file of
    `nbytes`. A window holds `window_reads` reads over window_reads / 60000
    * 2 Mbp, bench.py's coverage. The draws are taken in window order from
    one generator (and the FASTQ's from another); the rest of each window
    is made on a thread pool, at most `ahead()` windows ahead of the
    consumer."""
    rng = np.random.default_rng(seed)
    frng = np.random.default_rng(seed + 2)
    G = g.shape[0]
    names = cfg5_contigs(nbytes, G)
    hdr = b"@HD\tVN:1.6\tSO:coordinate\n" + b"".join(
        b"@SQ\tSN:%s\tLN:%d\n" % (nm, G) for nm in names)

    span = max(_CFG5_WINDOW * window_reads // 60000, 4 * _RL)

    def windows():
        rid = 0
        for c in range(len(names)):
            pos = 1
            while pos < G - 2 * _RL:
                hi = min(pos + span, G - _RL)
                d = _cfg5_draws(rng, G, pos, hi, window_reads)
                fq = _deep_draws(frng, window_reads) if fastq else None
                yield functools.partial(_cfg5_window, d, g, names[c], c, rid,
                                        fq)
                rid += window_reads
                pos = hi
    return hdr, _ordered_pool(windows(), ahead)


def _ordered_pool(tasks, ahead):
    """The results of the callables `tasks` yields, in order, made on a
    thread pool (numpy lets go of the GIL), with at most `ahead()` (1 or
    more) started and not yet taken. `tasks` is advanced on the caller's
    thread."""
    pool = ThreadPoolExecutor(max_workers=_GEN_THREADS)
    todo = deque()
    try:
        for task in tasks:
            todo.append(pool.submit(task))
            if len(todo) >= max(1, ahead()):
                yield todo.popleft().result()
        while todo:
            yield todo.popleft().result()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _ahead(f, nbytes: int, done: list, per0: int):
    """How many windows a writer at `f`, which has written `done[0]`
    windows, still needs to reach `nbytes`, from its bytes per window so
    far (`per0` before the first)."""
    def ahead():
        per = max(1, f.tell() // done[0]) if done[0] else per0
        return int(min(_GEN_THREADS, -(-(nbytes - f.tell()) // per)))
    return ahead


def write_bam(path: str, nbytes: int, seed: int = 2024,
              genome_len: int = _CFG5_GENOME, window_reads: int = 60000,
              sam_path: str | None = None, fastq_paths=None) -> int:
    """Write a cfg5-shaped BAM of at least `nbytes` on disk (fewer if the
    contigs run out), BGZF at zlib level 6 through the port's BgzfWriter.
    `sam_path` also gets the same records as SAM text, and `fastq_paths`
    (R1, R2) the FASTQ of their primaries (`deep_fastq`). Returns the bytes
    on disk."""
    from .translate import sam_header_to_bam
    from .utils.bgzf import BgzfWriter
    g = cfg5_genome(genome_len, seed)
    with contextlib.ExitStack() as stack:
        f = stack.enter_context(open(path, "wb"))
        done = [0]
        hdr, wins = _cfg5_windows(g, nbytes, seed, window_reads,
                                  _ahead(f, nbytes, done, 64 * window_reads),
                                  fastq=bool(fastq_paths))
        stack.callback(wins.close)
        twins = [stack.enter_context(open(p, "wb"))
                 for p in [sam_path] + list(fastq_paths or []) if p]
        if sam_path:
            twins[0].write(hdr)
        w = BgzfWriter(f, 6)
        w.write(sam_header_to_bam(hdr)[0])
        for text, recs, fq in wins:
            if f.tell() >= nbytes:
                break
            w.write(recs)
            if sam_path:
                twins[0].write(text)
            if fastq_paths:
                for t, b in zip(twins[-2:], fq):
                    t.write(b)
            done[0] += 1
        w.close()
    return os.path.getsize(path)


def write_sam(path: str, nbytes: int, seed: int = 2024,
              genome_len: int = _CFG5_GENOME,
              window_reads: int = 60000, bam_path: str | None = None) -> int:
    """The SAM text of `write_bam`'s first records (same seed and genome
    length, same records): the header and whole lines up to the first line
    end at or past `nbytes`. `bam_path` also gets the same records as an
    uncompressed BAM stream (header and records). Returns the bytes
    written."""
    from .datatypes.bam import bam_scan
    from .translate import sam_header_to_bam
    g = cfg5_genome(genome_len, seed)
    with contextlib.ExitStack() as stack:
        f = stack.enter_context(open(path, "wb"))
        done = [0]
        hdr, wins = _cfg5_windows(g, nbytes, seed, window_reads,
                                  _ahead(f, nbytes, done, 384 * window_reads))
        stack.callback(wins.close)
        fb = stack.enter_context(open(bam_path, "wb")) if bam_path else None
        f.write(hdr)
        if fb:
            fb.write(sam_header_to_bam(hdr)[0])
        for text, recs, _ in wins:
            room = nbytes - f.tell()
            if room <= 0:
                break
            if len(text) > room:
                text = text[:text.index(b"\n", room - 1) + 1]
                _, cut = bam_scan(np.frombuffer(recs, np.uint8),
                                  text.count(b"\n"))
                recs = recs[:cut]
            f.write(text)
            if fb:
                fb.write(recs)
            done[0] += 1
        return f.tell()


def _deep_draws(rng, n: int):
    """`deep_fastq`'s draws for `n` primaries: a uniform for each, and
    one more for each whose first is below 0.1."""
    u = rng.random(n)
    return u, rng.random(int((u < 0.1).sum()))


def deep_fastq(text: bytes, u: np.ndarray, v: np.ndarray):
    """(R1, R2) FASTQ bytes of the primary alignments (flag & 0x900 == 0,
    SEQ present) among cfg5 SAM lines `text`: each read in its sequencing
    orientation (reverse-complemented back, QUAL reversed, where flag & 16),
    R2 where flag & 128 and R1 otherwise, named `@QNAME 1:N:0:ATCACG` (2:
    for R2). The reads whose `u` (one uniform a primary) is below 0.1 have
    one base changed, at a column from `v`, so they differ from their
    alignment."""
    data = np.frombuffer(text, np.uint8)
    nl = np.nonzero(data == ord("\n"))[0]
    starts = np.concatenate([[0], nl[:-1] + 1])
    lines = ragged.gather_ranges(data, starts, nl - starts)
    fields, _, good, _ = ragged.split_first_fields(lines, ord("\t"), 11)
    flag, _ = ragged.atoi(fields[1])
    keep = np.nonzero(((flag & 0x900) == 0) & (fields[9].lens > 1))[0]
    flag = flag[keep]
    qname = ragged.take(fields[0], keep)
    seq, lens = ragged.to_matrix(ragged.take(fields[9], keep))
    qual, _ = ragged.to_matrix(ragged.take(fields[10], keep))
    n, L = seq.shape
    rev = (flag & 16) != 0
    idx = np.maximum(lens[:, None] - 1 - np.arange(L)[None, :], 0)
    seq[rev] = np.take_along_axis(seq, idx, axis=1)[rev]
    qual[rev] = np.take_along_axis(qual, idx, axis=1)[rev]
    seq[rev] = packops.ACGT[packops.BASE2BIT[seq[rev]] ^ 3]
    assert u.shape[0] == n
    alter = np.nonzero(u < 0.1)[0]
    col = (v * lens[alter]).astype(np.int64)
    seq[alter, col] = packops.ACGT[(packops.BASE2BIT[seq[alter, col]] + 1) & 3]
    r2 = (flag & 128) != 0
    out = []
    for m, tag in ((~r2, b" 1:N:0:ATCACG"), (r2, b" 2:N:0:ATCACG")):
        rows = np.nonzero(m)[0]
        k = rows.shape[0]
        out.append(ragged.interleave(
            [_const(k, b"@"), ragged.take(qname, rows), _const(k, tag),
             ragged.from_matrix(seq[rows], lens[rows]), _const(k, b"+"),
             ragged.from_matrix(qual[rows], lens[rows])],
            sep_after=[None, None, b"\n", b"\n", b"\n", b"\n"])
            .data.tobytes())
    return tuple(out)


def write_deep_fastq(bam_path: str, r1_path: str, r2_path: str, nbytes: int,
                     seed: int = 2024, sam_path: str | None = None,
                     **kw) -> int:
    """A cfg5 BAM of at least `nbytes` on disk at `bam_path` (`write_bam`)
    and the R1/R2 FASTQ of its primaries (`deep_fastq`) at `r1_path` and
    `r2_path`: the inputs of `zip --deep`. Returns the BAM's bytes on
    disk."""
    return write_bam(bam_path, nbytes, seed, sam_path=sam_path,
                     fastq_paths=(r1_path, r2_path), **kw)


# ---------------------------------------------------------------------------
# long reads (bench.py gen_longread_sam)
# ---------------------------------------------------------------------------

_LR_SEGS = 48     # match segments a read may need: 20 kb / 500 bp + margin


def _longread_block(rng, g, pos, rid0, n):
    """SAM lines of `n` long reads starting at genome positions `pos`."""
    rl = rng.integers(3000, 20000, n)
    # per read up to _LR_SEGS match segments of 500-3000 bp, each but the
    # last followed (p = 0.6) by a 1-7 bp insertion or deletion
    m = rng.integers(500, 3000, (n, _LR_SEGS))
    ind = np.where(rng.random((n, _LR_SEGS)) < 0.6,
                   rng.integers(1, 8, (n, _LR_SEGS)), 0)
    is_ins = rng.random((n, _LR_SEGS)) < 0.5
    # read bases consumed before segment k; a read ends in the segment
    # where its length is reached, which it clips, with no indel after it
    used = np.cumsum(m + np.where(is_ins, ind, 0), axis=1)
    last = np.minimum((used < rl[:, None]).sum(axis=1), _LR_SEGS - 1)
    before = np.concatenate([np.zeros((n, 1), np.int64),
                             used[:, :-1]], axis=1)
    k = np.arange(_LR_SEGS)[None, :]
    live = k <= last[:, None]
    m = np.where(k == last[:, None], np.maximum(rl[:, None] - before, 1), m)
    ind = np.where(k < last[:, None], ind, 0)
    ins_len = np.where(is_ins, ind, 0)
    del_len = np.where(is_ins, 0, ind)
    # genome start of each match segment
    gstep = m + del_len
    gstart = pos[:, None] + np.concatenate(
        [np.zeros((n, 1), np.int64), np.cumsum(gstep, axis=1)[:, :-1]],
        axis=1)
    # read = per segment: match bases off the genome, then inserted bases
    r_idx, s_idx = np.nonzero(live)
    mlen, ilen = m[r_idx, s_idx], ins_len[r_idx, s_idx]
    pool = rng.choice(_BASES, int(ilen.sum()) + 1)
    src = np.concatenate([g, pool])
    starts = np.stack([gstart[r_idx, s_idx],
                       g.shape[0] + np.concatenate([[0], np.cumsum(ilen)[:-1]])],
                      axis=1).reshape(-1)
    plens = np.stack([mlen, ilen], axis=1).reshape(-1)
    seq = ragged.gather_ranges(src, starts, plens)
    seq_lens = np.bincount(np.repeat(r_idx, 2), weights=plens,
                           minlength=n).astype(np.int64)
    seq = Col(seq.data.copy(), np.concatenate([[0], np.cumsum(seq_lens)]))
    nsub = rng.binomial(seq.data.shape[0], 0.02)
    sub = rng.integers(0, seq.data.shape[0], nsub)
    seq.data[sub] = _BASES[rng.integers(0, 4, nsub)]
    ne = np.bincount(np.searchsorted(seq.offsets[1:], sub, side="right"),
                     minlength=n) + ind.sum(axis=1)
    # ONT-like quality: a correlated random walk over a small alphabet
    walk = np.cumsum(rng.integers(-2, 3, seq.data.shape[0]))
    walk -= np.repeat(walk[seq.offsets[:-1]] - 1, seq_lens)
    qual = Col((np.clip(walk % 25 + 5, 2, 40) + 33).astype(np.uint8),
               seq.offsets)
    # CIGAR: per live segment "<m>M" then "<ind>I" or "<ind>D" if any
    cig_num = np.stack([mlen, ind[r_idx, s_idx]], axis=1).reshape(-1)
    cig_op = np.stack([np.full(mlen.shape[0], ord("M")),
                       np.where(is_ins[r_idx, s_idx], ord("I"), ord("D"))],
                      axis=1).reshape(-1).astype(np.uint8)
    pieces = np.nonzero(cig_num > 0)[0]
    ops = ragged.interleave([ragged.itoa(cig_num[pieces]),
                             Col.from_fixed(cig_op[pieces].reshape(-1, 1))])
    per_read = np.bincount(np.repeat(r_idx, 2)[pieces], weights=ops.lens,
                           minlength=n).astype(np.int64)
    cigar = Col(ops.data, np.concatenate([[0], np.cumsum(per_read)]))
    rl = seq_lens
    as_v = rl - 6 * ne
    tab = _const(n, b"\t")
    text = ragged.interleave([
        _const(n, b"lr"), ragged.itoa(rid0 + np.arange(n)),
        _const(n, b"\t0\tchrB\t"), ragged.itoa(pos + 1),
        _const(n, b"\t60\t"), cigar, _const(n, b"\t*\t0\t0\t"), seq, tab,
        qual, _const(n, b"\tNM:i:"), ragged.itoa(ne),
        _const(n, b"\tms:i:"), ragged.itoa(as_v - 2),
        _const(n, b"\tAS:i:"), ragged.itoa(as_v),
        _const(n, b"\tnn:i:0\ttp:A:P\tcm:i:"), ragged.itoa(rl // 19),
        _const(n, b"\ts1:i:"), ragged.itoa(as_v // 2),
        _const(n, b"\ts2:i:"),
        ragged.itoa((rng.random(n) * (np.maximum(as_v, 0) // 2 + 1))
                    .astype(np.int64)),
        _const(n, b"\tde:f:0."),
        Col.from_fixed(np.frombuffer(b"".join(
            b"%04d" % v for v in rng.integers(100, 700, n)), np.uint8)
            .reshape(n, 4)),
        _const(n, b"\trl:i:0\n")])
    return text.data.tobytes()


def write_longread_sam(path: str, nbytes: int, seed: int = 2024,
                       genome_len: int = 64 << 20, block: int = 64) -> int:
    """Write about `nbytes` of long-read SAM (bench.py `gen_longread_sam`'s
    shapes) off a `genome_len` genome, in blocks of `block` reads, each read
    starting 100-2000 bp after the previous one starts. Returns the bytes
    written."""
    rng = np.random.default_rng(seed)
    g = genome(np.random.default_rng(seed + 1), genome_len)
    G = g.shape[0]
    hdr = b"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrB\tLN:%d\n" % G
    with open(path, "wb") as f:
        f.write(hdr)
        pos, rid = 1, 0
        while f.tell() < nbytes:
            starts = pos + np.cumsum(rng.integers(100, 2000, block))
            # a read spans at most 20 kb plus its deletions
            starts = starts[starts + 25000 < G]
            if starts.shape[0] == 0:
                break
            text = _longread_block(rng, g, starts, rid, starts.shape[0])
            room = nbytes - f.tell()
            if len(text) > room:
                text = text[:text.index(b"\n", room - 1) + 1]
            f.write(text)
            pos, rid = int(starts[-1]), rid + starts.shape[0]
        return f.tell()


# ---------------------------------------------------------------------------
# cfg1: a cohort's joint-called VCF; and the tabular and other datatypes
# ---------------------------------------------------------------------------

_VCF_SAMPLES = 200
_GENES = [b"GENE%04d" % i for i in range(700)]
_CONS = [b"missense_variant", b"synonymous_variant", b"stop_gained",
         b"intron_variant", b"3_prime_UTR_variant"]
_AAS = [b"Ala", b"Val", b"Gly", b"Ser", b"Leu", b"Thr"]
_GTS = np.frombuffer(b"0/00/11/1./.", np.uint8).reshape(4, 3)


def vcf_header(samples: int = _VCF_SAMPLES, chrom: bytes = b"chr1") -> bytes:
    """bench.py `gen_vcf`'s header: GATK FORMAT and INFO definitions and
    VEP's CSQ, then the #CHROM line with `samples` sample names."""
    return (b"##fileformat=VCFv4.2\n##contig=<ID=%s,length=100000000>\n"
            b"##FORMAT=<ID=GT,Number=1,Type=String>\n"
            b"##FORMAT=<ID=AD,Number=R,Type=Integer>\n"
            b"##FORMAT=<ID=DP,Number=1,Type=Integer>\n"
            b"##FORMAT=<ID=GQ,Number=1,Type=Integer>\n"
            b"##FORMAT=<ID=PL,Number=G,Type=Integer>\n"
            b"##INFO=<ID=AF,Number=A,Type=Float>\n"
            b"##INFO=<ID=AC,Number=A,Type=Integer>\n"
            b"##INFO=<ID=AN,Number=1,Type=Integer>\n"
            b"##INFO=<ID=DP,Number=1,Type=Integer>\n"
            b"##INFO=<ID=BaseQRankSum,Number=1,Type=Float>\n"
            b"##INFO=<ID=ExcessHet,Number=1,Type=Float>\n"
            b"##INFO=<ID=FS,Number=1,Type=Float>\n"
            b"##INFO=<ID=MQ,Number=1,Type=Float>\n"
            b"##INFO=<ID=MQRankSum,Number=1,Type=Float>\n"
            b"##INFO=<ID=QD,Number=1,Type=Float>\n"
            b"##INFO=<ID=ReadPosRankSum,Number=1,Type=Float>\n"
            b"##INFO=<ID=SOR,Number=1,Type=Float>\n"
            b'##INFO=<ID=CSQ,Number=.,Type=String,Description="VEP">\n'
            b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" % chrom
            + b"\t".join(b"S%04d" % i for i in range(samples)) + b"\n")


def _vcf_cells(rng, af: np.ndarray, samples: int):
    """The sample matrix of len(af) rows: `GT:AD:DP:GQ:PL` cells each
    followed by a tab (row-major), the genotype codes (0/0, 0/1, 1/1, ./.)
    and each row's summed depth."""
    n = af.shape[0]
    probs = np.stack([(1 - af) ** 2, 2 * af * (1 - af), af ** 2,
                      np.full(n, 0.002)], axis=1)
    cum = np.cumsum(probs / probs.sum(axis=1, keepdims=True), axis=1)
    g = (rng.random((n, samples))[:, :, None] > cum[:, None, :3]).sum(-1)
    d = rng.poisson(30, (n, samples))
    aa = np.where(g == 1, d // 2, np.where(g == 2, d, 0))
    adr = d - aa
    pl = np.zeros((n, samples, 3), np.int64)
    pl[g == 0] = np.stack([np.zeros_like(d), 3 * d, 30 + 3 * d], -1)[g == 0]
    pl[g == 1] = np.stack([3 * aa, np.zeros_like(d), 3 * adr], -1)[g == 1]
    pl[g == 2] = np.stack([30 + 3 * d, 3 * d, np.zeros_like(d)], -1)[g == 2]
    spl = np.sort(pl, axis=-1)
    gq = np.minimum(spl[..., 1] - spl[..., 0] + 2, 99)
    cols = [Col.from_fixed(_GTS[g.ravel()])] + [
        ragged.itoa(v.ravel()) for v in
        (adr, aa, d, gq, pl[..., 0], pl[..., 1], pl[..., 2])]
    cells = ragged.interleave(cols, sep_after=[b":", b",", b":", b":", b":",
                                               b",", b",", b"\t"])
    return cells, g, d.sum(axis=1)


def write_vcf(path: str, nbytes: int, seed: int = 2024,
              samples: int = _VCF_SAMPLES, block: int = 200,
              chrom: bytes = b"chr1", genome: np.ndarray | None = None) -> int:
    """Write at least `nbytes` of cfg1-shaped VCF (bench.py `gen_vcf`): a
    cohort of `samples` samples with `GT:AD:DP:GQ:PL` cells (genotypes by
    Hardy-Weinberg at a row's allele frequency plus 0.2% missing, depths
    Poisson(30), AD split by genotype, PL and GQ from them), dbSNP-style
    IDs, AC/AN/AF and GATK's annotator soup in INFO, and 1-3 VEP CSQ
    transcripts per row, one variant every 50-3000 bp of `chrom`. REF is the
    base of `genome` at POS where given, random otherwise. Returns the bytes
    written."""
    rng = np.random.default_rng(seed)
    pos = 10000
    with open(path, "wb") as f:
        f.write(vcf_header(samples, chrom))
        while f.tell() < nbytes:
            n = block
            posv = pos + np.cumsum(rng.integers(50, 3000, n))
            pos = int(posv[-1])
            refc = rng.integers(0, 4, n)
            if genome is not None:
                on = posv <= genome.shape[0]
                refc[on] = packops.BASE2BIT[genome[posv[on] - 1]]
            altc = (refc + rng.integers(1, 4, n)) % 4
            af = rng.random(n) * 0.5
            cells, g, dp = _vcf_cells(rng, af, samples)
            # the last cell of a row ends it: its tab becomes the newline
            ends = cells.offsets[samples::samples] - 1
            cells.data[ends] = ord("\n")
            smp = cells.data
            row_off = cells.offsets[::samples]
            miss = (g == 3).sum(axis=1)
            an = 2 * (samples - miss)
            ac = (g == 1).sum(axis=1) + 2 * (g == 2).sum(axis=1)
            soup = rng.normal(size=(n, 7))
            rows = []
            for i in range(n):
                p = int(posv[i])
                ref, alt = bytes([_BASES[refc[i]]]), bytes([_BASES[altc[i]]])
                trs = []
                for _ in range(int(rng.integers(1, 4))):
                    cdna = int(rng.integers(1, 9000))
                    trs.append(b"|".join([
                        alt, _CONS[int(rng.integers(0, 5))],
                        _GENES[int(rng.integers(0, 700))],
                        b"ENST%011d" % rng.integers(1, 3e5),
                        b"c.%d%s>%s" % (cdna, ref, alt),
                        b"p.%s%d%s" % (_AAS[int(rng.integers(0, 6))],
                                       cdna // 3,
                                       _AAS[int(rng.integers(0, 6))]),
                        b"0.%04d" % rng.integers(0, 9999)]))
                s = soup[i]
                info = (b"AF=%.4f;AC=%d;AN=%d;BaseQRankSum=%.3f;"
                        b"ExcessHet=%.4f;FS=%.3f;MQ=%.2f;MQRankSum=%.3f;"
                        b"QD=%.2f;ReadPosRankSum=%.3f;SOR=%.3f;DP=%d;CSQ=%s"
                        % (round(int(ac[i]) / max(int(an[i]), 1), 4),
                           ac[i], an[i], s[0], 3.0103, abs(2 + 2 * s[1]),
                           60 - abs(s[2]), 0.5 * s[3], abs(15 + 5 * s[4]),
                           0.7 * s[5], abs(0.7 + 0.3 * s[6]), dp[i],
                           b",".join(trs)))
                rows.append(b"%s\t%d\trs%d\t%s\t%s\t%d\tPASS\t%s\t"
                            b"GT:AD:DP:GQ:PL\t" % (chrom, p, p, ref, alt,
                                                   30 + p % 60, info))
                rows.append(smp[row_off[i]:row_off[i + 1]].tobytes())
            f.write(b"".join(rows))
        return f.tell()


def _write_blocks(path: str, nbytes: int, head: bytes, block_fn) -> int:
    """Write `head`, then the blocks `block_fn()` returns until at least
    `nbytes` are written. Returns the bytes written."""
    with open(path, "wb") as f:
        f.write(head)
        while f.tell() < nbytes:
            f.write(block_fn())
        return f.tell()


def write_gff(path: str, nbytes: int, seed: int = 2024,
              seqid: bytes = b"chr1") -> int:
    """Write at least `nbytes` of GFF3 in Ensembl's shape: genes, each with
    a transcript (ID, Parent, Dbxref) and 2-8 exons and CDSs pointing at it
    (Parent), havana/ensembl sources, strands and phases."""
    rng = np.random.default_rng(seed)
    st = {"pos": 1000, "g": 0}

    def block():
        rows = []
        for _ in range(200):
            pos = st["pos"] = st["pos"] + int(rng.integers(1000, 20000))
            g = st["g"] = st["g"] + 1
            glen = int(rng.integers(2000, 60000))
            src = (b"havana", b"ensembl")[int(rng.integers(0, 2))]
            strand = (b"+", b"-")[int(rng.integers(0, 2))]
            gid, tid = b"ENSG%011d" % (g * 7), b"ENST%011d" % (g * 7 + 1)
            rows.append(b"%s\t%s\tgene\t%d\t%d\t.\t%s\t.\tID=gene:%s;"
                        b"Name=GENE%d;biotype=protein_coding;version=%d\n"
                        % (seqid, src, pos, pos + glen, strand, gid, g,
                           int(rng.integers(1, 20))))
            rows.append(b"%s\t%s\tmRNA\t%d\t%d\t.\t%s\t.\tID=transcript:%s;"
                        b"Parent=gene:%s;Dbxref=GeneID:%d,HGNC:HGNC:%d\n"
                        % (seqid, src, pos, pos + glen, strand, tid, gid,
                           1000 + g, 2000 + g))
            ne = int(rng.integers(2, 9))
            ex = np.sort(rng.integers(pos, pos + glen - 400, ne))
            for e in range(ne):
                a, b = int(ex[e]), int(ex[e]) + int(rng.integers(50, 400))
                rows.append(b"%s\t%s\texon\t%d\t%d\t.\t%s\t.\tParent="
                            b"transcript:%s;exon_number=%d;Name=%s-E%d\n"
                            % (seqid, src, a, b, strand, tid, e + 1, tid,
                               e + 1))
                rows.append(b"%s\t%s\tCDS\t%d\t%d\t.\t%s\t%d\tParent="
                            b"transcript:%s;protein_id=ENSP%011d\n"
                            % (seqid, src, a, b, strand,
                               int(rng.integers(0, 3)), tid, g * 7))
        return b"".join(rows)
    return _write_blocks(path, nbytes, b"##gff-version 3\n##sequence-region "
                         b"%s 1 248956422\n" % seqid, block)


def write_bed(path: str, nbytes: int, seed: int = 2024) -> int:
    """Write at least `nbytes` of BED6 peaks (a track line, then chrom,
    start, end, name, score, strand; 50-2000 bp apart, 50-500 bp long)."""
    rng = np.random.default_rng(seed)
    st = {"pos": 500, "i": 0}

    def block():
        n = 4000
        start = st["pos"] + np.cumsum(rng.integers(50, 2000, n))
        st["pos"] = int(start[-1])
        end = start + rng.integers(50, 500, n)
        score = rng.integers(0, 1000, n)
        strand = np.frombuffer(b"+-.", np.uint8)[rng.integers(0, 3, n)]
        i0 = st["i"]
        st["i"] += n
        return b"".join(b"chr7\t%d\t%d\tpeak_%d\t%d\t%c\n"
                        % (start[k], end[k], i0 + k, score[k], strand[k])
                        for k in range(n))
    return _write_blocks(path, nbytes, b'track name=test description='
                         b'"synthetic"\n', block)


_ME23_GTS = [b"AA", b"AG", b"GG", b"CT", b"CC", b"TT", b"--", b"A", b"DI"]


def write_me23(path: str, nbytes: int, seed: int = 2024,
               chrom: bytes = b"1") -> int:
    """Write at least `nbytes` of a 23andMe raw-data file: rsid,
    chromosome, position (1-20 bp apart) and genotype (diploid SNPs, some
    no-calls `--`, haploid calls and indels)."""
    rng = np.random.default_rng(seed)
    st = {"pos": 10000, "i": 0}

    def block():
        n = 8000
        pos = st["pos"] + np.cumsum(rng.integers(1, 20, n))
        st["pos"] = int(pos[-1])
        gt = rng.choice(len(_ME23_GTS), n,
                        p=[.3, .2, .2, .1, .1, .07, .01, .01, .01])
        i0 = st["i"]
        st["i"] += n
        return b"".join(b"rs%d\t%s\t%d\t%s\n"
                        % (3000000 + (i0 + k) * 11, chrom, pos[k],
                           _ME23_GTS[gt[k]]) for k in range(n))
    return _write_blocks(path, nbytes, b"# This data file generated by "
                         b"23andMe at: Sat Jan 01 00:00:00 2022\n# rsid\t"
                         b"chromosome\tposition\tgenotype\n", block)


def write_locs(path: str, nbytes: int, seed: int = 2024) -> int:
    """Write an Illumina .locs file of about `nbytes`: the 12-byte header
    (1, 1.0, n) and n cluster positions (x, y) as float32 on a jittered
    grid."""
    rng = np.random.default_rng(seed)
    n = max((nbytes - 12) // 8, 1)
    side = int(np.ceil(np.sqrt(n)))
    k = np.arange(n)
    xy = np.stack([(k % side) * 9.5, (k // side) * 9.5], 1)
    xy = (xy + rng.normal(0, 0.8, (n, 2))).astype("<f4")
    with open(path, "wb") as f:
        f.write(np.array([1], "<u4").tobytes() + np.array([1.0], "<f4")
                .tobytes() + np.array([n], "<u4").tobytes())
        f.write(xy.tobytes())
        return f.tell()


def write_generic(path: str, nbytes: int, seed: int = 2024) -> int:
    """Write at least `nbytes` of a text log with no datatype of its own
    (timestamps, levels, hosts, counters): what `zip --input-type generic`
    compresses as one blob per VB."""
    rng = np.random.default_rng(seed)
    st = {"t": 1_700_000_000_000}
    levels = [b"INFO", b"WARN", b"DEBUG", b"ERROR"]

    def block():
        n = 5000
        t = st["t"] + np.cumsum(rng.integers(0, 2000, n))
        st["t"] = int(t[-1])
        lv = rng.choice(4, n, p=[.7, .1, .18, .02])
        host = rng.integers(0, 32, n)
        val = rng.integers(0, 100000, n)
        return b"".join(b"%d %s node%02d.cluster served %d bytes in %d ms\n"
                        % (t[k], levels[lv[k]], host[k], val[k], val[k] % 997)
                        for k in range(n))
    return _write_blocks(path, nbytes, b"", block)
