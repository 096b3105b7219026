"""Synthetic inputs in the shape of bench configs cfg3 and cfg4.

cfg3 (`write_fastq`): single-end FASTQ of 150 bp reads sampled off a
repeat-family genome, 0.3% substitution errors, half of them
reverse-complemented, 4-bin Illumina quality with a positional ramp, and
QNAMEs that cycle through four flavours per block of reads (Illumina, BGI
fixed-width, SRA with length=, ONT uuid-like).

cfg4 (`write_fasta` + `write_paired_fastq`): the genome as a FASTA for
--make-reference, and proper pairs off it: R1 forward at p, R2
reverse-complemented at p + 150..350, 150 bp each, 0.3% errors, 4-bin
quality, Illumina QNAMEs with /1 and /2.

A vectorized re-implementation of bench.py's generators (its `_genome`,
`_qual_rows`, `gen_fastq`, `gen_fasta`, `gen_paired_fastq`), made from a
numpy seed, for the port's tests and chip_smoke.py.
"""

import numpy as np

from .ops import pack as packops

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
    pos = np.arange(rl)
    base = 36.0 - 8.0 * (pos / rl) ** 2 - 2.0 * (pos < 3)
    q = base[None, :] + rng.normal(0, 3.0, (n, rl))
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
    n = starts.shape[0]
    mat = g[starts[:, None] + np.arange(rl)[None, :]]
    nerr = rng.binomial(n * rl, err)
    mat[rng.integers(0, n, nerr), rng.integers(0, rl, nerr)] = \
        _BASES[rng.integers(0, 4, nerr)]
    return mat


def write_fasta(path: str, g: np.ndarray) -> int:
    """Genome `g` (ACGT bytes) as a one-contig FASTA with 60-base lines.
    Returns the bytes written."""
    G = g.shape[0]
    rows = g[: G - G % 60].reshape(-1, 60)
    block = np.empty((rows.shape[0], 61), np.uint8)
    block[:, :60] = rows
    block[:, 60] = ord("\n")
    tail = g[G - G % 60:]
    with open(path, "wb") as f:
        f.write(b">chrB test benchmark contig\n")
        f.write(block.tobytes())
        if tail.shape[0]:
            f.write(tail.tobytes() + b"\n")
        return f.tell()


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
