"""The `fastq_illumina_se` input: single-end Illumina FASTQ (cfg3).

150 bp reads sampled uniformly off a human-sized genome (`genome.py`: a
file of 512 MiB covers it about 0.08x, as a slice of a real run does), each
from one of the donor's two haplotypes, with 0.3% substitution errors, half
of them reverse-complemented; 4-bin Illumina quality with a positional ramp;
QNAMEs that cycle through four flavours per block of reads (Illumina, BGI
fixed-width, SRA with length=, ONT uuid-like). The quality, the QNAMEs and
the errors follow `genozip_tpu_torch/synth.py`'s `write_fastq`, whose reads
came off a 4 Mbp genome instead. A block depends only on the seed and its
index, and blocks are made on worker processes (`pool.py`).
"""

import contextlib

import numpy as np

from . import genome, pool
from .ragged import Col, fixed_digits, interleave, itoa

BASES = genome.BASES
BASE2BIT = np.zeros(256, dtype=np.uint8)
BASE2BIT[np.frombuffer(b"CGT", np.uint8)] = (1, 2, 3)


def qual_bins(noise: np.ndarray) -> np.ndarray:
    """Illumina-RTA3-style 4-bin quality with a positional ramp, from (n,
    rl) normal draws."""
    rl = noise.shape[1]
    pos = np.arange(rl)
    base = 36.0 - 8.0 * (pos / rl) ** 2 - 2.0 * (pos < 3)
    q = base[None, :] + noise
    # the nearest of the bins 2, 12, 23 and 37, the lower on a tie, as the
    # original's argmin of |q - bin|: near each midpoint both differences
    # are exact in float64, so comparing with the midpoint is the same test
    idx = (q > 7.0).astype(np.uint8) + (q > 17.5) + (q > 30.0)
    return np.frombuffer(b"#-8F", np.uint8)[idx]


def _const(n: int, b: bytes) -> Col:
    return Col.from_fixed(np.tile(np.frombuffer(b, np.uint8), (n, 1)))


def qnames(flavor: int, r: np.ndarray) -> Col:
    """The QNAMEs of reads `r` in one of the four flavours."""
    n = r.shape[0]
    if flavor == 0:
        return interleave(
            [_const(n, b"@SIM:1:FC706VJ:1:"), itoa(2100 + r // 100000),
             itoa(15000 + r % 90000), itoa(1000 + (r * 7) % 90000)],
            [None, b":", b":", b" 1:N:0:ATCACG"])
    if flavor == 1:
        return interleave(
            [_const(n, b"@E100016873L1C"),
             fixed_digits(r // 10000 % 999 + 1, 3),
             fixed_digits(r // 100 % 999 + 1, 3),
             fixed_digits(r % 9999999, 7)], [None, b"R", None, None])
    if flavor == 2:
        return interleave([_const(n, b"@SRR8861483."), itoa(r + 1),
                           itoa(r + 1)], [None, b" ", b" length=150"])
    return interleave(
        [_const(n, b"@"), fixed_digits(r * 2654435761 % (1 << 32), 8, 16),
         fixed_digits(r % (1 << 16), 4, 16),
         fixed_digits((r * 7) % (1 << 16), 4, 16),
         fixed_digits((r * 13) % (1 << 16), 4, 16),
         fixed_digits(r * 1099511627 % (1 << 48), 12, 16)],
        [None, b"-", b"-", b"-", b"-", None])


def _block(seed: int, i: int, n: int, rl: int) -> bytes:
    """The FASTQ records of block `i`: reads i * n to i * n + n - 1."""
    rng = np.random.default_rng([genome.seed64(seed), 2, i])
    g = genome.of(seed)
    starts = rng.integers(0, genome.TOTAL - rl, n)
    hap = rng.integers(0, 2, (n, 1))
    mat = g.reads(starts, rl, hap)
    nerr = rng.binomial(n * rl, 0.003)
    er, ec = rng.integers(0, n, nerr), rng.integers(0, rl, nerr)
    mat[er, ec] = BASES[rng.integers(0, 4, nerr)]
    rev = rng.random(n) < 0.5
    rc = BASE2BIT[mat] ^ 3
    mat[rev] = BASES[rc[rev][:, ::-1]]
    noise = rng.normal(0, 3.0, (n, rl))
    return interleave(
        [qnames(i % 4, i * n + np.arange(n, dtype=np.int64)),
         Col.from_fixed(mat), Col.from_fixed(qual_bins(noise))],
        [b"\n", b"\n+\n", b"\n"]).data.tobytes()


def write(path: str, nbytes: int, seed: int, block: int = 20000,
          rl: int = 150) -> int:
    """Write whole blocks of `block` reads to `path` until it holds at
    least `nbytes`. Returns the bytes written."""
    size = 0
    with open(path, "wb") as f, contextlib.closing(pool.parts(
            _block, lambda i: (seed, i, block, rl))) as blocks:
        for body in blocks:
            f.write(body)
            size += len(body)
            if size >= nbytes:
                break
    return size
