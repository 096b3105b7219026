"""A human-sized genome, made from the seed where a read needs it.

The inputs' reads come off a genome of GRCh38's length (its 25 primary
contigs, 3.09 Gbp), so that a file holds what a slice of a real run holds:
a FASTQ of some hundred MB samples it at under 0.1x, and a sorted BAM is a
narrow region at the run's depth. No 3.1 Gbp array is built: every base is
a function of its position and of keys drawn from the seed (a 32-bit mix of
both), so a read's bases are made with the read.

The reference has, at the rates of the generator it replaces
(`genozip_tpu_torch/synth.py`'s `genome`):

- i.i.d. background bases;
- interspersed repeats: a third of the 1 kbp slots hold a copy of one of six
  200-399 bp family prototypes drawn from the seed, 2% of its bases changed
  (about 10% of the genome);
- tandem repeats: one in each 20 kbp slot, a 2-39 bp unit 5-39 times;
- homopolymer runs: one in each 2 kbp slot, 5-29 bp.

The donor whose reads these are differs from it at about one site in 1024:
heterozygous at two sites in three, homozygous at the third; `reads` gives
the bases of the reference or of one of the donor's haplotypes.
"""

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
# GRCh38 primary assembly: chr1-22, X, Y, M
CONTIGS = (
    (b"chr1", 248956422), (b"chr2", 242193529), (b"chr3", 198295559),
    (b"chr4", 190214555), (b"chr5", 181538259), (b"chr6", 170805979),
    (b"chr7", 159345973), (b"chr8", 145138636), (b"chr9", 138394717),
    (b"chr10", 133797422), (b"chr11", 135086622), (b"chr12", 133275309),
    (b"chr13", 114364328), (b"chr14", 107043718), (b"chr15", 101991189),
    (b"chr16", 90338345), (b"chr17", 83257441), (b"chr18", 80373285),
    (b"chr19", 58617616), (b"chr20", 64444167), (b"chr21", 46709983),
    (b"chr22", 50818468), (b"chrX", 156040895), (b"chrY", 57227415),
    (b"chrM", 16569))
OFFSETS = np.concatenate([[0], np.cumsum([n for _, n in CONTIGS])])
TOTAL = int(OFFSETS[-1])                 # 3,088,269,832 < 2**32
U = np.uint32


def seed64(seed: int) -> int:
    """`seed` as a non-negative integer for numpy's generators."""
    return int(seed) % (1 << 64)


def _fmix(h: np.ndarray) -> np.ndarray:
    """MurmurHash3's 32-bit finaliser (a bijection), on a uint32 array."""
    h = h ^ (h >> U(16))
    h *= U(0x85EBCA6B)
    h ^= h >> U(13)
    h *= U(0xC2B2AE35)
    h ^= h >> U(16)
    return h


def _runs(rows: np.ndarray, a: np.ndarray, b: np.ndarray):
    """(row, position) of every position of the runs [a, b) of `rows`."""
    lens = b - a
    r = np.repeat(rows, lens)
    at = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return r, np.repeat(a - at, lens) + np.arange(int(lens.sum()))


class Genome:
    """The reference and the donor of one seed."""

    def __init__(self, seed: int):
        ss = np.random.SeedSequence([seed64(seed), 0x6E6F6D65])
        (self.k_base, self.k_rep, self.k_mut, self.k_tan, self.k_unit,
         self.k_hom, self.k_var) = (U(k) for k in ss.generate_state(7,
                                                                   np.uint32))
        rng = np.random.default_rng(ss.spawn(1)[0])
        self.plen = rng.integers(200, 400, 6)
        self.pstart = np.concatenate([[0], np.cumsum(self.plen)[:-1]])
        self.proto = rng.integers(0, 4, int(self.plen.sum())).astype(np.uint8)

    @staticmethod
    def _h(x, key) -> np.ndarray:
        return _fmix(np.asarray(x, np.uint32) * U(0x9E3779B1) + key)

    def _feature(self, code, starts, rl, size, key, place, fill):
        """Write one kind of feature into `code` (reads x rl): each slot of
        `size` bp holds at most one, which `place(slot, hash)` puts at
        (present, start in the slot, length); `fill(slot, hash, offset in
        the feature, position)` gives its bases where reads cover it."""
        for s in (starts // size, starts // size + 1):
            hs = self._h(s, key)
            present, at, ln = place(s, hs)
            fs = s * size + at
            a = np.maximum(fs, starts)
            b = np.minimum(fs + ln, starts + rl)
            rows = np.nonzero(present & (b > a))[0]
            r, pos = _runs(rows, a[rows], b[rows])
            code[r, pos - starts[r]] = fill(s[r], hs[r], pos - fs[r], pos)

    def _repeat_place(self, s, hs):
        fam = (hs >> U(8)) % U(6)
        return ((hs & U(0xFF)) < U(85), (hs >> U(16)).astype(np.int64) % 600,
                self.plen[fam])

    def _repeat_fill(self, s, hs, off, pos):
        base = self.proto[self.pstart[(hs >> U(8)) % U(6)] + off]
        hm = self._h(pos, self.k_mut)
        return np.where((hm & U(0xFFFF)) < U(1311),                 # 2%
                        ((hm >> U(16)) & U(3)).astype(np.uint8), base)

    @staticmethod
    def _tandem_place(s, hs):
        ln = (2 + hs % U(38)).astype(np.int64) * (5 + (hs >> U(8)) % U(35))
        return (np.ones(s.shape, bool),
                (hs >> U(16)).astype(np.int64) % 18440, ln)

    def _tandem_fill(self, s, hs, off, pos):
        u = (2 + hs % U(38)).astype(np.int64)
        return (self._h(s * 64 + off % u, self.k_unit) >> U(30)) \
            .astype(np.uint8)

    @staticmethod
    def _hom_place(s, hs):
        return (np.ones(s.shape, bool), (hs >> U(8)).astype(np.int64) % 1960,
                (5 + hs % U(25)).astype(np.int64))

    @staticmethod
    def _hom_fill(s, hs, off, pos):
        return (hs >> U(30)).astype(np.uint8)

    def reads(self, starts: np.ndarray, rl: int, hap=None) -> np.ndarray:
        """(n, rl) ASCII bases of reads at `starts` (each under TOTAL - rl):
        the reference's, or with `hap` ((n, 1) of 0 or 1) the donor's
        haplotype's."""
        starts = np.asarray(starts, np.int64)
        p = starts.astype(np.uint32)[:, None] + \
            np.arange(rl, dtype=np.uint32)[None, :]
        h = self._h(p, self.k_base)
        code = (h >> U(30)).astype(np.uint8)
        self._feature(code, starts, rl, 1000, self.k_rep, self._repeat_place,
                      self._repeat_fill)
        self._feature(code, starts, rl, 20000, self.k_tan,
                      self._tandem_place, self._tandem_fill)
        self._feature(code, starts, rl, 2000, self.k_hom, self._hom_place,
                      self._hom_fill)
        if hap is not None:
            # a variant site where 10 bits of the base's hash are 0
            r, c = np.nonzero(((h >> U(20)) & U(0x3FF)) == U(0))
            hv = self._h(starts[r] + c, self.k_var)
            hp = np.broadcast_to(np.asarray(hap), (starts.shape[0], 1))[r, 0]
            carry = (hv % U(3) == U(0)) | (((hv >> U(8)) & U(1)) == hp)
            r, c, hv = r[carry], c[carry], hv[carry]
            code[r, c] = ((code[r, c] + 1 + (hv >> U(16)) % U(3)) & U(3)) \
                .astype(np.uint8)
        return BASES[code]


_CACHE = {}


def of(seed: int) -> Genome:
    """The genome of `seed`, made once a process."""
    g = _CACHE.get(seed)
    if g is None:
        g = _CACHE[seed] = Genome(seed)
    return g
