"""Batched seed-hash aligner: reads -> (gpos, strand, mismatches), and the
PIZ-side rebuild of aligned reads.

Counterpart of genozip_tpu/ref/aligner.py, host numpy code as there (its
sharded device twin, `--mesh`, is not ported): candidates are generated,
scored and tie-broken in the same order, so the alignments, and with them
the archive bytes, are the same.

Reference parity: src/aligner.c. The serial hook scan with XOR+popcount
hamming (aligner.c:150-194, aligner_seg_seq :767) becomes whole-batch ops:
seed k-mers at fixed offsets per read -> refhash gather -> candidate GPOS ->
genome window gather -> mismatch count -> best candidate. The near-perfect
early exit (aligner.c:226) becomes a plain minimum over all candidates.
"""

import numpy as np

from ..ops import pack as packops
from .refstore import RefGenome, KMER, hash_kmer, NO_GPOS

NUM_SEEDS = 4          # seed positions per read ('--fast' uses 2)
MAX_MM_FRAC = 0.5      # alignment accepted if mismatches <= frac * len

# pairing (reference aligner.c:26-27): R2 candidates far from R1's GPOS get
# a score penalty so the near-mate placement wins ties
PAIR_MAX_DISTANCE = 500
NON_PAIR_PENALTY = 13

# splicing (reference aligner.c:17-23): 2-segment alignment with junction
# search for reads spanning an intron-like gap
SPLICE_MIN_FRAC = 0.10      # try splicing when mismatch frac in this range
SPLICE_MAX_FRAC = 0.68      # (match percent 32..90 in reference terms)
SPLICE_MIN_LEN = 32
MAX_SPLICE_GAP = 32 * 1024 - 1
MIN_SPLICE_CONTRIBUTION = 10


def _revcomp_codes(codes_mat: np.ndarray, lens: np.ndarray):
    """Reverse-complement each row of a (R, L) code matrix (rows padded)."""
    R, L = codes_mat.shape
    comp = codes_mat ^ 3
    # idx <= L-1 by construction (lens <= L); only the pad-column lower
    # bound needs clamping
    idx = np.maximum(lens[:, None] - 1 - np.arange(L)[None, :], 0)
    return np.take_along_axis(comp, idx, axis=1)


def align_batch(ref: RefGenome, codes_mat: np.ndarray, lens: np.ndarray,
                num_seeds: int = NUM_SEEDS, pair_gpos: np.ndarray | None = None,
                splice: bool = False):
    """Align a batch of reads (2-bit codes, padded matrix) against the genome.

    pair_gpos: per-read R1 GPOS (-1 unknown) — candidates farther than
    PAIR_MAX_DISTANCE get a NON_PAIR_PENALTY score handicap (aligner.c:210).
    splice=True: reads whose best single placement leaves a mid-range
    mismatch fraction get a 2-segment junction search over the best two
    candidate windows (aligner.c:514-586).

    Returns dict of arrays over reads:
      aligned (bool), gpos (int64, of the read's first base on fwd genome),
      is_fwd (bool), nmm (int32 mismatches vs the (possibly 2-segment)
      genome window), gpos2 (int64, second-segment window start; == gpos
      when unspliced), junction (int64; == len when unspliced).
    """
    R, L = codes_mat.shape
    G = ref.length
    if R == 0 or G < KMER:
        z = np.zeros(R, dtype=bool)
        return {"aligned": z, "gpos": np.zeros(R, np.int64),
                "is_fwd": np.ones(R, bool), "nmm": np.zeros(R, np.int32),
                "gpos2": np.zeros(R, np.int64),
                "junction": lens.astype(np.int64)}

    rc_mat = _revcomp_codes(codes_mat, lens)
    cands = []           # (gpos_of_read_start, is_fwd) per candidate set
    for direction, mat in ((1, codes_mat), (0, rc_mat)):
        # seed offsets spread over the read (clipped so kmer fits)
        for si in range(num_seeds):
            off = (lens - KMER) * si // max(num_seeds - 1, 1)
            off = np.minimum(np.maximum(off, 0), np.maximum(lens - KMER, 0))
            km = np.zeros(R, dtype=np.uint32)
            # off in [0, lens-KMER] -> idx in [0, L-1] by construction
            idx = off[:, None] + np.arange(KMER)[None, :]
            window = np.take_along_axis(mat, idx, axis=1)
            for j in range(KMER):
                km = (km << np.uint32(2)) | window[:, j].astype(np.uint32)
            h = hash_kmer(km, ref.hash_bits)
            g = ref.refhash[h].astype(np.int64)
            miss = g == int(NO_GPOS)
            start = g - off          # genome pos of read base 0 (this strand)
            start[miss] = -1
            cands.append((start, direction))
            size = 1 << ref.hash_bits
            if ref.refhash.shape[0] >= 2 * size:
                # layer-1 candidates (second locus of repetitive kmers,
                # refhash_make.c occupancy layers)
                g1 = ref.refhash[size + h].astype(np.int64)
                miss1 = g1 == int(NO_GPOS)
                start1 = g1 - off
                start1[miss1] = -1
                if (~miss1).any():
                    cands.append((start1, direction))

    # score every candidate: gather genome windows, count mismatches;
    # keep best AND runner-up (distinct gpos, same strand) for splicing
    BIG = np.int64(np.iinfo(np.int32).max)
    best_nmm = np.full(R, BIG, dtype=np.int64)
    best_score = np.full(R, BIG, dtype=np.int64)   # nmm + pair penalty
    best_gpos = np.full(R, -1, dtype=np.int64)
    best_fwd = np.ones(R, dtype=bool)
    sec_nmm = np.full(R, BIG, dtype=np.int64)
    sec_gpos = np.full(R, -1, dtype=np.int64)
    sec_fwd = np.ones(R, dtype=bool)
    pos_idx = np.arange(L)[None, :]
    valid_mask_base = pos_idx < lens[:, None]
    for start, direction in cands:
        ok = (start >= 0) & (start + lens <= G)
        # seeds mostly agree: a candidate equal to the read's current best
        # placement would produce the same mm and change nothing — skip
        # those rows and gather genome windows only for the rest (the
        # reference's near-perfect early exit, aligner.c:30, as row
        # compaction instead of control flow)
        dup = ok & (start == best_gpos) & ((direction == 1) == best_fwd)
        rows = np.nonzero(ok & ~dup)[0]
        mat = codes_mat if direction == 1 else rc_mat
        mm = np.full(R, BIG, dtype=np.int64)
        if rows.shape[0]:
            gidx = start[rows, None] + pos_idx
            gwin = ref.codes[np.minimum(gidx, G - 1)]
            mm[rows] = ((gwin != mat[rows]) &
                        valid_mask_base[rows]).sum(axis=1)
        score = mm
        if pair_gpos is not None:
            far = (pair_gpos >= 0) & \
                (np.abs(start - pair_gpos) > PAIR_MAX_DISTANCE)
            score = mm + np.where(ok & far, NON_PAIR_PENALTY, 0)
        better = score < best_score
        # displaced best becomes runner-up candidate; also track candidates
        # that beat only the runner-up (must differ from best's placement)
        demote = better & (best_gpos >= 0)
        sec_from_best = demote & ((best_gpos != start) | (best_fwd != (direction == 1)))
        sec_nmm = np.where(sec_from_best, best_nmm, sec_nmm)
        sec_gpos = np.where(sec_from_best, best_gpos, sec_gpos)
        sec_fwd = np.where(sec_from_best, best_fwd, sec_fwd)
        to_sec = ~better & (mm < sec_nmm) & \
            ((start != best_gpos) | ((direction == 1) != best_fwd)) & ok
        sec_nmm = np.where(to_sec, mm, sec_nmm)
        sec_gpos = np.where(to_sec, start, sec_gpos)
        sec_fwd = np.where(to_sec, direction == 1, sec_fwd)
        best_nmm = np.where(better, mm, best_nmm)
        best_score = np.where(better, score, best_score)
        best_gpos = np.where(better, start, best_gpos)
        best_fwd = np.where(better, direction == 1, best_fwd)

    gpos2 = best_gpos.copy()
    junction = lens.astype(np.int64).copy()
    if splice:
        best_nmm, best_gpos, gpos2, junction = _splice_pass(
            ref, codes_mat, rc_mat, lens, best_nmm, best_gpos, best_fwd,
            sec_nmm, sec_gpos, sec_fwd)

    aligned = best_nmm <= (lens * MAX_MM_FRAC).astype(np.int64)
    return {"aligned": aligned, "gpos": best_gpos, "is_fwd": best_fwd,
            "nmm": np.where(aligned, best_nmm, 0).astype(np.int32),
            "gpos2": np.where(aligned, gpos2, best_gpos),
            "junction": junction}


def _splice_pass(ref, codes_mat, rc_mat, lens, best_nmm, best_gpos, best_fwd,
                 sec_nmm, sec_gpos, sec_fwd):
    """Vectorized 2-segment junction search (aligner.c:514-586 redesigned):
    for eligible reads, read[i] = genome[gA+i] (i < j) else genome[gB+i];
    the incremental add/remove match scan becomes two cumsums."""
    R, L = codes_mat.shape
    G = ref.length
    frac = best_nmm / np.maximum(lens, 1)
    gap = np.abs(sec_gpos - best_gpos)
    elig = (lens >= SPLICE_MIN_LEN) & (frac >= SPLICE_MIN_FRAC) & \
        (frac <= SPLICE_MAX_FRAC) & (sec_gpos >= 0) & (best_gpos >= 0) & \
        (sec_fwd == best_fwd) & (gap > 0) & (gap <= MAX_SPLICE_GAP) & \
        (sec_gpos + lens <= G) & (best_gpos + lens <= G)
    rows = np.nonzero(elig)[0]
    gpos2 = best_gpos.copy()
    junction = lens.astype(np.int64).copy()
    if rows.shape[0] == 0:
        return best_nmm, best_gpos, gpos2, junction
    sub_lens = lens[rows]
    Ls = int(sub_lens.max())
    pos = np.arange(Ls)[None, :]
    valid = pos < sub_lens[:, None]
    mat = np.where(best_fwd[rows, None], codes_mat[rows, :Ls],
                   rc_mat[rows, :Ls])
    winA = ref.codes[np.minimum(best_gpos[rows, None] + pos, G - 1)]
    winB = ref.codes[np.minimum(sec_gpos[rows, None] + pos, G - 1)]
    eqA = ((mat == winA) & valid).astype(np.int64)
    eqB = ((mat == winB) & valid).astype(np.int64)
    base_matches = eqA.sum(axis=1)

    def best_junction(eq1, eq2):
        # matches(j) = sum(eq1[<j]) + sum(eq2[>=j]); j in [0, L]
        c1 = np.concatenate([np.zeros((rows.shape[0], 1), np.int64),
                             np.cumsum(eq1, axis=1)], axis=1)
        tot2 = eq2.sum(axis=1, keepdims=True)
        c2 = np.concatenate([np.zeros((rows.shape[0], 1), np.int64),
                             np.cumsum(eq2, axis=1)], axis=1)
        m = c1 + (tot2 - c2)
        j = np.argmax(m, axis=1)
        return m[np.arange(rows.shape[0]), j], j

    mAB, jAB = best_junction(eqA, eqB)   # best first, runner-up second
    mBA, jBA = best_junction(eqB, eqA)   # runner-up first
    use_ba = mBA > mAB
    max_m = np.where(use_ba, mBA, mAB)
    jbest = np.where(use_ba, jBA, jAB)
    g_first = np.where(use_ba, sec_gpos[rows], best_gpos[rows])
    g_second = np.where(use_ba, best_gpos[rows], sec_gpos[rows])
    engage = (max_m - base_matches) >= MIN_SPLICE_CONTRIBUTION
    # junction must split properly (both segments non-empty)
    engage &= (jbest > 0) & (jbest < sub_lens)
    er = rows[engage]
    best_gpos[er] = g_first[engage]
    gpos2[er] = g_second[engage]
    junction[er] = jbest[engage]
    best_nmm[er] = sub_lens[engage] - max_m[engage]
    return best_nmm, best_gpos, gpos2, junction


def mismatch_lists(ref: RefGenome, seq_mat: np.ndarray, codes_mat: np.ndarray,
                   lens: np.ndarray, gpos: np.ndarray, is_fwd: np.ndarray,
                   aligned: np.ndarray, gpos2: np.ndarray | None = None,
                   junction: np.ndarray | None = None):
    """For aligned reads, produce sparse mismatch (read_idx, pos_in_read,
    original_base_byte) lists — original ASCII bases (handles N etc.).
    Positions are in *stored* orientation: for reverse reads the stored
    sequence is the reverse-complement read, compared against fwd genome.
    With gpos2/junction (spliced 2-segment alignments): positions >=
    junction compare against the second window."""
    R, L = seq_mat.shape
    G = ref.length
    pos_idx = np.arange(L)[None, :]
    valid = (pos_idx < lens[:, None]) & aligned[:, None]
    safe = np.where(aligned, gpos, 0)
    gstart = safe[:, None]
    if gpos2 is not None:
        safe2 = np.where(aligned, gpos2, 0)
        gstart = np.where(pos_idx < junction[:, None], gstart,
                          safe2[:, None])
    gidx = np.minimum(gstart + pos_idx, max(G - 1, 0))
    gwin = ref.codes[gidx]
    # stored orientation codes: fwd reads as-is; rev reads revcomp'd
    stored = np.where(is_fwd[:, None], codes_mat,
                      _revcomp_codes(codes_mat, lens))
    stored_seq = np.where(is_fwd[:, None], seq_mat,
                          _rev_seq(seq_mat, lens))
    mm = (gwin != stored) & valid
    # non-ACGT bytes always count as mismatches (their code is a lie)
    acgt = packops.IS_ACGT[stored_seq]
    mm |= (~acgt) & valid
    ridx, ppos = np.nonzero(mm)
    return ridx, ppos, stored_seq[ridx, ppos]


def _rev_seq(seq_mat: np.ndarray, lens: np.ndarray):
    """Reverse-complement ASCII rows (complement of non-ACGT = itself)."""
    R, L = seq_mat.shape
    idx = np.maximum(lens[:, None] - 1 - np.arange(L)[None, :], 0)
    rev = np.take_along_axis(seq_mat, idx, axis=1)
    comp = rev.copy()
    for a, b in ((b"A", b"T"), (b"C", b"G")):
        ma = rev == a[0]
        mb = rev == b[0]
        comp[ma] = b[0]
        comp[mb] = a[0]
    return comp


def reconstruct_batch(ref: RefGenome, gpos: np.ndarray, lens: np.ndarray,
                      is_fwd: np.ndarray, mm_ridx: np.ndarray,
                      mm_pos: np.ndarray, mm_base: np.ndarray,
                      gpos2: np.ndarray | None = None,
                      junction: np.ndarray | None = None):
    """PIZ side: rebuild read sequences (ASCII) from genome + mismatch lists.
    Returns (R, L) ASCII matrix (rows padded with zeros)."""
    R = gpos.shape[0]
    L = int(lens.max()) if R else 0
    G = ref.length
    pos_idx = np.arange(L)[None, :]
    gstart = gpos[:, None]
    if gpos2 is not None:
        gstart = np.where(pos_idx < junction[:, None], gstart,
                          gpos2[:, None])
    gidx = np.minimum(gstart + pos_idx, max(G - 1, 0))
    seq = packops.ACGT[ref.codes[gidx]]
    seq[mm_ridx, mm_pos] = mm_base
    # stored orientation is fwd-genome; reverse reads need revcomp back
    rev = ~is_fwd
    if rev.any():
        sub = _rev_seq(seq[rev], lens[rev])
        seq[rev] = sub
    valid = pos_idx < lens[:, None]
    return np.where(valid, seq, 0)
