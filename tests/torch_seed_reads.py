"""Reads that hold the seed aligner (genozip_tpu_torch/ops/align_torch.py
and csrc/seed_align.cu) at its edges, for tests/test_torch_seed_align.py
and chip_smoke.py: `edge_batch` (lengths 1 to Lb, both strands, the
genome's last bases and position 0, codes above 3), `tie_read` (two
candidates with equal counts; the first must win) and `spread` (a batch
tiled and shuffled, so that short, long and Lb-length reads follow one
another within each stride of the kernel's persistent grid). Imports
nothing of the JAX package."""

import numpy as np
import torch

from genozip_tpu_torch.ops import align_torch


def edge_batch(ref, rng, Lb=256):
    """Edge reads (lengths 1, 15, 16, 17, Lb - 1, Lb), both strands, with
    substitutions and codes above 3, and reads of 150 bp (Lb - 28 when
    that is shorter), padded to Lb; then the reads at the genome's last
    bases (150 bp and Lb, each strand), at position 0 (both strands) and a
    tie read (tie_read). Returns (codes, lens, the tie read's row and first
    start)."""
    G, L0 = ref.length, min(150, Lb - 28)
    rows, lens = [], []

    def add(c, L):
        row = np.zeros(Lb, np.uint8)
        row[:L] = c
        rows.append(row)
        lens.append(L)
    for L in (1, 15, 16, 17, Lb - 1, Lb) + (L0,) * 42:
        p = int(rng.integers(0, G - L))
        c = np.array(ref.codes[p:p + L], np.uint8)
        if rng.random() < 0.5:
            c = (c ^ 3)[::-1]
        if L > 20:
            c[rng.integers(0, L, 3)] = rng.integers(0, 8, 3)
        add(c, L)
    for L, p in ((L0, G - L0), (Lb, G - Lb), (L0, 0)):
        c = np.array(ref.codes[p:p + L], np.uint8)
        c[rng.integers(0, L, 2)] ^= 1
        add(c, L)
        add((c ^ 3)[::-1], L)
    tie, p1, _ = tie_read(ref, rng, L0, Lb)
    add(tie, L0)
    return np.stack(rows), np.asarray(lens, np.int32), len(rows) - 1, p1


def spread(codes, lens, rng, R):
    """R rows of (codes, lens): the batch tiled to R rows, then shuffled.
    Returns (codes, lens, src), row i being the batch's row src[i]."""
    src = rng.permutation(np.arange(R) % codes.shape[0])
    return np.ascontiguousarray(codes[src]), lens[src], src


def tie_read(ref, rng, L: int = 150, Lb: int = 256, tries: int = 500):
    """A read of L bases (32 <= L <= Lb) off `ref` (a refstore.RefGenome)
    whose smallest mismatch count under the seed aligner is reached by two
    forward candidates at two different starts, p1 before s2 in candidate
    order: its first half copies the genome at p1, its second half the
    genome at s2 + L // 2, and bases outside the seeds' k-mers are changed
    until the two windows' counts are equal. Returns (codes (L,) uint8, p1,
    s2); the first candidate, p1, is the one the aligner must keep."""
    codes = np.asarray(ref.codes, np.uint8)
    G, half = codes.shape[0], L // 2
    offs = [min(max((L - 16) * si // 3, 0), max(L - 16, 0)) for si in range(4)]
    seeded = np.zeros(L, bool)
    for o in offs:
        seeded[o:o + 16] = True
    rh = torch.from_numpy(np.array(ref.refhash[:1 << ref.hash_bits],
                                   np.uint32).view(np.int32))
    for _ in range(tries):
        p1, s2 = (int(x) for x in rng.integers(0, G - L, 2))
        if abs(p1 - s2) < L:
            continue
        read = np.concatenate([codes[p1:p1 + half], codes[s2 + half:s2 + L]])
        w1, w2 = codes[p1:p1 + L], codes[s2:s2 + L]
        c1, c2 = int((read != w1).sum()), int((read != w2).sum())
        # raise the smaller count by changing bases that the other window
        # already mismatches, to a base neither window has there
        lo_half = np.arange(L) >= half if c1 > c2 else np.arange(L) < half
        other = w1 if c1 > c2 else w2
        free = np.nonzero(lo_half & ~seeded & (read != other))[0]
        need = abs(c1 - c2)
        if free.shape[0] < need:
            continue
        for i in rng.permutation(free)[:need]:
            read[i] = [b for b in range(4) if b not in (w1[i], w2[i])][0]
        row = np.zeros((1, Lb), np.uint8)
        row[0, :L] = read
        ct, lt = torch.from_numpy(row), torch.tensor([L], dtype=torch.int32)
        starts, oks, mats = align_torch.candidates(ct, lt, rh, G,
                                                   ref.hash_bits)
        starts, oks = starts[0].tolist(), oks[0].tolist()
        counts = [int((mats[c // 4][0, :L].numpy() != codes[s:s + L]).sum())
                  if ok else 1 << 30 for c, (s, ok) in
                  enumerate(zip(starts, oks))]
        best = min(counts)
        firsts = [c for c in range(8) if counts[c] == best]
        if starts[firsts[0]] == p1 and firsts[0] < 4 and any(
                starts[c] == s2 and c < 4 for c in firsts):
            return read, p1, s2
    raise ValueError(f"no tie read found in {tries} tries")
