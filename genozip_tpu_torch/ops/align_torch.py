"""The plain PyTorch version of the seed aligner kernel (csrc/seed_align.cu).

It computes what genozip_tpu's mesh aligner step computes
(`parallel/aligner_sharded.py` `make_sharded_aligner`'s `local`, :65-140)
with the whole genome in one slab (mp = 1): for each read, 4 seeds in each
direction (forward, then the reverse complement), the seed's 16-base k-mer
hashed into layer 0 of the refhash, each hit's genome window scored by its
mismatch count, and the first strictly smaller count kept. The u32 genome
positions are held in int64 and masked to 32 bits, since the CPU's
`torch.uint32` lacks shifts, division and comparisons. It is the CPU path
of `ops.align_cuda.seed_align` and the oracle the kernel is held to.
"""

import torch

KMER = 16
NUM_SEEDS = 4
FIB32 = 2654435761
NO_GPOS = 0xFFFFFFFF
MASK32 = 0xFFFFFFFF
NO_MATCH = 1 << 30


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """a * b mod 2^32 for 0 <= a, b < 2^32, without leaving int64."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def oriented_rows(codes: torch.Tensor, lens: torch.Tensor):
    """The forward rows and the reverse-complement rows (row
    clip(len-1-p, 0, Lb-1) xor 3), both (R, Lb) uint8."""
    Lb = codes.shape[1]
    pos = torch.arange(Lb, device=codes.device)
    ridx = (lens.long()[:, None] - 1 - pos[None, :]).clamp(0, Lb - 1)
    return codes, torch.gather(codes ^ 3, 1, ridx)


def candidates(codes: torch.Tensor, lens: torch.Tensor, rh: torch.Tensor,
               G: int, hash_bits: int):
    """The 8 candidates of each read in the kernel's order (forward seeds
    0-3, then reverse-complement seeds 0-3): (starts int64 (R, 8) of u32
    values, usable bool (R, 8), the two oriented row matrices)."""
    R, Lb = codes.shape
    dev = codes.device
    lens64 = lens.long()
    rh64 = rh.long() & MASK32
    mats = oriented_rows(codes, lens)
    ks = torch.arange(KMER, device=dev)
    starts, oks = [], []
    for mat in mats:
        m64 = mat.long()
        for si in range(NUM_SEEDS):
            off = torch.div((lens64 - KMER) * si, NUM_SEEDS - 1,
                            rounding_mode="floor")
            off = torch.minimum(off.clamp(min=0), (lens64 - KMER).clamp(min=0))
            idx = (off[:, None] + ks[None, :]).clamp(0, Lb - 1)
            win = torch.gather(m64, 1, idx)
            km = torch.zeros(R, dtype=torch.int64, device=dev)
            for j in range(KMER):
                km = ((km << 2) | win[:, j]) & MASK32
            h = _mul32(km, FIB32) >> (32 - hash_bits)
            g = rh64[h]
            start = (g - off) & MASK32
            ok = (g != NO_GPOS) & (off <= g) & \
                (start <= ((G - lens64) & MASK32)) & (lens64 <= G)
            starts.append(start)
            oks.append(ok)
    return torch.stack(starts, 1), torch.stack(oks, 1), mats


def seed_align_plain(codes: torch.Tensor, lens: torch.Tensor,
                     genome: torch.Tensor, rh: torch.Tensor, hash_bits: int):
    """codes uint8 (R, Lb), lens int32 (R,), genome uint8 (G,), rh int32
    (2^hash_bits,) of u32 slots -> (gpos int64 (R,) of u32 values,
    0xFFFFFFFF for none; is_fwd bool; nmm int32, 0 unless aligned; aligned
    bool), on the tensors' device."""
    R, Lb = codes.shape
    dev = codes.device
    G = genome.shape[0]
    lens64 = lens.long()
    starts, oks, mats = candidates(codes, lens, rh, G, hash_bits)
    pos = torch.arange(Lb, device=dev)
    valid = pos[None, :] < lens64[:, None]
    best_nmm = torch.full((R,), NO_MATCH, dtype=torch.int64, device=dev)
    best_gpos = torch.full((R,), NO_GPOS, dtype=torch.int64, device=dev)
    best_fwd = torch.ones(R, dtype=torch.bool, device=dev)
    for c in range(2 * NUM_SEEDS):
        start, ok = starts[:, c], oks[:, c]
        mat = mats[c // NUM_SEEDS]
        gi = (torch.where(ok, start, 0)[:, None] + pos[None, :]).clamp(
            max=max(G - 1, 0))
        gwin = genome[gi] if G else torch.zeros_like(mat)
        mm = ((gwin != mat) & valid).sum(1)
        mm = torch.where(ok, mm, NO_MATCH)
        better = mm < best_nmm
        best_nmm = torch.where(better, mm, best_nmm)
        best_gpos = torch.where(better, start, best_gpos)
        best_fwd = torch.where(better, c < NUM_SEEDS, best_fwd)
    aligned = (best_nmm <= torch.div(lens64, 2, rounding_mode="floor")) & \
        (best_gpos != NO_GPOS)
    nmm = torch.where(aligned, best_nmm, 0).to(torch.int32)
    return best_gpos, best_fwd, nmm, aligned
