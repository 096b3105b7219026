"""The seed aligner kernel (csrc/seed_align.cu) and its plain version
(ops/align_torch.py), with no import of the JAX package, so that the test on
the card also runs where JAX is not installed. The plain version is held to
genozip_tpu's sharded aligner in tests/test_torch_parallel.py; here it is
held to a per-read Python reading of the same rules, and the kernel to the
plain version on the card (tolerance: exact, integer outputs)."""

import numpy as np
import pytest
import torch

from genozip_tpu_torch import synth
from genozip_tpu_torch.ops import align_cuda, align_torch
from genozip_tpu_torch.ref import refstore

FIB32 = 2654435761


@pytest.fixture(scope="module")
def ref():
    g = synth.genome(np.random.default_rng(8), 200_000)
    return refstore.fasta_to_genome(
        b">c\n" + g.tobytes() + b"\n", hash_bits=18)


def batch(ref, rng, Lb=256):
    """Edge reads (lengths 1, 15, 16, 17, Lb - 1, Lb), both strands, with
    substitutions and codes above 3, and reads of 150 bp (100 when Lb is
    128), padded to Lb."""
    rows, lens = [], []
    for L in (1, 15, 16, 17, Lb - 1, Lb) + (min(150, Lb - 28),) * 42:
        p = int(rng.integers(0, ref.length - L))
        c = np.array(ref.codes[p:p + L], np.uint8)
        if rng.random() < 0.5:
            c = (c ^ 3)[::-1]
        if L > 20:
            c[rng.integers(0, L, 3)] = rng.integers(0, 8, 3)
        row = np.zeros(Lb, np.uint8)
        row[:L] = c
        rows.append(row)
        lens.append(L)
    return np.stack(rows), np.asarray(lens, np.int32)


def tensors(ref, codes, lens, dev="cpu"):
    rh = np.array(ref.refhash[:1 << ref.hash_bits], np.uint32).view(np.int32)
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev),
            torch.from_numpy(np.array(ref.codes, np.uint8)).to(dev),
            torch.from_numpy(rh).to(dev))


def one_read(ref, row, n):
    """The rules for one read, in Python integers."""
    Lb, G = row.shape[0], ref.length
    rh = ref.refhash
    best = (1 << 30, 0xFFFFFFFF, True)
    for fwd in (True, False):
        def base(p):
            return int(row[p]) if fwd else \
                int(row[min(max(n - 1 - p, 0), Lb - 1)]) ^ 3
        for si in range(4):
            off = min(max((n - 16) * si // 3, 0), max(n - 16, 0))
            km = 0
            for j in range(16):
                km = ((km << 2) | base(min(max(off + j, 0), Lb - 1))) \
                    & 0xFFFFFFFF
            g = int(rh[((km * FIB32) & 0xFFFFFFFF) >> (32 - ref.hash_bits)])
            start = (g - off) & 0xFFFFFFFF
            if g == 0xFFFFFFFF or off > g or n > G or \
                    start > ((G - n) & 0xFFFFFFFF):
                continue
            mm = sum(int(ref.codes[start + p]) != base(p)
                     for p in range(min(n, Lb)))
            if mm < best[0]:
                best = (mm, start, fwd)
    aligned = best[0] <= n // 2 and best[1] != 0xFFFFFFFF
    return best[1], best[2], best[0] if aligned else 0, aligned


def test_plain_version_follows_the_rules(ref):
    codes, lens = batch(ref, np.random.default_rng(1))
    gpos, fwd, nmm, aligned = align_cuda.seed_align(
        *tensors(ref, codes, lens), ref.hash_bits)
    for r in range(len(lens)):
        assert (int(gpos[r]), bool(fwd[r]), int(nmm[r]), bool(aligned[r])) \
            == one_read(ref, codes[r], int(lens[r])), r
    assert aligned[6:].float().mean() > 0.9


def test_plain_version_places_reads(ref):
    """Error-free 150 bp reads come back at their positions."""
    rng = np.random.default_rng(2)
    pos = rng.integers(0, ref.length - 150, 64)
    codes = np.zeros((64, 256), np.uint8)
    for i, p in enumerate(pos):
        codes[i, :150] = ref.codes[p:p + 150]
    lens = np.full(64, 150, np.int32)
    gpos, fwd, nmm, aligned = align_torch.seed_align_plain(
        *tensors(ref, codes, lens), ref.hash_bits)
    ok = aligned.numpy() & (nmm.numpy() == 0)
    assert ok.mean() > 0.9
    assert (gpos.numpy()[ok] == pos[ok]).all() and fwd.numpy()[ok].all()


@pytest.mark.cuda
def test_seed_align_kernel_equals_plain(ref):
    """The kernel equals its plain version on the card at the edge reads
    and at 150 bp reads, and counts one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(5)
    for Lb in (128, 256):
        codes, lens = batch(ref, rng, Lb)
        args = tensors(ref, codes, lens, "cuda")
        before = align_cuda.launches["seed_align"]
        k = align_cuda.seed_align(*args, ref.hash_bits)
        p = align_torch.seed_align_plain(*args, ref.hash_bits)
        torch.cuda.synchronize()
        assert align_cuda.launches["seed_align"] == before + 1
        for a, b in zip(k, p):
            assert torch.equal(a, b)
