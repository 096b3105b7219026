"""The seed aligner kernel (csrc/seed_align.cu) and its plain version
(ops/align_torch.py). The module imports nothing of the JAX package, so
that the test on the card also runs where JAX is not installed; the tests
that hold the plain version to genozip_tpu's MeshAligner(n_devices=1) import
it inside (tests/test_torch_parallel.py holds it to the sharded aligner
too). Here the plain version is held to a per-read Python reading of the
same rules, numpy models of the kernel's word compare and of its winner
reduction to the byte compare and the sequential rule, and the kernel to
the plain version on the card (tolerance: exact, integer outputs)."""

import numpy as np
import pytest
import torch

from genozip_tpu_torch import synth
from genozip_tpu_torch.ops import align_cuda, align_torch
from genozip_tpu_torch.ref import refstore
from tests.torch_seed_reads import edge_batch as batch, spread

FIB32 = 2654435761


# the cfg4 genome's length is 7 past a multiple of 16; so is GENOME_ODD's
GENOME_ODD = 200_007


def _genome_fasta(n):
    g = synth.genome(np.random.default_rng(8), n)
    return b">c\n" + g.tobytes() + b"\n"


@pytest.fixture(scope="module")
def ref():
    return refstore.fasta_to_genome(_genome_fasta(200_000), hash_bits=18)


@pytest.fixture(scope="module")
def ref_odd():
    return refstore.fasta_to_genome(_genome_fasta(GENOME_ODD), hash_bits=18)


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


def _follows_the_rules(ref):
    codes, lens, tie, p1 = batch(ref, np.random.default_rng(1))
    gpos, fwd, nmm, aligned = align_cuda.seed_align(
        *tensors(ref, codes, lens), ref.hash_bits)
    for r in range(len(lens)):
        assert (int(gpos[r]), bool(fwd[r]), int(nmm[r]), bool(aligned[r])) \
            == one_read(ref, codes[r], int(lens[r])), r
    assert aligned[6:].float().mean() > 0.9
    assert int(gpos[tie]) == p1 and bool(fwd[tie]) and bool(aligned[tie])
    assert int(gpos[-2]) == 0 and int(gpos[48]) == ref.length - 150


def test_plain_version_follows_the_rules(ref):
    _follows_the_rules(ref)


def test_plain_version_follows_the_rules_odd_genome(ref_odd):
    """The same on a genome whose length is not a multiple of 16."""
    _follows_the_rules(ref_odd)


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


@pytest.mark.parametrize("Lb", [128, 130, 256, 1024])
def test_plain_version_equals_mesh_aligner(ref_odd, Lb):
    """On a genome whose length is not a multiple of 16, the edge reads of
    `batch` (the genome's last bases, position 0, a tie, Lb up to 1024 and
    130, not a multiple of 4)
    through the port's MeshAligner (the plain version on the CPU) equal
    genozip_tpu's MeshAligner(n_devices=1), JAX on the CPU."""
    pytest.importorskip("jax")
    from genozip_tpu.parallel import mesh_aligner as ref_mesh
    from genozip_tpu.ref import refstore as ref_refstore
    from genozip_tpu_torch.parallel.mesh_aligner import MeshAligner
    jref = ref_refstore.fasta_to_genome(_genome_fasta(GENOME_ODD),
                                        hash_bits=18)
    assert jref.length == ref_odd.length == GENOME_ODD
    codes, lens, tie, p1 = batch(ref_odd, np.random.default_rng(Lb), Lb)
    want = ref_mesh.MeshAligner(jref, n_devices=1).align_batch(
        jref, codes, lens)
    got = MeshAligner(ref_odd, devices=["cpu"]).align_batch(
        ref_odd, codes, lens)
    for k in ("aligned", "gpos", "is_fwd", "nmm"):
        assert np.array_equal(got[k], want[k]), k
    assert got["gpos"][tie] == p1 and got["is_fwd"][tie]
    assert got["aligned"][-7:].all()


def test_winner_key_equals_sequential_rule():
    """The kernel's winner, the minimum of (count << 3) | c over usable
    candidates, is the sequential rule's: the first strictly smaller count
    (ties to the lowest index), none when no candidate is usable."""
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 6, (5000, 8))      # small: many ties
    usable = rng.random((5000, 8)) < 0.6
    for cnt, ok in zip(counts, usable):
        best, first = 1 << 30, None
        for c in range(8):
            if ok[c] and cnt[c] < best:
                best, first = cnt[c], c
        keys = [(int(cnt[c]) << 3) | c for c in range(8) if ok[c]]
        key = min(keys) if keys else None
        assert (None if key is None else (key >> 3, key & 7)) == \
            (None if first is None else (best, first))


def _word_count(genome, s, row, span):
    """The kernel's mismatch count of the window at s over row[:span]
    (csrc/seed_align.cu load_tile and count_tile): tiles of 248 bases in
    two halves of 31 words, lane l loading words w0 + P/4 + l and + 31 when
    they lie before the window's end and the genome's last whole word (else
    the genome's partial last word), the next lane's word by shuffle, a
    funnel shift by the start's byte offset, and the unequal bytes counted
    under a mask of the first span - q bytes (none for lane 31)."""
    G = genome.shape[0]
    whole = G // 4
    tail = int.from_bytes(bytes(genome[4 * whole:]), "little")
    lim = min((s + span + 3) >> 2, whole)

    def word(w):
        return int.from_bytes(bytes(genome[4 * w:4 * w + 4]), "little") \
            if w < lim else tail
    rw = np.zeros(-(-max(len(row), 1) // 248) * 248 + 8, np.uint8)
    rw[:len(row)] = row
    o, total, P = 8 * (s & 3), 0, 0
    while P == 0 or P < span:
        base = (s >> 2) + P // 4
        for half in (0, 31):
            w = [word(base + half + lane) for lane in range(32)]
            for lane in range(31):
                g4 = ((w[lane + 1] << 32 | w[lane]) >> o) & 0xFFFFFFFF
                q = P + 4 * lane + 4 * half
                r4 = int.from_bytes(bytes(rw[q:q + 4]), "little")
                nb = min(max(span - q, 0), 4)
                total += sum(((g4 >> 8 * k) & 0xFF) != ((r4 >> 8 * k) & 0xFF)
                             for k in range(nb))
        P += 248
    return total


@pytest.mark.parametrize("Lb", [128, 256])
def test_reverse_row_words_model_equals_bytes(Lb):
    """The kernel's reverse-complement row built a word at a time (reads
    of 16 to Lb bases: a funnel shift of two row words, reversed, xor 3)
    equals the byte rule row[clip(len-1-q, 0, Lb-1)] ^ 3 at every q < len."""
    rng = np.random.default_rng(Lb)
    for n in list(range(16, 40)) + [Lb - 1, Lb]:
        fwd = np.zeros(Lb + 8, np.uint8)
        fwd[:n] = rng.integers(0, 8, n)
        fw = fwd.view("<u4")
        rev = np.zeros(Lb + 8, np.uint8)
        rw = rev.view("<u4")
        for q in range(0, n, 4):
            e = n - 4 - q
            a = e >> 2
            src = ((int(fw[a + 1]) << 32 | int(fw[max(a, 0)])) >>
                   (8 * (e & 3))) & 0xFFFFFFFF
            rw[q >> 2] = int.from_bytes(src.to_bytes(4, "little")[::-1],
                                        "little") ^ 0x03030303
        want = fwd[np.clip(n - 1 - np.arange(n), 0, Lb - 1)] ^ 3
        assert np.array_equal(rev[:n], want), n


@pytest.mark.parametrize("span", [1, 15, 16, 150, 247, 248, 249, 700])
def test_word_compare_model_equals_byte_count(span):
    """The word compare counts what a byte compare counts, at every start
    offset, across tiles, and at the end of a genome whose length is not a
    multiple of 4 (its last, partial word read byte by byte)."""
    rng = np.random.default_rng(span)
    G = 4003
    genome = rng.integers(0, 5, G).astype(np.uint8)
    for s in (0, 1, 2, 3, 17, 1001, G - span - 1, G - span):
        row = genome[s:s + span].copy()
        row[rng.integers(0, span, 1 + span // 10)] = rng.integers(0, 8)
        assert _word_count(genome, s, row, span) == \
            int((genome[s:s + span] != row).sum()), s


# rows of a spread batch: over twice the warps resident on an H100 (3,168
# at Lb <= 1024), so each warp's stride crosses reads of other lengths
SPREAD_ROWS = 8192


@pytest.mark.cuda
def test_seed_align_kernel_equals_plain(ref, ref_odd):
    """The kernel equals its plain version on the card at the edge reads
    (the genome's last bases on a genome whose length is not a multiple of
    16, position 0, a tie) and at 150 bp reads, at Lb up to 1024, each
    batch alone and spread over SPREAD_ROWS rows (reads of every length
    following one another within a warp's stride); with Lb = 130 (rows not
    a multiple of 4 bytes) and with codes one byte past an aligned address
    (both read byte by byte); and counts one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(5)
    for ref, Lb, how in ((ref, 128, "alone"), (ref, 256, "alone"),
                         (ref_odd, 256, "alone"), (ref_odd, 1024, "alone"),
                         (ref, 256, "spread"), (ref_odd, 1024, "spread"),
                         (ref_odd, 130, "spread"), (ref_odd, 256, "offset")):
        codes, lens, tie, p1 = batch(ref, rng, Lb)
        src = np.arange(len(lens))
        if how != "alone":
            codes, lens, src = spread(codes, lens, rng, SPREAD_ROWS)
        args = list(tensors(ref, codes, lens, "cuda"))
        if how == "offset":
            buf = torch.empty(codes.size + 1, dtype=torch.uint8,
                              device="cuda")
            args[0] = buf[1:].view(codes.shape)
            args[0].copy_(torch.from_numpy(codes))
            assert args[0].data_ptr() % 4
        before = align_cuda.launches["seed_align"]
        k = align_cuda.seed_align(*args, ref.hash_bits)
        p = align_torch.seed_align_plain(*args, ref.hash_bits)
        torch.cuda.synchronize()
        assert align_cuda.launches["seed_align"] == before + 1
        for a, b in zip(k, p):
            assert torch.equal(a, b), (Lb, how)
        ties = torch.from_numpy(np.nonzero(src == tie)[0]).cuda()
        assert (k[0][ties] == p1).all() and k[1][ties].all(), (Lb, how)
