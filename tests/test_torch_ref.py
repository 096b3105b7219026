"""genozip_tpu_torch's reference store and aligner against genozip_tpu's:
the same `.ref.gxz` bytes, refhash, FASTA parse, cache, alignments (gpos,
strand, mismatches, junctions, with and without a pair hint) and rebuilt
reads, on inputs made from a numpy seed. genozip_tpu writes on its numpy
host path (`genozip_tpu.native.available` patched to False), as the port
does everywhere. The cache eviction unlinks only the port's own caches
(fault F4 of the reference is not carried over)."""

import os
import time

import numpy as np
import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import native as ref_native
from genozip_tpu.ref import aligner as ref_al, refstore as ref_rs
from genozip_tpu_torch import codecs, synth
from genozip_tpu_torch.ops import pack as packops
from genozip_tpu_torch.ref import aligner as al, refstore as rs


def _fasta(seed=3, n=120000):
    """Two contigs of a repeat-family genome, one soft-masked run and a few
    IUPAC bases, in 70-column lines."""
    g = synth.genome(np.random.default_rng(seed), n).copy()
    g[5000:5400] += 32                       # lowercase: soft-masked
    g[[100, n // 13, n * 3 // 4]] = np.frombuffer(b"NRN", np.uint8)
    parts = []
    for i, seq in enumerate((g[:n // 3], g[n // 3:])):
        rows = [seq[j:j + 70].tobytes() for j in range(0, seq.shape[0], 70)]
        parts.append(b">ctg%d test\n" % i + b"\n".join(rows) + b"\n")
    return b"".join(parts)


@pytest.fixture(scope="module")
def genome():
    fa = _fasta()
    return fa, rs.fasta_to_genome(fa), ref_rs.fasta_to_genome(fa)


def test_make_reference_bytes_equal(tmp_path, monkeypatch):
    """The .ref.gxz of make_reference (default 2^24-slot refhash) equals
    genozip_tpu's."""
    fa = tmp_path / "g.fa"
    fa.write_bytes(_fasta(seed=4))
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    rs.make_reference(str(fa), str(tmp_path / "port.ref.gxz"))
    ref_rs.make_reference(str(fa), str(tmp_path / "jax.ref.gxz"))
    assert (tmp_path / "port.ref.gxz").read_bytes() == \
        (tmp_path / "jax.ref.gxz").read_bytes()


def test_ref_file_bytes_equal_through_the_kernel_route(tmp_path, monkeypatch):
    """The same bytes when the genome and refhash sections go through the
    rANS kernels' plain version (a 2^16-slot refhash keeps it small)."""
    monkeypatch.setattr(ref_native, "available", lambda: False)
    fa = _fasta(seed=5)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        rs.write_ref_file(rs.fasta_to_genome(fa, 16),
                          str(tmp_path / "port.ref.gxz"))
    finally:
        codecs.disable_device_rans()
    ref_rs.write_ref_file(ref_rs.fasta_to_genome(fa, 16),
                          str(tmp_path / "jax.ref.gxz"))
    assert (tmp_path / "port.ref.gxz").read_bytes() == \
        (tmp_path / "jax.ref.gxz").read_bytes()


def test_fasta_to_genome_equals(genome):
    fa, port, jax = genome
    assert np.array_equal(port.codes, jax.codes)
    assert port.contigs == jax.contigs
    assert np.array_equal(port.iupac_pos, jax.iupac_pos)
    assert np.array_equal(port.iupac_chars, jax.iupac_chars)
    assert np.array_equal(port.refhash, jax.refhash)


@pytest.mark.parametrize("bits", [10, 14, 18])
@pytest.mark.parametrize("layers", [1, 2])
def test_build_refhash_equals(genome, bits, layers):
    """Small tables force slot collisions, so both layers' keep-the-smallest
    rules are exercised."""
    codes = genome[1].codes
    got = rs.build_refhash(codes, bits, layers=layers)
    assert np.array_equal(got, ref_rs.build_refhash(codes, bits,
                                                   layers=layers))


def test_hash_kmer_wraps_like_u32():
    km = np.array([0, 1, 0xFFFFFFFF, 0x9E3779B9, 123456789], np.uint32)
    for bits in (8, 24, 31):
        assert np.array_equal(rs.hash_kmer(km, bits),
                              ref_rs.hash_kmer(km, bits))


def _reads(ref, seed, n=400, L=120):
    """Reads off `ref`: substitutions, reverse strands, N bases, spliced
    reads (60 + gap + 60), unalignable random reads and short reads."""
    rng = np.random.default_rng(seed)
    G = ref.length
    rows, lens = [], []
    for i in range(n):
        p = int(rng.integers(0, G - 30000))
        kind = i % 5
        if kind == 0:                                    # spliced
            gap = int(rng.integers(200, 20000))
            c = np.concatenate([ref.codes[p:p + 60],
                                ref.codes[p + gap + 60:p + gap + L]])
        elif kind == 1:                                  # unalignable
            c = rng.integers(0, 4, L).astype(np.uint8)
        else:
            ln = L if kind != 2 else int(rng.integers(20, L))
            c = ref.codes[p:p + ln].copy()
            k = rng.binomial(ln, 0.02)
            c[rng.integers(0, ln, k)] = rng.integers(0, 4, k)
        seq = packops.ACGT[c]
        if rng.random() < 0.5:
            seq = packops.ACGT[(c ^ 3)[::-1]]
        if rng.random() < 0.1:
            seq = seq.copy()
            seq[rng.integers(0, seq.shape[0])] = ord("N")
        rows.append(seq)
        lens.append(seq.shape[0])
    lens = np.array(lens, np.int64)
    seq_mat = np.zeros((n, int(lens.max())), np.uint8)
    for i, s in enumerate(rows):
        seq_mat[i, :s.shape[0]] = s
    return seq_mat, lens


@pytest.mark.parametrize("splice", [False, True])
@pytest.mark.parametrize("hint", ["none", "pair"])
def test_align_batch_equals(genome, splice, hint):
    """Candidates, scores and tie-breaks match: every output array is
    equal, and so are the mismatch lists and the rebuilt reads."""
    _, port, jax = genome
    seq_mat, lens = _reads(port, seed=11 + splice)
    codes = packops.BASE2BIT[seq_mat]
    pair = None
    if hint == "pair":
        # R1 placements near (or, for every third read, far from) the read
        base = al.align_batch(port, codes, lens)["gpos"]
        rng = np.random.default_rng(5)
        pair = base + rng.integers(-350, 350, base.shape[0])
        pair[::3] += 100000
        pair[::7] = -1
    got = al.align_batch(port, codes, lens, pair_gpos=pair, splice=splice)
    want = ref_al.align_batch(jax, codes, lens, pair_gpos=pair, splice=splice)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert got["aligned"].mean() > 0.5
    if splice:
        assert (got["aligned"] & (got["junction"] < lens)).any()
    args = (seq_mat, codes, lens, got["gpos"], got["is_fwd"], got["aligned"],
            got["gpos2"], got["junction"])
    mm = al.mismatch_lists(port, *args)
    for a, b in zip(mm, ref_al.mismatch_lists(jax, *args)):
        assert np.array_equal(a, b)
    a = got["aligned"]
    ridx = np.repeat(np.arange(int(a.sum())),
                     np.bincount(mm[0], minlength=lens.shape[0])[a])
    rec = (got["gpos"][a], lens[a], got["is_fwd"][a], ridx, mm[1], mm[2],
           got["gpos2"][a], got["junction"][a])
    rebuilt = al.reconstruct_batch(port, *rec)
    assert np.array_equal(rebuilt, ref_al.reconstruct_batch(jax, *rec))
    # the rebuilt reads are the input reads
    assert np.array_equal(rebuilt, np.where(
        np.arange(rebuilt.shape[1])[None, :] < lens[a][:, None],
        seq_mat[a][:, :rebuilt.shape[1]], 0))


@pytest.mark.parametrize("cache", [False, True])
def test_load_ref_file_equals(tmp_path, monkeypatch, cache):
    """The port loads genozip_tpu's .ref.gxz (and its sidecar cache) to
    the same genome."""
    monkeypatch.delenv("GXZ_NO_REF_CACHE", raising=False)
    fa = tmp_path / "g.fa"
    fa.write_bytes(_fasta(seed=6, n=60000))
    ref_codecs.disable_device_rans()
    path = str(tmp_path / "g.ref.gxz")
    ref_rs.make_reference(str(fa), path)
    want = ref_rs.load_ref_file(path, cache=False)
    for _ in range(2 if cache else 1):     # first load writes the cache
        got = rs.load_ref_file(path, cache=cache)
        for k in ("codes", "refhash", "iupac_pos", "iupac_chars"):
            assert np.array_equal(getattr(got, k), getattr(want, k)), k
        assert got.contigs == want.contigs
        assert got.hash_bits == want.hash_bits
    assert os.path.exists(path + ".cache") == cache


def test_cache_eviction_spares_unrelated_files(tmp_path, monkeypatch):
    """Fault F4 of the reference: its TTL eviction unlinks every old
    `*.cache` file in the reference's directory. The port unlinks only its
    own stale `<name>.ref.gxz.cache` files."""
    monkeypatch.delenv("GXZ_NO_REF_CACHE", raising=False)
    monkeypatch.setenv("GXZ_REF_CACHE_TTL_H", "1")
    fa = tmp_path / "g.fa"
    fa.write_bytes(_fasta(seed=7, n=40000))
    path = str(tmp_path / "g.ref.gxz")
    rs.make_reference(str(fa), path)
    old = time.time() - 7200
    files = {
        "x.cache": b"an unrelated cache file",             # not ours
        "fake.ref.gxz.cache": b"no magic in this one",       # not ours
        "other.ref.cache": rs._CACHE_MAGIC + b"wrong name",  # not ours
        "stale.ref.gxz.cache": rs._CACHE_MAGIC + b"\0" * 8,  # ours, stale
    }
    for name, body in files.items():
        p = tmp_path / name
        p.write_bytes(body)
        os.utime(p, (old, old))
    fresh = tmp_path / "fresh.ref.gxz.cache"
    fresh.write_bytes(rs._CACHE_MAGIC)
    rs.load_ref_file(path)
    left = set(os.listdir(tmp_path))
    assert {"x.cache", "fake.ref.gxz.cache", "other.ref.cache",
            "fresh.ref.gxz.cache", "g.ref.gxz.cache"} <= left
    assert "stale.ref.gxz.cache" not in left


def test_corrupt_cache_is_rebuilt(tmp_path, monkeypatch):
    monkeypatch.delenv("GXZ_NO_REF_CACHE", raising=False)
    fa = tmp_path / "g.fa"
    fa.write_bytes(_fasta(seed=8, n=40000))
    path = str(tmp_path / "g.ref.gxz")
    ref = rs.make_reference(str(fa), path)
    (tmp_path / "g.ref.gxz.cache").write_bytes(b"garbage" * 10)
    got = rs.load_ref_file(path)
    assert np.array_equal(got.codes, ref.codes)
    assert (tmp_path / "g.ref.gxz.cache").read_bytes()[:8] == rs._CACHE_MAGIC


def test_used_ranges_equal():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, 100000).astype(np.uint8)
    port = rs.RefGenome(codes, [{"name": "c", "gpos": 0, "length": 100000}])
    jax = ref_rs.RefGenome(codes, [{"name": "c", "gpos": 0, "length": 100000}])
    port.start_tracking()
    jax.track_used = True
    for _ in range(3):
        s = rng.integers(0, 99000, 40)
        ln = rng.integers(1, 9000, 40)
        port.mark_used(s, ln)
        jax.mark_used(s, ln)
    assert port.used_ranges() == jax.used_ranges()
    assert port.used_ranges()
