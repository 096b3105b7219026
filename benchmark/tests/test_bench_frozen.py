"""The benchmark's generators make what their configurations state, and its
frozen copies give the numbers of the port's originals."""

import gzip
import hashlib
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from benchmark import roofline
from benchmark.gen import bam, fastq, genome
from benchmark.ref import rans_np as ref_rans

SEEDS = (2024, 2**31 + 977)


def _write(gen: str, path, seed: int, **params) -> int:
    """Make an input as the harness does: in a process of its own."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-m", "benchmark.gen", gen,
                          str(path), str(seed), json.dumps(params)],
                         cwd=root, check=True, capture_output=True,
                         text=True)
    return int(out.stdout)


def _digest(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("seed", SEEDS)
def test_fastq_is_made_from_the_seed(tmp_path, seed):
    a, b, c = (tmp_path / f"{x}.fastq" for x in "abc")
    n = _write("fastq", a, seed, nbytes=300_000, block=500)
    assert n >= 300_000 and n == a.stat().st_size
    _write("fastq", b, seed, nbytes=300_000, block=500)
    _write("fastq", c, seed + 1, nbytes=300_000, block=500)
    assert _digest(a) == _digest(b) != _digest(c)
    lines = a.read_bytes().split(b"\n")[:-1]
    assert len(lines) % 4 == 0
    seqs = lines[1::4]
    assert all(len(s) == 150 and set(s) <= set(b"ACGT") for s in seqs)
    assert all(x == b"+" for x in lines[2::4])
    # reads off 3.1 Gbp at well under 1x: no two share their first 32 bases
    assert len({s[:32] for s in seqs}) == len(seqs)


def test_genome_is_one_sequence_and_the_donor_differs_at_its_sites():
    g = genome.Genome(2**31 + 977)
    starts = np.random.default_rng(3).integers(0, genome.TOTAL - 300, 4000)
    a, b = g.reads(starts, 150), g.reads(starts + 70, 150)
    assert (a[:, 70:] == b[:, :80]).all()       # overlapping reads agree
    h0 = g.reads(starts, 150, np.zeros((4000, 1), int))
    h1 = g.reads(starts, 150, np.ones((4000, 1), int))
    for h in (h0, h1):
        assert 0.0002 < (h != a).mean() < 0.002  # ~2 sites in 3 per 1024
    assert (h0 != h1).mean() < (h0 != a).mean() + (h1 != a).mean()
    # 3 Mbp read end to end: all four bases, and homopolymer runs beyond
    # what i.i.d. bases give (about 2.9 runs of 5 or more a kbp)
    tile = g.reads(np.arange(10**6, 10**6 + 3 * 10**6, 150), 150).reshape(-1)
    assert set(np.unique(tile).tobytes()) == set(b"ACGT")
    runs = np.diff(np.flatnonzero(np.diff(tile.view(np.int8)) != 0))
    assert (runs >= 5).sum() > 3000 * 3        # background plus homopolymers


def _records(raw: bytes):
    """(refid, pos, flag) of each BAM record after the header."""
    l_text = struct.unpack_from("<i", raw, 4)[0]
    at = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, at)[0]
    at += 4
    for _ in range(n_ref):
        at += 4 + struct.unpack_from("<i", raw, at)[0] + 4
    out = []
    while at < len(raw):
        size, refid, pos = struct.unpack_from("<iii", raw, at)
        flag = struct.unpack_from("<H", raw, at + 18)[0]
        out.append((refid, pos, flag))
        at += 4 + size
    assert at == len(raw)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_bam_is_a_sorted_slice_at_its_depth(tmp_path, seed):
    a, b = tmp_path / "a.bam", tmp_path / "b.bam"
    n = _write("bam", a, seed, nbytes=400_000, window_reads=3000)
    assert n >= 400_000
    _write("bam", b, seed, nbytes=400_000, window_reads=3000)
    assert _digest(a) == _digest(b)
    data = a.read_bytes()
    raw = gzip.decompress(data)
    assert raw[:4] == b"BAM\x01" and data.endswith(bam.EOF_BLOCK)
    assert raw.count(b"@SQ\tSN:") == len(genome.CONTIGS)
    recs = _records(raw)
    prim = [p for r, p, f in recs if not f & 0x900]
    assert {r for r, _, _ in recs} == {0}
    assert prim == sorted(prim)
    depth = len(prim) * 150 / (prim[-1] - prim[0] + 150)
    assert 27 < depth < 33
    assert prim[0] >= bam.region_start(seed)


def test_bgzf_blocks_hold_whole_records():
    ends = np.cumsum([300] * 1000 + [70000] + [300] * 10)
    data = bytes(range(256)) * (int(ends[-1]) // 256 + 1)
    data = data[:int(ends[-1])]
    blocks, at = [], 0
    out = bam.bgzf(data, ends)
    while at < len(out):
        bsize = struct.unpack_from("<H", out, at + 16)[0] + 1
        isize = struct.unpack_from("<I", out, at + bsize - 4)[0]
        blocks.append(isize)
        at += bsize
    assert sum(blocks) == len(data) and gzip.decompress(out) == data
    assert max(blocks) <= bam.BLOCK
    cuts = np.cumsum(blocks)
    inside = cuts[(cuts > 300 * 1000) & (cuts < 300 * 1000 + 70000)]
    assert set(cuts) - set(inside) <= set(ends.tolist())


def test_qual_bins_equal_the_argmin():
    rng = np.random.default_rng(5)
    noise = rng.normal(0, 3.0, (2000, 150))
    noise[0, :4] = [7.0 - 36.0, 17.5 - 36.0, 30.0 - 36.0, 0.0]   # ties
    rl = noise.shape[1]
    pos = np.arange(rl)
    q = 36.0 - 8.0 * (pos / rl) ** 2 - 2.0 * (pos < 3) + noise
    bins = np.array([2, 12, 23, 37])
    want = (bins[np.abs(q[:, :, None] - bins).argmin(axis=2)] + 33)
    assert (fastq.qual_bins(noise) == want.astype(np.uint8)).all()


@pytest.mark.parametrize("order", (0, 1))
def test_reference_rans_equals_the_port(order):
    from genozip_tpu_torch import native
    from genozip_tpu_torch.ops import rans_np as port
    rng = np.random.default_rng(order)
    for n in (0, 1, 17, 4096, 300_001):
        data = rng.choice(np.frombuffer(b"ACGT#F", np.uint8), n).tobytes()
        s = port.encode(data, order)
        assert ref_rans.encode(data, order) == s
        assert ref_rans.decode(s) == data
        assert ref_rans.decode(native.rans_encode(data, order)) == data


def test_roofline_equals_chip_smoke():
    import chip_smoke
    datas, bufs = [b"x" * 1000, b"y" * 5000], [b"z" * 300, b"w" * 700]
    for order in (0, 1):
        tab = roofline.tab_bytes(order, len(datas))
        nb = chip_smoke.stream_bytes(datas, bufs, tab)
        assert nb == roofline.stream_bytes(6000, 1000, tab)
        ms, _ = chip_smoke.bound_ms(nb, 6000 * chip_smoke.OPS_PER_SYMBOL)
        assert roofline.call_bound_s(order, 2, 6000, 1000) == \
            pytest.approx(ms / 1e3, rel=1e-12)
    for big in ((10**9, 1), (1, 10**12)):
        assert roofline.bound_s(*big) == pytest.approx(
            chip_smoke.bound_ms(*big)[0] / 1e3, rel=1e-12)
    assert (roofline.HBM_BPS, roofline.INT_OPS, roofline.OPS_PER_SYMBOL) == \
        (chip_smoke.HBM_BPS, chip_smoke.INT_OPS, chip_smoke.OPS_PER_SYMBOL)


def test_tab_bytes_are_the_kernels_tables():
    from genozip_tpu_torch.ops import rans_torch
    datas = [b"ACGT" * 300, b"GATTACA" * 100]
    for order in (0, 1):
        b = rans_torch.prepare_encode(datas, order)
        assert b.tab.numel() * 4 == roofline.tab_bytes(order, len(datas))
