"""genozip_tpu_torch's own copies of genozip_tpu's host modules against the
originals, on inputs made from numpy seeds: ops/rans_np (the stream spec),
ops/arith_np, utils/ragged, txtfile with the gz-family readers of
utils/bgzf, utils/profiler and utils/progress. Every comparison is exact.
The copies keep only the numpy/zlib path; genozip_tpu is run both on its
numpy host path (`genozip_tpu.native.available` patched to False) and, where
its C++ host runtime loads, on that."""

import bz2
import gzip
import lzma
import zlib

import numpy as np
import pytest

from genozip_tpu import native as ref_native
from genozip_tpu import txtfile as ref_txtfile
from genozip_tpu.ops import arith_np as ref_arith, rans_np as ref_rans
from genozip_tpu.utils import profiler as ref_profiler, ragged as ref_ragged
from genozip_tpu.utils import bgzf as ref_bgzf
from genozip_tpu_torch import txtfile
from genozip_tpu_torch.ops import arith_np, rans_np
from genozip_tpu_torch.utils import bgzf, profiler, progress, ragged

QUALS = np.frombuffer(b"FFFF:F,#ABx", np.uint8)


@pytest.fixture(params=["numpy", "native"])
def ref_host(request, monkeypatch):
    """genozip_tpu's host path: numpy, or its C++ runtime as it loads."""
    if request.param == "numpy":
        monkeypatch.setattr(ref_native, "available", lambda: False)
    return request.param


def _payloads(seed):
    rng = np.random.default_rng(seed)
    return [b"", b"A", rng.choice(QUALS, 777).tobytes(),
            rng.choice(QUALS, 40000).tobytes(), b"\x05" * 3000,
            rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()]


# --- ops/rans_np, ops/arith_np ----------------------------------------------

@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n_lanes", [None, 16, 256])
def test_rans_np_equals(order, n_lanes):
    for d in _payloads(order * 7 + (n_lanes or 1)):
        buf = rans_np.encode(d, order, n_lanes=n_lanes)
        assert buf == ref_rans.encode(d, order, n_lanes=n_lanes)
        assert rans_np.decode(buf) == ref_rans.decode(buf) == d


def test_rans_np_tables_equal():
    rng = np.random.default_rng(3)
    for n in (0, 1, 255, 256, 70000, 1 << 20, 1 << 24, 1 << 30):
        assert rans_np.choose_num_lanes(n) == ref_rans.choose_num_lanes(n)
    for k in range(20):
        hist = rng.integers(0, 1000, 256) * (rng.random(256) < k / 20)
        f = rans_np.normalize_freqs(hist)
        assert np.array_equal(f, ref_rans.normalize_freqs(hist))
        ser = rans_np._freqs_serialize(f)
        assert ser == ref_rans._freqs_serialize(f)
        got, off = rans_np._freqs_deserialize(memoryview(ser), 0)
        want, woff = ref_rans._freqs_deserialize(memoryview(ser), 0)
        assert np.array_equal(got, want) and off == woff == len(ser)


@pytest.mark.parametrize("order", [0, 1])
def test_arith_np_equals(order):
    for d in _payloads(11 + order):
        buf = arith_np.encode(d, order=order)
        assert buf == ref_arith.encode(d, order=order)
        assert arith_np.decode(buf) == ref_arith.decode(buf) == d


# --- utils/ragged ------------------------------------------------------------

def _col(mod, rng, n, maxw=12):
    lens = rng.integers(0, maxw, n)
    data = rng.integers(32, 127, int(lens.sum()), dtype=np.uint8)
    return mod.Col(data, np.concatenate([[0], np.cumsum(lens)]))


def _same(a, b):
    return np.array_equal(a.data, b.data) and \
        np.array_equal(a.offsets, b.offsets)


@pytest.mark.parametrize("n", [0, 5, 300])
def test_ragged_equals(ref_host, n):
    rng = np.random.default_rng(n)
    mine, ref = _col(ragged, rng, n), _col(ref_ragged, np.random.default_rng(n), n)
    idx = rng.integers(0, max(n, 1), n) if n else np.zeros(0, np.int64)
    starts = rng.integers(0, max(mine.data.shape[0] - 20, 1), n)
    lens = rng.integers(0, 20, n)
    data = rng.integers(0, 256, mine.data.shape[0] + 40, dtype=np.uint8)
    assert _same(ragged.gather_ranges(data, starts, lens),
                 ref_ragged.gather_ranges(data, starts, lens))
    assert _same(ragged.take(mine, idx), ref_ragged.take(ref, idx))
    other = _col(ragged, rng, n, 5)
    seps = [b"\t", None]
    assert _same(ragged.interleave([mine, other], seps),
                 ref_ragged.interleave([ref, ref_ragged.Col(other.data,
                                                            other.offsets)],
                                       seps))
    if n:
        mat, ml = ragged.to_matrix(mine, fill=7)
        rmat, rml = ref_ragged.to_matrix(ref, fill=7)
        assert np.array_equal(mat, rmat) and np.array_equal(ml, rml)
        assert _same(ragged.from_matrix(mat, ml),
                     ref_ragged.from_matrix(rmat, rml))
        perm = rng.permutation(n)
        h = n // 2
        parts = [(perm[:h], ragged.take(mine, perm[:h])),
                 (perm[h:], ragged.take(mine, perm[h:]))]
        rparts = [(i, ref_ragged.Col(c.data, c.offsets)) for i, c in parts]
        assert _same(ragged.merge_rows(n, parts),
                     ref_ragged.merge_rows(n, rparts))
    vals = np.concatenate([rng.integers(-10 ** 12, 10 ** 12, n),
                           [0, -1, 9, 10, np.iinfo(np.int64).min,
                            np.iinfo(np.int64).max]]).astype(np.int64)
    assert _same(ragged.itoa(vals), ref_ragged.itoa(vals))
    assert np.array_equal(ragged.arange(n + 3), ref_ragged.arange(n + 3))


# --- txtfile and the gz-family readers ----------------------------------------

class _Fastq:
    """The datatype hooks TxtReader.vblocks calls: whole 4-line records."""
    optimize_enabled = False

    @staticmethod
    def suggested_vb_size():
        return None

    @staticmethod
    def vb_boundary(data, is_eof):
        if is_eof:
            return data.shape[0]
        nl = np.nonzero(data == ord("\n"))[0]
        q = nl.shape[0] // 4
        return int(nl[q * 4 - 1]) + 1 if q else 0


def _fastq_bytes(seed, n=3000):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(50, 151))
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), L).tobytes()
        q = rng.choice(QUALS, L).tobytes()
        out.append(b"@r%d/1\n%s\n+\n%s\n" % (i, seq, q))
    return b"".join(out)


def _bgzf(data, level=6, block=65280):
    out = []
    for i in range(0, len(data), block):
        out.append(ref_bgzf._one_block(data[i:i + block], level))
    return b"".join(out) + ref_bgzf.EOF_BLOCK


COMPRESS = {
    ".fastq": lambda b: b,
    ".fastq.gz": lambda b: gzip.compress(b, 6),
    ".fastq.bz2": lambda b: bz2.compress(b, 9),
    ".fastq.xz": lambda b: lzma.compress(b),
    ".bgzf.gz": _bgzf,
    ".members.gz": lambda b: b"".join(
        gzip.compress(b[i:i + 50000], 6) for i in range(0, len(b), 50000)),
}


@pytest.mark.parametrize("ext", list(COMPRESS))
def test_txtfile_equals(ref_host, ext, tmp_path):
    raw = _fastq_bytes(len(ext))
    path = str(tmp_path / ("in" + ext))
    with open(path, "wb") as f:
        f.write(COMPRESS[ext](raw))
    mine, ref = txtfile.TxtReader(path), ref_txtfile.TxtReader(path)
    try:
        assert mine.peek(1000) == ref.peek(1000)
        got = [v.tobytes() for v in mine.vblocks(_Fastq, 100000)]
        want = [v.tobytes() for v in ref.vblocks(_Fastq, 100000)]
        assert b"".join(got) == b"".join(want) == raw
        assert (mine.disk_size, mine.is_compressed) == \
            (ref.disk_size, ref.is_compressed)
        if ref_host == "native":
            # genozip_tpu's C++ BGZF reader returns at most the bytes asked
            # for and its numpy one whole blocks, so its VBs differ between
            # the two; the port takes the numpy path
            return
        assert got == want
        if isinstance(mine.f, (bgzf.BgzfBlockReader, bgzf.MgzipBlockReader)):
            assert type(mine.f).__name__ == type(ref.f).__name__
            assert mine.f.isizes == ref.f.isizes
            assert mine.f.mgzip_info() == ref.f.mgzip_info()
    finally:
        mine.close()
        ref.close()


def test_read_fastq_records_equals(tmp_path):
    raw = _fastq_bytes(9, 500)
    path = str(tmp_path / "r2.fastq")
    with open(path, "wb") as f:
        f.write(raw)
    mine, ref = txtfile.TxtReader(path), ref_txtfile.TxtReader(path)
    try:
        for k in (1, 7, 200, 1000):
            a, b = mine.read_fastq_records(k), ref.read_fastq_records(k)
            assert np.array_equal(a, b)
    finally:
        mine.close()
        ref.close()


def test_open_input_refuses_what_is_not_ported(monkeypatch):
    """URL and .cram inputs go to their bridges (`stream.py`); with no
    tool on PATH each fails naming the tool, as genozip_tpu does, and starts
    nothing."""
    monkeypatch.setenv("PATH", "/nonexistent")
    for path, tool in (("https://example.org/r.fastq", "curl or wget"),
                       ("r.cram", "`samtools`")):
        with pytest.raises(AssertionError, match=tool):
            ref_txtfile.open_input(path)
        with pytest.raises(FileNotFoundError, match=tool):
            txtfile.open_input(path)


def test_bgzf_is_bgzf_equals():
    blocks = _bgzf(b"ACGT" * 1000)
    for head in (blocks[:18], gzip.compress(b"x")[:18], b"\x1f\x8b", b""):
        assert bgzf.is_bgzf(head) == ref_bgzf.is_bgzf(head)
    assert bgzf.classify_mgzip(b"\x1f\x8b\x08\x00" + b"\0" * 6,
                               [1 << 20, 1 << 20, 5]) == \
        ref_bgzf.classify_mgzip(b"\x1f\x8b\x08\x00" + b"\0" * 6,
                                [1 << 20, 1 << 20, 5])


# --- utils/profiler and utils/progress -----------------------------------------

def test_profiler_report_equals():
    for mod in (profiler, ref_profiler):
        mod.reset()
        mod.add("zip:seg", 1.5)
        mod.add("zip:seg", 0.25)
        mod.add("piz:recon", 2.0)
        mod.add("tiny", 1e-6)
    try:
        assert profiler.report() == ref_profiler.report()
    finally:
        profiler.reset()
        ref_profiler.reset()


def test_progress_writes_nothing_when_quiet(capsys):
    progress.set_quiet(True)
    try:
        p = progress.Progress("zip x", 100, enabled=True)
        p.update(50)
        p.finish()
    finally:
        progress.set_quiet(False)
    assert capsys.readouterr().err == ""
    p = progress.Progress("zip x", 100, enabled=True)
    p.finish("done")
    assert "zip x: done" in capsys.readouterr().err


def test_zlib_codec_is_stdlib_zlib_level_6():
    """The port's ZLIB codec is zlib at level 6 on every machine (the JAX
    package's numpy host path), whatever genozip_tpu's C++ runtime does."""
    from genozip_tpu_torch import codecs
    data = _fastq_bytes(4, 200)
    assert codecs.compress(data, codecs.ZLIB) == zlib.compress(data, 6)
    assert codecs.decompress(zlib.compress(data, 9), codecs.ZLIB,
                             len(data)) == data
