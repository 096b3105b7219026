"""PIZ's workers decode VBs concurrently: `PizReader.load_vb` holds
`io_lock` only for the archive reads, so two VB decodes run at once (a
two-party barrier inside `codecs.decompress` must be passed), the restored
bytes do not depend on the worker count (paired FASTQ whose R2 copies R1's
sections, an encrypted archive, a gencomp BAM), the counters
`piz:uncompress.vbs` and `piz:uncompress.overlapped` say how often the
decodes overlapped, the drain's running digest joins the VBs' own
(`adler32_combine`), and recon's range copies (`ragged.copy_rows`) put
every byte where a row loop does. On the CPU, with the device rANS route's threshold low
enough that the batched decoder runs."""

import pathlib
import threading
import zlib

import numpy as np
import pytest

from genozip_tpu_torch import codecs, crypt, piz_pipeline, synth, zip_pipeline
from genozip_tpu_torch.format import sections as fmt
from genozip_tpu_torch.utils import profiler, ragged

VB = 256 << 10
PW = "hunter2"


@pytest.fixture(autouse=True)
def _device_rans():
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    yield
    codecs.disable_device_rans()


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """A 2 MB FASTQ and its archive of 8 or more VBs."""
    d = tmp_path_factory.mktemp("pizc")
    src = str(d / "reads.fastq")
    synth.write_fastq(src, 2 << 20, seed=17, block=2000)
    arc = str(d / "reads.gxz")
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        zip_pipeline.zip_file(src, arc, vb_size=VB, threads=4)
    finally:
        codecs.disable_device_rans()
    return src, arc


def _num_vbs(arc):
    pr = piz_pipeline.PizReader(arc)
    try:
        return pr.num_vbs()
    finally:
        pr.close()


def _restore(monkeypatch, arc, out, n_workers, password=None):
    monkeypatch.setattr(piz_pipeline, "workers", lambda: n_workers)
    return piz_pipeline.piz_file(arc, out, password=password)


def _meet_in_decompress(monkeypatch, timeout=30.0):
    """`codecs.decompress` on a worker thread: its first two calls wait
    for each other at a two-party barrier (BrokenBarrierError after
    `timeout` s when no second decode comes while the first waits); the
    main thread's calls (file header, dictionaries, txt header) pass."""
    barrier = threading.Barrier(2, timeout=timeout)
    lock = threading.Lock()
    seen = [0]
    orig = codecs.decompress

    def decompress(blob, codec, uncomp_len):
        if threading.current_thread() is not threading.main_thread():
            with lock:
                k = seen[0]
                seen[0] += 1
            if k < 2:
                barrier.wait()
        return orig(blob, codec, uncomp_len)

    monkeypatch.setattr(codecs, "decompress", decompress)
    return seen


def test_two_vb_decodes_run_at_once(fastq, tmp_path, monkeypatch):
    src, arc = fastq
    assert _num_vbs(arc) >= 8
    seen = _meet_in_decompress(monkeypatch)
    out = str(tmp_path / "r.out")
    _restore(monkeypatch, arc, out, 4)
    assert seen[0] >= 2
    assert pathlib.Path(out).read_bytes() == pathlib.Path(src).read_bytes()


@pytest.mark.parametrize("n_workers", [1, 4])
def test_counters_say_how_often_decodes_overlapped(fastq, tmp_path,
                                                   monkeypatch, n_workers):
    src, arc = fastq
    if n_workers > 1:
        _meet_in_decompress(monkeypatch)
    out = str(tmp_path / "r.out")
    with profiler.recording() as rec:
        _restore(monkeypatch, arc, out, n_workers)
    assert pathlib.Path(out).read_bytes() == pathlib.Path(src).read_bytes()
    c = rec.counters
    assert c["piz:uncompress.vbs"] == _num_vbs(arc)
    overlapped = c.get("piz:uncompress.overlapped", 0)
    if n_workers == 1:
        assert overlapped == 0
    else:
        assert overlapped >= 1
    # the locked reads are a child of each VB's read+uncompress
    ids = {s.id: s for s in rec.spans}
    reads = [s for s in rec.spans if s.name == "piz:read"]
    assert len(reads) == _num_vbs(arc)
    assert all(ids[s.parent].name == "piz:read+uncompress" for s in reads)


def _paired(d):
    g = synth.genome(np.random.default_rng(41), 512 << 10)
    r1, r2 = str(d / "r1.fastq"), str(d / "r2.fastq")
    synth.write_paired_fastq(r1, r2, g, 600 << 10, seed=42, block=1000)
    arc = str(d / "p.gxz")
    zip_pipeline.zip_pair(r1, r2, arc, vb_size=VB, threads=4)
    return arc, [r1, r2], None


def _encrypted(d):
    src = str(d / "r.fastq")
    synth.write_fastq(src, 1 << 20, seed=3, block=1000)
    arc = str(d / "e.gxz")
    zip_pipeline.zip_file(src, arc, vb_size=128 << 10, password=PW)
    return arc, [src], PW


def _gencomp_bam(d):
    src = str(d / "a.bam")
    synth.write_bam(src, 256 << 10, seed=5, genome_len=1 << 20,
                    window_reads=1500)
    arc = str(d / "b.gxz")
    zip_pipeline.zip_file(src, arc, vb_size=64 << 10)
    return arc, [src], None


def _holds(arc, make, password):
    """The archive is of the kind its test names: R2 VBs that copy R1
    sections, encrypted sections, gencomp components."""
    pr = piz_pipeline.PizReader(arc, password=password)
    try:
        h = pr.file_hdr
        if make is _paired:
            r2_vbs = range(1, pr.comp_num_vbs(1) + 1)
            return any("pair" in cm for vb_i in r2_vbs
                       for cm in pr.load_vb(vb_i, 1)[0]["ctxs"].values())
        if make is _encrypted:
            return bool(h.get("enc")) and all(
                pr.zr.read_section_bytes(e)[0][3] & crypt.FLAG_ENCRYPTED
                for e in pr.zr.sections(fmt.SEC_LOCAL))
        return bool(h.get("gencomp")) and h["num_vbs"] >= 2
    finally:
        pr.close()


@pytest.mark.parametrize("make", [_paired, _encrypted, _gencomp_bam],
                         ids=["pair", "password", "gencomp_bam"])
def test_outputs_equal_across_worker_counts(make, tmp_path, monkeypatch):
    arc, srcs, password = make(tmp_path)
    assert _holds(arc, make, password)
    ext = pathlib.Path(srcs[0]).suffix
    for n in (1, 8):
        out = str(tmp_path / f"w{n}{ext}")
        _restore(monkeypatch, arc, out, n, password)
        outs = [out] if len(srcs) == 1 else \
            [f"{out}.{i + 1}" for i in range(len(srcs))]
        for o, s in zip(outs, srcs):
            assert pathlib.Path(o).read_bytes() == \
                pathlib.Path(s).read_bytes(), (n, o)


@pytest.mark.parametrize("n1,n2", [(0, 0), (1, 0), (0, 1), (5, 7),
                                   (65521, 65521), (100_000, 70_000),
                                   (1 << 20, 3)])
def test_adler32_combine_equals_zlib(n1, n2):
    """The drain's running digest joins each VB's adler32 (checked by its
    worker) instead of reading the VB's bytes again."""
    rng = np.random.default_rng(n1 * 7 + n2)
    for a, b in ((rng.bytes(n1), rng.bytes(n2)),
                 (b"\xff" * n1, b"\xff" * n2)):
        assert piz_pipeline.adler32_combine(
            zlib.adler32(a), zlib.adler32(b), len(b)) == zlib.adler32(a + b)


@pytest.mark.parametrize("nbytes", [0, 100, ragged.NATIVE_MIN_BYTES - 1,
                                    ragged.NATIVE_MIN_BYTES, 100_000])
def test_copy_rows_equals_a_row_loop(nbytes):
    """`ragged.copy_rows`, which splices the tokenizer's pieces in recon,
    on both sides of the host runtime's threshold: scattered source rows
    to scattered destinations, rows of length 0 included."""
    rng = np.random.default_rng(nbytes)
    rows = nbytes // 20 + 1
    lens = rng.multinomial(nbytes, np.full(rows, 1 / rows))
    gaps = rng.integers(0, 3, rows)          # each source row after a gap
    src_starts = np.cumsum(lens + gaps) - lens
    src = rng.integers(0, 256, nbytes + int(gaps.sum()), dtype=np.uint8)
    dst_order = rng.permutation(lens.shape[0])
    dst_starts = np.empty_like(lens)
    dst_starts[dst_order] = np.cumsum(lens[dst_order]) - lens[dst_order]
    dst = np.zeros(int(lens.sum()), np.uint8)
    want = dst.copy()
    for s, d, n in zip(src_starts, dst_starts, lens):
        want[d:d + n] = src[s:s + n]
    ragged.copy_rows(src, src_starts, dst, dst_starts, lens)
    assert np.array_equal(dst, want)
