"""The genozip_tpu_torch SAM/BAM translations against genozip_tpu: `cat
--sam` of BAM archives, `cat --bam [--index] -o` of SAM archives (the .bam
and .bai bytes), `cat --coverage` and `--idxstats`, and the refusals of
fault F10 (filters on binary BAM records, and filters that genozip_tpu's
translations ignore), `--cram` without samtools, `--vcf` of an archive
that is not 23andMe, and `--password`.

The inputs are cfg5-shaped (synth.write_bam / write_sam, gencomp archives
with PRIM and DEPN components) and a BAM whose records carry every aux
type. As in test_torch_sam.py, the port's kernels take their plain PyTorch
route for payloads of 16 KiB and up, and genozip_tpu runs on its numpy host
path with its device path off. Parity is byte equality of the outputs
genozip_tpu and the port make of the same archive."""

import gzip
import io
import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import coverage as ref_coverage
from genozip_tpu import filters as ref_filters
from genozip_tpu import native as ref_native
from genozip_tpu import translate as ref_translate
from genozip_tpu import zip_pipeline as ref_zip
from genozip_tpu.utils import bgzf as ref_bgzf
from genozip_tpu_torch import cli, codecs, coverage, filters, piz_pipeline
from genozip_tpu_torch import synth
from genozip_tpu_torch import translate, zip_pipeline

KW = dict(seed=6, genome_len=1 << 20, window_reads=1500)
VB = 256 << 10   # after the first VB, which is the 1 MiB calibration peek


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def arch(tmp_path_factory):
    """A cfg5 BAM with its SAM text twin, and a SAM with its BAM stream
    twin, each zipped by the port (equal to genozip_tpu's archive)."""
    d = tmp_path_factory.mktemp("translate")
    mp = pytest.MonkeyPatch()
    mp.setenv("GXZ_DEVICE_RANS", "0")
    mp.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        synth.write_bam(str(d / "a.bam"), 250 << 10, sam_path=str(d / "a.sam"),
                        **KW)
        synth.write_sam(str(d / "s.sam"), 1400 << 10,
                        bam_path=str(d / "s.bamstream"), **KW)
        for src in ("a.bam", "s.sam"):
            zip_pipeline.zip_file(str(d / src), str(d / f"{src}.gxz"),
                                  vb_size=VB)
            ref_zip.zip_file(str(d / src), str(d / f"{src}.ref.gxz"),
                             vb_size=VB)
            assert _read(d / f"{src}.gxz") == _read(d / f"{src}.ref.gxz")
            pr = piz_pipeline.PizReader(str(d / f"{src}.gxz"))
            assert pr.num_vbs() >= 2 and pr.file_hdr["gencomp"]
            pr.close()
    finally:
        codecs.disable_device_rans()
    yield d
    mp.undo()


@pytest.fixture(autouse=True)
def host_reference(monkeypatch):
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    yield
    codecs.disable_device_rans()


def _args(path, **kw):
    base = dict(input=str(path), reference=None, password=None,
                no_header=False, output=None)
    base.update(kw)
    return SimpleNamespace(**base)


def _aux_record(rng, i):
    """One BAM record whose aux holds every type, values from `rng`."""
    qname = b"q%d" % i
    aux = b"".join([
        b"XAA" + bytes([int(rng.integers(65, 90))]),
        b"Xcc" + struct.pack("<b", int(rng.integers(-128, 128))),
        b"XCC" + struct.pack("<B", int(rng.integers(0, 256))),
        b"Xss" + struct.pack("<h", int(rng.integers(-30000, 30000))),
        b"XSS" + struct.pack("<H", int(rng.integers(0, 65535))),
        b"Xii" + struct.pack("<i", int(rng.integers(-2**31, 2**31 - 1))),
        b"XII" + struct.pack("<I", int(rng.integers(0, 2**32 - 1))),
        b"Xff" + struct.pack("<f", float(rng.normal() * 1e3)),
        b"XZZ" + b"v%d,x;y" % i + b"\x00",
        b"XHH" + b"1AE3" + b"\x00",
        b"XBB" + b"s" + struct.pack("<I", 3) +
        struct.pack("<3h", *rng.integers(-999, 999, 3).tolist()),
        b"XbB" + b"f" + struct.pack("<I", 2) +
        struct.pack("<2f", *rng.normal(size=2).tolist()),
        b"XcB" + b"C" + struct.pack("<I", 0),
    ])
    l_seq = int(rng.integers(0, 5)) * (i % 3 != 0)
    seq = bytes(((int(rng.integers(1, 16)) << 4) | int(rng.integers(0, 16)))
                for _ in range((l_seq + 1) // 2))
    qual = bytes(rng.integers(0, 41, l_seq).tolist()) if i % 4 else \
        b"\xff" * l_seq
    n_cig = i % 3
    cig = b"".join(struct.pack("<I", (int(rng.integers(1, 99)) << 4) |
                               int(rng.integers(0, 9))) for _ in range(n_cig))
    refid = int(rng.integers(-1, 2))
    body = struct.pack("<iiBBHHHIiii", refid, int(rng.integers(-1, 9999)),
                       len(qname) + 1, 60, 4680, n_cig,
                       int(rng.integers(0, 4096)), l_seq,
                       refid if i % 2 else int(rng.integers(-1, 2)),
                       int(rng.integers(-1, 9999)),
                       int(rng.integers(-500, 500))) + \
        qname + b"\x00" + cig + seq + qual + aux
    return struct.pack("<I", len(body)) + body


def test_bam_vb_to_sam_equals_reference():
    """Every aux type (A, c/C/s/S/i/I, f, Z, H, B arrays), empty SEQ, '*'
    QUAL, no CIGAR, unmapped mates: the same SAM text."""
    rng = np.random.default_rng(11)
    recs = b"".join(_aux_record(rng, i) for i in range(60))
    names = ["chrA", "chrB"]
    assert translate.bam_vb_to_sam(recs, names) == \
        ref_translate.bam_vb_to_sam(recs, names)
    assert translate.bam_vb_to_sam(b"", names) == b""
    hdr = translate.sam_header_to_bam(
        b"@HD\tVN:1.6\n@SQ\tSN:chrA\tLN:99\n@SQ\tSN:chrB\tLN:7\n")[0]
    assert translate.bam_header_to_sam(hdr) == \
        ref_translate.bam_header_to_sam(hdr)


@pytest.mark.parametrize("no_header", [False, True])
def test_cat_sam_equals_reference(arch, no_header):
    """cat --sam of a gencomp BAM archive: genozip_tpu's bytes, which are
    the generator's SAM text of the same records."""
    z = arch / "a.bam.gxz"
    mine, ref = io.BytesIO(), io.BytesIO()
    filters.cat_translated_sam(_args(z, no_header=no_header), mine)
    ref_filters.cat_translated_sam(_args(z, no_header=no_header), ref)
    assert mine.getvalue() == ref.getvalue()
    sam = _read(arch / "a.sam")
    if no_header:
        sam = sam[sam.index(b"\nb") + 1:]
    assert mine.getvalue() == sam


@pytest.mark.parametrize("src", ["a.bam", "s.sam"])
@pytest.mark.parametrize("what", ["coverage", "idxstats"])
def test_coverage_equals_reference(arch, src, what):
    """--coverage and --idxstats of a BAM and a SAM archive; the read
    counts are the generator's mapped reads per contig."""
    z = arch / f"{src}.gxz"
    args = _args(z, coverage=what == "coverage", idxstats=what == "idxstats")
    mine, ref = io.BytesIO(), io.StringIO()
    coverage.show_coverage(args, mine)
    ref_coverage.show_coverage(args, ref)
    assert mine.getvalue() == ref.getvalue().encode()
    if what == "idxstats":
        text = _read(arch / ("a.sam" if src == "a.bam" else "s.sam"))
        rows = [ln.split(b"\t") for ln in text.splitlines()
                if not ln.startswith(b"@")]
        want = {}
        for r in rows:
            if not int(r[1]) & 4:
                want[r[2].decode()] = want.get(r[2].decode(), 0) + 1
        got = {ln.split("\t")[0]: int(ln.split("\t")[2])
               for ln in mine.getvalue().decode().splitlines()[:-1]}
        assert got == want


@pytest.mark.parametrize("what", ["coverage", "idxstats"])
def test_coverage_of_odd_bam_records_equals_reference(what, tmp_path):
    """Unmapped records, RNAME '*', empty SEQ and every aux type: the port
    counts a BAM archive's records from their binary fields, genozip_tpu
    from their SAM translation; the output is the same."""
    rng = np.random.default_rng(13)
    hdr = translate.sam_header_to_bam(
        b"@HD\tVN:1.6\n@SQ\tSN:chrA\tLN:99999\n@SQ\tSN:chrB\tLN:99999\n")[0]
    src = str(tmp_path / "odd.bam")
    with gzip.open(src, "wb") as f:
        f.write(hdr + b"".join(_aux_record(rng, i) for i in range(300)))
    z = str(tmp_path / "odd.gxz")
    zip_pipeline.zip_file(src, z)
    args = _args(z, coverage=what == "coverage", idxstats=what == "idxstats")
    mine, ref = io.BytesIO(), io.StringIO()
    coverage.show_coverage(args, mine)
    ref_coverage.show_coverage(args, ref)
    assert mine.getvalue() == ref.getvalue().encode()
    # the records include unmapped ones
    assert int(mine.getvalue().split()[-1].replace(b",", b"")) > 0


@pytest.mark.parametrize("index", [False, True])
def test_cat_bam_equals_reference(arch, index, tmp_path):
    """cat --bam [--index] -o of a gencomp SAM archive: the .bam and .bai
    are genozip_tpu's bytes, and the BAM stream is the generator's."""
    z = arch / "s.sam.gxz"
    mine, ref = str(tmp_path / "m.bam"), str(tmp_path / "r.bam")
    cli.main(["cat", str(z), "--bam", "-o", mine, "--device", "cpu"] +
             (["--index"] if index else []))
    ref_filters.cat_translated_bam(_args(z, index=index), ref)
    assert _read(mine) == _read(ref)
    assert gzip.decompress(_read(mine)) == _read(arch / "s.bamstream")
    assert os.path.exists(mine + ".bai") == index
    if index:
        assert _read(mine + ".bai") == _read(ref + ".bai")


def test_indexing_bgzf_writer_equals_reference():
    """Virtual offsets and block bytes over records that straddle blocks."""
    rng = np.random.default_rng(3)
    mine_f, ref_f = io.BytesIO(), io.BytesIO()
    ref_f.close = lambda: None
    mine = translate.IndexingBgzfWriter(mine_f)
    ref = ref_translate.IndexingBgzfWriter(ref_f)
    mine.write_blob(b"BAM\x01hdr")
    ref.write_blob(b"BAM\x01hdr")
    for _ in range(6):
        lens = rng.integers(1, 40000, int(rng.integers(1, 8)))
        blob = rng.integers(0, 256, int(lens.sum()), np.uint8).tobytes()
        a, b = mine.write_records(blob, lens), ref.write_records(blob, lens)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    mine.close()
    ref.close()
    assert mine_f.getvalue() == ref_f.getvalue()
    assert translate._one_block(b"x" * 999, 6) == \
        ref_bgzf._one_block(b"x" * 999, 6)


@pytest.mark.parametrize("argv", [
    ["--sam", "--head", "3"], ["--sam", "--regions", "chr1"],
    ["--sam", "--count"], ["--coverage", "--grep", "b1"],
    ["--idxstats", "--lines", "1-5"], ["--bam", "--qnames", "b1"],
])
def test_translation_with_a_filter_is_refused(arch, argv):
    """F10: genozip_tpu's translations ignore these filters; the port
    refuses and names the filter."""
    z = str(arch / ("s.sam.gxz" if "--bam" in argv else "a.bam.gxz"))
    with pytest.raises(NotImplementedError, match=f"{argv[1]}.*F10"):
        cli.main(["cat", z, "-o", os.devnull, "--device", "cpu"] + argv)


@pytest.mark.parametrize("argv", [["--lines", "2-4"], ["--count"],
                                  ["--regions", "chr1"], ["--qnames", "b1"],
                                  ["--bases", "ACGT"]])
def test_bam_archive_refuses_record_filters(arch, argv):
    """F10: a BAM archive's records are binary; genozip_tpu cuts them at
    newline bytes. The port refuses and points to cat --sam."""
    with pytest.raises(NotImplementedError, match=f"{argv[0]}.*F10"):
        cli.main(["cat", str(arch / "a.bam.gxz"), "-o", os.devnull,
                  "--device", "cpu"] + argv)


def test_cram_without_samtools_is_refused(arch, monkeypatch):
    """cat --cram pipes through `samtools view -C` as genozip_tpu does, and
    fails with its message where samtools is not on PATH."""
    monkeypatch.setenv("PATH", "")
    z = str(arch / "a.bam.gxz")
    with pytest.raises(AssertionError) as ref_exc:
        ref_filters.cat_translated_cram(_args(z, cram_ref=None), None)
    with pytest.raises(RuntimeError) as exc:
        cli.main(["cat", z, "--cram", "--device", "cpu"])
    assert str(exc.value) == str(ref_exc.value)


@pytest.mark.parametrize("argv", [["--vcf"], ["--password", "pw"]])
def test_slice5_cat_options_not_ported(arch, argv, capsysbinary):
    """Both are ported: --vcf (test_torch_datatypes2.py) refuses a SAM
    archive as genozip_tpu does, and --password (test_torch_crypt.py) on an
    archive that is not encrypted is ignored, as genozip_tpu ignores it."""
    z = str(arch / "s.sam.gxz")
    if argv[0] == "--vcf":
        with pytest.raises(ValueError,
                           match="--vcf translation needs a 23andMe archive"):
            cli.main(["cat", z, "--device", "cpu"] + argv)
        return
    cli.main(["cat", z, "--head", "5", "--device", "cpu"])
    plain = capsysbinary.readouterr().out
    cli.main(["cat", z, "--head", "5", "--device", "cpu"] + argv)
    assert capsysbinary.readouterr().out == plain and plain.count(b"\n") > 5


def test_index_needs_output(arch):
    with pytest.raises(ValueError, match="--index needs --bam -o"):
        cli.main(["cat", str(arch / "s.sam.gxz"), "--bam", "--index",
                  "--device", "cpu"])
