"""genozip_tpu_torch's `cat` filters against genozip_tpu's: --lines,
--count, --bases, --qnames (a list and @FILE) and -r/--regions (VBs
skipped by the random-access index, then lines), alone and combined with
the older filters, on a gencomp SAM archive of several VBs, on a SAM
archive without gencomp and on a FASTQ archive.

Both packages read the same archive (the port's, which equals
genozip_tpu's); genozip_tpu's options are parsed by its own CLI parser and
run through its `filters.cat_filtered`, the port's through its CLI `cat -o
FILE`. Parity is byte equality of the output. --regions on a gencomp
archive is held to the lines in the regions instead: genozip_tpu skips
MAIN VBs by the random-access index and loses the PRIM/DEPN lines deported
from them that lie in a region (fault F12)."""

import io

import pytest

from genozip_tpu import cli as ref_cli
from genozip_tpu import codecs as ref_codecs
from genozip_tpu import filters as ref_filters
from genozip_tpu import native as ref_native
from genozip_tpu import zip_pipeline as ref_zip
from genozip_tpu_torch import cli, codecs, piz_pipeline, synth, zip_pipeline

VB = 256 << 10   # after the first VB, which is the 1 MiB calibration peek


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def arch(tmp_path_factory):
    """A cfg5 SAM (gencomp) and a cfg3 FASTQ, zipped by the port; each
    archive equals genozip_tpu's."""
    d = tmp_path_factory.mktemp("filters")
    mp = pytest.MonkeyPatch()
    mp.setenv("GXZ_DEVICE_RANS", "0")
    mp.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        synth.write_sam(str(d / "s.sam"), 1500 << 10, seed=8,
                        genome_len=1 << 20, window_reads=1500)
        synth.write_fastq(str(d / "r.fastq"), 1300 << 10, seed=9, block=800)
        # the same records without the secondary and supplementary ones:
        # no gencomp components
        with open(d / "s.sam", "rb") as f, open(d / "n.sam", "wb") as g:
            g.writelines(ln for ln in f if ln.startswith(b"@") or
                         not int(ln.split(b"\t")[1]) & 0x900)
        for src in ("s.sam", "n.sam", "r.fastq"):
            zip_pipeline.zip_file(str(d / src), str(d / f"{src}.gxz"),
                                  vb_size=VB)
            ref_zip.zip_file(str(d / src), str(d / f"{src}.ref.gxz"),
                             vb_size=VB)
            assert _read(d / f"{src}.gxz") == _read(d / f"{src}.ref.gxz")
        for src, gc in (("s.sam", True), ("n.sam", False)):
            pr = piz_pipeline.PizReader(str(d / f"{src}.gxz"))
            assert pr.num_vbs() >= 3 and bool(pr.file_hdr["gencomp"]) == gc
            pr.close()
        with open(d / "qn.txt", "wb") as f:
            f.write(b"b17\nb1502\n\nb3000\nnot-there\n")
    finally:
        codecs.disable_device_rans()
    yield d
    mp.undo()


@pytest.fixture(autouse=True)
def host_reference(monkeypatch):
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    yield
    codecs.disable_device_rans()


def _both(d, src, argv, tmp_path):
    """(port's output, genozip_tpu's output) of `cat` with `argv`."""
    z = str(d / f"{src}.gxz")
    argv = [a.format(d=d) for a in argv]
    out = str(tmp_path / "out")
    cli.main(["cat", z, "-o", out, "--device", "cpu"] + argv)
    ref = io.BytesIO()
    ref_filters.cat_filtered(ref_cli.build_parser().parse_args(
        ["cat", z] + argv), ref)
    return _read(out), ref.getvalue()


SAM_CASES = [
    ["--lines", "5-40"], ["--lines", "2900-"], ["--lines=-20"],
    ["--count"], ["--count", "--grep", "XA:Z"], ["--count", "--lines", "10-50"],
    ["--bases", "ACGT"], ["--bases", "^ACGT", "--count"],
    ["--qnames", "b3,b10,b1500,b4490"], ["--qnames", "@{d}/qn.txt"],
    ["--lines", "3-300", "--downsample", "3"], ["--tail", "7", "--lines",
                                                "1-100"],
    ["--head", "5", "--bases", "ACGT", "--no-header"],
]


@pytest.mark.parametrize("argv", SAM_CASES, ids=lambda a: " ".join(a))
def test_sam_filters_equal_reference(arch, argv, tmp_path):
    mine, ref = _both(arch, "s.sam", argv, tmp_path)
    assert mine == ref
    assert mine, "the case selects nothing"


REGIONS = ["chr1:1-100000", "chr1:130000-",
           "chr1:100000-110000,chr1:140000-141000", "1:150000-160000"]
REGION_CASES = [["--regions", REGIONS[0]], ["-r", REGIONS[1]],
                ["--regions", REGIONS[2], "--count"],
                ["--regions", REGIONS[3], "--lines", "3-9"]]


@pytest.mark.parametrize("argv", REGION_CASES, ids=lambda a: " ".join(a))
def test_regions_equal_reference(arch, argv, tmp_path):
    """Without gencomp: VBs skipped by the random-access index, then the
    lines outside the regions dropped, as genozip_tpu does."""
    mine, ref = _both(arch, "n.sam", argv, tmp_path)
    assert mine == ref
    assert mine, "the case selects nothing"


def _in_regions(text: bytes, spec: str) -> bytes:
    """The header and the lines whose RNAME and POS lie in a region of
    `spec`, straight from the SAM text."""
    regs = []
    for part in spec.split(","):
        chrom, _, rng = part.partition(":")
        a, _, b = rng.partition("-")
        regs.append((chrom.removeprefix("chr"), int(a or 0),
                     int(b) if b else 1 << 62))
    out = []
    for ln in text.splitlines(keepends=True):
        f = ln.split(b"\t")
        if ln.startswith(b"@") or any(
                f[2].decode().removeprefix("chr") == c and s <= int(f[3]) <= e
                for c, s, e in regs):
            out.append(ln)
    return b"".join(out)


@pytest.mark.parametrize("spec", REGIONS[:3])
def test_f12_regions_keep_deported_lines(arch, spec, tmp_path):
    """On a gencomp archive the port's --regions gives every line in the
    regions; genozip_tpu's loses the PRIM/DEPN lines of the VBs it
    skips."""
    mine, ref = _both(arch, "s.sam", ["--regions", spec], tmp_path)
    want = _in_regions(_read(arch / "s.sam"), spec)
    assert mine == want
    assert len(ref) < len(want)


FASTQ_CASES = [
    ["--lines", "2-9"], ["--count"], ["--count", "--downsample", "4"],
    ["--qnames", "SIM:1:FC706VJ:1:2100:15002:1014,SRR8861483.1603"],
    ["--bases", "^ACGT", "--count"], ["--regions", "chr1", "--head", "3"],
]


@pytest.mark.parametrize("argv", FASTQ_CASES, ids=lambda a: " ".join(a))
def test_fastq_filters_equal_reference(arch, argv, tmp_path):
    mine, ref = _both(arch, "r.fastq", argv, tmp_path)
    assert mine == ref
    assert mine, "the case selects nothing"


def test_regions_skip_vbs(arch, tmp_path, monkeypatch):
    """Without gencomp, a region inside one VB's span reconstructs only the
    VBs whose random-access entries overlap it."""
    seen = []
    orig = piz_pipeline.PizReader.load_vb

    def load_vb(self, vb_i, comp_i=0):
        if comp_i == 0:
            seen.append(vb_i)
        return orig(self, vb_i, comp_i)
    monkeypatch.setattr(piz_pipeline.PizReader, "load_vb", load_vb)
    pr = piz_pipeline.PizReader(str(arch / "n.sam.gxz"))
    nvb = pr.num_vbs()
    pr.close()
    out = str(tmp_path / "o")
    cli.main(["cat", str(arch / "n.sam.gxz"), "-r", "chr1:120000-120100",
              "-o", out, "--device", "cpu"])
    assert 0 < len(set(seen)) < nvb
    assert _read(out).count(b"\n") > 0
