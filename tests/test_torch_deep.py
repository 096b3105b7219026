"""`zip --deep` (a BAM with the R1/R2 FASTQ it was aligned from) in
genozip_tpu_torch, against genozip_tpu.

The inputs come from synth.write_deep_fastq: a cfg5 BAM of several VBs and
the FASTQ of its primaries, one read in ten changed so that it misses its
alignment. genozip_tpu runs on its numpy host path with its device path
off, and zip_deep pinned to one seg worker (`os.cpu_count` patched to 1):
with more, it segs the REF_INTERNAL BAM component on up to 8 threads and
its bytes depend on that (fault F9). Its own deep tests skip without its
C++ runtime; its deep and bamass modules take the Python `bam_scan` here.
Parity is byte equality of archives, and each package decodes the other's
archive back to the inputs. genozip_tpu writes an archive it cannot decode
for most multi-VB cfg5 inputs (fault F11: under REF_INTERNAL a VB's SEQ is
diffed against genome bases that a later VB populates); there the port's
archive differs and decodes, as test_f11_* shows. The parity inputs are
ones whose genozip_tpu archive decodes (asserted below), the only ones on
which it can serve as the spec."""

import gzip
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import filters as ref_filters
from genozip_tpu import native as ref_native
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu_torch import cli, codecs, piz_pipeline, synth, zip_pipeline

VB = 1 << 20
KW = dict(seed=12, genome_len=1 << 20, window_reads=3000)


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def host_reference(monkeypatch):
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    monkeypatch.setenv("GXZ_NO_REF_CACHE", "1")
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    yield
    codecs.disable_device_rans()


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """The inputs, and the deep archive of each package (equal)."""
    d = tmp_path_factory.mktemp("deep")
    bam, r1, r2 = str(d / "a.bam"), str(d / "r1.fq"), str(d / "r2.fq")
    synth.write_deep_fastq(bam, r1, r2, 500 << 10, **KW)
    mp = pytest.MonkeyPatch()
    mp.setenv("GXZ_DEVICE_RANS", "0")
    mp.setattr(ref_native, "available", lambda: False)
    mp.setattr(os, "cpu_count", lambda: 1)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        zip_pipeline.zip_deep(bam, [r1, r2], str(d / "port.gxz"), vb_size=VB)
        ref_zip.zip_deep(bam, [r1, r2], str(d / "ref.gxz"), vb_size=VB)
    finally:
        codecs.disable_device_rans()
        mp.undo()
    src = [gzip.decompress(_read(bam)), _read(r1), _read(r2)]
    return d, (bam, r1, r2), src


def test_deep_archive_equals_reference(deep):
    d, _, _ = deep
    assert _read(d / "port.gxz") == _read(d / "ref.gxz")
    pr = piz_pipeline.PizReader(str(d / "port.gxz"))
    comps = pr.components()
    pr.close()
    assert [c["dt"] for c in comps] == ["bam", "fastq", "fastq"]
    assert comps[0]["num_vbs"] >= 3


@pytest.mark.parametrize("who", ["port", "ref"])
def test_each_package_unzips_the_others_deep_archive(deep, who, tmp_path):
    """The BAM component comes back as its BAM stream, the FASTQs as they
    were."""
    d, _, src = deep
    out = str(tmp_path / "o")
    if who == "port":
        piz_pipeline.piz_file(str(d / "ref.gxz"), out)
    else:
        ref_piz.piz_file(str(d / "port.gxz"), out)
    for i, want in enumerate(src, start=1):
        assert _read(f"{out}.{i}") == want


def test_deep_reads_hit_and_miss(deep):
    """Reads equal to their alignment keep only a flag (2: SEQ and QUAL
    hit); changed reads miss (0), and their SEQ is stored."""
    d, _, _ = deep
    pr = piz_pipeline.PizReader(str(d / "port.gxz"))
    try:
        flags = np.concatenate([
            pr.load_vb(v, c)[1]["DEEP"]["local"][0]
            for c in (1, 2) for v in range(1, pr.comp_num_vbs(c) + 1)])
    finally:
        pr.close()
    share = np.bincount(flags.astype(np.int64), minlength=3) / flags.shape[0]
    assert 0.05 < share[0] < 0.2 and share[2] > 0.8


def test_f11_reference_deep_archive_fails_its_digest(tmp_path, monkeypatch):
    """A supplementary alignment (75H75M, 400 bp after its primary) near
    the end of a VB is diffed against bases that only the next VB
    populates. genozip_tpu's archive then fails a digest at unzip; the port
    keeps those bases unset, and its archive unzips."""
    bam, r1, r2 = (str(tmp_path / n) for n in ("a.bam", "r1.fq", "r2.fq"))
    synth.write_deep_fastq(bam, r1, r2, 200 << 10, **KW)
    ref_z, port_z = str(tmp_path / "ref.gxz"), str(tmp_path / "port.gxz")
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    ref_zip.zip_deep(bam, [r1], ref_z, vb_size=256 << 10)
    zip_pipeline.zip_deep(bam, [r1], port_z, vb_size=256 << 10)
    with pytest.raises(AssertionError, match="digest mismatch"):
        ref_piz.piz_file(ref_z, None)
    piz_pipeline.piz_file(port_z, str(tmp_path / "p"))
    assert _read(tmp_path / "p.1") == gzip.decompress(_read(bam))
    assert _read(tmp_path / "p.2") == _read(r1)


def test_zip_deep_cli_on_eight_threads(deep, tmp_path):
    """zip --deep BAM FQ... on 8 threads writes the bytes of one worker
    (the fixture's archive: os.cpu_count was 1); unzip gives back every
    component."""
    d, (bam, r1, r2), src = deep
    z, out = str(tmp_path / "c.gxz"), str(tmp_path / "o")
    cli.main(["zip", bam, r1, r2, "--deep", "-o", z, "--vblock", "1",
              "--threads", "8", "--device", "cpu", "-q"])
    assert _read(z) == _read(d / "port.gxz")
    cli.main(["unzip", z, "-o", out, "--device", "cpu"])
    for i, want in enumerate(src, start=1):
        assert _read(f"{out}.{i}") == want


def test_cat_sam_of_a_deep_archive_equals_reference(deep, tmp_path):
    """cat --sam translates the BAM component; the FASTQ components are not
    read."""
    d, _, _ = deep
    out = str(tmp_path / "o.sam")
    cli.main(["cat", str(d / "port.gxz"), "--sam", "-o", out, "--device",
              "cpu"])
    ref = io.BytesIO()
    ref_filters.cat_translated_sam(SimpleNamespace(
        input=str(d / "port.gxz"), reference=None, password=None,
        no_header=False), ref)
    assert _read(out) == ref.getvalue()
    assert ref.getvalue().count(b"\n") > 1000
