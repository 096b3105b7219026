"""genozip_tpu_torch's remaining zip tools against genozip_tpu: --md5,
--truncate, --biopsy, --tar, --replace, the external-tool and URL input
bridges (through PATH shims, as genozip_tpu's tests/test_stream.py does:
the tools themselves are not installed), and the refusals of fault F14
(--password or --md5 with --pair or --deep, which genozip_tpu drops without
a word). As in test_torch_sam.py, the port's rANS kernels take their plain
route for payloads of 16 KiB and up, and genozip_tpu runs on its numpy host
path. Every comparison is exact bytes."""

import hashlib
import os
import stat
import tarfile

import pytest

from genozip_tpu import biopsy as ref_biopsy
from genozip_tpu import cli as ref_cli
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu_torch import biopsy, cli, piz_pipeline, synth, zip_pipeline
from tests.test_torch_sam import host_reference  # noqa: F401


def _read(p):
    with open(p, "rb") as f:
        return f.read()


def _fastq(d, nbytes=300 << 10, seed=3):
    p = str(d / f"r{seed}.fastq")
    synth.write_fastq(p, nbytes, seed=seed, block=1000)
    return p


def _sam(d):
    p = str(d / "a.sam")
    synth.write_sam(p, 300 << 10, seed=4, genome_len=1 << 20,
                    window_reads=1500)
    return p


def _both(src, **kw):
    """Zip `src` with both packages; the archives must be the same bytes.
    Returns the port's."""
    port, refz = src + ".port.gxz", src + ".ref.gxz"
    zip_pipeline.zip_file(src, port, **kw)
    ref_zip.zip_file(src, refz, **kw)
    assert _read(port) == _read(refz)
    return port


def test_md5_equals_reference(host_reference, tmp_path):
    src = _sam(tmp_path)
    port = _both(src, use_md5=True)
    pr = piz_pipeline.PizReader(port)
    h = pr.file_hdr
    pr.close()
    assert h["md5"] == hashlib.md5(_read(src)).hexdigest()
    piz_pipeline.piz_file(port, src + ".out")
    ref_piz.piz_file(port, src + ".out2")
    assert _read(src + ".out") == _read(src + ".out2") == _read(src)


@pytest.mark.parametrize("kind", ["fastq", "sam"])
def test_truncate_equals_reference(host_reference, tmp_path, kind):
    """An input cut mid-record, with --truncate: both packages write the
    same archive, of the whole records before the cut."""
    src = _fastq(tmp_path) if kind == "fastq" else _sam(tmp_path)
    data = _read(src)
    cut = str(tmp_path / f"cut.{kind}")
    with open(cut, "wb") as f:
        f.write(data[:len(data) * 2 // 3 + 7])
    port = _both(cut, truncate=True)
    piz_pipeline.piz_file(port, cut + ".out")
    out = _read(cut + ".out")
    kept = _read(cut)[:len(out)]
    assert out == kept and 0 < len(data) * 2 // 3 + 7 - len(out) < 2000
    assert out.endswith(b"\n")


def test_biopsy_equals_reference_and_the_vb(host_reference, tmp_path):
    """VB 2 of a biopsy is the text of VB 2 of the archive zipped at the
    same VB size (1 MiB and up: zip's calibration reads the first MiB)."""
    src = _fastq(tmp_path, 2600 << 10)
    vb = 1 << 20
    want = _read(ref_biopsy.biopsy_take(src, 2, vb_size=vb))
    os.remove(src + ".vb2")
    path = biopsy.biopsy_take(src, 2, vb_size=vb)
    assert path == src + ".vb2" and _read(path) == want
    z = src + ".gxz"
    zip_pipeline.zip_file(src, z, vb_size=vb)
    pr = piz_pipeline.PizReader(z)
    try:
        assert pr.read_vb(2) == want
    finally:
        pr.close()
    with pytest.raises(ValueError, match="fewer than 99 VBs"):
        biopsy.biopsy_take(src, 99, vb_size=vb)


def test_biopsy_cli(tmp_path, capsys):
    src = _fastq(tmp_path, 2600 << 10)
    ref_cli.main(["zip", src, "--biopsy", "2", "--vblock", "1"])
    want = _read(src + ".vb2")
    os.remove(src + ".vb2")
    cli.main(["zip", src, "--biopsy", "2", "--vblock", "1", "--device",
              "cpu"])
    assert _read(src + ".vb2") == want and len(want) > (900 << 10)
    assert "biopsy: VB 2 ->" in capsys.readouterr().out


def test_tar_members_equal_reference(host_reference, tmp_path):
    """`zip --tar` of two inputs: each member is that input's own archive
    (from either package), named after the input."""
    a, b = _fastq(tmp_path, 200 << 10, 3), _sam(tmp_path)
    port_tar, ref_tar = str(tmp_path / "p.tar"), str(tmp_path / "r.tar")
    cli.main(["zip", a, b, "--tar", port_tar, "--md5", "--device", "cpu"])
    ref_cli.main(["zip", a, b, "--tar", ref_tar, "--md5"])
    members = {}
    for name, t in (("port", port_tar), ("ref", ref_tar)):
        with tarfile.open(t) as tf:
            members[name] = {m.name: tf.extractfile(m).read()
                             for m in tf.getmembers()}
    assert list(members["port"]) == ["r3.fastq.gxz", "a.sam.gxz"]
    assert members["port"] == members["ref"]
    for src in (a, b):
        zip_pipeline.zip_file(src, src + ".own.gxz", use_md5=True)
        assert members["port"][os.path.basename(src) + ".gxz"] == \
            _read(src + ".own.gxz")


def test_replace_removes_the_input_only_when_verified(tmp_path, monkeypatch):
    src = _fastq(tmp_path)
    data = _read(src)
    z = src + ".gxz"

    def broken(*a, **k):
        raise ValueError("component 0: digest mismatch")
    monkeypatch.setattr(piz_pipeline, "piz_file", broken)
    with pytest.raises(ValueError, match="digest mismatch"):
        cli.main(["zip", src, "-o", z, "--replace", "--device", "cpu", "-q"])
    assert _read(src) == data
    monkeypatch.undo()
    cli.main(["zip", src, "-o", z, "--replace", "--device", "cpu", "-q"])
    assert not os.path.exists(src)
    piz_pipeline.piz_file(z, src + ".out")
    assert _read(src + ".out") == data


def _shim(d, name, fixture):
    """An executable `name` in `d` that prints `fixture`, whatever its
    arguments; it calls nothing through PATH."""
    sh = os.path.join(d, name)
    with open(sh, "w") as f:
        f.write(f"#!/bin/sh\nexec /bin/cat {fixture}\n")
    os.chmod(sh, os.stat(sh).st_mode | stat.S_IEXEC)


def _vcf_text():
    return (b"##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
            b"FILTER\tINFO\n" +
            b"".join(b"chr1\t%d\t.\tA\tG\t50\tPASS\t.\n" % (100 + i)
                     for i in range(500)))


@pytest.mark.parametrize("kind", ["cram", "bcf", "ora", "url"])
def test_input_bridges_equal_reference(host_reference, tmp_path, monkeypatch,
                                       kind):
    """A .cram, .bcf or .ora input, or a URL, read through its tool (a shim
    on a PATH that holds nothing else): the archive equals genozip_tpu's
    and unzips to the text the tool printed."""
    shims = tmp_path / "bin"
    shims.mkdir()
    if kind == "cram":
        text, tool, src = _read(_sam(tmp_path)), "samtools", "in.cram"
    elif kind == "bcf":
        text, tool, src = _vcf_text(), "bcftools", "in.bcf"
    else:
        text = _read(_fastq(tmp_path, 100 << 10))
        tool, src = ("orad", "in.ora") if kind == "ora" else \
            ("curl", "http://localhost:9/r.fastq")
    fixture = tmp_path / "fixture.txt"
    fixture.write_bytes(text)
    _shim(str(shims), tool, fixture)
    monkeypatch.setenv("PATH", str(shims))
    if kind != "url":
        src = str(tmp_path / src)
        with open(src, "wb") as f:
            f.write(b"opaque")       # the shim decodes it
    port, refz = str(tmp_path / "p.gxz"), str(tmp_path / "r.gxz")
    zip_pipeline.zip_file(src, port)
    ref_zip.zip_file(src, refz)
    assert _read(port) == _read(refz)
    piz_pipeline.piz_file(port, str(tmp_path / "out"))
    assert _read(str(tmp_path / "out")) == text


def test_missing_tool_fails_clearly(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    for name, tool in (("x.cram", "samtools"), ("x.bcf", "bcftools"),
                       ("x.ora", "orad")):
        p = tmp_path / name
        p.write_bytes(b"opaque")
        with pytest.raises(FileNotFoundError, match=tool):
            zip_pipeline.zip_file(str(p), str(p) + ".gxz")


@pytest.mark.parametrize("opt", [["--password", "pw"], ["--md5"]])
@pytest.mark.parametrize("mode", ["--pair", "--deep"])
def test_f14_refused(tmp_path, opt, mode):
    """genozip_tpu's zip_pair and zip_deep take neither --password nor --md5
    and write a plain archive (fault F14): the port refuses both, naming the
    option and F14, before it reads anything."""
    z = str(tmp_path / "x.gxz")
    with pytest.raises(ValueError, match=f"{opt[0]} is not supported with "
                       f"{mode} \\(fault F14\\)"):
        cli.main(["zip", "a.fastq", "b.fastq", mode, "-o", z, "--device",
                  "cpu"] + opt)
    assert not os.path.exists(z)
