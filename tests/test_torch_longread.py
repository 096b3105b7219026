"""Long-read SAM (bench.py's `gen_longread_sam` shapes, written by
genozip_tpu_torch's `synth.write_longread_sam`): the generator's lines are
well formed, and the port's archive of them equals genozip_tpu's, on its
numpy host path with its device path off, and unzips to the input."""

import re

import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import native as ref_native
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu_torch import codecs, piz_pipeline, synth, zip_pipeline

CIG = re.compile(rb"(\d+)([MID])")


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def longread(tmp_path_factory):
    d = tmp_path_factory.mktemp("longread")
    sam = str(d / "lr.sam")
    synth.write_longread_sam(sam, 1200 << 10, seed=31, genome_len=1 << 20)
    return sam


def test_longread_lines_are_well_formed(longread):
    """3-20 kb reads; SEQ and QUAL as long as the CIGAR's M + I; indels
    between matches; the minimap2 tags; positions ascending."""
    lines = _read(longread).splitlines()
    assert lines[:2] == [b"@HD\tVN:1.6\tSO:coordinate",
                         b"@SQ\tSN:chrB\tLN:1048576"]
    pos = []
    for ln in lines[2:]:
        f = ln.split(b"\t")
        ops = CIG.findall(f[5])
        assert b"".join(n + o for n, o in ops) == f[5]
        qlen = sum(int(n) for n, o in ops if o in b"MI")
        assert qlen == len(f[9]) == len(f[10])
        assert 3000 <= qlen <= 20007
        assert [t[:5] for t in f[11:]] == [
            b"NM:i:", b"ms:i:", b"AS:i:", b"nn:i:", b"tp:A:", b"cm:i:",
            b"s1:i:", b"s2:i:", b"de:f:", b"rl:i:"]
        pos.append(int(f[3]))
    assert len(pos) > 40 and pos == sorted(pos)
    assert any(b"I" in ln.split(b"\t")[5] for ln in lines[2:])
    assert any(b"D" in ln.split(b"\t")[5] for ln in lines[2:])


def test_longread_archive_equals_reference(longread, monkeypatch, tmp_path):
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        port, ref = str(tmp_path / "p.gxz"), str(tmp_path / "r.gxz")
        zip_pipeline.zip_file(longread, port, vb_size=256 << 10)
        ref_zip.zip_file(longread, ref, vb_size=256 << 10)
        assert _read(port) == _read(ref)
        piz_pipeline.piz_file(port, str(tmp_path / "o1"))
        ref_piz.piz_file(port, str(tmp_path / "o2"))
    finally:
        codecs.disable_device_rans()
    assert _read(tmp_path / "o1") == _read(tmp_path / "o2") == \
        _read(longread)
