"""The genozip_tpu_torch BAM slice against genozip_tpu: BAM zip, unzip and cat
(BGZF in, byte-exact BGZF out), REF_INTERNAL from the binary reference
catalog, and gencomp with the SAG store built from binary PRIM records; the
port's BGZF writers, its Python `bam_scan` and the cfg5 generator.

The reference runs on its numpy host path (`genozip_tpu.native.available`
patched to False) with its device path off; the port's rANS kernels take
their plain PyTorch route for payloads of 16 KiB and up."""

import gzip
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import native as ref_native
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu.utils import bgzf as ref_bgzf
from genozip_tpu_torch import codecs, filters, piz_pipeline, synth
from genozip_tpu_torch import translate, zip_pipeline
from genozip_tpu_torch.datatypes.bam import bam_scan
from genozip_tpu_torch.utils import bgzf
from tests.test_bam import synth_bam, synth_sorted_bam_with_supps
from tests.test_sag import synth_sag_sam
from tests.test_torch_sam import _cc_sam, _nh_sam, _solo_sam


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def host_reference(monkeypatch):
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    yield
    codecs.disable_device_rans()


def _write_bgzf(path, raw):
    w = bgzf.open_bgzf(path)
    w.write(raw)
    w.close()


def _sam_as_bam(path, sam: bytes):
    """A SAM text as BGZF BAM, through the port's SAM -> BAM translation."""
    hdr = b"".join(ln + b"\n" for ln in sam.split(b"\n")
                   if ln.startswith(b"@"))
    bam_hdr, ids = translate.sam_header_to_bam(hdr)
    _write_bgzf(path, bam_hdr + translate.sam_vb_to_bam(sam[len(hdr):],
                                                         ids)[0])


def _synth_cfg5(path):
    synth.write_bam(path, 256 << 10, seed=5, genome_len=1 << 20,
                    window_reads=1500)


# name -> (writes the input file, VB size)
CASES = {
    # multi-VB BAM (the first VB is the 1 MiB the calibration read ahead),
    # BGZF from the port's writer: the re-emission is exact
    "bgzf_multi_vb": (lambda p: _write_bgzf(p, synth_bam(6000)), 128 << 10),
    # plain gzip (not BGZF): the output is standard BGZF
    "gzip": (lambda p: gzip.open(p, "wb").write(synth_bam(400)), 64 << 10),
    # gencomp: supplementaries whose SEQ/QUAL are their primary's slice
    "gencomp_sa": (lambda p: _write_bgzf(p, synth_sorted_bam_with_supps(900)),
                   64 << 10),
    "cfg5": (_synth_cfg5, 256 << 10),
    # the SAM SAG flavours (FLAG, NH, CC, SOLO) as BAM
    "sag_flag": (lambda p: _sam_as_bam(p, synth_sag_sam(300)), 32 << 10),
    "sag_nh": (lambda p: _sam_as_bam(p, _nh_sam()), 32 << 10),
    "sag_cc": (lambda p: _sam_as_bam(p, _cc_sam()), 32 << 10),
    "sag_solo": (lambda p: _sam_as_bam(p, _solo_sam()), 32 << 10),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bam_archive_equals_reference(case, tmp_path):
    write, vb = CASES[case]
    src = str(tmp_path / "in.bam")
    write(src)
    port, refz = str(tmp_path / "p.gxz"), str(tmp_path / "r.gxz")
    zip_pipeline.zip_file(src, port, vb_size=vb)
    ref_zip.zip_file(src, refz, vb_size=vb)
    assert _read(port) == _read(refz)
    h = piz_pipeline.PizReader(port).file_hdr
    assert h["ref_internal"]
    if case in ("gencomp_sa", "cfg5") or case.startswith("sag"):
        assert h["gencomp"] and h["gencomp"]["depn_vbs"] > 0
    if case != "gzip":
        assert h["mgzip"]["exact"]
    if case == "bgzf_multi_vb":
        assert h["num_vbs"] >= 2
    outs = []
    for i, (unzip, z) in enumerate(((piz_pipeline.piz_file, refz),
                                    (ref_piz.piz_file, port),
                                    (piz_pipeline.piz_file, port))):
        out = str(tmp_path / f"o{i}.bam")
        unzip(z, out)
        outs.append(_read(out))
    assert outs[0] == outs[1] == outs[2]
    if h["mgzip"]["exact"]:
        assert outs[0] == _read(src)            # BGZF-exact
    else:
        assert gzip.decompress(outs[0]) == gzip.decompress(_read(src))


def test_cat_one_vb_and_header_of_bam(tmp_path):
    """cat --one-vb N of a gencomp BAM gives VB N's records in their
    original order; per-record filters of binary records refuse."""
    src = str(tmp_path / "gc.bam")
    _write_bgzf(src, synth_sorted_bam_with_supps(4500))
    z = str(tmp_path / "gc.gxz")
    zip_pipeline.zip_file(src, z, vb_size=64 << 10)
    pr = piz_pipeline.PizReader(z)
    try:
        assert pr.num_vbs() >= 2 and pr.file_hdr["gencomp"]
        hdr = pr.txt_header()
        pieces = [pr.read_vb(v) for v in range(1, pr.num_vbs() + 1)]
    finally:
        pr.close()
    assert hdr + b"".join(pieces) == gzip.decompress(_read(src))

    def cat(**kw):
        out = io.BytesIO()
        filters.cat_filtered(SimpleNamespace(input=z, reference=None, **kw),
                             out)
        return out.getvalue()

    assert cat(one_vb=2, no_header=True) == pieces[1]
    assert cat(header_only=True) == hdr
    with pytest.raises(NotImplementedError):
        cat(head=3)


def test_bam_scan_equals_reference():
    raw = synth_sorted_bam_with_supps(300)
    l_text = int.from_bytes(raw[4:8], "little")
    recs = np.frombuffer(raw[8 + l_text + 4 + 4 + 6 + 4:], np.uint8)
    for cut in (recs.shape[0], recs.shape[0] - 7, 1000, 3):
        for cap in (1 << 20, 17):
            p = bam_scan(recs[:cut], cap)
            r = ref_native.bam_scan(recs[:cut], cap)
            assert (p[0] == r[0]).all() and p[1] == r[1]


def test_bgzf_writers_equal_reference():
    """The port's BgzfWriter writes the bytes of genozip_tpu's zlib
    BgzfWriter; ExactBgzfWriter re-creates a BGZF file from its isizes."""
    rng = np.random.default_rng(4)
    data = rng.choice(np.frombuffer(b"ACGT\t\n", np.uint8), 400000).tobytes()

    class Sink(io.BytesIO):
        def close(self):
            self.value = self.getvalue()
            super().close()

    outs = []
    for mod in (bgzf, ref_bgzf):
        s = Sink()
        w = mod.BgzfWriter(s)
        for a in range(0, len(data), 70001):
            w.write(data[a:a + 70001])
        w.close()
        outs.append(s.value)
    assert outs[0] == outs[1]
    rd = bgzf.BgzfBlockReader(io.BytesIO(outs[0]))
    plain = b"".join(iter(lambda: rd.read(1 << 16), b""))
    info = rd.mgzip_info()
    assert plain == data and info["exact"]
    s = Sink()
    w = bgzf.ExactBgzfWriter(s, rd.isizes, info["level"],
                             bytes.fromhex(info["header"]))
    w.write(plain[:99999])
    w.write(plain[99999:])
    w.close()
    assert s.value == outs[0]


def test_cfg5_bam_is_its_sam_translated(tmp_path):
    """write_sam's lines (the first of write_bam's records, same seed)
    through sam_vb_to_bam are write_bam's records."""
    bam, sam = str(tmp_path / "c.bam"), str(tmp_path / "c.sam")
    kw = dict(seed=9, genome_len=1 << 20, window_reads=1500)
    synth.write_bam(bam, 64 << 10, **kw)
    synth.write_sam(sam, 64 << 10, **kw)
    txt = _read(sam)
    hdr = b"".join(ln + b"\n" for ln in txt.split(b"\n")
                   if ln.startswith(b"@"))
    bam_hdr, ids = translate.sam_header_to_bam(hdr)
    recs = translate.sam_vb_to_bam(txt[len(hdr):], ids)[0]
    raw = gzip.decompress(_read(bam))
    assert len(raw) > len(bam_hdr) + len(recs)
    assert raw[:len(bam_hdr) + len(recs)] == bam_hdr + recs
    assert txt.count(b"\t256\t") and txt.count(b"\t2048\t")
