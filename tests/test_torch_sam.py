"""The genozip_tpu_torch SAM slice against genozip_tpu: SAM zip, unzip and cat
without a reference (REF_INTERNAL where the header has @SQ lines), with
--reference/--REFERENCE and --optimize, and with gencomp components (PRIM/
DEPN) and their SAG predictors.

As in test_torch_pipeline.py, the port's rANS device threshold is lowered to
16 KiB on the CPU, so the larger sections take the kernels' plain PyTorch
route; the reference runs with its device path off and on its numpy host
path (`genozip_tpu.native.available` patched to False). Parity is exact
byte equality of archives, and each package decodes the other's archive
back to the input."""

import io
import os
from types import SimpleNamespace

import numpy as np
import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import filters as ref_filters
from genozip_tpu import native as ref_native
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu import sag as ref_sag
from genozip_tpu import translate as ref_translate
from genozip_tpu.utils import ragged as ref_ragged
from genozip_tpu_torch import codecs, filters, piz_pipeline, sag, synth
from genozip_tpu_torch import translate, zip_pipeline
from genozip_tpu_torch.ref.refstore import make_reference
from genozip_tpu_torch.utils import ragged
from tests.test_sag import synth_sag_sam, synth_sa_sam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "backcomp")
ACGT = np.frombuffer(b"ACGT", np.uint8)
QALPH = np.frombuffer(b"FF:,#", np.uint8)


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def host_reference(monkeypatch):
    """genozip_tpu on its numpy host path with its device path off; the
    port's kernels on their plain route for payloads of 16 KiB and up."""
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    monkeypatch.setenv("GXZ_NO_REF_CACHE", "1")
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    yield
    codecs.disable_device_rans()


def zip_both(src, vb_size, **kw):
    """Zip `src` with both packages; returns (port archive, reference
    archive) after checking they are the same bytes and that each package
    decodes the other's archive (and its own) back to `src`."""
    port, refz = src + ".port.gxz", src + ".ref.gxz"
    zip_pipeline.zip_file(src, port, vb_size=vb_size, **kw)
    ref_zip.zip_file(src, refz, vb_size=vb_size, **kw)
    assert _read(port) == _read(refz)
    orig = _read(src)
    if kw.get("optimize"):
        # --optimize is lossy: both decode to the optimized text
        ref_piz.piz_file(refz, src + ".o0")
        orig = _read(src + ".o0")
    rk = {"reference": kw["reference"]} \
        if kw.get("reference") and not kw.get("store_ref") else {}
    ext = os.path.splitext(src)[1]
    piz_pipeline.piz_file(refz, src + ".o1" + ext, **rk)
    ref_piz.piz_file(port, src + ".o2" + ext, **rk)
    piz_pipeline.piz_file(port, src + ".o3" + ext, **rk)
    for i in (1, 2, 3):
        assert _read(src + f".o{i}{ext}") == orig, f"decode {i}"
    return port, refz


# ---------------------------------------------------------------------------
# inputs (small: each case zips and unzips in a second or two)
# ---------------------------------------------------------------------------

def _plain_sam(n=400, sq=True, seed=3):
    rng = np.random.default_rng(seed)
    rows = [b"@HD\tVN:1.6\tSO:coordinate\n"]
    if sq:
        rows.append(b"@SQ\tSN:c1\tLN:60000\n")
    g = rng.choice(ACGT, 60000)
    pos = 100
    for i in range(n):
        pos += int(rng.integers(0, 100))
        seq = g[pos - 1:pos + 99].copy()
        k = int(rng.integers(0, 3))
        seq[rng.integers(0, 100, k)] = rng.choice(ACGT, k)
        qual = rng.choice(QALPH, 100).tobytes()
        fl = 99 if i % 2 == 0 else 147
        rows.append(b"r%d\t%d\tc1\t%d\t60\t100M\t=\t%d\t%d\t%s\t%s\t"
                    b"NM:i:%d\tAS:i:%d\tXS:i:%d\n"
                    % (i, fl, pos, pos + 200, 300 if fl == 99 else -300,
                       seq.tobytes(), qual, k, 100 - k, 80 - k))
    return b"".join(rows)


def _nh_sam(n=200):
    rng = np.random.default_rng(23)
    rows = [b"@HD\tVN:1.6\n@SQ\tSN:c1\tLN:100000\n"]
    for i in range(n):
        seq = rng.choice(ACGT, 60).tobytes()
        qual = rng.choice(QALPH, 60).tobytes()
        nh = int(rng.integers(2, 5))
        pos = 50 + i * 11
        rows.append(b"m%d\t0\tc1\t%d\t255\t60M\t*\t0\t0\t%s\t%s\tNH:i:%d\n"
                    % (i, pos, seq, qual, nh))
        for k in range(nh - 1):
            rows.append(b"m%d\t256\tc1\t%d\t0\t60M\t*\t0\t0\t*\t*\tNH:i:%d\n"
                        % (i, pos + 300 * (k + 1), nh))
    return b"".join(rows)


def _cc_sam(n=200):
    rng = np.random.default_rng(29)
    rows = [b"@HD\tVN:1.6\n@SQ\tSN:c1\tLN:100000\n@SQ\tSN:c2\tLN:100000\n"]
    for i in range(n):
        seq = rng.choice(ACGT, 60).tobytes()
        qual = rng.choice(QALPH, 60).tobytes()
        pos = 50 + i * 11
        spos = pos + 5000
        rows.append(b"c%d\t0\tc1\t%d\t60\t60M\t*\t0\t0\t%s\t%s\t"
                    b"CC:Z:c1\tCP:i:%d\n" % (i, pos, seq, qual, spos))
        cc, cp = (b"c1", pos) if i % 10 else (b"c2", pos + 7)
        rows.append(b"c%d\t256\tc1\t%d\t0\t60M\t*\t0\t0\t*\t*\t"
                    b"CC:Z:%s\tCP:i:%d\n" % (i, spos, cc, cp))
    return b"".join(rows)


def _solo_sam(n=300):
    rng = np.random.default_rng(23)
    rows = [b"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:c1\tLN:500000\n"]
    p = 100
    for i in range(n):
        p += int(rng.integers(1, 80))
        s = rng.choice(ACGT, 60).tobytes()
        q = (rng.integers(20, 40, 60) + 33).astype(np.uint8).tobytes()
        base = b"NH:i:2\tCB:Z:%s-1\tUB:Z:%s" % (
            bytes(rng.choice(ACGT, 16)), bytes(rng.choice(ACGT, 12)))
        rows.append(b"v%d\t0\tc1\t%d\t255\t60M\t*\t0\t0\t%s\t%s\t%s\n"
                    % (i, p, s, q, base))
        if i % 3 == 0:
            rows.append(b"v%d\t256\tc1\t%d\t0\t60M\t*\t0\t0\t*\t*\t%s\n"
                        % (i, int(rng.integers(1, 400000)), base))
    return b"".join(rows)


def _probe_sam():
    """The verify skill's probes: \\x01 (the tokenizer's mark byte) in text
    fields, malformed aux fields, '*' SEQ/QUAL, and no final newline."""
    body = _plain_sam(120, seed=9).split(b"\n")
    hdr = [ln for ln in body if ln.startswith(b"@")]
    recs = [ln for ln in body if ln and not ln.startswith(b"@")]
    extra = [
        b"q\x01x\t0\tc1\t500\t60\t10M\t*\t0\t0\tACGTACGTAC\tFFFFFFFFFF\t"
        b"XZ:Z:a\x01b",
        b"bad1\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*",
        b"bad2\t0\tc1\t600\t60\t10M\t*\t0\t0\tACGTACGTAC\tFFFFFFFFFF\tbad",
        b"bad3\t0\tc1\t700\t60\t10M\t*\t0\t0\tACGTACGTAC\tFFFFFFFFFF\t"
        b"NM:i:007\tX:i:1\tNM:i:1\t",
        b"bad4\t0\tc1\t800\t60\t10M\t*\t0\t0\tACGTNCGTAC\t*\tAS:i:-3",
        b"short\t0\tc1",
    ]
    lines = hdr + recs[:60] + extra + recs[60:]
    return b"\n".join(lines)      # no final newline


def _cfg5_sam():
    d = os.environ["_CFG5_DIR"]
    p = os.path.join(d, "cfg5.synth.sam")
    if not os.path.exists(p):
        synth.write_sam(p, 400 << 10, seed=5, genome_len=1 << 20,
                        window_reads=1500)
    return _read(p)


CASES = {
    "no_sq": (lambda: _plain_sam(sq=False), 32 << 10, {}),
    "ref_internal": (lambda: _plain_sam(), 32 << 10, {}),
    "optimize": (lambda: _plain_sam(), 32 << 10, {"optimize": True}),
    "probes": (_probe_sam, 16 << 10, {}),
    "sag_flag": (lambda: synth_sag_sam(300), 32 << 10, {}),
    "sag_sa": (lambda: synth_sa_sam(200), 32 << 10, {}),
    "sag_nh": (_nh_sam, 32 << 10, {}),
    "sag_cc": (_cc_sam, 32 << 10, {}),
    "sag_solo": (_solo_sam, 32 << 10, {}),
    "cfg5": (_cfg5_sam, 256 << 10, {}),
    # gencomp_split keeps a last VB without its final newline whole
    "sag_no_final_newline": (lambda: synth_sag_sam(300)[:-1], 32 << 10, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sam_archive_equals_reference(case, tmp_path, monkeypatch):
    make, vb, kw = CASES[case]
    monkeypatch.setenv("_CFG5_DIR", str(tmp_path))
    src = str(tmp_path / f"{case}.sam")
    with open(src, "wb") as f:
        f.write(make())
    port, _ = zip_both(src, vb, **kw)
    h = piz_pipeline.PizReader(port).file_hdr
    if case.startswith("sag") or case == "cfg5":
        assert h["gencomp"] and h["gencomp"]["depn_vbs"] > 0, h["gencomp"]
    if case != "no_sq":
        assert h["ref_internal"]


@pytest.fixture(scope="module")
def genome_ref(tmp_path_factory):
    """A one-contig reference (c1) and a SAM of reads off it, some with
    mismatches and MD/NM tags."""
    d = tmp_path_factory.mktemp("samref")
    rng = np.random.default_rng(41)
    g = rng.choice(ACGT, 60000)
    fa = str(d / "g.fa")
    with open(fa, "wb") as f:
        f.write(b">c1\n" + b"\n".join(g[i:i + 60].tobytes()
                                      for i in range(0, g.shape[0], 60))
                + b"\n")
    ref = str(d / "g.ref.gxz")
    make_reference(fa, ref, hash_bits=14)
    rows = [b"@HD\tVN:1.6\n@SQ\tSN:c1\tLN:60000\n"]
    for i in range(300):
        pos = int(rng.integers(1, 59800))
        seq = g[pos - 1:pos + 99].copy()
        md = b"100"
        nm = 0
        if i % 3 == 0:
            seq[40] = ACGT[(np.nonzero(ACGT == seq[40])[0][0] + 1) % 4]
            md, nm = b"40%s59" % bytes([g[pos - 1 + 40]]), 1
        rows.append(b"x%d\t0\tc1\t%d\t60\t100M\t*\t0\t0\t%s\t%s\tNM:i:%d\t"
                    b"MD:Z:%s\n" % (i, pos, seq.tobytes(),
                                    rng.choice(QALPH, 100).tobytes(), nm, md))
    sam = str(d / "x.sam")
    with open(sam, "wb") as f:
        f.write(b"".join(rows))
    return d, ref, sam


@pytest.mark.parametrize("store_ref", [False, True],
                         ids=["reference", "REFERENCE"])
def test_sam_with_reference(genome_ref, store_ref, tmp_path):
    d, ref, sam = genome_ref
    src = str(tmp_path / "x.sam")
    with open(src, "wb") as f:
        f.write(_read(sam))
    port, _ = zip_both(src, 16 << 10, reference=ref, store_ref=store_ref)
    h = piz_pipeline.PizReader(port).file_hdr
    assert h["ref_stored"] == store_ref and not h["ref_internal"]


def test_r4_sam_fixture_decodes(tmp_path):
    out = str(tmp_path / "r4.sam")
    piz_pipeline.piz_file(os.path.join(FIX, "r4.sam.gxz"), out)
    assert _read(out) == _read(os.path.join(FIX, "r4.sam"))


@pytest.fixture(scope="module")
def gencomp_archive(tmp_path_factory):
    """A multi-VB SAM gencomp archive (the port's; equal to the
    reference's, as test_sam_archive_equals_reference holds). Its first VB
    is the 1 MiB the calibration read ahead; the rest are 64 KiB."""
    d = tmp_path_factory.mktemp("gc")
    src = str(d / "gc.sam")
    with open(src, "wb") as f:
        f.write(synth_sag_sam(3600))
    z = str(d / "gc.gxz")
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        zip_pipeline.zip_file(src, z, vb_size=64 << 10)
    finally:
        codecs.disable_device_rans()
    return src, z


def _cat(z, **kw):
    args = SimpleNamespace(input=z, reference=None, **kw)
    out = io.BytesIO()
    filters.cat_filtered(args, out)
    return out.getvalue()


def test_cat_one_vb_drains_gencomp(gencomp_archive):
    """cat --one-vb N gives VB N's original records in their order: the
    deported lines of VBs 1..N-1 are drained, not handed to VB N
    (genozip_tpu's fault F3)."""
    src, z = gencomp_archive
    pr = piz_pipeline.PizReader(z)
    try:
        assert pr.num_vbs() >= 3 and pr.file_hdr["gencomp"]
        pieces = [pr.read_vb(v) for v in range(1, pr.num_vbs() + 1)]
    finally:
        pr.close()
    orig = _read(src)
    hdr_len = len(orig) - sum(len(p) for p in pieces)
    assert b"".join(pieces) == orig[hdr_len:]
    for vb in (2, 3):
        assert _cat(z, one_vb=vb, no_header=True) == pieces[vb - 1]


@pytest.mark.parametrize("kw", [
    {"head": 25}, {"tail": 30}, {"grep": "Q7"}, {"downsample": 7},
    {"seq_only": True}, {"qual_only": True}, {"header_only": True}],
    ids=["head", "tail", "grep", "downsample", "seq_only", "qual_only",
         "header_only"])
def test_cat_filters_equal_reference(gencomp_archive, kw):
    src, z = gencomp_archive
    full = dict(head=None, tail=None, grep=None, downsample=None,
                no_header=False, header_only=False, seq_only=False,
                qual_only=False, one_vb=None)
    full.update(kw)
    ref_out = io.BytesIO()
    ref_filters.cat_filtered(SimpleNamespace(input=z, reference=None, **full),
                             ref_out)
    assert _cat(z, **full) == ref_out.getvalue()


def test_host_helpers_equal_reference():
    """qname_hash, atoi, split_first_fields, count_sep_per_row and
    rows_equal against genozip_tpu's numpy path, on seeded rows."""
    rng = np.random.default_rng(12)
    words = [b"%d" % v for v in rng.integers(-10**12, 10**12, 300)]
    words += [b"007", b"-", b"", b"12a", b"9" * 25, b"-0", b"0"]
    words += [bytes(rng.choice(np.frombuffer(b"AB:\t12-", np.uint8),
                               int(rng.integers(0, 30))))
              for _ in range(300)]
    col = ragged.Col.from_list(words)
    rcol = ref_ragged.Col.from_list(words)
    for a, b in zip(ragged.atoi(col), ref_ragged.atoi(rcol)):
        assert (a == b).all()
    assert (sag.qname_hash(col) == ref_sag.qname_hash(rcol)).all()
    assert (ragged.count_sep_per_row(col, ord(":")) ==
            ref_ragged.count_sep_per_row(rcol, ord(":"))).all()
    for k in (2, 3):
        p = ragged.split_first_fields(col, ord("\t"), k)
        r = ref_ragged.split_first_fields(rcol, ord("\t"), k)
        for x, y in zip(p[0] + [p[1]], r[0] + [r[1]]):
            assert x.data.tobytes() == y.data.tobytes()
            assert (x.offsets == y.offsets).all()
        assert (p[2] == r[2]).all() and (p[3] == r[3]).all()
    other = ragged.Col.from_list(words[::-1])
    assert (ragged.rows_equal(col, other) ==
            ref_ragged.rows_equal(rcol, ref_ragged.Col.from_list(words[::-1]))
            ).all()


def test_sam_to_bam_translation_equals_reference():
    txt = _read(os.path.join(FIX, "r4.sam"))
    hdr = b"".join(ln + b"\n" for ln in txt.split(b"\n")
                   if ln.startswith(b"@"))
    p_hdr, p_ids = translate.sam_header_to_bam(hdr)
    r_hdr, r_ids = ref_translate.sam_header_to_bam(hdr)
    assert p_hdr == r_hdr and p_ids == r_ids
    p = translate.sam_vb_to_bam(txt[len(hdr):], p_ids)
    r = ref_translate.sam_vb_to_bam(txt[len(hdr):], r_ids)
    assert p[0] == r[0]
    assert all((a == b).all() for a, b in zip(p[1:], r[1:]))
