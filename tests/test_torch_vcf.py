"""The genozip_tpu_torch VCF slice against genozip_tpu: VCF zip, unzip and
cat, with the PBWT genotype matrix, the INFO relations (AC/AN/AF, END, DP
from the samples' DP), VEP CSQ, ID from POS, the per-FORMAT-tag sample
contexts with their GATK predictions (DP from AD, GQ from PL) and
int-list decomposition, and REF against a reference (--reference and
--REFERENCE, contig named as in the genome or without its `chr`).

As in test_torch_sam.py (whose `host_reference` fixture and `zip_both`
helper these tests use), the port's rANS kernels take their plain PyTorch
route for payloads of 16 KiB and up, and genozip_tpu runs on its numpy host
path with its device path off. Parity is exact byte equality of archives;
each package decodes the other's archive back to the input, and `cat`
outputs are equal."""

import io
import os
import tempfile

import numpy as np
import pytest

from genozip_tpu import cli as ref_cli
from genozip_tpu import filters as ref_filters
from genozip_tpu.ops import pbwt as ref_pbwt
from genozip_tpu_torch import cli, codecs, piz_pipeline, synth, zip_pipeline
from genozip_tpu_torch.ops import pbwt
from genozip_tpu_torch.ref.refstore import make_reference
from tests.test_torch_sam import host_reference, zip_both  # noqa: F401
from tests.test_vcf_format import synth_csq_vcf, synth_rich_vcf
from tests.test_vcf_gatk import synth_gatk_vcf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "backcomp")
HDR1 = (b"##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
        b"\tINFO\tFORMAT\tS0\n")
HDR3 = (b"##fileformat=VCFv4.2\n"
        b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2\tS3\n")


def _read(p):
    with open(p, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# inputs: the shapes of test_vcf_format.py, test_vcf_gatk.py and
# test_vcf_relations.py, small
# ---------------------------------------------------------------------------

def _overlong_cells():
    """Cells with more subfields than FORMAT declares (SMPEXC)."""
    rows = [HDR1]
    for i in range(200):
        cell = b"0/1:5:6:7:8" if i % 50 == 0 else b"0/1:5"
        rows.append(b"chr3\t%d\t.\tT\tA\t9\tPASS\t.\tGT:DP\t%s\n"
                    % (100 + i, cell))
    return b"".join(rows)


def _mixed_format():
    """Two FORMAT words in one VB: the flat sample fallback."""
    rows = [HDR1]
    for i in range(300):
        fmt, cell = ((b"GT:DP", b"0/1:33") if i % 2 else (b"GT", b"1|1"))
        rows.append(b"chr2\t%d\t.\tA\tC\t50\tPASS\tDP=9\t%s\t%s\n"
                    % (1000 + i * 7, fmt, cell))
    return b"".join(rows)


def _haploid_wide():
    """Haploid GTs and allele indices above 9: no PBWT."""
    rng = np.random.default_rng(33)
    rows = [HDR1[:-1] + b"\tS1\n"]
    for i in range(300):
        rows.append(b"chrX\t%d\t.\tG\tT\t10\tPASS\t.\tGT:GQ\t%d:%d\t%d:%d\n"
                    % (500 + i * 11, rng.integers(0, 2), rng.integers(0, 99),
                       rng.integers(0, 12), rng.integers(0, 99)))
    return b"".join(rows)


def _info_per_tag():
    """Per-key INFO contexts: variable tag order, flags, snpEff ANN."""
    rows = [b"##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
            b"\tINFO\n"]
    for i in range(800):
        if i % 7 == 0:
            info = b"DB;DP=%d;AF=0.%03d" % (i % 90 + 1, i % 999)
        elif i % 7 == 1:
            info = b"."
        elif i % 7 == 2:
            info = b"DP=%d;ANN=G|missense|MODERATE;DB" % (i % 70)
        else:
            info = b"DP=%d;AF=0.%03d;MQ=%d" % (i % 90 + 1, (i * 3) % 999,
                                               30 + i % 30)
        rows.append(b"chr5\t%d\t.\tA\tG\t40\tPASS\t%s\n" % (1000 + i * 9, info))
    return b"".join(rows)


def _id_pos():
    rows = [HDR3]
    for i in range(60):
        pos = 1000 + i * 7
        ident = b"rs%d" % pos if i % 5 else b"custom_%d" % i
        rows.append(b"chr1\t%d\t%s\tA\tG\t50\tPASS\tX=1\tGT\t0/1\t0/0\t1/1\n"
                    % (pos, ident))
    return b"".join(rows)


def _end_delta():
    rows = [HDR3]
    for i in range(40):
        pos = 500 + i * 11
        rows.append(b"chr1\t%d\t.\tA\t<DEL>\t50\tPASS\tEND=%d;SVTYPE=DEL\t"
                    b"GT\t0/1\t0/0\t1/1\n" % (pos, pos + 100 + i))
    return b"".join(rows)


def _ac_an_af():
    rng = np.random.default_rng(5)
    rows = [HDR3]
    for i in range(50):
        an, ac = 6, int(rng.integers(0, 7))
        af = b"." if i > 45 else b"%.4f" % (ac / an)
        rows.append(b"chr1\t%d\t.\tA\tG\t9\tPASS\tAC=%d;AN=%d;AF=%s\t"
                    b"GT\t0/1\t0/0\t1/1\n" % (100 + i * 3, ac, an, af))
    return b"".join(rows)


def _info_dp():
    rng = np.random.default_rng(6)
    rows = [HDR3]
    for i in range(50):
        dps = rng.integers(5, 40, 3)
        info_dp = int(dps.sum()) if i % 7 else int(dps.sum()) + 3
        cells = b"\t".join(b"0/1:%d" % d for d in dps)
        rows.append(b"chr1\t%d\t.\tA\tG\t9\tPASS\tDP=%d\tGT:DP\t%s\n"
                    % (100 + i * 3, info_dp, cells))
    return b"".join(rows)


def _ad_int_list():
    rng = np.random.default_rng(7)
    rows = [HDR3]
    for i in range(400):
        cells = []
        for _ in range(3):
            d = int(rng.poisson(30))
            g = int(rng.integers(0, 3))
            aa = {0: 0, 1: d // 2, 2: d}[g]
            cells.append(b"%s:%d,%d:%d" % ([b"0/0", b"0/1", b"1/1"][g],
                                           d - aa, aa, d))
        rows.append(b"chr1\t%d\t.\tA\tG\t9\tPASS\tX=1\tGT:AD:DP\t%s\n"
                    % (100 + i * 3, b"\t".join(cells)))
    rows.append(b"chr1\t5000\t.\tA\tG\t9\tPASS\tX=1\tGT:AD:DP\t"
                b"0/1:.,.:7\t./.:.:0\t0/1:1,2,3:6\n")
    return b"".join(rows)


def _ad_ragged():
    rows = [HDR3]
    for i in range(30):
        cells = [b"0/1:%d,%d:9" % (i - 15, 2 * i), b"0/0:3:9", b"1/1:1,2:9"]
        rows.append(b"chr1\t%d\t.\tA\tG\t9\tPASS\tX=1\tGT:AD:DP\t%s\n"
                    % (100 + i * 3, b"\t".join(cells)))
    return b"".join(rows)


def _odd_rows():
    """Rows whose tab count differs (EXC), a literal TOK_MARK byte in INFO
    and in a sample, an empty line, CRLF."""
    rows = [HDR3]
    for i in range(120):
        rows.append(b"chr1\t%d\trs%d\tC\tT\t7\tPASS\tDP=%d;K=v%d\tGT:DP\t"
                    b"0|1:%d\t1|1:%d\t0/0:%d\n"
                    % (50 + i, 50 + i, i, i % 4, i, i + 1, i + 2))
    rows[30] = b"chr1\t80\t.\tC\tT\t7\tPASS\n"
    rows[40] = b"chr1\t90\t.\tC\tT\t7\tPASS\tDP=1;W=\x01x\tGT:DP\t0|1:1" \
        b"\t1|1:2\t0/0:\x013\n"
    rows[50] = b"\n"
    rows[60] = rows[60][:-1] + b"\r\n"
    return b"".join(rows)


def _cfg1(nbytes, samples, seed=9):
    """synth.write_vcf's text, cfg1's shapes with `samples` samples."""
    def make():
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "c.vcf")
            synth.write_vcf(p, nbytes, seed=seed, samples=samples, block=50)
            return _read(p)
    return make


CASES = {
    "gatk": (lambda: synth_gatk_vcf(n=300), 64 << 10),
    "rich": (lambda: synth_rich_vcf(n=400), 64 << 10),
    "csq_diverse": (lambda: synth_csq_vcf(n=400), 64 << 10),
    "csq_repetitive": (lambda: synth_csq_vcf(n=400, diverse=False),
                       64 << 10),
    "info_per_tag": (_info_per_tag, 64 << 10),
    "overlong_cells": (_overlong_cells, 64 << 10),
    "mixed_format": (_mixed_format, 64 << 10),
    "haploid_wide": (_haploid_wide, 64 << 10),
    "id_pos": (_id_pos, 64 << 10),
    "end_delta": (_end_delta, 64 << 10),
    "ac_an_af": (_ac_an_af, 64 << 10),
    "info_dp": (_info_dp, 64 << 10),
    "ad_int_list": (_ad_int_list, 64 << 10),
    "ad_ragged": (_ad_ragged, 64 << 10),
    "odd_rows": (_odd_rows, 64 << 10),
    "no_final_newline": (lambda: synth_gatk_vcf(n=200)[:-1], 64 << 10),
    "cfg1_3_samples": (_cfg1(60 << 10, 3), 16 << 10),
    "cfg1_200_samples": (_cfg1(200 << 10, 200), 64 << 10),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_vcf_archive_equals_reference(case, tmp_path):
    make, vb = CASES[case]
    src = str(tmp_path / f"{case}.vcf")
    with open(src, "wb") as f:
        f.write(make())
    zip_both(src, vb)


@pytest.mark.parametrize("threads", [1, 3])
def test_cfg1_multi_vb(threads, tmp_path):
    """A cfg1-shaped file over several VBs (the first is the 1 MiB the
    calibration read ahead) and seg threads: the lazy ID, CSQ and int-list
    choices freeze after calibration in both packages, so the bytes do not
    depend on the thread count."""
    src = str(tmp_path / "cfg1.vcf")
    synth.write_vcf(src, 1100 << 10, seed=12, block=40)
    port, _ = zip_both(src, 64 << 10, threads=threads)
    pr = piz_pipeline.PizReader(port)
    assert pr.num_vbs() >= 3
    assert pr.file_hdr["segconf"]["n_samples"] == 200
    pr.close()


@pytest.fixture(scope="module")
def genome_ref(tmp_path_factory):
    """A 1 Mbp genome as a one-contig reference named chr1."""
    d = tmp_path_factory.mktemp("vcfref")
    g = synth.genome(np.random.default_rng(17), 1 << 20)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, g, names=[b"chr1"])
    ref = str(d / "g.ref.gxz")
    make_reference(fa, ref, hash_bits=14)
    return g, ref


@pytest.mark.parametrize("chrom", [b"chr1", b"1"])
@pytest.mark.parametrize("store_ref", [False, True],
                         ids=["reference", "REFERENCE"])
def test_vcf_with_reference(genome_ref, chrom, store_ref, tmp_path):
    """REF against the genome: the contig found under the CHROM name or
    under `chr` + CHROM; --REFERENCE archives unzip without the
    reference."""
    g, ref = genome_ref
    src = str(tmp_path / "r.vcf")
    synth.write_vcf(src, 80 << 10, seed=21, samples=10, block=50,
                    chrom=chrom, genome=g[:700_000])
    port, _ = zip_both(src, 64 << 10, reference=ref, store_ref=store_ref)
    pr = piz_pipeline.PizReader(port)
    assert pr.file_hdr["ref_stored"] == store_ref
    pr.close()


def test_vcf_reference_is_needed(genome_ref, tmp_path):
    """Without --REFERENCE the archive names its reference, and unzip
    without it says which to give."""
    g, ref = genome_ref
    src = str(tmp_path / "r.vcf")
    synth.write_vcf(src, 20 << 10, seed=22, samples=5, genome=g)
    port = src + ".gxz"
    zip_pipeline.zip_file(src, port, reference=ref)
    with pytest.raises(ValueError, match="--reference g.ref.gxz"):
        piz_pipeline.piz_file(port, str(tmp_path / "x.out"))


def test_r4_vcf_fixture_decodes(tmp_path):
    out = str(tmp_path / "r4.vcf")
    piz_pipeline.piz_file(os.path.join(FIX, "r4.vcf.gxz"), out)
    assert _read(out) == _read(os.path.join(FIX, "r4.vcf"))


@pytest.mark.parametrize("shape", [(0, 4), (1, 1), (37, 6), (300, 400)])
def test_pbwt_equals_reference(shape):
    rng = np.random.default_rng(shape[0] + shape[1])
    A = rng.choice(np.array([0, 0, 0, 1, 1, 2, 10], np.uint8), shape)
    Y = pbwt.pbwt_encode(A)
    assert np.array_equal(Y, ref_pbwt.pbwt_encode(A))
    assert np.array_equal(pbwt.pbwt_decode(Y), A)
    assert np.array_equal(ref_pbwt.pbwt_decode(Y), A)


@pytest.fixture(scope="module")
def vcf_archive(tmp_path_factory):
    """A cfg1-shaped VCF over several VBs, zipped by the port (its archive
    equals genozip_tpu's, as test_cfg1_multi_vb holds)."""
    d = tmp_path_factory.mktemp("vcfcat")
    src = str(d / "c.vcf")
    synth.write_vcf(src, 1100 << 10, seed=31, samples=30, block=50)
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        zip_pipeline.zip_file(src, src + ".gxz", vb_size=64 << 10)
    finally:
        codecs.disable_device_rans()
    return d, src


CAT_CASES = [
    ["--head", "5"], ["--tail", "7"], ["--grep", "rs1"],
    ["--lines", "5-40"], ["--lines", "1900-"], ["--count"],
    ["--count", "--grep", "missense"], ["--header-only"],
    ["--no-header", "--head", "3"], ["--downsample", "50"],
    ["-r", "chr1:100000-200000"], ["--regions", "1:1000000-", "--count"],
    ["--regions", "chr1:50000-60000,chr1:2000000-2100000", "--lines", "2-4"],
    ["--bases", "^ACGT", "--count"], ["--qnames", "chr1"],
]


@pytest.mark.parametrize("argv", CAT_CASES, ids=lambda a: " ".join(a))
def test_vcf_cat_equals_reference(vcf_archive, argv, tmp_path):
    d, src = vcf_archive
    z = src + ".gxz"
    out = str(tmp_path / "out")
    cli.main(["cat", z, "-o", out, "--device", "cpu"] + argv)
    ref = io.BytesIO()
    ref_filters.cat_filtered(ref_cli.build_parser().parse_args(
        ["cat", z] + argv), ref)
    assert _read(out) == ref.getvalue()
    assert ref.getvalue(), "the case selects nothing"


def test_vcf_cat_projection_is_refused(vcf_archive):
    """--seq-only/--qual-only name FASTQ lines and SAM columns; a VCF archive
    has neither (genozip_tpu asserts the same)."""
    d, src = vcf_archive
    for flag in ("--seq-only", "--qual-only"):
        with pytest.raises(ValueError, match=f"{flag}: unsupported for vcf"):
            cli.main(["cat", src + ".gxz", flag, "-o", os.devnull,
                      "--device", "cpu"])
