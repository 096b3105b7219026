"""The genozip_tpu_torch text datatypes against genozip_tpu: FASTA (as a file
to compress), GFF3 (with per-attribute sub-contexts and the Parent = last
ID prediction), BED, 23andMe, Illumina LOCS and generic files; `zip
--input-type`; and `cat --vcf` of a 23andMe archive against a reference.

As in test_torch_sam.py (whose `host_reference` fixture and `zip_both`
helper these tests use), the port's rANS kernels take their plain PyTorch
route for payloads of 16 KiB and up, and genozip_tpu runs on its numpy host
path with its device path off. Parity is exact byte equality of archives
and of `cat --vcf` output; each package decodes the other's archive back to
the input."""

import io
import os
import struct

import numpy as np
import pytest

from genozip_tpu import cli as ref_cli
from genozip_tpu import filters as ref_filters
from genozip_tpu import translate as ref_translate
from genozip_tpu import zip_pipeline as ref_zip
from genozip_tpu.ref import refstore as ref_refstore
from genozip_tpu_torch import cli, piz_pipeline, synth, translate
from genozip_tpu_torch.ref.refstore import load_ref_file, make_reference
from tests.test_datatypes2 import synth_bed, synth_gff, synth_me23
from tests.test_torch_sam import host_reference, zip_both  # noqa: F401


def _read(p):
    with open(p, "rb") as f:
        return f.read()


def _written(writer, nbytes, **kw):
    """The bytes a `synth` writer writes."""
    def make(tmp):
        p = os.path.join(tmp, "w")
        writer(p, nbytes, **kw)
        return _read(p)
    return make


def _fasta_multi(tmp):
    """Several contigs with 70- and 60-base lines, lowercase runs, N runs,
    `;` comments, an empty line and no final newline."""
    rng = np.random.default_rng(8)
    out = [b";comment line\n"]
    for c in range(5):
        seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), 9000,
                         p=[.22, .22, .22, .22, .03, .03, .03, .02, .01])
        w = 70 if c % 2 else 60
        out.append(b">ctg%d some description %d\n" % (c, c * 11))
        out.append(b"\n".join(seq[i:i + w].tobytes()
                              for i in range(0, seq.shape[0], w)) + b"\n")
        if c == 2:
            out.append(b"\n")
    return b"".join(out)[:-1]


def _fasta_genome(tmp):
    p = os.path.join(tmp, "g.fa")
    synth.write_fasta(p, synth.genome(np.random.default_rng(4), 400_000))
    return _read(p)


def _gff_attrs(tmp):
    """test_datatypes2.py's attribute rows: genes, their mRNAs (ID, Parent,
    Dbxref) and exons (Parent, exon_number)."""
    rng = np.random.default_rng(12)
    rows = [b"##gff-version 3\n"]
    pos = 1000
    for g in range(120):
        pos += int(rng.integers(1000, 9000))
        gid, tid = b"gene%05d" % g, b"tx%05d" % g
        rows.append(b"chr1\thavana\tgene\t%d\t%d\t.\t+\t.\tID=%s;Name=GENE%d;"
                    b"biotype=protein_coding\n" % (pos, pos + 5000, gid, g))
        rows.append(b"chr1\thavana\tmRNA\t%d\t%d\t.\t+\t.\tID=%s;Parent=%s;"
                    b"Dbxref=GeneID:%d,HGNC:HGNC:%d\n"
                    % (pos, pos + 5000, tid, gid, 1000 + g, 2000 + g))
        for e in range(6):
            rows.append(b"chr1\thavana\texon\t%d\t%d\t.\t+\t.\tParent=%s;"
                        b"exon_number=%d\n"
                        % (pos + e * 700, pos + e * 700 + 400, tid, e + 1))
    return b"".join(rows)


def _gff_adversarial(tmp):
    """Rows that break key=value: no '=', empty values, a literal mark
    byte, trailing ';' (test_datatypes2.py's adversarial rows)."""
    return (b"##gff-version 3\n"
            b"c\tx\tgene\t1\t10\t.\t+\t.\tID=a;Parent=b\n"
            b"c\tx\tgene\t2\t11\t.\t+\t.\tjustakey\n"
            b"c\tx\tgene\t3\t12\t.\t+\t.\tID=;empty=\n"
            b"c\tx\tgene\t4\t13\t.\t+\t.\tID=x;\n"
            b"c\tx\tgene\t5\t14\t.\t+\t.\t;;\n"
            b"c\tx\tgene\t6\t15\t.\t+\t.\tk=v=w;q=a;q=b\n"
            b"c\tx\tgene\t7\t16\t.\t+\t.\tweird\x01mark=1\n") * 40


def _locs(tmp, tail=b""):
    rng = np.random.default_rng(14)
    n = 20000
    xy = (rng.random((n, 2)) * 30000).astype("<f4")
    return struct.pack("<IfI", 1, 1.0, n) + xy.tobytes() + tail


def _binary(tmp):
    rng = np.random.default_rng(15)
    return rng.integers(0, 256, 50000, dtype=np.uint8).tobytes() + \
        b"text tail" * 3000


CASES = {   # name: (file name, bytes, VB size, zip options)
    "fasta_genome": ("g.fa", _fasta_genome, 128 << 10, {}),
    "fasta_multi": ("m.fasta", _fasta_multi, 16 << 10, {}),
    "gff_synth": ("a.gff", lambda t: synth_gff(1500), 64 << 10, {}),
    "gff_attrs": ("b.gff3", _gff_attrs, 64 << 10, {}),
    "gff_adversarial": ("c.gff3", _gff_adversarial, 64 << 10, {}),
    "gff_ensembl": ("d.gff3", _written(synth.write_gff, 150 << 10, seed=5),
                    64 << 10, {}),
    "bed_synth": ("a.bed", lambda t: synth_bed(1500), 64 << 10, {}),
    "bed_peaks": ("b.bed", _written(synth.write_bed, 150 << 10, seed=6),
                  64 << 10, {}),
    "me23_synth": ("a.txt", lambda t: synth_me23(2000), 64 << 10, {}),
    "me23_raw": ("b.23andme", _written(synth.write_me23, 150 << 10, seed=7),
                 64 << 10, {}),
    "locs": ("s.locs", _locs, 64 << 10, {}),
    "locs_tail": ("t.dat", lambda t: _locs(t, b"\x01\x02\x03"), 64 << 10,
                  {"dt_name": "locs"}),
    "generic_log": ("x.log", _written(synth.write_generic, 200 << 10, seed=8),
                    64 << 10, {}),
    "generic_binary": ("y.bin", _binary, 32 << 10, {}),
    "input_type_bed": ("peaks.txt", lambda t: synth_bed(800), 64 << 10,
                       {"dt_name": "bed"}),
}
DT = {"fasta": "fasta", "gff": "gff", "bed": "bed", "me23": "me23",
      "locs": "locs", "generic": "generic", "input": "bed"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_archive_equals_reference(case, tmp_path):
    name, make, vb, kw = CASES[case]
    src = str(tmp_path / name)
    with open(src, "wb") as f:
        f.write(make(str(tmp_path)))
    port, _ = zip_both(src, vb, **kw)
    pr = piz_pipeline.PizReader(port)
    assert pr.file_hdr["dt"] == DT[case.split("_")[0]]
    pr.close()


def test_zip_input_type_cli(tmp_path):
    """`zip --input-type` forces the datatype a file's name and first bytes
    do not give: the port's CLI writes genozip_tpu's archive."""
    src = str(tmp_path / "rows.txt")
    with open(src, "wb") as f:
        f.write(synth_bed(600))
    cli.main(["zip", src, "--input-type", "bed", "-o", src + ".gxz",
              "--device", "cpu", "-q"])
    ref_zip.zip_file(src, src + ".ref.gxz", dt_name="bed")
    assert _read(src + ".gxz") == _read(src + ".ref.gxz")
    cli.main(["zip", src, "-o", src + ".g.gxz", "--device", "cpu", "-q"])
    for z, dt in ((src + ".gxz", "bed"), (src + ".g.gxz", "generic")):
        pr = piz_pipeline.PizReader(z)
        assert pr.file_hdr["dt"] == dt
        pr.close()
    with pytest.raises(ValueError, match="unknown datatype"):
        cli.main(["zip", src, "--input-type", "cram", "-o",
                  str(tmp_path / "no.gxz"), "--device", "cpu"])


@pytest.fixture(scope="module")
def me23_ref(tmp_path_factory):
    """A 1 Mbp genome as a reference with one contig, chr1."""
    d = tmp_path_factory.mktemp("me23ref")
    fa = str(d / "g.fa")
    synth.write_fasta(fa, synth.genome(np.random.default_rng(19), 1 << 20),
                      names=[b"chr1"])
    ref = str(d / "g.ref.gxz")
    make_reference(fa, ref, hash_bits=14)
    return ref


def _me23_text(chrom=b"1"):
    """23andMe rows inside the genome (chromosome `chrom`, found as chr1),
    with a row off its end, rows of another chromosome, no-calls, haploid
    calls and indels."""
    rng = np.random.default_rng(23)
    rows = [b"# This data file generated by 23andMe\n"
            b"# rsid\tchromosome\tposition\tgenotype\n"]
    gts = [b"AA", b"AG", b"GG", b"CT", b"CC", b"TT", b"--", b"A", b"DI",
           b"GT"]
    pos = 50
    for i in range(3000):
        pos += int(rng.integers(1, 300))
        c = chrom if i % 97 else b"7"
        rows.append(b"rs%d\t%s\t%d\t%s\n" % (1000 + i, c, pos,
                                             gts[int(rng.integers(0, 10))]))
    rows.append(b"rs9\t%s\t%d\tAA\n" % (chrom, 5 << 20))
    return b"".join(rows)


def _ref_cat_vcf(z, ref, extra=()):
    out = io.BytesIO()
    ref_filters.cat_translated_vcf(ref_cli.build_parser().parse_args(
        ["cat", z, "--vcf", "--reference", ref] + list(extra)), out)
    return out.getvalue()


@pytest.mark.parametrize("chrom", [b"1", b"chr1"])
@pytest.mark.parametrize("extra", [[], ["--no-header"]],
                         ids=["header", "no-header"])
def test_cat_vcf_equals_reference(me23_ref, chrom, extra, tmp_path):
    src = str(tmp_path / "g.23andme")
    with open(src, "wb") as f:
        f.write(_me23_text(chrom))
    port, _ = zip_both(src, 32 << 10)
    out = str(tmp_path / "o.vcf")
    cli.main(["cat", port, "--vcf", "--reference", me23_ref, "-o", out,
              "--device", "cpu"] + extra)
    want = _ref_cat_vcf(port, me23_ref, extra)
    assert _read(out) == want
    assert want.count(b"\n") > 2000


def test_me23_vb_to_vcf_equals_reference(me23_ref):
    text = _me23_text()
    mine = translate.me23_vb_to_vcf(text, load_ref_file(me23_ref))
    ref = ref_translate.me23_vb_to_vcf(text,
                                       ref_refstore.load_ref_file(me23_ref))
    assert mine == ref and mine


def test_f13_cat_vcf_keeps_the_last_row(me23_ref, tmp_path):
    """A 23andMe file without its final newline: genozip_tpu's cat --vcf
    drops the last row (fault F13); the port translates it."""
    text = _me23_text()[:-len(b"rs9\t1\t5242880\tAA\n")] + \
        b"rs8\t1\t777\tGT"
    src = str(tmp_path / "n.23andme")
    with open(src, "wb") as f:
        f.write(text)
    port, _ = zip_both(src, 32 << 10)
    out = str(tmp_path / "o.vcf")
    cli.main(["cat", port, "--vcf", "--reference", me23_ref, "-o", out,
              "--device", "cpu", "--no-header"])
    want = _ref_cat_vcf(port, me23_ref, ["--no-header"])
    got = _read(out)
    assert got.startswith(want) and got[len(want):].startswith(b"1\t777\trs8\t")
    assert got.count(b"\n") == want.count(b"\n") + 1


def test_cat_vcf_needs_a_23andme_archive_and_a_reference(me23_ref, tmp_path):
    src = str(tmp_path / "a.bed")
    with open(src, "wb") as f:
        f.write(synth_bed(300))
    z = src + ".gxz"
    cli.main(["zip", src, "-o", z, "--device", "cpu", "-q"])
    with pytest.raises(ValueError, match="needs a 23andMe archive"):
        cli.main(["cat", z, "--vcf", "--reference", me23_ref, "--device",
                  "cpu"])
    m = str(tmp_path / "m.23andme")
    with open(m, "wb") as f:
        f.write(_me23_text())
    cli.main(["zip", m, "-o", m + ".gxz", "--device", "cpu", "-q"])
    with pytest.raises(ValueError, match="needs --reference"):
        cli.main(["cat", m + ".gxz", "--vcf", "--device", "cpu"])
