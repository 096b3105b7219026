"""`zip --bamass` in genozip_tpu_torch against genozip_tpu: a FASTQ zipped
against a reference with the placements of the BAM its reads were aligned
into (src/fastq_bamass.c), so that unzip needs only the reference.

The inputs come from synth.write_deep_fastq (a cfg5 BAM and the R1 of its
primaries) and a reference of the genome they were sampled off, with the
BAM's contig names. genozip_tpu runs on its numpy host path with its device
path off; its own bamass test skips without its C++ runtime. Parity is byte
equality of archives, and each package decodes the other's archive back to
the FASTQ."""

import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import native as ref_native
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu.ref import refstore as ref_refstore
from genozip_tpu_torch import cli, codecs, piz_pipeline, synth, zip_pipeline
from genozip_tpu_torch.ref import refstore

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
def bamass(tmp_path_factory):
    """A reference of the cfg5 genome (contigs chr1, chr2, ... as in the
    BAM), the BAM, its R1, and the bamass archive of each package."""
    d = tmp_path_factory.mktemp("bamass")
    bam, r1, r2 = str(d / "a.bam"), str(d / "r1.fq"), str(d / "r2.fq")
    nbytes = 300 << 10
    synth.write_deep_fastq(bam, r1, r2, nbytes, **KW)
    fa = str(d / "g.fa")
    synth.write_fasta(fa, synth.cfg5_genome(KW["genome_len"], KW["seed"]),
                      synth.cfg5_contigs(nbytes, KW["genome_len"]))
    ref = str(d / "g.ref.gxz")
    mp = pytest.MonkeyPatch()
    mp.setenv("GXZ_DEVICE_RANS", "0")
    mp.setenv("GXZ_NO_REF_CACHE", "1")
    mp.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        refstore.make_reference(fa, ref, hash_bits=18)
        ref_refstore.make_reference(fa, str(d / "g.jax.ref.gxz"),
                                    hash_bits=18)
        assert _read(ref) == _read(d / "g.jax.ref.gxz")
        for who, fn in (("port", zip_pipeline.zip_file),
                        ("ref", ref_zip.zip_file)):
            fn(r1, str(d / f"{who}.gxz"), vb_size=VB, reference=ref,
               bamass=bam)
        zip_pipeline.zip_file(r1, str(d / "plain.gxz"), vb_size=VB,
                              reference=ref)
    finally:
        codecs.disable_device_rans()
        mp.undo()
    return d, ref, r1


def test_bamass_archive_equals_reference(bamass):
    d, _, _ = bamass
    assert _read(d / "port.gxz") == _read(d / "ref.gxz")
    # the placements change what is stored: not the aligner's archive
    assert _read(d / "port.gxz") != _read(d / "plain.gxz")


@pytest.mark.parametrize("who", ["port", "ref"])
def test_each_package_unzips_the_others_bamass_archive(bamass, who,
                                                       tmp_path):
    """Unzip needs only --reference, not the BAM."""
    d, ref, r1 = bamass
    out = str(tmp_path / "o")
    if who == "port":
        piz_pipeline.piz_file(str(d / "ref.gxz"), out, reference=ref)
    else:
        ref_piz.piz_file(str(d / "port.gxz"), out, reference=ref)
    assert _read(out) == _read(r1)


def test_zip_bamass_cli(bamass, tmp_path):
    d, ref, r1 = bamass
    z = str(tmp_path / "c.gxz")
    cli.main(["zip", r1, "--reference", ref, "--bamass", str(d / "a.bam"),
              "-o", z, "--vblock", "1", "--device", "cpu", "-q"])
    cli.main(["unzip", z, "--reference", ref, "-o", z + ".out", "--device",
              "cpu"])
    assert _read(z + ".out") == _read(r1)
