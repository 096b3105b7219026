"""genozip_tpu_torch's BWT codec and `zip --best` against genozip_tpu.

The suffix array and forward transform equal genozip_tpu's; the vectorized
inverse walk equals genozip_tpu's step-by-step loop; BWT payloads (one
block and several) are the same bytes; and `--best` archives of a small
FASTQ and of a SAM whose archive holds BWT sections are byte-equal, each
package decoding the other's. genozip_tpu runs on its numpy host path
(`native.available` patched to False, so its inverse is the Python loop).
The codec-trial mode is module-global in both packages, so a fixture puts
both back to "normal" after each test. Every comparison is exact bytes."""

import os

import numpy as np
import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import native as ref_native
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu.codecs import assign as ref_assign, bwt as ref_bwt
from genozip_tpu_torch import cli, codecs, piz_pipeline, synth, zip_pipeline
from genozip_tpu_torch.codecs import assign, bwt
from genozip_tpu_torch.format import sections as fmt
from tests.test_torch_sam import host_reference  # noqa: F401


@pytest.fixture(autouse=True)
def normal_mode(monkeypatch):
    monkeypatch.setattr(ref_native, "available", lambda: False)
    yield
    assign.set_mode("normal")
    ref_assign.set_mode("normal")


def _read(p):
    with open(p, "rb") as f:
        return f.read()


def _case(name: str) -> bytes:
    rng = np.random.default_rng(len(name))
    if name == "empty":
        return b""
    if name == "one":
        return b"x"
    if name == "constant":
        return b"A" * 5000
    if name == "random":
        return rng.integers(0, 256, 20000, np.uint8).tobytes()
    if name == "dna":
        g = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
        return b"".join(g[s:s + 100].tobytes()
                        for s in rng.integers(0, 3900, 300))
    if name == "text":
        return b"the quick brown fox jumps over the lazy dog " * 500
    assert name == "digits"
    return rng.integers(0, 9, 50000, np.uint8).tobytes()


CASES = ["empty", "one", "constant", "random", "dna", "text", "digits"]


@pytest.mark.parametrize("name", CASES)
def test_suffix_array_and_forward_equal_reference(name):
    a = np.frombuffer(_case(name), np.uint8)
    assert np.array_equal(bwt.suffix_array(a), ref_bwt.suffix_array(a))
    if a.shape[0]:
        last, prim = bwt.bwt_forward(a)
        ref_last, ref_prim = ref_bwt.bwt_forward(a)
        assert prim == ref_prim and np.array_equal(last, ref_last)


@pytest.mark.parametrize("stride", [1, 7, 256, 1 << 20])
@pytest.mark.parametrize("name", CASES[1:])
def test_vectorized_inverse_equals_the_loop(name, stride, monkeypatch):
    """The walk from sampled rows (every row, a few, the default, only the
    sentinel's) gives the loop's bytes, which are the input."""
    monkeypatch.setattr(bwt, "WALK_STRIDE", stride)
    a = np.frombuffer(_case(name), np.uint8)
    last, prim = bwt.bwt_forward(a)
    got = bwt.bwt_inverse(last, prim)
    assert np.array_equal(got, ref_bwt.bwt_inverse(last, prim))
    assert got.tobytes() == a.tobytes()


@pytest.mark.parametrize("name", CASES)
def test_bwt_codec_bytes_equal_reference(name):
    data = _case(name)
    blob = codecs.compress(data, codecs.BWT)
    assert blob == ref_codecs.compress(data, ref_codecs.BWT)
    assert codecs.decompress(blob, codecs.BWT, len(data)) == data
    assert ref_codecs.decompress(blob, ref_codecs.BWT, len(data)) == data


def test_bwt_multiblock_equals_reference():
    """Above BWT_BLOCK the payload splits into blocks (genozip_tpu's
    test_codecs.py case): the same bytes, decoded both ways."""
    assert bwt.BWT_BLOCK == ref_bwt.BWT_BLOCK
    data = (b"BANANASPLIT" * 500000)[: bwt.BWT_BLOCK + 12345]
    blob = bwt.compress(data, codecs.RANS1)
    assert blob == ref_bwt.compress(data, ref_codecs.RANS1)
    assert int.from_bytes(blob[:8], "little") == (1 << 64) - 1
    assert bwt.decompress(blob) == data


def _codecs_of(path) -> list:
    """The codec of every section of an archive, in file order."""
    with open(path, "rb") as f:
        zr = fmt.ZReader(f)
        out = []
        for ent in zr.index:
            f.seek(ent.offset)
            out.append(fmt._HDR.unpack(f.read(fmt.HDR_SIZE))[2])
    return out


@pytest.mark.parametrize("kind", ["fastq", "sam"])
def test_best_archive_equals_reference(host_reference, tmp_path, kind):
    """`--best` archives of a small FASTQ and of a 1 MiB SAM (whose POS and
    SAGIDX sections take BWT) are the same bytes from both packages."""
    src = str(tmp_path / f"in.{kind}")
    if kind == "fastq":
        synth.write_fastq(src, 200 << 10, seed=3, block=1000)
    else:
        synth.write_sam(src, 1 << 20, seed=4, genome_len=1 << 20,
                        window_reads=1500)
    assign.set_mode("best")
    ref_assign.set_mode("best")
    port, refz = src + ".port.gxz", src + ".ref.gxz"
    zip_pipeline.zip_file(src, port)
    ref_zip.zip_file(src, refz)
    assert _read(port) == _read(refz)
    if kind == "sam":
        assert _codecs_of(refz).count(ref_codecs.BWT) >= 1
    piz_pipeline.piz_file(refz, src + ".o1")
    ref_piz.piz_file(port, src + ".o2")
    for i in (1, 2):
        assert _read(src + f".o{i}") == _read(src)


def test_cli_best_leaves_the_mode_as_it_was(host_reference, tmp_path):
    """`zip --best` trials with the wider candidate lists and puts the
    module-global mode back afterwards, so a later zip in the same process
    is a normal one."""
    src = str(tmp_path / "r.fastq")
    synth.write_fastq(src, 100 << 10, seed=5, block=500)
    z = src + ".gxz"
    cli.main(["zip", src, "-o", z, "--best", "--device", "cpu", "-q"])
    assert assign.get_mode() == "normal"
    ref_assign.set_mode("best")
    ref_zip.zip_file(src, src + ".ref.gxz")
    assert _read(z) == _read(src + ".ref.gxz")
    assert os.path.getsize(z) > 0
