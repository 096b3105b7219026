"""The genozip_tpu_torch slice end to end against genozip_tpu: single-end
FASTQ zip, unzip, cat and ls.

The port's rANS device threshold is lowered to 16 KiB on the CPU, so the
VB sections and the nested SEQ and QUAL streams take the kernels' plain
PyTorch route; the reference runs with its device path off and on its numpy
host path (`genozip_tpu.native.available` patched to False), the host path
the port takes everywhere. Parity is exact byte equality of archives and
outputs. The port also decodes archives that genozip_tpu wrote with its C++
host runtime (ZLIB through libdeflate, an xxh64 digest per VB)."""

import io
import os
import subprocess
import sys

import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import native as ref_native
from genozip_tpu import cli as ref_cli, filters as ref_filters
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu_torch import cli, codecs, filters, piz_pipeline, synth
from genozip_tpu_torch import zip_pipeline
from genozip_tpu_torch.codecs import assign as codec_assign
from genozip_tpu_torch.ops import rans_cuda, rans_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "backcomp")
VB = 256 << 10


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """A ~2 MB cfg3-shaped FASTQ zipped by both packages. Returns (dir,
    fastq, port archive, reference archive, plain-route calls)."""
    d = tmp_path_factory.mktemp("slice")
    fq = str(d / "reads.fastq")
    synth.write_fastq(fq, 2 << 20, seed=7, block=2000)
    mp = pytest.MonkeyPatch()
    calls = []
    orig = rans_torch.encode_plain
    mp.setattr(rans_torch, "encode_plain",
               lambda *a, **k: calls.append(1) or orig(*a, **k))
    mp.setenv("GXZ_DEVICE_RANS", "0")
    mp.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        zip_pipeline.zip_file(fq, str(d / "port.gxz"), vb_size=VB)
        ref_zip.zip_file(fq, str(d / "ref.gxz"), vb_size=VB)
    finally:
        codecs.disable_device_rans()
        mp.undo()
    return d, fq, str(d / "port.gxz"), str(d / "ref.gxz"), len(calls)


@pytest.fixture
def device_route():
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    yield
    codecs.disable_device_rans()


def test_archive_equals_reference(archives):
    d, fq, port, ref, n_plain = archives
    assert n_plain > 0, "the plain-torch route was never taken"
    assert _read(port) == _read(ref)


def test_fast_mode_archive_equals_reference(archives, device_route,
                                            monkeypatch):
    """zip --fast (fewer codec trials) writes the reference's bytes too."""
    from genozip_tpu.codecs import assign as ref_assign
    from genozip_tpu_torch.codecs import assign
    d, fq, port, ref, _ = archives
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    try:
        assign.set_mode("fast")
        ref_assign.set_mode("fast")
        zip_pipeline.zip_file(fq, str(d / "fast_port.gxz"), vb_size=VB)
        ref_zip.zip_file(fq, str(d / "fast_ref.gxz"), vb_size=VB)
    finally:
        assign.set_mode("normal")
        ref_assign.set_mode("normal")
    assert _read(str(d / "fast_port.gxz")) == _read(str(d / "fast_ref.gxz"))


def test_reference_decodes_port_archive(archives):
    d, fq, port, ref, _ = archives
    ref_codecs.disable_device_rans()
    ref_piz.piz_file(port, str(d / "by_ref.fastq"))
    assert _read(str(d / "by_ref.fastq")) == _read(fq)


def test_port_decodes_reference_archive(archives, device_route):
    d, fq, port, ref, _ = archives
    piz_pipeline.piz_file(ref, str(d / "by_port.fastq"))
    assert _read(str(d / "by_port.fastq")) == _read(fq)


def test_port_decodes_native_reference_archive(archives, device_route,
                                              monkeypatch):
    """An archive genozip_tpu wrote with its C++ host runtime: its ZLIB
    sections come from libdeflate and its VB headers carry an xxh64 digest
    the port cannot compute, so the port checks adler32 instead."""
    d, fq, port, ref, _ = archives
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    ref_codecs.disable_device_rans()
    nat = str(d / "native.gxz")
    ref_zip.zip_file(fq, nat, vb_size=VB)
    pr = piz_pipeline.PizReader(nat)
    try:
        has_x64 = "x64" in pr.load_vb(1)[0]
    finally:
        pr.close()
    assert has_x64 == ref_native.available()
    piz_pipeline.piz_file(nat, str(d / "native.by_port"))
    assert _read(str(d / "native.by_port")) == _read(fq)


def test_port_decodes_r4_fixture(tmp_path, device_route):
    out = str(tmp_path / "r4.out")
    piz_pipeline.piz_file(os.path.join(FIX, "r4.fastq.gxz"), out)
    assert _read(out) == _read(os.path.join(FIX, "r4.fastq"))


CAT_ARGS = [["--head", "7"], ["--tail", "5"], ["--grep", "SRR"],
            ["--downsample", "97"], ["--grep", "AC", "--downsample", "3"],
            ["--seq-only", "--head", "20"], ["--qual-only", "--tail", "3"],
            ["--one-vb", "3"], ["--header-only"]]


@pytest.mark.parametrize("extra", CAT_ARGS, ids=[" ".join(a) for a in CAT_ARGS])
def test_cat_equals_reference(archives, extra, device_route):
    d, fq, port, ref, _ = archives
    ref_codecs.disable_device_rans()
    got, want = io.BytesIO(), io.BytesIO()
    filters.cat_filtered(cli.build_parser().parse_args(
        ["cat", port, "--device", "cpu"] + extra), got)
    ref_filters.cat_filtered(ref_cli.build_parser().parse_args(
        ["cat", port] + extra), want)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue() or extra == ["--header-only"]


def test_ls_equals_reference(archives, capsys):
    d, fq, port, ref, _ = archives
    cli.main(["ls", port, "--stats"])
    got = capsys.readouterr().out
    ref_cli.main(["ls", port, "--stats"])
    assert got == capsys.readouterr().out


def test_cli_never_loads_jax(archives, tmp_path):
    """zip, unzip, cat and ls through the port's CLI in a fresh interpreter;
    jax must never be imported."""
    d, fq, port, ref, _ = archives
    z = str(tmp_path / "cli.gxz")
    script = f"""
import sys
from genozip_tpu_torch.cli import main
main(["zip", {fq!r}, "-o", {z!r}, "--device", "cpu", "-q"])
main(["unzip", {z!r}, "-o", {z!r} + ".out", "--device", "cpu"])
main(["cat", {z!r}, "--head", "3", "--device", "cpu"])
main(["ls", {z!r}])
print("JAX_LOADED", "jax" in sys.modules)
"""
    env = {k: v for k, v in os.environ.items() if k != "GXZ_DEVICE_RANS"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JAX_LOADED False" in res.stdout
    assert _read(z + ".out") == _read(fq)


def test_device_cuda_without_gpu_raises(archives):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    d, fq, port, ref, _ = archives
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["unzip", port, "-o", str(d / "x.out"), "--device", "cuda"])
    codecs.disable_device_rans()


@pytest.mark.parametrize("flag", [["--deep"], ["--bamass", "a.bam"],
                                  ["r2.fastq"],
                                  ["--deep", "--reference", "g.ref.gxz"]])
def test_unported_zip_options_raise(archives, flag):
    """More than one input without --pair, --deep or --tar (genozip_tpu
    zips the first and ignores the rest), --deep without its FASTQ inputs
    and --bamass without --reference are refused before anything is
    read."""
    d, fq, port, ref, _ = archives
    want = {"--deep": (ValueError, "needs a BAM plus FASTQ"),
            "--bamass": (ValueError, "needs --reference"),
            "r2.fastq": (ValueError, "needs --pair, --deep or --tar")
            }[flag[0]]
    with pytest.raises(want[0], match=want[1]):
        cli.main(["zip", fq, "-o", str(d / "no.gxz"), "--device", "cpu"] + flag)
    codecs.disable_device_rans()


def test_unported_datatype_raises(tmp_path):
    """Every datatype of genozip_tpu is ported (a VCF zips and unzips); a
    datatype that neither package knows is refused."""
    p = tmp_path / "x.vcf"
    p.write_bytes(b"##fileformat=VCFv4.2\n#CHROM\tPOS\n1\t5\n")
    zip_pipeline.zip_file(str(p), str(tmp_path / "x.gxz"))
    piz_pipeline.piz_file(str(tmp_path / "x.gxz"), str(tmp_path / "x.out"))
    assert _read(tmp_path / "x.out") == _read(p)
    with pytest.raises(ValueError, match="unknown datatype 'bcf'"):
        zip_pipeline.zip_file(str(p), str(tmp_path / "y.gxz"), dt_name="bcf")


def _broken(*a, **k):
    raise rans_cuda.DeviceKernelError("launch failed")


def _seg_sample(fq):
    """Seg the first 1 MiB of `fq` as zip's calibration does."""
    import numpy as np
    from genozip_tpu_torch.datatypes import get
    data = np.frombuffer(_read(fq)[:1 << 20], np.uint8)
    dt = get("fastq")()
    dt.segconf_scan(data[:64 << 10])
    return dt.seg_vb(data[:dt.vb_boundary(data, False)].copy())


@pytest.mark.parametrize("site", ["zip", "unzip", "assign", "precompress"])
def test_kernel_failure_is_not_swallowed(archives, device_route, monkeypatch,
                                         site):
    """A failing kernel route stops the run: codec trials, calibration and
    worker-side compression do not drop the codec and carry on with host
    coders."""
    d, fq, port, ref, _ = archives
    if site == "precompress":
        job = zip_pipeline.ZipJob(str(d / "pre.gxz"))
        res = _seg_sample(fq)
        job.precommit_codecs(res)       # commits codecs on a working route
        job.out.close()
    monkeypatch.setattr(rans_cuda, "_decode" if site == "unzip" else "_encode",
                        _broken)
    with pytest.raises(rans_cuda.DeviceKernelError, match="launch failed"):
        if site == "zip":
            zip_pipeline.zip_file(fq, str(d / "broken.gxz"), vb_size=VB)
        elif site == "unzip":
            piz_pipeline.piz_file(port, str(d / "broken.out"))
        elif site == "assign":
            codec_assign.assign_best(_read(fq)[:1 << 20], "qual")
        else:
            job.precompress_locals(res)
