"""The genozip_tpu_torch slice 2 end to end against genozip_tpu: FASTQ zip
against a reference (--reference, --REFERENCE), paired FASTQ (--pair, with
and without a reference), --optimize, unzip of both components, and cat
--r1/--r2/--interleave.

Inputs are cfg4-shaped (`synth.write_paired_fastq` off a repeat-family
genome) and made from numpy seeds. The port's rANS device threshold is
16 KiB on the CPU, so the VB sections and nested streams take the kernels'
plain PyTorch route; genozip_tpu runs with its device path off and on its
numpy host path (`genozip_tpu.native.available` patched to False), as the
port does everywhere. Parity is exact byte equality of archives and
outputs."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import native as ref_native
from genozip_tpu import cli as ref_cli, filters as ref_filters
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu_torch import cli, codecs, filters, piz_pipeline, synth
from genozip_tpu_torch import zip_pipeline
from genozip_tpu_torch.ref import refstore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VB = 256 << 10

# archive kind -> (paired?, zip keyword arguments; "REF" is the .ref.gxz)
KINDS = {
    "pair_ref": (True, {"reference": "REF"}),
    "pair_noref": (True, {}),
    "single_ref": (False, {"reference": "REF"}),
    "store_ref": (False, {"reference": "REF", "store_ref": True}),
    "optimize": (False, {"reference": "REF", "optimize": True}),
    "pair_optimize": (True, {"reference": "REF", "optimize": True}),
}


def _read(p):
    with open(p, "rb") as f:
        return f.read()


def _zip(port: bool, kind: str, d, out, threads=None):
    paired, kw = KINDS[kind]
    kw = {k: (str(d / "g.ref.gxz") if v == "REF" else v)
          for k, v in kw.items()}
    r1, r2 = str(d / "r1.fastq"), str(d / "r2.fastq")
    if port:
        codecs.enable_device_rans("cpu", min_size=16 << 10)
        try:
            if paired:
                zip_pipeline.zip_pair(r1, r2, out, vb_size=VB, threads=threads,
                                      **kw)
            else:
                zip_pipeline.zip_file(r1, out, vb_size=VB, threads=threads,
                                      **kw)
        finally:
            codecs.disable_device_rans()
    else:
        ref_codecs.disable_device_rans()
        if paired:
            ref_zip.zip_pair(r1, r2, out, vb_size=VB, **kw)
        else:
            ref_zip.zip_file(r1, out, vb_size=VB, **kw)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 512 Kbp genome, its .ref.gxz (a 2^18-slot refhash keeps loads
    quick) and ~2 x 600 KB of pairs off it, and every kind of archive
    written by both packages. Returns (dir, {kind: (port archive,
    reference archive)})."""
    d = tmp_path_factory.mktemp("pair")
    mp = pytest.MonkeyPatch()
    mp.setenv("GXZ_DEVICE_RANS", "0")
    mp.setenv("GXZ_NO_REF_CACHE", "1")
    mp.setattr(ref_native, "available", lambda: False)
    g = synth.genome(np.random.default_rng(41), 512 << 10)
    synth.write_fasta(str(d / "g.fa"), g)
    refstore.make_reference(str(d / "g.fa"), str(d / "g.ref.gxz"),
                            hash_bits=18)
    synth.write_paired_fastq(str(d / "r1.fastq"), str(d / "r2.fastq"), g,
                             600 << 10, seed=42, block=1000)
    arcs = {}
    try:
        for kind in KINDS:
            arcs[kind] = (str(d / f"{kind}.port.gxz"),
                          str(d / f"{kind}.jax.gxz"))
            _zip(True, kind, d, arcs[kind][0])
            _zip(False, kind, d, arcs[kind][1])
    finally:
        mp.undo()
    return d, arcs


@pytest.fixture(autouse=True)
def _no_ref_cache(monkeypatch):
    monkeypatch.setenv("GXZ_NO_REF_CACHE", "1")


def _want(d, kind):
    """The files an archive of `kind` decodes to."""
    paired, kw = KINDS[kind]
    outs = [_read(str(d / "r1.fastq"))]
    if paired:
        outs.append(_read(str(d / "r2.fastq")))
    if kw.get("optimize"):
        from genozip_tpu_torch.datatypes import get
        dt = get("fastq")()
        outs = [dt.optimize_vb(np.frombuffer(o, np.uint8).copy()).tobytes()
                for o in outs]
    return outs


def _decoded(out, paired):
    return [_read(out + ".1"), _read(out + ".2")] if paired else [_read(out)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_archive_equals_reference(data, kind):
    d, arcs = data
    port, jax = arcs[kind]
    assert _read(port) == _read(jax)


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_decodes_reference_archive(data, kind):
    d, arcs = data
    paired, kw = KINDS[kind]
    out = str(d / f"{kind}.by_port")
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        piz_pipeline.piz_file(arcs[kind][1], out,
                              reference=None if kind == "store_ref" or
                              "reference" not in kw else str(d / "g.ref.gxz"))
    finally:
        codecs.disable_device_rans()
    assert _decoded(out, paired) == _want(d, kind)


@pytest.mark.parametrize("kind", list(KINDS))
def test_reference_decodes_port_archive(data, kind):
    d, arcs = data
    paired, kw = KINDS[kind]
    out = str(d / f"{kind}.by_jax")
    ref_codecs.disable_device_rans()
    ref_piz.piz_file(arcs[kind][0], out,
                     reference=None if kind == "store_ref" or
                     "reference" not in kw else str(d / "g.ref.gxz"))
    assert _decoded(out, paired) == _want(d, kind)


@pytest.mark.parametrize("kind", ["pair_ref", "store_ref"])
def test_port_decodes_native_reference_archive(data, kind, tmp_path,
                                              monkeypatch):
    """Archives genozip_tpu wrote with its C++ host runtime (libdeflate
    ZLIB, an xxh64 digest per VB) decode through the port."""
    d, arcs = data
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    paired, kw = KINDS[kind]
    nat = str(tmp_path / f"{kind}.native.gxz")
    _zip(False, kind, d, nat)
    out = str(tmp_path / f"{kind}.out")
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        piz_pipeline.piz_file(nat, out, reference=None if kind == "store_ref"
                              else str(d / "g.ref.gxz"))
    finally:
        codecs.disable_device_rans()
    assert _decoded(out, paired) == _want(d, kind)


def test_reference_engages(data):
    """The aligner placed most reads, the R2 GPOS went in as a delta and
    some R2 sections were dropped as equal to R1's."""
    d, arcs = data
    pr = piz_pipeline.PizReader(arcs["pair_ref"][0], str(d / "g.ref.gxz"))
    try:
        h1, sec1, _ = pr.load_vb(1, 0)
        h2, sec2, _ = pr.load_vb(1, 1)
    finally:
        pr.close()
    aligned = sec1["SQBITMAP"]["local"][0]
    assert aligned.mean() > 0.9
    assert h2["meta"].get("gpos_pair_delta")
    assert any("pair" in cm for cm in h2["ctxs"].values())


def test_store_ref_archive_holds_the_reference(data):
    """--REFERENCE stores the genome ranges the reads used, and the port
    rebuilds the genome from them without a .ref file."""
    d, arcs = data
    assert os.path.getsize(arcs["store_ref"][0]) > \
        os.path.getsize(arcs["single_ref"][0])
    pr = piz_pipeline.PizReader(arcs["store_ref"][0])
    try:
        assert pr.file_hdr["ref_stored"]
        full = refstore.load_ref_file(str(d / "g.ref.gxz"), cache=False)
        got = pr.dt.ref
        assert got.length == full.length
        stored = got.codes != 0     # bases outside the stored ranges are 0
        assert stored.mean() > 0.5
        assert np.array_equal(got.codes[stored], full.codes[stored])
    finally:
        pr.close()


def test_threads_do_not_change_the_archive(data):
    """The same input gives the same archive at -@ 1 and -@ 8, paired and
    single."""
    d, arcs = data
    for kind in ("pair_ref", "single_ref"):
        outs = []
        for threads in (1, 8):
            out = str(d / f"{kind}.t{threads}.gxz")
            _zip(True, kind, d, out, threads=threads)
            outs.append(_read(out))
        assert outs[0] == outs[1] == _read(arcs[kind][1])


CAT_ARGS = [["--r1"], ["--r2"], ["--r2", "--head", "7"], ["--r1", "--tail", "5"],
            ["--r2", "--grep", "GATTACA"], ["--r2", "--downsample", "13"],
            ["--r1", "--seq-only", "--head", "4"]]


@pytest.mark.parametrize("kind", ["pair_ref", "pair_noref"])
@pytest.mark.parametrize("extra", CAT_ARGS, ids=[" ".join(a) for a in CAT_ARGS])
def test_cat_component_equals_reference(data, kind, extra):
    d, arcs = data
    ref = ["--reference", str(d / "g.ref.gxz")] if kind == "pair_ref" else []
    got, want = io.BytesIO(), io.BytesIO()
    filters.cat_filtered(cli.build_parser().parse_args(
        ["cat", arcs[kind][0], "--device", "cpu"] + ref + extra), got)
    ref_codecs.disable_device_rans()
    ref_filters.cat_filtered(ref_cli.build_parser().parse_args(
        ["cat", arcs[kind][0]] + ref + extra), want)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue() or "--grep" in extra


@pytest.mark.parametrize("kind", ["pair_ref", "pair_noref"])
def test_cat_interleave_equals_reference(data, kind):
    d, arcs = data
    ref = ["--reference", str(d / "g.ref.gxz")] if kind == "pair_ref" else []
    got, want = io.BytesIO(), io.BytesIO()
    filters.cat_filtered(cli.build_parser().parse_args(
        ["cat", arcs[kind][0], "--interleave", "--device", "cpu"] + ref), got)
    ref_codecs.disable_device_rans()
    ref_filters.cat_interleaved(ref_cli.build_parser().parse_args(
        ["cat", arcs[kind][0], "--interleave"] + ref), want)
    assert got.getvalue() == want.getvalue()
    r1, r2 = (_read(str(d / n)).splitlines(keepends=True)
              for n in ("r1.fastq", "r2.fastq"))
    pairs = [b"".join(r1[i:i + 4] + r2[i:i + 4]) for i in range(0, len(r1), 4)]
    assert got.getvalue() == b"".join(pairs)


@pytest.mark.parametrize("extra", [["--head", "11"], ["--tail", "3"],
                                   ["--downsample", "5"]])
def test_cat_interleave_takes_filters(data, extra):
    """genozip_tpu's --interleave ignores every filter and prints the whole
    file; the port applies them to the interleaved records."""
    d, arcs = data
    full, got = io.BytesIO(), io.BytesIO()
    base = ["cat", arcs["pair_noref"][0], "--interleave", "--device", "cpu"]
    filters.cat_filtered(cli.build_parser().parse_args(base), full)
    filters.cat_filtered(cli.build_parser().parse_args(base + extra), got)
    lines = full.getvalue().splitlines(keepends=True)
    recs = [b"".join(lines[i:i + 4]) for i in range(0, len(lines), 4)]
    k = int(extra[1])
    want = {"--head": recs[:k], "--tail": recs[-k:],
            "--downsample": recs[::k]}[extra[0]]
    assert got.getvalue() == b"".join(want)


def test_ls_equals_reference(data, capsys):
    d, arcs = data
    cli.main(["ls", arcs["pair_ref"][0], "--stats"])
    got = capsys.readouterr().out
    ref_cli.main(["ls", arcs["pair_ref"][0], "--stats"])
    assert got == capsys.readouterr().out


def test_missing_reference_is_a_clear_error(data):
    d, arcs = data
    with pytest.raises(ValueError, match="--reference g.ref.gxz"):
        piz_pipeline.piz_file(arcs["pair_ref"][0], str(d / "nope"))


@pytest.mark.parametrize("argv,match", [
    (["--pair", "--REFERENCE"], "not supported with --pair"),
    (["--pair"], "two FASTQ inputs"),
])
def test_zip_refusals(data, argv, match):
    d, arcs = data
    extra = [str(d / "r2.fastq")] if "--REFERENCE" in argv else []
    with pytest.raises(ValueError, match=match):
        cli.main(["zip", str(d / "r1.fastq")] + extra + argv +
                 ["--reference", str(d / "g.ref.gxz"), "--device", "cpu",
                  "-o", str(d / "refused.gxz")])
    codecs.disable_device_rans()


@pytest.mark.parametrize("flag", ["--r1", "--r2", "--interleave"])
def test_pair_filters_need_a_paired_archive(data, flag):
    d, arcs = data
    with pytest.raises(ValueError, match="needs a paired archive"):
        filters.cat_filtered(cli.build_parser().parse_args(
            ["cat", arcs["single_ref"][0], flag, "--reference",
             str(d / "g.ref.gxz")]), io.BytesIO())


def test_r2_out_of_step_is_refused(data, tmp_path):
    d, arcs = data
    short = tmp_path / "r2.fastq"
    short.write_bytes(b"".join(_read(str(d / "r2.fastq"))
                               .splitlines(keepends=True)[:-8]))
    with pytest.raises(ValueError, match="out of step"):
        zip_pipeline.zip_pair(str(d / "r1.fastq"), str(short),
                              str(tmp_path / "x.gxz"))


def test_cli_pair_never_loads_jax(data, tmp_path):
    """zip --pair --reference, unzip, cat and ls through the port's CLI in a
    fresh interpreter; jax is never imported."""
    d, arcs = data
    z, ref = str(tmp_path / "cli.gxz"), str(d / "g.ref.gxz")
    script = f"""
import sys
from genozip_tpu_torch.cli import main
main(["zip", {str(d / "r1.fastq")!r}, {str(d / "r2.fastq")!r}, "--pair",
      "--reference", {ref!r}, "-o", {z!r}, "--device", "cpu", "-q"])
main(["unzip", {z!r}, "-o", {z!r} + ".out", "--reference", {ref!r},
      "--device", "cpu"])
main(["cat", {z!r}, "--interleave", "--head", "2", "--reference", {ref!r},
      "--device", "cpu"])
main(["ls", {z!r}])
print("JAX_LOADED", "jax" in sys.modules)
"""
    env = {k: v for k, v in os.environ.items() if k != "GXZ_DEVICE_RANS"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=600)
    assert res.returncode == 0, res.stderr
    assert "JAX_LOADED False" in res.stdout
    assert _read(z + ".out.1") == _read(str(d / "r1.fastq"))
    assert _read(z + ".out.2") == _read(str(d / "r2.fastq"))


def test_r2_longer_than_r1_is_refused(data, tmp_path):
    d, arcs = data
    long2 = tmp_path / "r2.fastq"
    long2.write_bytes(_read(str(d / "r2.fastq")) + b"@extra/2\nACGT\n+\nFFFF\n")
    with pytest.raises(ValueError, match="more reads than R1"):
        zip_pipeline.zip_pair(str(d / "r1.fastq"), str(long2),
                              str(tmp_path / "x.gxz"))


def test_fast_reference_cli_archive_equals_reference(data, tmp_path,
                                                     monkeypatch):
    """zip --fast --reference through both CLIs: genozip_tpu's --fast sets
    aligner.NUM_SEEDS = 2, which align_batch's default argument never reads,
    so the aligner keeps four seeds there and here."""
    from genozip_tpu.codecs import assign as ref_assign
    from genozip_tpu.ref import aligner as ref_al
    from genozip_tpu_torch.codecs import assign
    d, arcs = data
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    monkeypatch.setattr(ref_native, "available", lambda: False)
    monkeypatch.setattr(ref_al, "NUM_SEEDS", ref_al.NUM_SEEDS)
    argv = ["zip", str(d / "r1.fastq"), "--fast", "-q",
            "--reference", str(d / "g.ref.gxz")]
    try:
        cli.main(argv + ["-o", str(tmp_path / "port.gxz"), "--device", "cpu"])
        ref_codecs.disable_device_rans()
        ref_cli.main(argv + ["-o", str(tmp_path / "jax.gxz")])
    finally:
        codecs.disable_device_rans()
        assign.set_mode("normal")
        ref_assign.set_mode("normal")
    assert _read(str(tmp_path / "port.gxz")) == _read(str(tmp_path / "jax.gxz"))
