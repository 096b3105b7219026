"""genozip_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports the JAX package genozip_tpu (or jax, or the
`cryptography` package that genozip_tpu's encryption may use), at the top
of a file or inside a function; and a run of the port's commands in a
fresh interpreter leaves no `genozip_tpu` or `genozip_tpu.*` module, no
`jax` and no `cryptography` in sys.modules, and maps the port's own host
runtime (genozip_tpu_torch/build/libgxz_host.so) and neither genozip_tpu's
(genozip_tpu/native/libgxz.so) nor any libdeflate. The SAM/BAM modules
(sag, translate, datatypes/sam, sam_tags, bam), those of deep, bamass,
coverage and regions, the VCF, PBWT and text datatype modules, and crypt,
the AES binding, the BWT codec, biopsy and stream, the multi-device
modules (parallel/) and the seed aligner's binding are among the files
walked, and SAM/BAM, --deep, --bamass, VCF, `cat --vcf`, translation,
--password, --best, --dp, --mesh and --hosts commands among the runs (a
--hosts run starts its worker processes through a wrapper that reports
what each loaded); on a card, SAM and BAM archives from `--device cuda`
equal the cpu ones."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from genozip_tpu_torch import synth, zip_pipeline, codecs
from genozip_tpu_torch.ref import refstore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "genozip_tpu_torch")
SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")) + \
    ["chip_smoke.py"]
FORBIDDEN = ("genozip_tpu", "jax", "cryptography")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(tree):
    """Every module name an import statement, importlib.import_module or
    __import__ with a literal name brings in."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def test_sources_found():
    assert len(SOURCES) > 25 and "genozip_tpu_torch/cli.py" in SOURCES
    for m in ("sag.py", "translate.py", "datatypes/sam.py",
              "datatypes/sam_tags.py", "datatypes/bam.py", "deep.py",
              "bamass.py", "coverage.py", "regions.py", "datatypes/vcf.py",
              "ops/pbwt.py", "datatypes/tabular.py", "datatypes/gff.py",
              "datatypes/fasta.py", "datatypes/generic.py", "crypt.py",
              "ops/aes_cuda.py", "ops/aes_torch.py", "codecs/bwt.py",
              "biopsy.py", "stream.py", "parallel/__init__.py",
              "parallel/zip_sharded.py", "parallel/piz_sharded.py",
              "parallel/aligner_sharded.py", "parallel/mesh_aligner.py",
              "parallel/multihost.py", "parallel/flagship.py",
              "ops/align_cuda.py", "ops/align_torch.py",
              "native/__init__.py", "ops/arith_cuda.py",
              "ops/arith_torch.py", "ops/pbwt_cuda.py",
              "ops/pbwt_torch.py"):
        assert f"genozip_tpu_torch/{m}" in SOURCES


@pytest.mark.parametrize("path", SOURCES)
def test_no_import_of_the_jax_package(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _imports(tree) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A small cfg3-shaped FASTQ, a genome with its .ref.gxz and pairs off
    it, and the port's archives of both (written in this process)."""
    d = tmp_path_factory.mktemp("iso")
    synth.write_fastq(str(d / "r.fastq"), 300 << 10, seed=3, block=1000)
    g = synth.genome(np.random.default_rng(5), 256 << 10)
    synth.write_fasta(str(d / "g.fa"), g)
    refstore.make_reference(str(d / "g.fa"), str(d / "g.ref.gxz"),
                            hash_bits=16)
    synth.write_paired_fastq(str(d / "r1.fastq"), str(d / "r2.fastq"), g,
                             200 << 10, seed=6, block=1000)
    kw = dict(seed=4, genome_len=1 << 20, window_reads=1500)
    synth.write_bam(str(d / "a.bam"), 200 << 10, **kw)
    synth.write_sam(str(d / "a.sam"), 300 << 10, **kw)
    synth.write_vcf(str(d / "v.vcf"), 200 << 10, seed=7, samples=20)
    synth.write_me23(str(d / "m.txt"), 100 << 10, seed=8)
    synth.write_fasta(str(d / "chr1.fa"), g, names=[b"chr1"])
    refstore.make_reference(str(d / "chr1.fa"), str(d / "c1.ref.gxz"),
                            hash_bits=14)
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        zip_pipeline.zip_file(str(d / "a.bam"), str(d / "b.gxz"))
        zip_pipeline.zip_file(str(d / "r.fastq"), str(d / "r.gxz"))
        zip_pipeline.zip_pair(str(d / "r1.fastq"), str(d / "r2.fastq"),
                              str(d / "p.gxz"), reference=str(d / "g.ref.gxz"))
        zip_pipeline.zip_file(str(d / "a.sam"), str(d / "s.gxz"))
        zip_pipeline.zip_deep(str(d / "a.bam"), [str(d / "r1.fastq")],
                              str(d / "d.gxz"))
        zip_pipeline.zip_file(str(d / "v.vcf"), str(d / "v.gxz"))
        zip_pipeline.zip_file(str(d / "m.txt"), str(d / "m.gxz"))
        zip_pipeline.zip_file(str(d / "r.fastq"), str(d / "e.gxz"),
                              password="pw", use_md5=True)
    finally:
        codecs.disable_device_rans()
    return d


# each case: one command of the port's CLI, run alone in a fresh interpreter
RUNS = {
    "zip": ["zip", "{d}/r.fastq", "-o", "{t}/z.gxz", "--device", "cpu", "-q"],
    "unzip": ["unzip", "{d}/r.gxz", "-o", "{t}/r.out", "--device", "cpu"],
    "cat": ["cat", "{d}/r.gxz", "--head", "3", "--device", "cpu"],
    "ls": ["ls", "{d}/r.gxz", "--stats"],
    "zip_pair_reference": ["zip", "{d}/r1.fastq", "{d}/r2.fastq", "--pair",
                           "--reference", "{d}/g.ref.gxz", "-o", "{t}/p.gxz",
                           "--device", "cpu", "-q"],
    "unzip_pair_reference": ["unzip", "{d}/p.gxz", "--reference",
                             "{d}/g.ref.gxz", "-o", "{t}/p.out", "--device",
                             "cpu"],
    "zip_sam_gencomp": ["zip", "{d}/a.sam", "-o", "{t}/s.gxz", "--device",
                        "cpu", "-q"],
    "unzip_bam": ["unzip", "{d}/b.gxz", "-o", "{t}/b.bam", "--device", "cpu"],
    "zip_deep": ["zip", "{d}/a.bam", "{d}/r1.fastq", "--deep", "-o",
                 "{t}/d.gxz", "--device", "cpu", "-q"],
    "unzip_deep": ["unzip", "{d}/d.gxz", "-o", "{t}/d.out", "--device",
                   "cpu"],
    "zip_bamass": ["zip", "{d}/r1.fastq", "--reference", "{d}/g.ref.gxz",
                   "--bamass", "{d}/a.bam", "-o", "{t}/ba.gxz", "--device",
                   "cpu", "-q"],
    "cat_sam": ["cat", "{d}/b.gxz", "--sam", "-o", "{t}/b.sam", "--device",
                "cpu"],
    "cat_bam_index": ["cat", "{d}/s.gxz", "--bam", "--index", "-o",
                      "{t}/s.bam", "--device", "cpu"],
    "cat_idxstats": ["cat", "{d}/b.gxz", "--idxstats", "--device", "cpu"],
    "cat_regions_count": ["cat", "{d}/s.gxz", "-r", "chr1:1-100000",
                          "--count", "--device", "cpu"],
    "zip_vcf": ["zip", "{d}/v.vcf", "-o", "{t}/v.gxz", "--device", "cpu",
                "-q"],
    "unzip_vcf": ["unzip", "{d}/v.gxz", "-o", "{t}/v.vcf", "--device", "cpu"],
    "cat_vcf": ["cat", "{d}/m.gxz", "--vcf", "--reference", "{d}/c1.ref.gxz",
                "-o", "{t}/m.vcf", "--device", "cpu"],
    "zip_password_md5": ["zip", "{d}/r.fastq", "-o", "{t}/e.gxz",
                         "--password", "pw", "--md5", "--device", "cpu",
                         "-q"],
    "unzip_password": ["unzip", "{d}/e.gxz", "-o", "{t}/r.out", "--password",
                       "pw", "--device", "cpu"],
    "cat_password": ["cat", "{d}/e.gxz", "--head", "3", "--password", "pw",
                     "--device", "cpu"],
    "zip_best": ["zip", "{d}/v.vcf", "-o", "{t}/b.gxz", "--best", "--device",
                 "cpu", "-q"],
    "zip_dp": ["zip", "{d}/r.fastq", "-o", "{t}/dp.gxz", "--dp", "2",
               "--device", "cpu", "-q"],
    "zip_mesh_reference": ["zip", "{d}/r1.fastq", "--reference",
                           "{d}/g.ref.gxz", "--mesh", "1", "-o",
                           "{t}/mesh.gxz", "--device", "cpu", "-q"],
    "zip_hosts": ["zip", "{d}/r.fastq", "-o", "{t}/h.gxz", "--hosts", "2",
                  "--device", "cpu", "-q"],
}
# a --hosts run starts its workers through this wrapper, which reports what
# each worker process loaded
WORKER = """
import json, runpy, sys
sys.argv = ["multihost"] + sys.argv[1:]
try:
    runpy.run_module("genozip_tpu_torch.parallel.multihost",
                     run_name="__main__", alter_sys=True)
finally:
    print("WORKER", json.dumps(sorted(
        k for k in sys.modules if k.split(".")[0] in
        ("jax", "genozip_tpu", "cryptography"))), flush=True)
    with open("/proc/self/maps") as f:
        print("WORKERLIBS", json.dumps(sorted(
            {ln.split()[-1] for ln in f if "libgxz" in ln
             or "libdeflate" in ln})), flush=True)
"""
SCRIPT = """
import json, sys
from genozip_tpu_torch.cli import main
argv = json.loads(sys.argv[1])
if "--hosts" in argv:
    from genozip_tpu_torch.parallel import multihost
    Popen = multihost.subprocess.Popen
    def wrapped(cmd, **kw):
        assert cmd[1:3] == ["-m", "genozip_tpu_torch.parallel.multihost"]
        return Popen([cmd[0], "-c", sys.argv[2]] + cmd[3:], **kw)
    multihost.subprocess.Popen = wrapped
rc = main(argv)
loaded = sorted(k for k in sys.modules if k.split(".")[0] in
                ("jax", "genozip_tpu", "cryptography"))
with open("/proc/self/maps") as f:
    libs = sorted({ln.split()[-1] for ln in f if "libgxz" in ln
                   or "libdeflate" in ln})
print("RESULT", json.dumps({"rc": rc, "loaded": loaded, "libs": libs}))
"""
HOST_LIB = os.path.realpath(os.path.join(PORT, "build", "libgxz_host.so"))
# commands that may end without a call into the host runtime (a --hosts
# run's workers call it, each checked on its own)
NO_HOST_CALL = {"ls", "zip_hosts"}


@pytest.mark.parametrize("case", list(RUNS))
def test_a_run_loads_no_jax_module(inputs, case, tmp_path):
    argv = [a.format(d=inputs, t=tmp_path) for a in RUNS[case]]
    env = {k: v for k, v in os.environ.items() if k != "GXZ_DEVICE_RANS"}
    env.update(PYTHONPATH=ROOT, GXZ_NO_REF_CACHE="1")
    res = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(argv),
                          WORKER],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")]
    got = json.loads(line[-1][len("RESULT "):])
    libs = got.pop("libs")
    assert got == {"rc": 0, "loaded": []}
    assert libs == [HOST_LIB] or (case in NO_HOST_CALL and libs == [])
    workers = [x for x in res.stdout.splitlines() if x.startswith("WORKER ")]
    assert workers == (["WORKER []"] * 2 if case == "zip_hosts" else [])
    wlibs = [json.loads(x[len("WORKERLIBS "):]) for x in
             res.stdout.splitlines() if x.startswith("WORKERLIBS ")]
    assert wlibs == ([[HOST_LIB]] * 2 if case == "zip_hosts" else [])
    if case in ("zip_dp", "zip_hosts"):
        out = "dp.gxz" if case == "zip_dp" else "h.gxz"
        with open(tmp_path / out, "rb") as a, open(inputs / "r.gxz", "rb") as b:
            assert a.read() == b.read()
    if case in ("unzip", "unzip_password"):
        with open(tmp_path / "r.out", "rb") as a, \
                open(inputs / "r.fastq", "rb") as b:
            assert a.read() == b.read()
    if case == "unzip_vcf":
        with open(tmp_path / "v.vcf", "rb") as a, \
                open(inputs / "v.vcf", "rb") as b:
            assert a.read() == b.read()
    if case == "cat_vcf":
        with open(tmp_path / "m.vcf", "rb") as a:
            assert a.read().count(b"\trs") > 1000
    if case == "unzip_bam":
        with open(tmp_path / "b.bam", "rb") as a, \
                open(inputs / "a.bam", "rb") as b:
            assert a.read() == b.read()
    if case == "unzip_deep":
        with open(tmp_path / "d.out.2", "rb") as a, \
                open(inputs / "r1.fastq", "rb") as b:
            assert a.read() == b.read()
    if case == "unzip_pair_reference":
        for i in (1, 2):
            with open(tmp_path / f"p.out.{i}", "rb") as a, \
                    open(inputs / f"r{i}.fastq", "rb") as b:
                assert a.read() == b.read()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["a.sam", "a.bam"])
def test_sam_bam_cuda_archive_equals_cpu(inputs, name, tmp_path):
    """A SAM and a BAM zipped with --device cuda are the bytes of their
    --device cpu archives, and unzip on the card gives the input back."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from genozip_tpu_torch import piz_pipeline
    src = str(inputs / name)
    outs = {}
    for dev in ("cpu", "cuda"):
        codecs.enable_device_rans(dev, min_size=16 << 10)
        try:
            z = str(tmp_path / f"{dev}.gxz")
            zip_pipeline.zip_file(src, z)
            out = str(tmp_path / f"{dev}.out{os.path.splitext(name)[1]}")
            piz_pipeline.piz_file(z, out)
        finally:
            codecs.disable_device_rans()
        with open(z, "rb") as f, open(out, "rb") as g:
            outs[dev] = (f.read(), g.read())
    with open(src, "rb") as f:
        assert outs["cuda"][1] == f.read()
    assert outs["cuda"] == outs["cpu"]
