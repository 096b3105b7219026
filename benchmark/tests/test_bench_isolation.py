"""Nothing the benchmark runs on the card loads JAX or genozip_tpu, and the
plain reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "genozip_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    base = os.path.join(harness.BENCH, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_genozip_tpu():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".", 1)[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("ref"):
        for name in _imports(path):
            assert name.split(".", 1)[0] in {"numpy", "zlib"}, (path, name)


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "genozip_tpu_torch_fake", sys)
    assert "genozip_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "genozip_tpu.fake", sys)
    assert "genozip_tpu" in harness.forbidden_modules()


def test_harness_and_program_load_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, taps, trace, sink, roofline\n"
        "from benchmark.ops import zip, unzip\n"
        "from benchmark.gen import fastq, bam\n"
        "from benchmark.ref import judge\n"
        "import genozip_tpu_torch.zip_pipeline\n"
        "import genozip_tpu_torch.piz_pipeline\n"
        "for m in harness.manifest()['per_layer']:\n"
        "    harness.metric_reader(m['name'])\n"
        "print(harness.forbidden_modules())\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=dict(
                             os.environ, USE_FLAX="0")).stdout
    assert out.strip() == "[]"
