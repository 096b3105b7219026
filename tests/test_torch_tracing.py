"""The port's spans and counters (genozip_tpu_torch/utils/profiler.py): off,
they keep nothing; on, a zip and an unzip give each VB its chain of spans
under one VB id, the rANS calls' steps inside their call, every parent on
record; `--trace-out` writes one Chrome trace on one clock; the
benchmark's span metrics read them. The `cuda` test runs on a card."""

import ast
import collections
import json
import os
import pathlib
import time

import pytest

from genozip_tpu_torch import cli, codecs, synth
from genozip_tpu_torch.piz_pipeline import piz_file
from genozip_tpu_torch.utils import profiler
from genozip_tpu_torch.zip_pipeline import zip_file

PKG = pathlib.Path(__file__).resolve().parent.parent / "genozip_tpu_torch"
VB = 256 << 10
RANS_STEPS = ("rans:prepare", "rans:h2d", "rans:kernel", "rans:d2h",
              "rans:finish")
ZIP_CHAIN = ("zip:read", "zip:seg", "zip:compress-local", "zip:seg-wait",
             "zip:merge+write")
PIZ_CHAIN = ("piz:io-wait", "piz:read+uncompress", "piz:recon",
             "piz:drain")


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A 2 MB FASTQ zipped and unzipped on the CPU with the device route's
    threshold low enough that `rans_cuda`'s batched calls run, each under a
    recording. Returns (zip recording, unzip recording)."""
    d = tmp_path_factory.mktemp("tracing")
    fq = str(d / "reads.fastq")
    synth.write_fastq(fq, 2 << 20, seed=11, block=2000)
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    try:
        with profiler.recording() as rz:
            zip_file(fq, str(d / "r.gxz"), vb_size=VB, threads=4)
        with profiler.recording() as ru:
            piz_file(str(d / "r.gxz"), str(d / "r.out"))
    finally:
        codecs.disable_device_rans()
    assert (d / "r.out").read_bytes() == pathlib.Path(fq).read_bytes()
    return rz, ru


def _by_vb(rec):
    out = collections.defaultdict(list)
    for s in rec.spans:
        if s.vb is not None:
            out[(s.comp, s.vb)].append(s)
    return out


def test_off_keeps_no_span_and_no_counter():
    assert profiler._rec is None
    before = profiler.snapshot()
    for _ in range(3):
        with profiler.timer("test:off"):
            pass
    profiler.count("test:off-counter", 5)
    after = profiler.snapshot()
    assert after["counters"] == before["counters"]
    assert "test:off-counter" not in profiler._counters
    assert after["counts"]["test:off"] == before["counts"].get(
        "test:off", 0) + 3
    assert after["totals"]["test:off"] >= before["totals"].get(
        "test:off", 0.0)
    assert not getattr(profiler._tls, "stack", [])
    with profiler.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {} and rec.samples == []


def test_recording_counts_and_bounds():
    with profiler.recording(max_spans=2) as rec:
        for _ in range(5):
            with profiler.timer("test:on"):
                profiler.count("test:on-counter", 2)
    assert len(rec.spans) == 2 and rec.dropped == 3 + 3
    assert rec.counters["test:on-counter"] == 10
    assert rec.counters[profiler.DROPPED] == 6
    a, b = [v for _, _, v in rec.samples]
    assert b - a == 2
    assert not getattr(profiler._tls, "stack", [])


def test_counters_and_spans_lose_nothing_across_threads():
    """More threads than cores, switching often: every count and span
    lands."""
    import sys
    import threading
    n_threads, n = 4 * (os.cpu_count() or 2), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiler.recording() as rec:
            def work():
                for _ in range(n):
                    with profiler.timer("test:stress"):
                        profiler.count("test:stress")
            ts = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert rec.counters["test:stress"] == n_threads * n
    assert sum(s.name == "test:stress" for s in rec.spans) == n_threads * n
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    assert all(s.parent == 0 for s in rec.spans)


def test_bound_task_takes_the_submitting_span():
    from concurrent.futures import ThreadPoolExecutor

    def task():
        with profiler.timer("test:task"):
            pass

    with profiler.recording() as rec, ThreadPoolExecutor(2) as pool:
        with profiler.file(), profiler.timer("test:root"):
            with profiler.vb(0, 7):
                pool.submit(profiler.bind(task)).result()
            pool.submit(task).result()
    root = next(s for s in rec.spans if s.name == "test:root")
    bound, plain = [s for s in rec.spans if s.name == "test:task"]
    assert (root.file, root.comp, root.vb) == (root.file, None, None)
    assert bound.parent == root.id and bound.thread != root.thread
    assert (bound.file, bound.comp, bound.vb) == (root.file, 0, 7)
    assert plain.parent == 0 and plain.file is None


def test_zip_spans_chain_each_vb(recorded):
    rz, _ = recorded
    spans = rz.spans
    ids = {s.id: s for s in spans}
    assert all(s.parent == 0 or s.parent in ids for s in spans)
    root = [s for s in spans if s.name == "zip:file"]
    assert len(root) == 1 and root[0].parent == 0
    assert {s.file for s in spans} == {root[0].file}
    vbs = _by_vb(rz)
    assert len(vbs) >= 4
    for (comp, vb), ss in vbs.items():
        names = {s.name for s in ss}
        if "zip:seg" in names:
            assert set(ZIP_CHAIN) <= names, (vb, names)
    assert any("rans:encode-many" in {s.name for s in ss}
               for ss in vbs.values())
    for name in ("zip:open", "zip:codec-commit", "zip:global-area"):
        assert any(s.name == name for s in spans), name
    _check_rans_children(spans, "rans:encode-many")
    n_calls = sum(s.name == "rans:encode-many" for s in spans)
    c = rz.counters
    assert c["rans:enc.card.calls"] == n_calls > 0
    assert c["rans:enc.card.bytes"] == c.get("rans:enc.o0.symbols", 0) + \
        c.get("rans:enc.o1.symbols", 0)
    assert c["rans:enc.card.streams"] >= n_calls
    assert c["rans:enc.host.streams"] > 0 and c["rans:enc.host.bytes"] > 0
    assert "rans:enc.h2d_bytes" not in c     # the CPU: nothing copied


def test_unzip_spans_chain_each_vb(recorded):
    _, ru = recorded
    spans = ru.spans
    ids = {s.id: s for s in spans}
    assert all(s.parent == 0 or s.parent in ids for s in spans)
    root = [s for s in spans if s.name == "piz:file"]
    assert len(root) == 1 and {s.file for s in spans} == {root[0].file}
    assert any(s.name == "piz:open" for s in spans)
    vbs = _by_vb(ru)
    assert len(vbs) >= 4
    for (comp, vb), ss in vbs.items():
        assert set(PIZ_CHAIN) <= {s.name for s in ss}, vb
    # a worker's first span was caused by the span that submitted it
    for s in spans:
        if s.name == "piz:io-wait":
            assert ids[s.parent].name == "piz:file"
    _check_rans_children(spans, "rans:decode-many")
    assert ru.counters["rans:dec.card.calls"] == sum(
        s.name == "rans:decode-many" for s in spans) > 0


def _check_rans_children(spans, call):
    ids = {s.id: s for s in spans}
    calls = [s for s in spans if s.name == call]
    kids = [s for s in spans if s.name in RANS_STEPS]
    assert len(kids) == len(RANS_STEPS) * len(calls)
    for k in kids:
        p = ids[k.parent]
        assert p.name == call
        assert p.start_ns <= k.start_ns <= k.end_ns <= p.end_ns
        assert (p.file, p.comp, p.vb) == (k.file, k.comp, k.vb)


def _timer_calls(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "timer" and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "profiler":
            yield node


def test_every_timer_call_site_takes_one_positional_argument():
    """The benchmark swaps `profiler.timer` for a one-argument wrapper
    while it traces; a keyword or a locally bound `timer` would break or
    hide a call site."""
    n = 0
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and \
                    (node.module or "").endswith("profiler"):
                assert "timer" not in [a.name for a in node.names], path
        for call in _timer_calls(tree):
            n += 1
            where = f"{path.relative_to(PKG)}:{call.lineno}"
            assert len(call.args) == 1 and not call.keywords, where
            assert not isinstance(call.args[0], ast.Starred), where
    assert n >= 40


def test_anchor_places_a_span_on_the_profile_clock():
    from torch.profiler import ProfilerActivity, profile, record_function
    anchors = []
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiler.recording() as rec:
        anchors.append(profiler.anchor())
        for _ in range(3):
            with profiler.timer("test:block"):
                with record_function("test.block"):
                    time.sleep(0.01)
        anchors.append(profiler.anchor())
    to_us = profiler.clock_map(prof, anchors)
    evs = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.name == "test.block")
    spans = sorted((to_us(s.start_ns), to_us(s.end_ns))
                   for s in rec.spans if s.name == "test:block")
    assert len(evs) == len(spans) == 3
    for (es, ee), (ss, se) in zip(evs, spans):
        # the block lies inside its span, their middles within 50 us
        assert ss - 50 <= es and ee <= se + 50, (es, ss, ee, se)
        assert abs((es + ee) / 2 - (ss + se) / 2) < 50, (es, ss, ee, se)


def test_trace_out_writes_one_chrome_trace(tmp_path, capsys):
    fq = str(tmp_path / "r.fastq")
    synth.write_fastq(fq, 1 << 20, seed=5, block=2000)
    tr = tmp_path / "zip.json"
    try:
        cli.main(["zip", fq, "-o", str(tmp_path / "r.gxz"), "--device",
                  "cpu", "--vblock", "1", "--trace-out", str(tr), "-q"])
        cli.main(["unzip", str(tmp_path / "r.gxz"), "-o",
                  str(tmp_path / "r.out"), "--device", "cpu",
                  "--show-time"])
    finally:
        codecs.disable_device_rans()
    out = capsys.readouterr().out
    assert "TOTAL (sum of regions)" in out and "rans:dec.host.streams" in out
    assert out.index("TOTAL (sum of regions)") < out.index("counter")
    t = json.loads(tr.read_text())
    ev = t["traceEvents"]
    xs = [e for e in ev if e["ph"] == "X"]
    names = {e["name"] for e in xs}
    assert {"zip:file", "zip:read", "zip:global-area",
            "rans:encode-many"} <= names
    ids = {e["args"]["id"] for e in xs}
    assert all(e["args"]["parent"] in ids or e["args"]["parent"] == 0
               for e in xs)
    assert any(e["ph"] == "C" and e["name"] == "rans:enc.card.calls"
               for e in ev)
    assert t["otherData"]["counters"]["rans:enc.card.calls"] > 0
    threads = {e["tid"] for e in ev if e["ph"] == "M" and
               e["name"] == "thread_name"}
    assert {e["tid"] for e in xs} <= threads and len(threads) > 1


NEW_METRICS = {
    "fastq-se.zip": ("read_thread_s_per_GB", "global_area_thread_s_per_GB",
                     "rans_host_thread_s_per_GB.zip"),
    "fastq-se.unzip": ("rans_host_thread_s_per_GB.unzip",
                       "io_wait_thread_s_per_GB"),
}


@pytest.mark.parametrize("cell", sorted(NEW_METRICS))
def test_traced_cell_reads_the_span_metrics(cell):
    from benchmark import harness
    # the discovery test's size; a threshold of 128 KiB keeps the plain
    # reference's judging of the card's streams short on a CPU
    r = harness.run_cell(cell, 2**31 + 17, 0.5, True, device="cpu",
                         overrides={"nbytes": 1 << 20, "block": 2000},
                         min_size=1 << 17)
    assert r["correct"], r
    for m in NEW_METRICS[cell]:
        assert r["metrics"][m]["value"] > 0, (m, r["metrics"])
        assert r["metrics"][m]["unit"] == "s/GB"


# the rANS kernels of csrc/rans.cu (benchmark/metrics/rans_*_roofline.py)
RANS_KERNELS = ("o1_enc_entries_kernel", "stripe_kernel",
                "encode_lanes_kernel", "scan_sums_kernel",
                "scan_partials_kernel", "scatter_kernel", "o1_slots_kernel",
                "rans_decode_kernel", "unstripe_kernel")


def _kernel_base(name):
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0].split("<", 1)[0].rsplit("::", 1)[-1].strip()


@pytest.mark.cuda
def test_trace_out_kernels_start_inside_their_calls(tmp_path):
    """On the card: in the `--trace-out` export of a zip and an unzip of a
    64 MiB FASTQ, every rANS kernel starts inside a `rans:encode-many` /
    `rans:decode-many` span, within 50 us."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    fq = str(tmp_path / "r.fastq")
    synth.write_fastq(fq, 64 << 20, seed=2024)
    try:
        for cmd, call, io in (
                ("zip", "rans:encode-many", [fq, "-o", str(tmp_path / "r.gxz")]),
                ("unzip", "rans:decode-many",
                 [str(tmp_path / "r.gxz"), "-o", str(tmp_path / "r.out")])):
            tr = tmp_path / f"{cmd}.json"
            cli.main([cmd, *io, "--device", "cuda", "--trace-out", str(tr)]
                     + (["-q"] if cmd == "zip" else []))
            ev = json.loads(tr.read_text())["traceEvents"]
            calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                           if e["ph"] == "X" and e["name"] == call)
            kernels = [e for e in ev if e["ph"] == "X" and
                       e.get("cat") == "device" and
                       _kernel_base(e["name"]) in RANS_KERNELS]
            assert calls and kernels, cmd
            worst = 0.0
            for k in kernels:
                miss = min(max(s - k["ts"], k["ts"] - e, 0.0)
                           for s, e in calls)
                worst = max(worst, miss)
                assert miss <= 50, (cmd, k["name"], miss)
            inside = [min(k["ts"] - s for s, e in calls if s <= k["ts"])
                      for k in kernels if any(s <= k["ts"] for s, _ in calls)]
            print(f"{cmd}: {len(kernels)} rANS kernels in {len(calls)} "
                  f"{call} spans; farthest outside {worst:.1f} us; "
                  f"median start after the span's {sorted(inside)[len(inside) // 2]:.1f} us; "
                  f"{sum(e['ph'] == 'X' and e.get('cat') == 'device' for e in ev)} "
                  f"device ops, {sum(e['ph'] == 'X' and e.get('cat') == 'span' for e in ev)} spans")
    finally:
        codecs.disable_device_rans()
    assert pathlib.Path(fq).read_bytes() == (tmp_path / "r.out").read_bytes()
