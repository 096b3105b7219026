"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, and the result line.

Everything particular to a cell is data or a file of its own, found by name
(`BENCHMARK.json` at the repository's root lists the cells and metrics):

- `workloads/<cell>.json`: the configuration, the traffic (the name of a
  module `ops/<traffic>.py`) with its parameters, the chips, and why;
- `configs/<config>.json`: the generator (`gen/<generator>.py`) with its
  sizes, the zip options, what was assumed and what was cut;
- `metrics/<metric>.py`: one reader a per-layer metric, `read(run)` -> a
  number or None (nothing to read: the metric is left out of the line).

A run loads the program's kernels (built at first use into the checkout),
generates its inputs from `--seed` (in a process of its own, `python -m
benchmark.gen`) into a directory of its own under the temporary directory,
and warms up with one whole operation of the cell's kind: that is set-up.
The window then starts operations, one client back to back, while the
clock reads under `--seconds`, and ends at the last completion.
With `--trace 1` the window runs under `torch.profiler`, with the program's
`--show-time` regions recorded, and the line carries the per-layer metrics
instead of the end-to-end ones.
"""

import hashlib
import importlib
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

from . import taps, trace
from .ref import judge

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "genozip_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_file(name: str, bench: str = BENCH) -> dict:
    return load_json(os.path.join(bench, "workloads", f"{name}.json"))


def config_file(name: str, bench: str = BENCH) -> dict:
    return load_json(os.path.join(bench, "configs", f"{name}.json"))


def module(kind: str, name: str):
    """`<kind>/<name>.py` of the benchmark."""
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def metric_reader(name: str, bench: str = BENCH):
    """`metrics/<name>.py` (a name may hold dots, so it is loaded by path)."""
    path = os.path.join(bench, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.m_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def process_age_s() -> float | None:
    """Seconds since this process started, from /proc (None where there is
    no /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return up - start / os.sysconf("SC_CLK_TCK")


def cpu_s() -> float:
    """CPU seconds that this process has used."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


class Input:
    """One generated input file of a cell."""

    def __init__(self, path: str, seed: int):
        self.path, self.seed = path, seed
        self.size = os.path.getsize(path)
        h = hashlib.sha256()
        with open(path, "rb") as f:
            while chunk := f.read(16 << 20):
                h.update(chunk)
        self.digest = h.hexdigest()
        self.archive = None


class Run:
    """The state of one run, which the ops and the metric readers read."""

    def __init__(self, cell_name, cell, config, seed, seconds, trace_on,
                 device, fault):
        self.name, self.cell, self.config = cell_name, cell, config
        self.traffic = cell.get("params", {})
        self.seed, self.seconds, self.trace = seed, seconds, trace_on
        self.device, self.fault = device, fault
        self.op = module("ops", cell["traffic"])
        self.zip_opts = dict(config.get("zip", {}))
        self.zip_opts.update(self.traffic.get("zip", {}))
        self.tmp = tempfile.mkdtemp(prefix="gxz_bench_")
        self.inputs = []
        self.attempted = self.failed = self.done = 0
        self.bytes_done = self.out_bytes = 0
        self.window_s = 0.0
        self.op_s = []           # seconds of each operation of the window
        self.errors = []
        self.regions = {}
        self.summary = None
        self.tap = taps.RansTap(self.op.KIND, fault if fault in taps.FAULTS
                                else None)
        self.sample = taps.Sample(seed, self.op.KEPT)
        self.kept = {}           # slot -> the op's record of a kept file
        self.setup_parts = {}
        self.sink = None
        self.on_close = []       # what the ops opened: closed with the run

    def path(self, name: str) -> str:
        return os.path.join(self.tmp, name)

    def close(self):
        for fn in self.on_close:
            fn()
        shutil.rmtree(self.tmp, ignore_errors=True)


def _setup(run, overrides, min_size):
    """Kernels, inputs, the op's own set-up and one warm-up operation; their
    seconds go to run.setup_parts."""
    t = time.perf_counter()

    def lap(part):
        nonlocal t
        now = time.perf_counter()
        run.setup_parts[part] = round(now - t, 3)
        t = now


    from genozip_tpu_torch import codecs, native
    if min_size is None:
        codecs.enable_device_rans(run.device)
    else:
        codecs.enable_device_rans(run.device, min_size)
    if run.device == "cuda":
        from genozip_tpu_torch.ops import rans_cuda
        rans_cuda.lib()
    native.lib()
    lap("kernels")
    params = dict(run.config["params"])
    params.update(overrides or {})
    files = int(run.traffic.get("files", 1))
    name = run.config["file_name"]
    for j in range(files):
        seed = run.seed + j
        path = run.path(f"{j}.{name}")
        # in a process of its own, whose workers fork without CUDA
        subprocess.run([sys.executable, "-m", f"{__package__}.gen",
                        run.config["generator"], path, str(seed),
                        json.dumps(params)], cwd=os.path.dirname(BENCH),
                       check=True, stdout=subprocess.DEVNULL)
        run.inputs.append(Input(path, seed))
    lap("inputs")
    run.op.setup(run)
    lap("op_setup")
    run.op.one(run, -1, None)
    _sync(run)
    lap("warm_up")


def _sync(run):
    if run.device == "cuda":
        import torch
        torch.cuda.synchronize()


def _window(run):
    """Operations back to back while the clock reads under the window's
    length; returns (perf_counter at start, at the last completion)."""
    t0 = t_last = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        slot = run.sample.keep(i)
        run.tap.begin_file(slot)
        run.attempted += 1
        try:
            run.bytes_done += run.op.one(run, i, slot)
            run.done += 1
        except Exception as e:      # a failed operation counts, and the
            run.failed += 1         # window goes on
            run.errors.append(f"{type(e).__name__}: {e}"[:300])
        _sync(run)
        now = time.perf_counter()
        run.op_s.append(round(now - t_last, 4))
        t_last = now
        i += 1
    return t0, t_last


def _traced_window(run):
    """`_window` under torch.profiler, with the program's regions recorded;
    sets run.summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if run.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    rtap = taps.RegionTap()
    with profile(activities=acts) as prof, rtap.installed():
        with record_function(trace.WINDOW_EVENT):
            host0 = time.perf_counter_ns()
            t0, t1 = _window(run)
        if run.device == "cuda":
            torch.cuda.synchronize()
    spans, window = trace.device_spans(prof)
    if window is None:
        raise RuntimeError("the profile holds no window event")
    off = window[0] - host0 / 1e3
    host = [(n, tid, s / 1e3 + off, e / 1e3 + off)
            for n, tid, s, e in rtap.spans]
    run.summary = trace.Summary(spans, window, host)
    return t0, t1


def _memory_peak(run, chips) -> int:
    if run.device != "cuda":
        return 0
    import torch
    return max(torch.cuda.max_memory_allocated(d) for d in range(chips))


def _checks(run) -> dict:
    """Each number compared, with its limit: {name: (value, limit, "max" |
    "min")}."""
    checked, wrong = judge.streams_wrong(run.tap.kind, run.tap.kept)
    out = {"failed": (run.failed, 0, "max"),
           "completed": (run.done, 1, "min")}
    for k, v in run.op.check(run).items():
        out[k] = (v, 0, "max")
    out["rans_streams_wrong"] = (wrong, 0, "max")
    out["rans_streams_checked"] = (checked, 1, "min")
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace_on: bool, *,
             device: str = "cuda", bench: str = BENCH, man: dict | None = None,
             overrides: dict | None = None, min_size: int | None = None,
             fault: str | None = None) -> dict:
    """Run one cell once; returns the result object (with its "checks" key
    last). `overrides` (sizes), `min_size` (the device threshold),
    `device="cpu"` and `fault` serve the tests and the control runs."""
    man = man if man is not None else manifest()
    cell = cell_file(cell_name, bench)
    entry = next((w for w in man["workloads"] if w["name"] == cell_name),
                 None)
    if entry is None:
        raise SystemExit(f"{cell_name}: not a cell of BENCHMARK.json")
    if (entry["config"], entry["traffic"], entry["chips"]) != \
            (cell["config"], cell["traffic"], cell["chips"]):
        raise SystemExit(f"{cell_name}: workloads/{cell_name}.json and "
                         "BENCHMARK.json disagree")
    config = config_file(cell["config"], bench)
    run = Run(cell_name, cell, config, seed, seconds, trace_on, device,
              fault)
    try:
        _setup(run, overrides, min_size)
        if device == "cuda":
            import torch
            for d in range(cell["chips"]):
                torch.cuda.reset_peak_memory_stats(d)
        age = process_age_s()
        setup_s = age if age is not None else time.time() - START
        before, c0 = taps.region_totals(), cpu_s()
        with run.tap.installed():
            t0, t1 = (_traced_window if trace_on else _window)(run)
        after, window_cpu_s = taps.region_totals(), cpu_s() - c0
        run.window_s = t1 - t0
        run.regions = {k: v - before.get(k, 0.0) for k, v in after.items()}
        peak = _memory_peak(run, cell["chips"])
        checks = _checks(run)
        metrics = {}
        if trace_on:
            for m in man["per_layer"]:
                if applies(m, cell_name):
                    v = metric_reader(m["name"], bench)(run)
                    if v is not None:
                        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            e2e = dict(run.op.end_to_end(run)) if run.done else {}
            e2e["setup_s"] = setup_s
            for m in man["end_to_end"]:
                if applies(m, cell_name) and m["name"] in e2e:
                    metrics[m["name"]] = {"value": e2e[m["name"]],
                                          "unit": m["unit"]}
    finally:
        run.close()
    correct = all((v <= lim) if sense == "max" else (v >= lim)
                  for v, lim, sense in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": _device_name(device), "count": cell["chips"],
           "memory_peak_bytes": peak}
    if trace_on:
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace_on:
        out["breakdown"] = run.summary.breakdown()
    out["setup_parts"] = run.setup_parts
    out["op_s"] = run.op_s
    # the host's pace: CPU seconds of this process over the window
    out["window_cpu_s"] = window_cpu_s
    out["errors"] = run.errors[:5]
    out["checks"] = {k: {"value": v, "limit": lim, "bound": sense}
                     for k, (v, lim, sense) in checks.items()}
    return out


def _device_name(device: str) -> str:
    if device != "cuda":
        return device
    import torch
    return torch.cuda.get_device_name(0)


START = time.time()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark "
                                 "of genozip_tpu_torch once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = manifest()
    entry = next((w for w in man["workloads"] if w["name"] == args.workload),
                 None)
    if entry is None:
        print(f"{args.workload}: no such cell in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), man=man)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark must not load: {bad}",
              file=sys.stderr)
        return 4
    print(f"setup parts (s): {result['setup_parts']}", file=sys.stderr)
    for k, c in result["checks"].items():
        rel = "<=" if c["bound"] == "max" else ">="
        print(f"check {k} {c['value']} {rel} {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
