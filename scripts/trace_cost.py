"""What the port's tracing (genozip_tpu_torch/utils/profiler.py) costs.

Off: ns per `profiler.timer` call of each tree named on the command line
(each timed in a process of its own, best of 5 rounds of 200,000 calls),
and the region calls of one zip and one unzip of the input (`_counts`),
which multiply the difference into a cost per file.

On: `genozip_tpu_torch zip` and `unzip` of one FASTQ (the benchmark's
`fastq_illumina_se` input, made from `--seed`) through the CLI's `main`
in this process, with and without `--trace-out`, in the turns off, on,
on, off, off, on; seconds of each run, the trace's size and its spans.

    python3 scripts/trace_cost.py [--mib 512] [--seed N] [--out DIR] TREE...

Runs on the CUDA card (`--device cpu` rehearses it); prints one JSON line
at the end.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TIMER_NS = """
import sys, time
sys.path.insert(0, sys.argv[1])
from genozip_tpu_torch.utils import profiler
n, best = 200_000, None
for _ in range(5):
    t = time.perf_counter_ns()
    for _ in range(n):
        with profiler.timer("x"):
            pass
    dt = (time.perf_counter_ns() - t) / n
    best = dt if best is None else min(best, dt)
print(best)
"""


def timer_ns(tree: str) -> float:
    out = subprocess.run([sys.executable, "-c", TIMER_NS,
                          os.path.abspath(tree)], check=True,
                         capture_output=True, text=True).stdout
    return float(out.split()[-1])


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--mib", type=int, default=512)
    ap.add_argument("--seed", type=int, default=2**31 + 4242)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the run with the plain versions")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    res = {"card": card(),
           "timer_ns": {t: timer_ns(t) for t in args.trees}}
    print(res, flush=True)

    sys.path.insert(0, ROOT)
    from genozip_tpu_torch import cli
    from genozip_tpu_torch.utils import profiler
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                      "fastq_illumina_se.json")))
    params = dict(cfg["params"], nbytes=args.mib << 20)
    work = os.path.join(args.out, "trace_cost")
    os.makedirs(work, exist_ok=True)
    fq = os.path.join(work, "reads.fastq")
    subprocess.run([sys.executable, "-m", "benchmark.gen", "fastq", fq,
                    str(args.seed), json.dumps(params)], cwd=ROOT,
                   check=True, stdout=subprocess.DEVNULL)
    gxz, back = fq + ".gxz", fq + ".out"
    vblock = str(cfg["zip"]["vb_size"] >> 20)
    dev = ["--device", args.device]
    cmds = {"zip": ["zip", fq, "-o", gxz, "--vblock", vblock, "-q", *dev],
            "unzip": ["unzip", gxz, "-o", back, *dev]}

    # warm: kernels built and loaded, the archive made; then one file's
    # region calls
    for cmd in ("zip", "unzip"):
        profiler.reset()
        cli.main(cmds[cmd])
        res[f"{cmd}_region_calls"] = sum(profiler._counts.values())
    runs = {}
    for cmd in ("zip", "unzip"):
        for on in (0, 1, 1, 0, 0, 1):
            argv = list(cmds[cmd])
            tr = os.path.join(work, f"{cmd}.trace.json")
            if on:
                argv += ["--trace-out", tr]
            t = time.perf_counter()
            cli.main(argv)
            s = time.perf_counter() - t
            runs.setdefault(f"{cmd}_{'on' if on else 'off'}_s", []).append(
                round(s, 4))
            if on:
                ev = json.load(open(tr))["traceEvents"]
                res[f"{cmd}_trace"] = {
                    "bytes": os.path.getsize(tr),
                    "spans": sum(e.get("cat") == "span" for e in ev),
                    "device_ops": sum(e.get("cat") == "device" for e in ev),
                    "counter_events": sum(e["ph"] == "C" for e in ev)}
            print(cmd, "on" if on else "off", round(s, 3), flush=True)
    res.update(runs)
    with open(fq, "rb") as a, open(back, "rb") as b:
        res["restored"] = a.read() == b.read()
    for p in (fq, gxz, back):
        os.unlink(p)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
