#!/usr/bin/env python3
"""The control and the planted faults of a cell, on the card at the cell's
own size: the readings that the limits of `correct` are set between.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        [--modes none,optimize,flip,half_batch,unchanged] [--seconds 10]

`none` is a sound run; `optimize` the control (the program's own lossy
path, QUAL binned, which breaks the configurations' byte-exact guarantee);
`flip`, `half_batch` and `unchanged` the faults planted in the batched rANS
calls of the cell's traffic (`benchmark/taps.py`). All runs share this
process, so the kernels load once. One line a run: the mode, the seed,
`correct` and each number compared. The benchmark's own runs never run
this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="optimize")
    ap.add_argument("--seconds", type=float, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for mode in args.modes.split(","):
        for seed in map(int, args.seeds.split(",")):
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 fault=None if mode == "none" else mode)
            print(json.dumps({
                "mode": mode, "seed": seed, "correct": r["correct"],
                "attempted": r["attempted"], "failed": r["failed"],
                "checks": {k: v["value"] for k, v in r["checks"].items()},
                "errors": r["errors"][:2]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
