#!/usr/bin/env python3
"""The benchmark of genozip_tpu_torch: run one cell once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for (it exits non-zero and prints no result without them). The last
line of standard output is the result object; the last lines of standard
error give each number compared with its limit. The cells, the metrics and
`run_seconds` are in BENCHMARK.json; see benchmark/harness.py.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program builds its kernels into the checkout
# (genozip_tpu_torch/build/) and uses no other build or kernel cache
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
