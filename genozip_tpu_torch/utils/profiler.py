"""Wall-clock region profiler (genozip_tpu_torch's own copy of
genozip_tpu/utils/profiler.py, unchanged).

Reference parity: src/profiler.h START_TIMER/COPY_TIMER macros wrapping ~300
regions, aggregated per VB and reported with --show-time. Here: a
context-manager accumulating per-region totals + call counts; enabled
globally (zero overhead ~100ns when reading time anyway is cheap)."""

import time
from collections import defaultdict
from contextlib import contextmanager

_totals = defaultdict(float)
_counts = defaultdict(int)
enabled = True


@contextmanager
def timer(region: str):
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _totals[region] += dt
        _counts[region] += 1


def add(region: str, seconds: float):
    _totals[region] += seconds
    _counts[region] += 1


def reset():
    _totals.clear()
    _counts.clear()


def report(min_frac: float = 0.005) -> str:
    total = sum(_totals.values())
    rows = sorted(_totals.items(), key=lambda kv: -kv[1])
    out = [f"{'region':24s} {'seconds':>9s} {'calls':>8s} {'%':>6s}"]
    for name, sec in rows:
        if total and sec / total < min_frac:
            continue
        out.append(f"{name:24s} {sec:9.3f} {_counts[name]:8d} "
                   f"{100 * sec / max(total, 1e-12):5.1f}%")
    out.append(f"{'TOTAL (sum of regions)':24s} {total:9.3f}")
    return "\n".join(out)
