"""What the benchmark reads from the program while a window runs.

- `RansTap` wraps `genozip_tpu_torch.ops.rans_cuda.encode_many` and
  `decode_many`, the batched calls through which every rANS stream reaches
  the card (the codecs, the zip flush and the PIZ reader all call them by
  module attribute). For each call it counts the streams, symbols and coded
  bytes (the roofline's work, whatever kernels implement the call) and, for
  the files that `Sample` keeps, holds what went in and what came out, for
  the plain reference to judge once the window has closed. A `fault`
  replaces the call's result, for the checks that show the comparison
  fails.
- `RegionTap` wraps `genozip_tpu_torch.utils.profiler.timer`, the
  `--show-time` regions, to record each region's interval and thread (the
  labels of the device's idle gaps); the program's own totals still
  accumulate.
- `Sample` draws from the seed which files of a window are kept for the
  comparison: a reservoir of `k`, so that every file is equally likely
  whatever the window's count.
"""

import contextlib
import threading
import time

import numpy as np


class Sample:
    """Reservoir of `k` file indices drawn from `seed`."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng([seed, 0x5A17])
        self.k = k

    def keep(self, i: int):
        """The slot that file `i` (0, 1, ... in window order) goes to, or
        None. Decided before the file starts, from `i` and the seed alone."""
        if i < self.k:
            slot = i
        else:
            slot = int(self.rng.integers(0, i + 1))
            if slot >= self.k:
                return None
        return slot


def _flip(b: bytes) -> bytes:
    """`b` with one byte in its middle changed."""
    if not b:
        return b"\x01"
    a = bytearray(b)
    a[len(a) // 2] ^= 0x5A
    return bytes(a)


# faults planted in a batched call's result (see tests and control.py):
# an answer altered where it is produced; half of the batch left out (its
# streams zero bytes of their length); the call returning its input
FAULTS = {
    "flip": lambda ins, outs: [_flip(outs[0])] + list(outs[1:]),
    "half_batch": lambda ins, outs: [
        bytes(len(o)) if i >= len(outs) // 2 else o
        for i, o in enumerate(outs)],
    "unchanged": lambda ins, outs: [bytes(x) for x in ins],
}


class RansTap:
    """Counts and samples the batched rANS calls of one kind ("encode" or
    "decode") while installed."""

    def __init__(self, kind: str, fault: str | None = None):
        self.kind = kind
        self.fault = FAULTS[fault] if fault else None
        self.calls = []          # (order, streams, symbols, coded bytes)
        self.kept = {}           # slot -> [(ins, outs)]
        self.slot = None         # the running file's slot (None: not kept)
        self._lock = threading.Lock()

    def begin_file(self, slot):
        self.slot = slot
        if slot is not None:
            self.kept[slot] = []

    @contextlib.contextmanager
    def installed(self):
        from genozip_tpu_torch.ops import rans_cuda
        name = f"{self.kind}_many"
        orig = getattr(rans_cuda, name)

        def tapped(ins, *args, **kw):
            ins = list(ins)
            outs = orig(ins, *args, **kw)
            if self.fault and outs:
                outs = self.fault(ins, outs)
            if self.kind == "encode":
                order = args[0] if args else kw["order"]
                symbols, coded = sum(map(len, ins)), sum(map(len, outs))
            else:
                order = ins[0][1] if ins else 0
                symbols, coded = sum(map(len, outs)), sum(map(len, ins))
            with self._lock:
                self.calls.append((int(order), len(ins), symbols, coded))
                if self.slot is not None:
                    self.kept[self.slot].append((ins, outs))
            return outs

        setattr(rans_cuda, name, tapped)
        try:
            yield self
        finally:
            setattr(rans_cuda, name, orig)


class RegionTap:
    """Records (region, thread id, start ns, end ns) of every `--show-time`
    region entered while installed, on `time.perf_counter_ns`."""

    def __init__(self):
        self.spans = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def installed(self):
        from genozip_tpu_torch.utils import profiler
        orig = profiler.timer

        @contextlib.contextmanager
        def timer(region: str):
            t0 = time.perf_counter_ns()
            try:
                with orig(region):
                    yield
            finally:
                span = (region, threading.get_ident(), t0,
                        time.perf_counter_ns())
                with self._lock:
                    self.spans.append(span)

        profiler.timer = timer
        try:
            yield self
        finally:
            profiler.timer = orig


def region_totals() -> dict:
    """A copy of the program's `--show-time` totals: thread-seconds by
    region."""
    from genozip_tpu_torch.utils import profiler
    return dict(profiler._totals)
