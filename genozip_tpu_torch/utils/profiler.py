"""Wall-clock region profiler, spans and counters (genozip_tpu_torch's copy
of genozip_tpu/utils/profiler.py, grown into the port's one tracing
system).

Reference parity: src/profiler.h START_TIMER/COPY_TIMER macros wrapping ~300
regions, aggregated per VB and reported with --show-time. Here:

- `timer(region)` accumulates per-region totals and call counts
  (`_totals`, `_counts`, under a lock, since many threads end spans at
  once; `report()` prints them) on every call. While a recording is on
  it also keeps a span: its name, thread, start and end
  (`time.perf_counter_ns`), the span that caused it (the innermost span
  open on the thread; a pool task's first span takes the span that
  submitted it, through `bind`), and the file and (comp_i, vb_i) it works
  for (`file()` and `vb()`, thread-local).
- `count(name, n)` adds to counters, only while a recording is on.
- `recording()` turns spans and counters on and yields a `Recording`:
  spans in a bounded buffer, counter deltas, each counter's running value
  over time. `snapshot()` copies the totals, call counts and counters.
- `trace_to(path, cuda)` runs a block under a recording (and under
  torch.profiler when `cuda`) and writes one Chrome trace JSON: spans,
  counters and the card's kernels, copies and memsets on one clock.

Every call site passes `timer` exactly one positional argument, through
the module attribute: the benchmark replaces `profiler.timer` with a
one-argument wrapper while it traces a window."""

import itertools
import json
import threading
import time
from collections import defaultdict, namedtuple
from contextlib import contextmanager

_totals = defaultdict(float)
_counts = defaultdict(int)

Span = namedtuple("Span", "id parent name thread start_ns end_ns file comp vb")

MAX_SPANS = 1 << 19          # a recording's span buffer
DROPPED = "profiler:dropped"    # spans and counter samples past the buffer
ANCHOR = "genozip_tpu_torch.trace_anchor"

_rec = None                  # the recording on, or None (timer's one test)
_counters = {}               # name -> running total (recordings only)
_lock = threading.Lock()     # _totals, _counts and _counters
_tls = threading.local()     # .stack (open span ids), .ctx, .origin
_ids = itertools.count(1)
_file_ids = itertools.count(1)
_NO_CTX = (None, None, None)  # (file id, comp_i, vb_i)


@contextmanager
def timer(region: str):
    rec = _rec
    if rec is None:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            add(region, time.perf_counter() - t0)
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    sid = next(_ids)
    parent = stack[-1] if stack else getattr(_tls, "origin", 0)
    ctx = getattr(_tls, "ctx", _NO_CTX)
    stack.append(sid)
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        stack.pop()
        add(region, (t1 - t0) / 1e9)
        rec._keep(Span(sid, parent, region, threading.get_ident(), t0, t1,
                       *ctx))


def add(region: str, seconds: float):
    with _lock:
        _totals[region] += seconds
        _counts[region] += 1


def reset():
    with _lock:
        _totals.clear()
        _counts.clear()


def report(min_frac: float = 0.005) -> str:
    with _lock:
        totals, counts = dict(_totals), dict(_counts)
    total = sum(totals.values())
    rows = sorted(totals.items(), key=lambda kv: -kv[1])
    out = [f"{'region':24s} {'seconds':>9s} {'calls':>8s} {'%':>6s}"]
    for name, sec in rows:
        if total and sec / total < min_frac:
            continue
        out.append(f"{name:24s} {sec:9.3f} {counts[name]:8d} "
                   f"{100 * sec / max(total, 1e-12):5.1f}%")
    out.append(f"{'TOTAL (sum of regions)':24s} {total:9.3f}")
    return "\n".join(out)


# --- counters ------------------------------------------------------------------

def count(name: str, n: int = 1):
    """Add `n` to counter `name` while a recording is on (else nothing)."""
    rec = _rec
    if rec is None:
        return
    with _lock:
        v = _counters[name] = _counters.get(name, 0) + n
    rec._sample(name, v)


def snapshot() -> dict:
    """Copies of the region totals (seconds), their call counts and the
    counters."""
    with _lock:
        return {"totals": dict(_totals), "counts": dict(_counts),
                "counters": dict(_counters)}


def counters_report(counters: dict) -> str:
    """The counters as a table of their own (`--show-time` prints it after
    `report()`)."""
    out = [f"{'counter':32s} {'value':>16s}"]
    for name in sorted(counters):
        out.append(f"{name:32s} {counters[name]:16,}")
    return "\n".join(out)


# --- what a span belongs to ----------------------------------------------------

@contextmanager
def file():
    """Spans in the block work for a new file (a new file id)."""
    prev = getattr(_tls, "ctx", _NO_CTX)
    _tls.ctx = (next(_file_ids), None, None)
    try:
        yield
    finally:
        _tls.ctx = prev


@contextmanager
def vb(comp_i: int, vb_i: int):
    """Spans in the block work for VB `vb_i` of component `comp_i` of the
    current file."""
    prev = getattr(_tls, "ctx", _NO_CTX)
    _tls.ctx = (prev[0], comp_i, vb_i)
    try:
        yield
    finally:
        _tls.ctx = prev


def bind(fn):
    """`fn` to run on another thread (a pool task) under this thread's
    file and VB, its first spans children of this thread's innermost open
    span."""
    ctx = getattr(_tls, "ctx", _NO_CTX)
    stack = getattr(_tls, "stack", None)
    origin = stack[-1] if stack else getattr(_tls, "origin", 0)

    def bound(*args, **kw):
        prev = getattr(_tls, "ctx", _NO_CTX), getattr(_tls, "origin", 0)
        _tls.ctx, _tls.origin = ctx, origin
        try:
            return fn(*args, **kw)
        finally:
            _tls.ctx, _tls.origin = prev
    return bound


# --- recordings ------------------------------------------------------------------

class Recording:
    """What one `recording()` kept: `spans` (in the order they ended) and
    `samples` ((ns, counter, running value) at each `count`), at most
    `max_spans` each (`dropped` counts the rest), `threads`
    (ident -> name), and at its end `counters` (each counter's change over
    the recording)."""

    def __init__(self, max_spans: int):
        self.max_spans = max_spans
        self.spans, self.samples, self.threads = [], [], {}
        self.counters = {}
        self.dropped = 0
        self.on = True
        self._lock = threading.Lock()

    def _keep(self, span):
        with self._lock:
            if not self.on:
                return
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
            else:
                self.spans.append(span)
                if span.thread not in self.threads:
                    self.threads[span.thread] = \
                        threading.current_thread().name

    def _sample(self, name, value):
        t = time.perf_counter_ns()
        with self._lock:
            if not self.on:
                return
            if len(self.samples) >= self.max_spans:
                self.dropped += 1
            else:
                self.samples.append((t, name, value))


@contextmanager
def recording(max_spans: int = MAX_SPANS):
    """Spans and counters on for the block; yields the `Recording`, whose
    `counters` are filled when the block ends. Nothing is written. A
    recording inside another takes the spans until it ends."""
    global _rec
    rec = Recording(max_spans)
    before = snapshot()["counters"]
    prev, _rec = _rec, rec
    try:
        yield rec
    finally:
        _rec = prev
        with rec._lock:
            rec.on = False
        if rec.dropped:
            with _lock:
                _counters[DROPPED] = _counters.get(DROPPED, 0) + rec.dropped
        after = snapshot()["counters"]
        rec.counters = {k: v - before.get(k, 0) for k, v in after.items()
                        if v != before.get(k, 0)}


# --- one trace on the card's clock -----------------------------------------------

def anchor() -> int:
    """Enter an `ANCHOR` event for the running torch.profiler; returns its
    time on `perf_counter_ns`: the midpoint of the reads around entering
    `record_function(ANCHOR)`."""
    from torch.profiler import record_function
    with record_function(ANCHOR + ".warm"):     # the first entry is slow
        pass
    t0 = time.perf_counter_ns()
    with record_function(ANCHOR):
        t1 = time.perf_counter_ns()
    return (t0 + t1) // 2


def clock_map(prof, anchors_ns):
    """A function from perf_counter_ns to the profile's clock (us), fitted
    through the `ANCHOR` events of `prof` entered at `anchors_ns` (one
    anchor: an offset; two: offset and rate)."""
    from torch.autograd import DeviceType
    starts = sorted(e.time_range.start for e in prof.events()
                    if e.name == ANCHOR and e.device_type == DeviceType.CPU)
    if len(starts) != len(anchors_ns) or not starts:
        raise RuntimeError("the profile does not hold the trace's anchors")
    h0, p0 = anchors_ns[0] / 1e3, starts[0]
    rate = 1.0
    if len(starts) > 1 and anchors_ns[-1] > anchors_ns[0]:
        rate = (starts[-1] - p0) / (anchors_ns[-1] / 1e3 - h0)
    return lambda ns: p0 + (ns / 1e3 - h0) * rate


def device_ops(prof):
    """[(name, device index, start us, end us)] of the card's kernels,
    copies and memsets in a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType
    return [(e.name, e.device_index, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name != ANCHOR
            and not getattr(e, "is_user_annotation", False)]


def chrome_trace(rec, to_us, ops=()) -> dict:
    """A Chrome trace (`chrome://tracing`, Perfetto) of recording `rec`:
    its spans ("X", one track a thread, ids, parents, file and VB in
    `args`), its counters ("C", each counter's running value) and `ops`
    (from `device_ops`, one track a card), all through `to_us` on one
    clock."""
    ev = [{"ph": "M", "name": "process_name", "pid": 1,
           "args": {"name": "genozip_tpu_torch"}}]
    for tid, name in rec.threads.items():
        ev.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                   "args": {"name": name}})
    for s in rec.spans:
        t0 = to_us(s.start_ns)
        ev.append({"ph": "X", "cat": "span", "name": s.name, "pid": 1,
                   "tid": s.thread, "ts": t0,
                   "dur": to_us(s.end_ns) - t0,
                   "args": {"id": s.id, "parent": s.parent, "file": s.file,
                            "comp": s.comp, "vb": s.vb}})
    for t, name, value in rec.samples:
        ev.append({"ph": "C", "name": name, "pid": 1, "ts": to_us(t),
                   "args": {"value": value}})
    cards = sorted({d for _, d, _, _ in ops})
    for d in cards:
        ev.append({"ph": "M", "name": "process_name", "pid": 2 + d,
                   "args": {"name": f"cuda:{d}"}})
    for name, d, s, e in ops:
        ev.append({"ph": "X", "cat": "device", "name": name, "pid": 2 + d,
                   "tid": 0, "ts": s, "dur": e - s})
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {"counters": rec.counters,
                          "spans_dropped": rec.dropped}}


@contextmanager
def trace_to(path: str, cuda: bool = False):
    """Run the block under a recording and write `chrome_trace` to `path`
    when it ends. With `cuda` the block also runs under torch.profiler (CPU
    and CUDA activities), whose device operations join the trace, aligned
    through an anchor event at the recording's start and one at its end."""
    prof = None
    if cuda:
        import torch
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    anchors = []
    try:
        with recording() as rec:
            if prof is not None:
                anchors.append(anchor())
            yield rec
            if prof is not None:
                torch.cuda.synchronize()
                anchors.append(anchor())
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    to_us, ops = (lambda ns: ns / 1e3), ()
    if prof is not None:
        to_us, ops = clock_map(prof, anchors), device_ops(prof)
    with open(path, "w") as f:
        json.dump(chrome_trace(rec, to_us, ops), f)
