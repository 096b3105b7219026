"""The device trace of a window, reduced to what the metrics read.

`torch.profiler` (CUPTI) records every kernel, copy and memset on the card,
whoever launched it. `device_spans` takes them from a finished profile, on
the profile's clock in microseconds; `Summary` reduces them over the window:
the union of busy intervals (kernels and copies overlap nothing twice), the
device seconds of each kernel by name, the top operations, and the idle
gaps labelled by the `--show-time` regions open on the host at the time.
"""

WINDOW_EVENT = "benchmark.window"


def short_name(name: str) -> str:
    """A device operation's name without "void", anonymous namespaces and
    its argument list ("void (anonymous namespace)::rans_decode_kernel<0>(
    long const*, ...)" -> "rans_decode_kernel<0>"), at most 100
    characters; a copy or memset keeps its whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0].strip()[:100]


def kernel_base(name: str) -> str:
    """A kernel's function name without namespace and template arguments
    ("rans::encode_lanes_kernel<0, true>(...)" -> "encode_lanes_kernel")."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    return short_name(name).split("<", 1)[0].rsplit("::", 1)[-1]


def device_spans(prof):
    """([(name, start us, end us)] of the device's operations, (window start
    us, window end us)) from a finished `torch.profiler.profile` whose
    window ran inside `record_function(WINDOW_EVENT)`."""
    from torch.autograd import DeviceType
    spans, window = [], None
    for e in prof.events():
        if e.name == WINDOW_EVENT and e.device_type == DeviceType.CPU:
            window = (e.time_range.start, e.time_range.end)
        elif e.device_type == DeviceType.CUDA and e.name != WINDOW_EVENT \
                and not getattr(e, "is_user_annotation", False):
            spans.append((e.name, e.time_range.start, e.time_range.end))
    return spans, window


def union(intervals):
    """Sorted disjoint intervals covering `intervals` ((start, end) pairs)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def host_labels(spans, t0: float, t1: float):
    """[(start, end, label)] covering [t0, t1] from host region `spans`
    (region, thread, start, end on the trace's clock): each label names
    the innermost region open on each thread, joined by "+", or "host: no
    region"."""
    points = []
    for k, (name, tid, s, e) in enumerate(spans):
        if e <= s:
            continue
        points.append((s, 1, k))
        points.append((e, 0, k))
    points.sort()
    open_ = {}            # thread -> [(start, k)] regions open
    out, at = [], t0

    def label():
        inner = {max(v)[1] for v in open_.values() if v}
        return "+".join(sorted({spans[k][0] for k in inner})) or \
            "host: no region"

    for t, kind, k in points:
        t = min(max(t, t0), t1)
        if t > at:
            out.append((at, t, label()))
            at = t
        tid = spans[k][1]
        if kind:
            open_.setdefault(tid, []).append((spans[k][2], k))
        else:
            open_[tid].remove((spans[k][2], k))
    if t1 > at:
        out.append((at, t1, label()))
    return out


class Summary:
    """The window's device time, from `device_spans` and host region spans
    on the same clock (microseconds)."""

    def __init__(self, spans, window, host_spans=()):
        w0, w1 = window
        self.window_s = (w1 - w0) / 1e6
        clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in spans
                   if e > w0 and s < w1]
        busy = union((s, e) for _, s, e in clipped)
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        self.kernel_s, self.op_s = {}, {}
        for n, s, e in clipped:
            b = kernel_base(n)
            self.kernel_s[b] = self.kernel_s.get(b, 0.0) + (e - s) / 1e6
            k = short_name(n)
            self.op_s[k] = self.op_s.get(k, 0.0) + (e - s) / 1e6
        idle, at = [], w0
        for s, e in busy:
            if s > at:
                idle.append((at, s))
            at = max(at, e)
        if w1 > at:
            idle.append((at, w1))
        self.idle_s = {}
        labels = host_labels(list(host_spans), w0, w1)
        j = 0
        for s, e in idle:
            while j < len(labels) and labels[j][1] <= s:
                j += 1
            k = j
            while k < len(labels) and labels[k][0] < e:
                a, b, lab = labels[k]
                d = (min(b, e) - max(a, s)) / 1e6
                if d > 0:
                    self.idle_s[lab] = self.idle_s.get(lab, 0.0) + d
                k += 1

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(self.op_s), "idle_gaps": head(self.idle_s)}
