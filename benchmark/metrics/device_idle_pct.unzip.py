"""device_idle_pct.unzip: the share of the window in which no kernel, copy or
memset ran on the card (one minus the union of the device's busy intervals
in the trace, over the window)."""


def read(run):
    if run.summary is None or run.summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.summary.busy_s / run.summary.window_s)
