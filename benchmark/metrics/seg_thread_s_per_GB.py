"""seg_thread_s_per_GB: thread-seconds in the program's `--show-time` region
`zip:seg` over the window (seg: `datatypes/*`, `seg.py`, `contexts.py`), per
GB (1e9 bytes) of the window's input bytes."""

REGION = "zip:seg"


def read(run):
    secs = run.regions.get(REGION)
    if not secs or not run.bytes_done:
        return None
    return secs / (run.bytes_done / 1e9)
