"""read_thread_s_per_GB: thread-seconds in the program's span `zip:read`
over the window (input + VB split: each step of `TxtReader.vblocks`, the
reads, the VB boundary search and its copies, with each VB's Adler-32/MD5
digests, and calibration's peek), per GB (1e9 bytes) of the window's input
bytes. Nothing to read where the program has no such span."""

REGION = "zip:read"


def read(run):
    secs = run.regions.get(REGION)
    if not secs or not run.bytes_done:
        return None
    return secs / (run.bytes_done / 1e9)
