"""io_wait_thread_s_per_GB: thread-seconds in the program's span
`piz:io-wait` over the window (the unzip workers queued for the archive's
lock, `PizReader.io_lock`, before each VB's read and decode), per GB (1e9
bytes) of the window's restored bytes. Nothing to read where the program
has no such span."""

REGION = "piz:io-wait"


def read(run):
    secs = run.regions.get(REGION)
    if not secs or not run.bytes_done:
        return None
    return secs / (run.bytes_done / 1e9)
