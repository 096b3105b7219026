"""uncompress_thread_s_per_GB: thread-seconds in the program's `--show-time`
region `piz:read+uncompress` over the window (the archive read and the
codecs, the device decoders' waits in it), per GB (1e9 bytes) of the
window's restored bytes."""

REGION = "piz:read+uncompress"


def read(run):
    secs = run.regions.get(REGION)
    if not secs or not run.bytes_done:
        return None
    return secs / (run.bytes_done / 1e9)
