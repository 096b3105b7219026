"""compress_thread_s_per_GB: thread-seconds in the program's `--show-time`
region `zip:compress-local` over the window (codecs: the local sections
compressed beside seg), per GB (1e9 bytes) of the window's input bytes."""

REGION = "zip:compress-local"


def read(run):
    secs = run.regions.get(REGION)
    if not secs or not run.bytes_done:
        return None
    return secs / (run.bytes_done / 1e9)
