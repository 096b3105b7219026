"""recon_thread_s_per_GB: thread-seconds in the program's `--show-time` region
`piz:recon` over the window (reconstruction of each VB's text), per GB (1e9
bytes) of the window's restored bytes."""

REGION = "piz:recon"


def read(run):
    secs = run.regions.get(REGION)
    if not secs or not run.bytes_done:
        return None
    return secs / (run.bytes_done / 1e9)
