"""rans_host_thread_s_per_GB.zip: thread-seconds in the program's span
`rans:encode-many` over the window (each batched rANS encode on the card
as the host sees it: framing, the copies there and back, the launch and the
wait for the card), per GB (1e9 bytes) of the window's input bytes.
Nothing to read where the program has no such span."""

REGION = "rans:encode-many"


def read(run):
    secs = run.regions.get(REGION)
    if not secs or not run.bytes_done:
        return None
    return secs / (run.bytes_done / 1e9)
