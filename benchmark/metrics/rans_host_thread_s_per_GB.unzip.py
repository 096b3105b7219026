"""rans_host_thread_s_per_GB.unzip: thread-seconds in the program's span
`rans:decode-many` over the window (each batched rANS decode on the card
as the host sees it: parsing the streams, the copies there and back, the
launch and the wait for the card), per GB (1e9 bytes) of the window's
restored bytes. Nothing to read where the program has no such span."""

REGION = "rans:decode-many"


def read(run):
    secs = run.regions.get(REGION)
    if not secs or not run.bytes_done:
        return None
    return secs / (run.bytes_done / 1e9)
