"""global_area_thread_s_per_GB: thread-seconds in the program's span
`zip:global-area` over the window (`ZipJob.write_global_area`: the
dictionary and counts payloads with their codec trials, the stats,
random-access and file-header sections, and the archive's finish), per GB
(1e9 bytes) of the window's input bytes. Nothing to read where the program
has no such span."""

REGION = "zip:global-area"


def read(run):
    secs = run.regions.get(REGION)
    if not secs or not run.bytes_done:
        return None
    return secs / (run.bytes_done / 1e9)
