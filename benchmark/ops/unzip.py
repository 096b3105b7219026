"""Unzip traffic: one client restores the cell's archives back to back
through `piz_pipeline.piz_file`, in this process, as `genozip_tpu_torch
unzip --device cuda` does, into a pipe that a thread of this process
drains (`sink.py`; nothing restored is written to disk). Set-up makes each
archive with the program's zip.

The comparison: every restored file of the window must have the input's
length, and the files that the seed's sample keeps must equal the
generated input byte for byte (a BAM's BGZF included; the sink hashes
only those); the rANS streams that the card decoded for the kept files are
judged by the plain reference (`ref/judge.py`).
"""

from .zip import _sink, _zip

KIND = "decode"
KEPT = 2


def setup(run):
    run.wrong_size = 0
    for j, src in enumerate(run.inputs):
        src.archive = run.path(f"{j}.gxz")
        _zip(run, src, src.archive)


def one(run, i, slot) -> int:
    """Unzip file i of the window (-1: the warm-up); returns the bytes
    restored. A file that the seed's sample keeps is hashed."""
    from genozip_tpu_torch.piz_pipeline import piz_file
    src = run.inputs[max(i, 0) % len(run.inputs)]
    if i >= 0 and slot is not None:
        run.kept[slot] = False       # until this file is restored right
    digest, n = _sink(run, src).restore(
        lambda out: piz_file(src.archive, out), digest=slot is not None)
    if i >= 0:
        if slot is not None:
            run.kept[slot] = digest == src.digest
        run.wrong_size += n != src.size
    return n


def end_to_end(run) -> dict:
    return {"unzip_MBps": run.bytes_done / 1e6 / run.window_s}


def check(run) -> dict:
    """restored_wrong: the sampled files of the window that differ from the
    input, and any file of another length."""
    return {"restored_wrong": run.wrong_size + sum(
        not ok for ok in run.kept.values())}
