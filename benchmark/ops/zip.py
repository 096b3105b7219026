"""Zip traffic: one client compresses the cell's input files back to back
through `zip_pipeline.zip_file`, in this process, as `genozip_tpu_torch zip
--device cuda` does (the default VB size and threads unless the cell's
configuration names others). The archives of the files that the seed's
sample keeps stay for the comparison; the others overwrite one scratch
file.

The comparison: each kept archive is restored by the program's own unzip
into a hashing pipe (`sink.py`) and must give back the generated input
byte for byte; the program is the only decoder of its archive format, so
this follows the program (PERF.md says so). The rANS streams that the card
coded for the kept files are judged apart, by the plain reference
(`ref/judge.py`).
"""

import os

from ..sink import HashSink

KIND = "encode"     # the batched rANS calls that this traffic drives
KEPT = 2            # files a run keeps for the comparison


def _zip(run, src, out):
    from genozip_tpu_torch.zip_pipeline import zip_file
    opts = dict(run.zip_opts)
    if run.fault == "optimize":      # the control: the program's lossy path
        opts["optimize"] = True
    zip_file(src.path, out, **opts)


def _sink(run, src):
    """The run's restore pipe, named with the input's suffix (a `.bam` is
    restored with its BGZF)."""
    if run.sink is None:
        suffix = os.path.splitext(src.path)[1]
        run.sink = HashSink(run.path(f"restored{suffix}"))
        run.on_close.append(run.sink.close)
    return run.sink


def setup(run):
    pass


def one(run, i, slot) -> int:
    """Zip file i of the window (-1: the warm-up); returns its input
    bytes."""
    src = run.inputs[max(i, 0) % len(run.inputs)]
    out = run.path(f"kept{slot}.gxz" if slot is not None else "scratch.gxz")
    run.kept.pop(slot, None)
    _zip(run, src, out)
    if i >= 0:
        run.out_bytes += os.path.getsize(out)
        if slot is not None:
            run.kept[slot] = (src, out)
    return src.size


def end_to_end(run) -> dict:
    return {"zip_MBps": run.bytes_done / 1e6 / run.window_s,
            "ratio": run.bytes_done / run.out_bytes}


def check(run) -> dict:
    """restored_wrong: kept archives that do not restore the input."""
    from genozip_tpu_torch.piz_pipeline import piz_file
    wrong = 0
    for src, archive in run.kept.values():
        try:
            digest, _ = _sink(run, src).restore(
                lambda out: piz_file(archive, out))
        except Exception as e:      # an archive that cannot be read back
            run.errors.append(f"restore: {type(e).__name__}: {e}"[:300])
            wrong += 1
            continue
        wrong += digest != src.digest
    return {"restored_wrong": wrong}
