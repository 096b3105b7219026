"""`cat` output filters for FASTQ archives: --head/--tail/--grep/--downsample/
--header-only/--seq-only/--qual-only/--one-vb, and for paired archives
--r1/--r2 (one component) and --interleave (records alternating R1/R2).

Counterpart of genozip_tpu/filters.py `cat_filtered` and `cat_interleaved`
(reference src/writer.c:544-663). --tail and --downsample without --grep are
plan edits (writer_plan.py): VBs wholly outside the range are never
reconstructed. --grep is a per-record predicate applied by the plan executor.
Every filter applies to interleaved records too.
"""

from . import writer_plan as wp
from .piz_pipeline import PizReader


def cat_filtered(args, out):
    pr = PizReader(args.input, getattr(args, "reference", None))
    try:
        _cat(pr, args, out)
    finally:
        pr.close()


def _cat(pr, args, out):
    dt_name = pr.file_hdr["dt"]
    lines_per_rec = 4 if dt_name == "fastq" else 1
    grep = args.grep.encode() if getattr(args, "grep", None) else None
    head = getattr(args, "head", None)
    downsample = getattr(args, "downsample", None)
    tail = getattr(args, "tail", None)
    paired = pr.file_hdr.get("pair")
    interleave = getattr(args, "interleave", False)
    for flag in ("r1", "r2", "interleave"):
        if getattr(args, flag, False) and not paired:
            raise ValueError(f"--{flag} needs a paired archive")
    if interleave:
        plan = wp.build_interleave_plan(pr)
    else:
        plan = wp.build_plan(pr, 1 if getattr(args, "r2", False) else 0)
    predicate = None
    if grep is not None and not downsample:
        predicate = (lambda rec: grep in rec)
    elif downsample and (grep is not None or interleave):
        # downsample the raw record ordinals, then --grep
        state = {"i": 0}

        def predicate(rec: bytes) -> bool:
            state["i"] += 1
            return (state["i"] - 1) % downsample == 0 and \
                (grep is None or grep in rec)
    elif (downsample or tail) and not interleave:
        counts = wp.vb_record_counts(pr, plan)
        if downsample:
            plan = wp.edit_downsample(plan, downsample, counts)
        else:
            plan = wp.edit_tail(plan, tail, counts)
            tail = None
    if getattr(args, "header_only", False):
        out.write(pr.txt_header(0))
        return
    if getattr(args, "one_vb", None):
        plan = [it for it in plan if it.vb_i == args.one_vb]
    transform = None
    proj = ("seq" if getattr(args, "seq_only", False) else
            "qual" if getattr(args, "qual_only", False) else None)
    if proj is not None:
        # one SEQ or QUAL line per record
        k = {"seq": 1, "qual": 3}[proj]

        def transform(rec: bytes) -> bytes | None:
            parts = rec.split(b"\n")
            return parts[k] + b"\n" if len(parts) > k else None
    wp.execute_plan(pr, plan, out, lines_per_rec=lines_per_rec,
                    predicate=predicate, head=head, tail=tail,
                    no_header=getattr(args, "no_header", False)
                    or proj is not None,
                    transform=transform)
