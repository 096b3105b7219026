"""`cat` output filters for FASTQ, SAM and BAM archives: --head/--tail/--grep/
--downsample/--header-only/--seq-only/--qual-only/--one-vb, and for paired
archives --r1/--r2 (one component) and --interleave (records alternating
R1/R2). A BAM archive takes only the filters that keep whole VBs
(--header-only, --one-vb).

Counterpart of genozip_tpu/filters.py `cat_filtered` and `cat_interleaved`
(reference src/writer.c:544-663). --tail and --downsample without --grep are
plan edits (writer_plan.py): VBs wholly outside the range are never
reconstructed. --grep is a per-record predicate applied by the plan executor.
Every filter applies to interleaved records too. --one-vb N on a gencomp
archive drains the deported lines of VBs 1..N-1, so VB N gets its own
(genozip_tpu's filters.py:130-134 drops them: fault F3).
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
    if dt_name == "bam":
        per_record = [f for f in ("head", "tail", "grep", "downsample",
                                  "seq_only", "qual_only", "r1", "r2",
                                  "interleave") if getattr(args, f, None)]
        if per_record:
            raise NotImplementedError(
                f"cat --{per_record[0].replace('_', '-')} of a BAM archive "
                "(its records are binary; cat --sam is not yet ported)")
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
        plan = wp.edit_one_vb(plan, args.one_vb)
    transform = None
    proj = ("seq" if getattr(args, "seq_only", False) else
            "qual" if getattr(args, "qual_only", False) else None)
    if proj is not None:
        # one SEQ or QUAL line per record: FASTQ lines 1 and 3, SAM
        # columns 9 and 10
        if dt_name == "fastq":
            k = {"seq": 1, "qual": 3}[proj]

            def transform(rec: bytes) -> bytes | None:
                parts = rec.split(b"\n")
                return parts[k] + b"\n" if len(parts) > k else None
        else:
            k = {"seq": 9, "qual": 10}[proj]

            def transform(rec: bytes) -> bytes | None:
                cols = rec.rstrip(b"\n").split(b"\t")
                return cols[k] + b"\n" if len(cols) > k else None
    wp.execute_plan(pr, plan, out, lines_per_rec=lines_per_rec,
                    predicate=predicate, head=head, tail=tail,
                    no_header=getattr(args, "no_header", False)
                    or proj is not None,
                    transform=transform)
