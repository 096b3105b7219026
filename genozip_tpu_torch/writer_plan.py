"""Recon-plan IR + executor: the writer backbone of `cat`.

Counterpart of genozip_tpu/writer_plan.py (reference src/writer.c:866
writer_create_plan, :1203 writer_main_loop). A plan is a list of typed items
built from the archive (one component, or a paired archive's two components
interleaved, the reference's PLAN_INTERLEAVE) and edited by the positional
filters (--lines/--tail/--downsample/--one-vb, and --regions, which skips
the VBs the random-access index places outside every region, except in a
gencomp archive: fault F12); per-record
predicates (--grep/--qnames/--bases), the regions' line filter, projections
(--seq-only/--qual-only) and --count are applied by the executor, to
interleaved records as to any others. A MAIN VB of a gencomp archive that a
filter skips stays in the plan as DRAIN_VB, which consumes its share of the
deported PRIM/DEPN lines, so the VBs after it get their own lines back.
"""

from dataclasses import dataclass

import numpy as np

from .format import sections as fmt
from .regions import regions_overlap
from .utils import ragged

# plan item kinds
TXTHEADER = "txthdr"      # emit the txt header
VB_RANGE = "vb"           # records start.. step `step` of one VB
INTERLEAVE = "ilv"        # alternate records of (vb, comp 0) and (vb, comp 1)
DRAIN_VB = "drain"        # consume a skipped VB's gencomp queue share


@dataclass
class PlanItem:
    kind: str
    vb_i: int = 0
    comp_i: int = 0
    start: int = 0            # record index within the VB
    end: int | None = None    # exclusive; None = to the VB's end
    step: int = 1             # downsample stride (on raw record ordinals)
    phase: int = 0            # stride phase carried across VBs


def records_of(buf: bytes, lines_per_rec: int):
    """Split reconstructed text into records (vectorized newline scan).
    Returns (starts, ends) byte offsets per record."""
    a = np.frombuffer(buf, np.uint8)
    nl = np.nonzero(a == ord("\n"))[0]
    starts = np.concatenate([[0], nl[:-1] + 1]) if nl.shape[0] else \
        np.zeros(1 if buf else 0, np.int64)
    ends = nl + 1
    if buf and (nl.shape[0] == 0 or nl[-1] != len(buf) - 1):
        starts = np.concatenate(
            [starts, [nl[-1] + 1 if nl.shape[0] else 0]])
        ends = np.concatenate([ends, [len(buf)]])
    starts = starts[:ends.shape[0]]
    nrec = starts.shape[0] // lines_per_rec
    if lines_per_rec == 1:
        return starts, ends
    return (starts[::lines_per_rec][:nrec],
            ends[lines_per_rec - 1::lines_per_rec][:nrec])


def build_plan(pr, comp_i: int = 0, regions=None, ra=None):
    """Full plan of one component: header + every VB. With `regions` and
    the archive's random-access index `ra`, a VB whose entries overlap no
    region is a DRAIN_VB (src/sections.h:536-541). Not in a gencomp
    archive: a MAIN VB's entries cover only the lines it kept, and the
    PRIM/DEPN lines deported from it may lie in a region (genozip_tpu skips
    the VB all the same and loses them: fault F12)."""
    plan = [PlanItem(TXTHEADER, comp_i=comp_i)]
    if pr.file_hdr.get("gencomp"):
        ra = None
    for vb_i in range(1, pr.comp_num_vbs(comp_i) + 1):
        ents = ra.get(f"{comp_i}:{vb_i}") if regions is not None and \
            ra is not None else None
        if ents is not None and not any(
                regions_overlap(regions, c, lo, hi) for (c, lo, hi) in ents):
            plan.append(PlanItem(DRAIN_VB, vb_i=vb_i, comp_i=comp_i))
        else:
            plan.append(PlanItem(VB_RANGE, vb_i=vb_i, comp_i=comp_i))
    return plan


def build_interleave_plan(pr):
    """Paired archive: records alternate R1/R2, VB by VB."""
    return [PlanItem(INTERLEAVE, vb_i=vb_i)
            for vb_i in range(1, pr.num_vbs() + 1)]


def edit_downsample(plan, k: int, counts):
    """--downsample=k: keep every k-th record (raw ordinals), carried
    across VBs via the per-item phase."""
    seen = 0
    for it, cnt in zip(plan, counts):
        if it.kind != VB_RANGE:
            continue
        it.step = k
        it.phase = seen % k
        seen += cnt
    return plan


def edit_one_vb(plan, vb_i: int):
    """--one-vb: VB `vb_i` only; the VBs before it drain."""
    return [it if it.vb_i == vb_i or it.kind == TXTHEADER else
            PlanItem(DRAIN_VB, vb_i=it.vb_i, comp_i=it.comp_i)
            for it in plan if it.vb_i <= vb_i]


def edit_lines_range(plan, first: int, last: int, counts):
    """--lines=first-last (1-based, inclusive) as a plan trim: VBs wholly
    outside the range drain, never reconstructed."""
    out = []
    seen = 0
    for it, cnt in zip(plan, counts):
        if it.kind != VB_RANGE:
            out.append(it)
            continue
        lo, hi = seen + 1, seen + cnt   # 1-based record ordinals of this VB
        seen += cnt
        if hi < first or lo > last:
            out.append(PlanItem(DRAIN_VB, vb_i=it.vb_i, comp_i=it.comp_i))
            continue
        e = cnt - max(hi - last, 0)
        out.append(PlanItem(VB_RANGE, vb_i=it.vb_i, comp_i=it.comp_i,
                            start=max(first - lo, 0),
                            end=e if e < cnt else None, step=it.step,
                            phase=it.phase))
    return out


def edit_tail(plan, k: int, counts):
    """--tail=k: keep only the last k records; VBs wholly before them
    drain, never reconstructed."""
    total = sum(c for it, c in zip(plan, counts) if it.kind == VB_RANGE)
    return edit_lines_range(plan, max(total - k, 0) + 1, 1 << 62, counts)


def vb_record_counts(pr, plan):
    """Record count per plan item, from the VB headers (0 for non-VB
    items); a gencomp MAIN VB adds its deported lines (src/gencomp_piz.c)."""
    counts = []
    has_gc = pr.ensure_gencomp()
    for it in plan:
        if it.kind != VB_RANGE:
            counts.append(0)
            continue
        payload, _ = pr.zr.read_one(fmt.SEC_VB_HEADER, vb_i=it.vb_i,
                                    comp_i=it.comp_i)
        if payload is None and it.comp_i == 0:
            payload, _ = pr.zr.read_one(fmt.SEC_VB_HEADER, vb_i=it.vb_i)
        # vb_hdr["n"] counts records (a FASTQ record is the 4-line read)
        n = fmt.vbhdr_parse(payload)["n"]
        if has_gc and it.comp_i == 0:
            n += sum(pr.gencomp_counts(it.vb_i))
        counts.append(n)
    return counts


def execute_plan(pr, plan, out, lines_per_rec: int = 1, predicate=None,
                 head: int | None = None, tail: int | None = None,
                 no_header: bool = False, transform=None,
                 count_only: bool = False, line_filter=None,
                 workers: int = 1):
    """The writer loop: consume plan items in order, apply `line_filter`
    to each VB's bytes and the per-record predicate, honour the head
    budget, buffer for tail-after-predicates and emit, or with
    `count_only` write only the number of records emitted. `transform`
    maps each emitted record (None drops it). Up to `workers` VBs
    reconstruct ahead of the loop."""
    emitted = 0
    tail_buf = []

    def emit(rec: bytes) -> bool:
        """Returns False when the head budget is exhausted."""
        nonlocal emitted
        if transform is not None:
            rec = transform(rec)
            if rec is None:
                return True
        if tail is not None:
            tail_buf.append(rec)
            if len(tail_buf) > tail:
                tail_buf.pop(0)
            return True
        emitted += 1
        if not count_only:
            out.write(rec)
        return not (head and emitted >= head)

    whole = predicate is None and head is None and tail is None and \
        transform is None and not count_only and line_filter is None
    ranges = [it for it in plan if it.kind == VB_RANGE]
    if len({it.comp_i for it in ranges}) > 1:
        raise ValueError("a plan's VB ranges must be of one component")
    vbs = pr.vbs_in_order([it.vb_i for it in ranges],
                          ranges[0].comp_i if ranges else 0, workers)
    try:
        for it in plan:
            if it.kind == TXTHEADER:
                hdr = pr.txt_header(it.comp_i)
                if hdr and not no_header and not count_only:
                    out.write(hdr)
                continue
            if it.kind == DRAIN_VB:
                if pr.ensure_gencomp():
                    pr.drain_vb_gencomp(it.vb_i)
                continue
            if it.kind == INTERLEAVE:
                buf, starts, ends = _interleaved(pr, it.vb_i, lines_per_rec)
            else:
                buf = next(vbs)
                if line_filter is not None:
                    buf = line_filter(buf)
            if whole and it.start == 0 and it.end is None and it.step == 1:
                out.write(buf)
                continue
            if it.kind != INTERLEAVE:
                starts, ends = records_of(buf, lines_per_rec)
            end = starts.shape[0] if it.end is None else \
                min(it.end, starts.shape[0])
            stop = False
            for r in range(it.start, end):
                if it.step > 1 and (r + it.phase) % it.step != 0:
                    continue
                rec = buf[starts[r]:ends[r]]
                if predicate is not None and not predicate(rec):
                    continue
                if not emit(rec):
                    stop = True
                    break
            if stop:
                break
    finally:
        vbs.close()
    if not count_only:
        for rec in tail_buf:
            out.write(rec)
    else:
        out.write(b"%d\n" % (len(tail_buf) if tail is not None else emitted))
    return emitted


def _interleaved(pr, vb_i: int, lines_per_rec: int):
    """VB `vb_i` of both components, records alternating R1/R2: (bytes,
    record starts, record ends)."""
    cols = []
    for comp_i in (0, 1):
        b = pr.read_vb(vb_i, comp_i)
        st, en = records_of(b, lines_per_rec)
        cols.append(ragged.gather_ranges(np.frombuffer(b, np.uint8), st,
                                         en - st))
    if len(cols[0]) != len(cols[1]):
        raise ValueError(f"VB {vb_i}: R1 has {len(cols[0])} records, R2 "
                         f"{len(cols[1])}")
    merged = ragged.interleave(cols)
    first = merged.offsets[:-1]
    second = first + cols[0].lens
    starts = np.stack([first, second], axis=1).reshape(-1)
    ends = np.stack([second, merged.offsets[1:]], axis=1).reshape(-1)
    return merged.data.tobytes(), starts, ends
