"""Recon-plan IR + executor: the writer backbone of `cat`.

Counterpart of genozip_tpu/writer_plan.py (reference src/writer.c:866
writer_create_plan, :1203 writer_main_loop). A plan is a list of typed items
built from the archive (one component, or a paired archive's two components
interleaved, the reference's PLAN_INTERLEAVE) and edited by the positional
filters (--tail/--downsample/--one-vb); per-record predicates (--grep) and
projections (--seq-only/--qual-only) are applied by the executor, to
interleaved records as to any others. A MAIN VB of a gencomp archive that a
filter skips stays in the plan as DRAIN_VB, which consumes its share of the
deported PRIM/DEPN lines, so the VBs after it get their own lines back.
"""

from dataclasses import dataclass

import numpy as np

from .format import sections as fmt
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


def build_plan(pr, comp_i: int = 0):
    """Full plan of one component: header + every VB."""
    return [PlanItem(TXTHEADER, comp_i=comp_i)] + [
        PlanItem(VB_RANGE, vb_i=vb_i, comp_i=comp_i)
        for vb_i in range(1, pr.comp_num_vbs(comp_i) + 1)]


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


def edit_tail(plan, k: int, counts):
    """--tail=k: keep only the last k records; VBs wholly before them
    drain, never reconstructed."""
    total = sum(c for it, c in zip(plan, counts) if it.kind == VB_RANGE)
    first = max(total - k, 0)      # 0-based ordinal of the first kept record
    out = []
    seen = 0
    for it, cnt in zip(plan, counts):
        if it.kind != VB_RANGE:
            out.append(it)
            continue
        lo = seen
        seen += cnt
        if seen <= first:
            out.append(PlanItem(DRAIN_VB, vb_i=it.vb_i, comp_i=it.comp_i))
            continue
        out.append(PlanItem(VB_RANGE, vb_i=it.vb_i, comp_i=it.comp_i,
                            start=max(first - lo, 0), step=it.step,
                            phase=it.phase))
    return out


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
                 no_header: bool = False, transform=None):
    """The writer loop: consume plan items in order, apply the per-record
    predicate, honour the head budget, buffer for tail-after-predicates and
    emit. `transform` maps each emitted record (None drops it)."""
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
        out.write(rec)
        return not (head and emitted >= head)

    whole = predicate is None and head is None and tail is None and \
        transform is None
    for it in plan:
        if it.kind == TXTHEADER:
            hdr = pr.txt_header(it.comp_i)
            if hdr and not no_header:
                out.write(hdr)
            continue
        if it.kind == DRAIN_VB:
            if pr.ensure_gencomp():
                pr.drain_vb_gencomp(it.vb_i)
            continue
        if it.kind == INTERLEAVE:
            buf, starts, ends = _interleaved(pr, it.vb_i, lines_per_rec)
        else:
            buf = pr.read_vb(it.vb_i, it.comp_i)
        if whole and it.start == 0 and it.step == 1:
            out.write(buf)
            continue
        if it.kind != INTERLEAVE:
            starts, ends = records_of(buf, lines_per_rec)
        stop = False
        for r in range(it.start, starts.shape[0]):
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
    for rec in tail_buf:
        out.write(rec)
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
