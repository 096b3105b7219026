"""`cat --coverage` and `cat --idxstats`: reads and bases per contig of a SAM
or BAM archive (reference parity: src/coverage.c coverage_show_coverage
:52), from the reconstructed records, vectorized per VB.

Counterpart of genozip_tpu/coverage.py, with its output bytes: --idxstats
prints 0 for each contig's length and unmapped count, where samtools
idxstats prints the length and the unmapped reads placed on the contig.
genozip_tpu counts a BAM archive's records on their SAM translation; the
port reads the three fields it needs (RNAME, FLAG, SEQ's length, which is
1 for an empty SEQ, whose text is '*') from the binary records, without
decoding their aux fields.
"""

import numpy as np

from .contexts import dedup_col
from .datatypes.bam import bam_scan
from .filters import refuse_filters, main_vbs
from .piz_pipeline import PizReader
from .translate import bam_header_to_sam
from .utils import profiler, ragged
from .utils.ragged import Col


def show_coverage(args, out):
    """Write the table to `out` (a binary file)."""
    refuse_filters(args, "--idxstats" if getattr(args, "idxstats", False)
                   else "--coverage")
    pr = PizReader(args.input, getattr(args, "reference", None),
                   getattr(args, "password", None))
    try:
        dt = pr.file_hdr["dt"]
        if dt not in ("sam", "bam"):
            raise ValueError("--coverage/--idxstats need SAM/BAM archives")
        ref_names = None
        if dt == "bam":
            _, ref_names = bam_header_to_sam(pr.txt_header())
        reads, bases = {}, {}
        unmapped = 0
        for buf in main_vbs(pr):
            with profiler.timer("cat:coverage"):
                cols = _bam_fields(buf, ref_names) if dt == "bam" \
                    else _sam_fields(buf)
                if cols is not None:
                    unmapped += _count(*cols, reads, bases)
    finally:
        pr.close()

    if getattr(args, "idxstats", False):
        rows = [f"{name}\t0\t{reads[name]}\t0\n" for name in reads]
        rows.append(f"*\t0\t0\t{unmapped}\n")
    else:
        rows = [f"{'contig':20s} {'reads':>12s} {'bases':>15s}\n"]
        rows += [f"{name:20s} {reads[name]:>12,} {bases[name]:>15,}\n"
                 for name in sorted(reads, key=lambda k: -reads[k])]
        rows.append(f"{'(unmapped)':20s} {unmapped:>12,}\n")
    out.write("".join(rows).encode())


def _sam_fields(buf: bytes):
    """(FLAG, RNAME column, SEQ length) of the lines of SAM text with 11
    fields or more, or None if there are none."""
    a = np.frombuffer(buf, np.uint8)
    nl = np.nonzero(a == ord("\n"))[0]
    starts = np.concatenate([[0], nl[:-1] + 1])
    lines = ragged.gather_ranges(a, starts, nl - starts)
    fields, rest, good, bad = ragged.split_first_fields(lines, ord("\t"), 11)
    if good.shape[0] == 0:
        return None
    return ragged.atoi(fields[1])[0], fields[2], fields[9].lens


def _bam_fields(buf: bytes, ref_names):
    """The fields of `_sam_fields` from a VB of BAM records, as their SAM
    translation (`translate.bam_vb_to_sam`) would give them."""
    data = np.frombuffer(buf, np.uint8)
    off, _ = bam_scan(data, 1 << 24)
    if off.shape[0] == 0:
        return None
    refid = (data[off + 4].astype(np.uint32) |
             data[off + 5].astype(np.uint32) << 8 |
             data[off + 6].astype(np.uint32) << 16 |
             data[off + 7].astype(np.uint32) << 24).astype(np.int32)
    flag = data[off + 18].astype(np.int64) | \
        data[off + 19].astype(np.int64) << 8
    l_seq = (data[off + 20].astype(np.int64) |
             data[off + 21].astype(np.int64) << 8 |
             data[off + 22].astype(np.int64) << 16 |
             data[off + 23].astype(np.int64) << 24)
    names = Col.from_list([b"*"] + [n.encode() for n in ref_names])
    rname = ragged.take(names, refid.astype(np.int64) + 1)
    return flag, rname, np.where(l_seq > 0, l_seq, 1)


def _count(flags, rname, seqlen, reads: dict, bases: dict) -> int:
    """Add one VB's mapped reads and their SEQ bases to `reads` and `bases`
    by RNAME; returns its unmapped reads."""
    uw, inv = dedup_col(rname)
    mapped_mask = (flags & 4) == 0
    for w in range(len(uw)):
        name = uw.row(w).decode("utf-8", "replace")
        if name == "*":
            continue
        m = (inv == w) & mapped_mask
        if not m.any():
            continue
        reads[name] = reads.get(name, 0) + int(m.sum())
        bases[name] = bases.get(name, 0) + int(seqlen[m].sum())
    return int(((flags & 4) != 0).sum())
