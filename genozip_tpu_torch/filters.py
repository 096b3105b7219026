"""`cat`: an archive's text, filtered or translated.

Filters, for the archives of every text datatype: --head/--tail/--lines/
--downsample/--one-vb (positional), --grep/--qnames/--bases (per record),
-r/--regions (whole VBs by the random-access index, then lines; SAM and
VCF), --header-only, --count, for FASTQ and SAM --seq-only/--qual-only, and
for paired archives --r1/--r2 (one component) and --interleave (records
alternating R1/R2). Translations: --sam (BAM archive to SAM text), --bam
[--index] (SAM archive to BGZF BAM and its BAI), --cram (through `samtools
view -C`), --coverage and --idxstats (coverage.py), --vcf (23andMe archive
to VCF, against a reference).

Counterpart of genozip_tpu/filters.py (reference src/writer.c:544-663).
Positional filters without a per-record predicate are plan edits
(writer_plan.py): VBs wholly outside the range are never reconstructed;
the others are applied by the plan executor. Where the port differs:

- F3: --one-vb N on a gencomp archive drains the deported lines of VBs
  1..N-1, so VB N gets its own (genozip_tpu's filters.py:130-134 drops
  them).
- F8: every filter applies to interleaved records too (genozip_tpu's
  --interleave ignores them).
- F10: a BAM archive's records are binary, and genozip_tpu cuts them at
  newline bytes for its per-record filters, so the port refuses those
  filters on a BAM archive; genozip_tpu's translations (--sam, --bam,
  --coverage, --idxstats, --vcf) ignore every filter but --no-header, so
  the port refuses a filter combined with one.
- F12: -r/--regions on a gencomp archive reconstructs every MAIN VB, and
  so keeps the PRIM/DEPN lines in the regions that genozip_tpu drops with
  the VBs it skips.
"""

import shutil
import subprocess
import sys

import numpy as np

from . import writer_plan as wp
from .piz_pipeline import PizReader, workers
from .translate import (VCF_ME23_HEADER, IndexingBgzfWriter,
                        bam_header_to_sam, bam_vb_to_sam, build_bai,
                        me23_vb_to_vcf, sam_header_to_bam, sam_vb_to_bam)
from .utils import profiler

# per-record and positional filters, in the order the refusals name them
FILTERS = ("head", "tail", "grep", "downsample", "regions", "lines",
           "qnames", "bases", "count", "seq_only", "qual_only", "one_vb",
           "header_only", "r1", "r2", "interleave")
# those of them that keep whole VBs, and so whole BAM records
_WHOLE_VB = ("one_vb", "header_only")


def _set(args, names):
    return [f"--{f.replace('_', '-')}" for f in names if getattr(args, f, None)]


def refuse_filters(args, translation: str):
    """F10: genozip_tpu's translations ignore every filter but --no-header;
    the port refuses the combination."""
    bad = _set(args, FILTERS)
    if bad:
        raise NotImplementedError(
            f"cat {translation} with {bad[0]}: genozip_tpu ignores the "
            f"filter there (fault F10); not supported")


def cat(args):
    """genozip_tpu's `cat` dispatch, in its order; the output goes to -o
    FILE or stdout (--cram hands -o to samtools)."""
    if getattr(args, "cram", False):
        cat_translated_cram(args, args.output)
        return
    out = open(args.output, "wb") if args.output else sys.stdout.buffer
    try:
        if args.coverage or args.idxstats:
            from .coverage import show_coverage
            show_coverage(args, out)
        elif args.sam:
            cat_translated_sam(args, out)
        elif args.bam:
            cat_translated_bam(args, out, args.output)
        elif args.vcf:
            cat_translated_vcf(args, out)
        else:
            cat_filtered(args, out)
    finally:
        if args.output:
            out.close()
        else:
            out.flush()


def cat_filtered(args, out):
    pr = PizReader(args.input, getattr(args, "reference", None),
                   getattr(args, "password", None))
    try:
        _cat(pr, args, out)
    finally:
        pr.close()


def _cat(pr, args, out):
    dt_name = pr.file_hdr["dt"]
    if dt_name == "bam":
        bad = _set(args, [f for f in FILTERS if f not in _WHOLE_VB])
        if bad:
            raise NotImplementedError(
                f"cat {bad[0]} of a BAM archive: its records are binary and "
                "genozip_tpu cuts them at newline bytes (fault F10); filter "
                "the SAM text of cat --sam instead")
    lines_per_rec = 4 if dt_name == "fastq" else 1
    grep = args.grep.encode() if getattr(args, "grep", None) else None
    head = getattr(args, "head", None)
    downsample = getattr(args, "downsample", None)
    tail = getattr(args, "tail", None)
    count_only = getattr(args, "count", False)
    lines_rng = None
    if getattr(args, "lines", None):
        # --lines=first-last (1-based, inclusive)
        a, _, b = args.lines.partition("-")
        lines_rng = (int(a) if a else 1, int(b) if b else 1 << 62)
    qnames = None
    if getattr(args, "qnames", None):
        # --qnames a,b,c or @FILE (src/qname_filter.c): keep records whose
        # QNAME is listed
        spec = args.qnames
        if spec.startswith("@"):
            with open(spec[1:], "rb") as f:
                qnames = {ln.strip() for ln in f if ln.strip()}
        else:
            qnames = {q.encode() for q in spec.split(",") if q}
    bases_pos = None
    if getattr(args, "bases", None):
        # --bases (src/bases_filter.c): keep only reads whose SEQ uses only
        # the given IUPAC characters (^ negates)
        neg = args.bases.startswith("^")
        bs = args.bases[1:] if neg else args.bases
        allowed = np.zeros(256, bool)
        allowed[np.frombuffer(bs.upper().encode(), np.uint8)] = True
        allowed[np.frombuffer(bs.lower().encode(), np.uint8)] = True
        bases_pos = (allowed, neg)
    regions = ra = line_filter = None
    if getattr(args, "regions", None):
        from . import regions as regions_mod
        from .format import sections as fmt
        regions = regions_mod.parse_regions(args.regions)
        payload, _ = pr.zr.read_one(fmt.SEC_RANDOM_ACCESS)
        if payload is not None:
            ra = fmt.json_parse(payload)

        def line_filter(buf):
            return regions_mod.filter_lines(buf, dt_name, regions)

    paired = pr.file_hdr.get("pair")
    interleave = getattr(args, "interleave", False)
    for flag in ("r1", "r2", "interleave"):
        if getattr(args, flag, False) and not paired:
            raise ValueError(f"--{flag} needs a paired archive")
    if interleave:
        plan = wp.build_interleave_plan(pr)
    else:
        plan = wp.build_plan(pr, 1 if getattr(args, "r2", False) else 0,
                             regions=regions, ra=ra)

    # the per-record predicate (the vb->drop_curr_line role)
    def content_pred(rec: bytes) -> bool:
        if grep is not None and grep not in rec:
            return False
        if qnames is not None and _rec_qname(rec, dt_name) not in qnames:
            return False
        if bases_pos is not None:
            allowed, neg = bases_pos
            a = np.frombuffer(_rec_seq(rec, dt_name), np.uint8)
            all_in = bool(allowed[a].all()) if a.shape[0] else True
            if all_in == neg:
                return False
        return True

    has_pred = grep is not None or qnames is not None or bases_pos is not None
    predicate = content_pred if has_pred else None
    if not has_pred and line_filter is None and not interleave and \
            (lines_rng or downsample or tail):
        # positional filters as plan edits: VBs wholly outside the range
        # are never reconstructed
        counts = wp.vb_record_counts(pr, plan)
        if downsample:
            plan = wp.edit_downsample(plan, downsample, counts)
        if lines_rng:
            plan = wp.edit_lines_range(plan, lines_rng[0], lines_rng[1],
                                       counts)
        if tail and not downsample and not lines_rng:
            plan = wp.edit_tail(plan, tail, counts)
            tail = None
    elif lines_rng or downsample:
        # positional filters on the ordinals of the records the regions'
        # line filter keeps (or of interleaved records), before the
        # per-record predicate
        state = {"i": 0}
        base_pred = predicate

        def predicate(rec: bytes) -> bool:
            state["i"] += 1
            i = state["i"]
            if lines_rng and not (lines_rng[0] <= i <= lines_rng[1]):
                return False
            if downsample and (i - 1) % downsample != 0:
                return False
            return base_pred is None or base_pred(rec)

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
        if dt_name not in ("fastq", "sam"):
            raise ValueError(f"--{proj}-only: unsupported for {dt_name}")
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
                    transform=transform, count_only=count_only,
                    line_filter=line_filter,
                    workers=1 if head else workers())


def _rec_qname(rec: bytes, dt_name: str) -> bytes:
    """The QNAME of one reconstructed record (for --qnames)."""
    if dt_name == "fastq":
        e = min(x for x in (rec.find(b"\n"), rec.find(b" "), rec.find(b"\t"),
                            len(rec)) if x >= 0)
        q = rec[1:e]
        return q[:-2] if q[-2:-1] == b"/" else q
    return rec.split(b"\t", 1)[0]


def _rec_seq(rec: bytes, dt_name: str) -> bytes:
    """The SEQ of one reconstructed record (for --bases): FASTQ line 1, SAM
    column 9, the whole line of other datatypes."""
    if dt_name == "fastq":
        p1 = rec.find(b"\n")
        p2 = rec.find(b"\n", p1 + 1)
        return rec[p1 + 1:p2 if p2 >= 0 else len(rec)]
    if dt_name == "sam":
        f = rec.split(b"\t", 10)
        return f[9] if len(f) > 9 else b""
    return rec.rstrip(b"\n")


def main_vbs(pr):
    """The MAIN (component 0) VBs in order, reconstructed ahead on the
    piz workers."""
    return pr.vbs_in_order(range(1, pr.comp_num_vbs(0) + 1), 0, workers())


def cat_translated_sam(args, out):
    """BAM archive -> SAM text (reference parity: genocat --sam,
    src/data_types.h:253-259)."""
    refuse_filters(args, "--sam")
    pr = PizReader(args.input, getattr(args, "reference", None),
                   getattr(args, "password", None))
    try:
        if pr.file_hdr["dt"] != "bam":
            raise ValueError("--sam translation needs a BAM archive")
        sam_hdr, ref_names = bam_header_to_sam(pr.txt_header())
        if not getattr(args, "no_header", False):
            out.write(sam_hdr)
        for buf in main_vbs(pr):
            with profiler.timer("cat:bam-to-sam"):
                sam = bam_vb_to_sam(buf, ref_names)
            out.write(sam)
    finally:
        pr.close()


def cat_translated_bam(args, out, out_path):
    """SAM archive -> BGZF BAM, and with --index the BAI at `out_path`.bai
    (reference parity: genocat --bam SAM2BAM translators,
    src/data_types.h:253-259, and native BAI generation, src/bai.c)."""
    refuse_filters(args, "--bam")
    index = getattr(args, "index", False)
    if index and not out_path:
        raise ValueError("--index needs --bam -o FILE")
    pr = PizReader(args.input, getattr(args, "reference", None),
                   getattr(args, "password", None))
    try:
        if pr.file_hdr["dt"] != "sam":
            raise ValueError("--bam translation needs a SAM archive")
        bam_hdr, name2id = sam_header_to_bam(pr.txt_header())
        w = IndexingBgzfWriter(out)
        w.write_blob(bam_hdr)
        cols = []   # per VB: (refids, poss, ends, vbeg, vend)
        for buf in main_vbs(pr):
            with profiler.timer("cat:sam-to-bam"):
                blob, lens, refids, poss, ends = sam_vb_to_bam(buf, name2id)
                vbeg, vend = w.write_records(blob, lens)
            cols.append((refids, poss, ends, vbeg, vend))
        w.close()
    finally:
        pr.close()
    if index:
        with profiler.timer("cat:bai"):
            e, u = np.zeros(0, np.int64), np.zeros(0, np.uint64)
            refids, poss, ends, vbeg, vend = (
                np.concatenate(c) for c in zip(*(cols or [(e, e, e, u, u)])))
            m = refids >= 0
            bai = build_bai(len(name2id), refids[m], poss[m], ends[m],
                            vbeg[m], vend[m])
        with open(out_path + ".bai", "wb") as f:
            f.write(bai)


def cat_translated_vcf(args, out):
    """23andMe archive -> VCF (reference parity: genocat --vcf on ME23,
    src/data_types.h:262); the REF base comes from the reference genome."""
    refuse_filters(args, "--vcf")
    pr = PizReader(args.input, getattr(args, "reference", None),
                   getattr(args, "password", None))
    try:
        if pr.file_hdr["dt"] != "me23":
            raise ValueError("--vcf translation needs a 23andMe archive")
        ref = pr.dt.ref
        if ref is None:
            raise ValueError("--vcf translation needs --reference")
        if not getattr(args, "no_header", False):
            out.write(VCF_ME23_HEADER)
        for buf in main_vbs(pr):
            with profiler.timer("cat:me23-to-vcf"):
                vcf = me23_vb_to_vcf(buf, ref)
            out.write(vcf)
    finally:
        pr.close()


def cat_translated_cram(args, out_path):
    """SAM/BAM archive -> CRAM via `samtools view -C` (reference parity: the
    SAM2CRAM translator role, src/data_types.h:253-259 + src/cram.c; the
    reference crosses the same samtools pipe, file.c:560). A SAM archive's
    text goes through the filters; a BAM archive's is cat --sam's."""
    tool = shutil.which("samtools")
    if not tool:
        raise RuntimeError("--cram needs `samtools` on PATH (the reference "
                           "bridges CRAM through samtools the same way, "
                           "file.c:560)")
    argv = [tool, "view", "-C", "-o", out_path or "/dev/stdout"]
    if getattr(args, "cram_ref", None):
        argv += ["-T", args.cram_ref]
    argv.append("-")
    pr = PizReader(args.input, getattr(args, "reference", None),
                   getattr(args, "password", None))
    dt = pr.file_hdr["dt"]
    pr.close()
    if dt not in ("sam", "bam"):
        raise ValueError("--cram needs a SAM or BAM archive")
    proc = subprocess.Popen(argv, stdin=subprocess.PIPE)
    try:
        if dt == "bam":
            cat_translated_sam(args, proc.stdin)
        else:
            cat_filtered(args, proc.stdin)
    finally:
        proc.stdin.close()
        rc = proc.wait()
    if rc:
        raise RuntimeError(f"samtools view -C exited with {rc}")
