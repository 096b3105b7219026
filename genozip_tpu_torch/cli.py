"""CLI: zip / unzip / cat / ls for FASTQ (single-end or paired), SAM, BAM and
VCF, with or without a reference genome, and for FASTA, GFF, BED, 23andMe,
LOCS and generic files (`zip --input-type` names the datatype where the
file's name and first bytes do not); `zip --make-reference` for FASTA, `zip
--deep` (a BAM with its FASTQs) and `zip --bamass`; `cat` translates SAM
and BAM archives (--sam, --bam [--index], --cram), counts their reads
(--coverage, --idxstats), and translates a 23andMe archive to VCF (--vcf).
Archives are encrypted with --password (AES-256-CTR); `zip --best` widens
the codec trials (BWT among them), `--md5` stores the input's MD5,
`--truncate` accepts an input cut mid-record, `--tar FILE` writes one
archive per input into a tar file, `--replace` removes the inputs once the
archive verified, and `--biopsy N` writes VB N's text. Inputs may be URLs
(curl or wget) or .cram, .bcf and .ora files (samtools, bcftools, orad).

Across devices: `zip --dp N` encodes N VBs' rANS sections at a time over N
devices (the same archive bytes), `zip --mesh N --reference R` places FASTQ
reads with the seed aligner kernel on N devices (genozip_tpu's mesh
aligner's placements, not the host aligner's), and `zip --hosts N` segs VB
stripes in N worker processes over torch.distributed (the same archive
bytes; plain inputs, not SAM/BAM: fault F5). `--hosts 1` is a plain zip.

Counterpart of genozip_tpu/cli.py, with its option names. `--device` names
where the kernels run: `cuda` (default; raises when no GPU is present) or
`cpu` (the kernels' plain PyTorch versions). The archive bytes are the
same either way. genozip_tpu drops some options without a word where
another one takes over (faults F14, F17); the port refuses them, naming
the fault: `--password`/`--md5` with `--pair`, `--deep` or `--hosts`
(F14); `--dp`/`--mesh` with `--pair`, `--deep` or `--tar`, and `--hosts`
with an option its workers would not see (F17). GXZ_REFERENCE names the
reference when --reference is not given. `cat -o FILE` writes what `cat`
prints to FILE.

`zip` and `unzip` take `--show-time` (the region totals, then the
counters in a table of their own) and `--trace-out FILE` (one Chrome trace
JSON of the command: spans, counters and, with `--device cuda`, the card's
operations from torch.profiler, on one clock; `utils/profiler.trace_to`).
"""

import argparse
import contextlib
import os


def _device_arg(p):
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the rANS kernels run (default: cuda)")


def _trace_args(p):
    p.add_argument("--show-time", action="store_true",
                   help="wall-clock region profile, then the counters "
                        "(rANS streams and bytes by route, card calls, "
                        "copies)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome trace JSON of the command: its "
                        "spans (one track a thread, with file and VB), its "
                        "counters and, with --device cuda, the card's "
                        "kernels, copies and memsets on the same clock")


def build_parser():
    p = argparse.ArgumentParser(prog="gxzip",
                                description="genomic compressor (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    z = sub.add_parser("zip", help="compress")
    z.add_argument("input")
    z.add_argument("input2", nargs="*", default=[],
                   help="R2 FASTQ with --pair; the FASTQ(s) with --deep")
    z.add_argument("--pair", action="store_true",
                   help="co-compress paired R1/R2 FASTQ files")
    z.add_argument("-o", "--output")
    z.add_argument("--input-type", dest="dt", default=None,
                   help="the input's datatype (fastq, sam, bam, vcf, fasta, "
                        "gff, bed, me23, locs, generic) where its name and "
                        "first bytes do not say")
    z.add_argument("--vblock", type=int, default=None, help="VB size in MB")
    z.add_argument("--stats", action="store_true")
    _trace_args(z)
    z.add_argument("--test", action="store_true",
                   help="verify by decompress+digest after compressing")
    z.add_argument("--fast", action="store_true",
                   help="favor speed: fewer codec trials")
    z.add_argument("-q", "--quiet", action="store_true",
                   help="suppress progress output")
    z.add_argument("-@", "--threads", type=int, default=None,
                   help="seg worker threads (default: all cores)")
    z.add_argument("--reference", default=None,
                   help="align SEQ against this .ref.gxz")
    z.add_argument("--REFERENCE", "--store-reference", dest="store_ref",
                   action="store_true",
                   help="also store the used reference ranges in the archive "
                        "so unzip needs no .ref file (REF_EXT_STORE)")
    z.add_argument("--make-reference", action="store_true",
                   help="compress a FASTA into a .ref.gxz reference")
    z.add_argument("--optimize", action="store_true",
                   help="LOSSY: bin QUAL to the Illumina 8-level scheme (the "
                        "archive digest covers the modified data)")
    z.add_argument("--bamass", default=None,
                   help="use an existing BAM's alignments for FASTQ SEQ "
                        "without storing the BAM (needs --reference)")
    z.add_argument("--deep", action="store_true",
                   help="co-compress a BAM (the first input) with its "
                        "FASTQ(s)")
    z.add_argument("--password", default=None,
                   help="encrypt with AES-256")
    z.add_argument("--md5", action="store_true",
                   help="also store the input's MD5 (checked by unzip)")
    z.add_argument("--truncate", action="store_true",
                   help="accept an input cut mid-record (the cut record is "
                        "dropped)")
    z.add_argument("--best", action="store_true",
                   help="favor ratio: wider codec trials, larger samples")
    z.add_argument("--replace", action="store_true",
                   help="remove the input(s) after the archive verified "
                        "(implies --test)")
    z.add_argument("--tar", default=None,
                   help="write one archive per input into this tar file")
    z.add_argument("--biopsy", type=int, default=None,
                   help="write VB N's raw text to INPUT.vbN and stop")
    z.add_argument("--mesh", type=int, default=None,
                   help="align FASTQ reads with the seed aligner kernel on N "
                        "devices (genome+refhash on each, reads split over "
                        "them); needs --reference")
    z.add_argument("--dp", type=int, default=None,
                   help="VBs data-parallel over N devices: N VBs' section "
                        "payloads encoded at a time, one launch per device; "
                        "archive bytes identical to the single-device path")
    z.add_argument("--hosts", type=int, default=None,
                   help="multi-host ZIP: N torch.distributed processes seg "
                        "VB stripes in parallel (dict-merge collective over "
                        "the process group); archive bytes identical to "
                        "single-process")
    _device_arg(z)

    u = sub.add_parser("unzip", help="decompress")
    u.add_argument("input")
    u.add_argument("-o", "--output")
    u.add_argument("--test", action="store_true", help="verify only")
    _trace_args(u)
    u.add_argument("--reference", default=None)
    u.add_argument("--password", default=None)
    _device_arg(u)

    c = sub.add_parser("cat", help="decompress to stdout")
    c.add_argument("input")
    c.add_argument("--head", type=int, default=None)
    c.add_argument("--tail", type=int, default=None)
    c.add_argument("--grep", default=None)
    c.add_argument("--downsample", type=int, default=None)
    c.add_argument("--no-header", action="store_true")
    c.add_argument("--header-only", action="store_true",
                   help="emit only the txt header")
    c.add_argument("--seq-only", action="store_true",
                   help="one SEQ line per record")
    c.add_argument("--qual-only", action="store_true",
                   help="one QUAL line per record")
    c.add_argument("--one-vb", type=int, default=None,
                   help="reconstruct a single VB")
    c.add_argument("--r1", action="store_true",
                   help="emit only R1 of a paired archive")
    c.add_argument("--r2", action="store_true",
                   help="emit only R2 of a paired archive")
    c.add_argument("--interleave", action="store_true",
                   help="interleave R1/R2 records of a paired archive")
    c.add_argument("-r", "--regions", default=None,
                   help="chr[:start-end][,...] region filter")
    c.add_argument("--bases", default=None,
                   help="keep reads whose SEQ uses only these IUPAC chars "
                        "(^ prefix negates)")
    c.add_argument("--count", action="store_true",
                   help="print the number of records that pass the filters")
    c.add_argument("--lines", default=None,
                   help="record range first-last, 1-based inclusive")
    c.add_argument("--qnames", default=None,
                   help="comma-separated QNAMEs, or @FILE with one per line")
    c.add_argument("--sam", action="store_true",
                   help="translate a BAM archive to SAM text")
    c.add_argument("--bam", action="store_true",
                   help="translate a SAM archive to BAM")
    c.add_argument("-o", "--output", default=None,
                   help="write the output to FILE instead of stdout")
    c.add_argument("--index", action="store_true",
                   help="with --bam -o FILE: also write FILE.bai")
    c.add_argument("--cram", action="store_true",
                   help="translate a SAM/BAM archive to CRAM via samtools")
    c.add_argument("--cram-ref", default=None,
                   help="FASTA passed to samtools -T for CRAM encoding")
    c.add_argument("--coverage", action="store_true",
                   help="per-contig read/base counts")
    c.add_argument("--idxstats", action="store_true",
                   help="samtools-idxstats-style read counts")
    c.add_argument("--reference", default=None)
    c.add_argument("--vcf", action="store_true",
                   help="translate a 23andMe archive to VCF (needs "
                        "--reference)")
    c.add_argument("--password", default=None)
    _device_arg(c)

    l = sub.add_parser("ls", help="list archive metadata")
    l.add_argument("inputs", nargs="+")
    l.add_argument("--stats", action="store_true",
                   help="per-context compressed-size table (SEC_STATS)")
    l.add_argument("--reference", default=None,
                   help="accepted; ls reads only metadata")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.reference is None and os.environ.get("GXZ_REFERENCE"):
        args.reference = os.environ["GXZ_REFERENCE"]
    if getattr(args, "quiet", False):
        from .utils import progress as _prog
        _prog.set_quiet(True)
    if args.cmd != "ls":
        from . import codecs
        codecs.enable_device_rans(args.device)
    from .utils import profiler
    trace_out = getattr(args, "trace_out", None)
    show_time = getattr(args, "show_time", False)
    if trace_out:
        traced = profiler.trace_to(trace_out, cuda=args.device == "cuda")
    elif show_time:
        traced = profiler.recording()
    else:
        traced = contextlib.nullcontext()
    with traced as rec:
        _run(args)
    if show_time:
        print(profiler.report())
        print(profiler.counters_report(rec.counters))
    return 0


def _run(args):
    if args.cmd == "zip":
        _zip(args)
    elif args.cmd == "unzip":
        from .piz_pipeline import piz_file
        if args.test:
            piz_file(args.input, None, reference=args.reference,
                     password=args.password)
            print("verified: round-trip digest OK")
            return
        out = args.output or args.input.removesuffix(".gxz")
        if out == args.input:
            out = args.input + ".out"
        piz_file(args.input, out, reference=args.reference,
                 password=args.password)
    elif args.cmd == "cat":
        from .filters import cat
        cat(args)
    elif args.cmd == "ls":
        _ls(args)


def _zip(args):
    if args.make_reference:
        from .ref.refstore import make_reference
        out = args.output or args.input + ".ref.gxz"
        ref = make_reference(args.input, out)
        print(f"reference: {ref.length:,} bases, "
              f"{len(ref.contigs)} contigs -> {out}")
        return
    if args.pair and len(args.input2) != 1:
        raise ValueError("--pair needs two FASTQ inputs")
    if args.deep and not args.input2:
        raise ValueError("--deep needs a BAM plus FASTQ input(s)")
    if args.input2 and not (args.pair or args.deep or args.tar):
        raise ValueError("more than one input needs --pair, --deep or --tar")
    if args.pair and args.store_ref:
        # genozip_tpu's zip_pair drops --REFERENCE without a word and writes
        # an archive that still needs the .ref file
        raise ValueError("--REFERENCE is not supported with --pair")
    hosts = args.hosts is not None and args.hosts > 1
    together = "pair" if args.pair else "deep" if args.deep else \
        "hosts" if hosts else None
    for opt in ("password", "md5"):
        if together and getattr(args, opt) and not args.tar:
            # genozip_tpu's zip_pair, zip_deep and zip_file_multihost take
            # neither option and write a plain archive without a word
            # (fault F14)
            raise ValueError(f"--{opt} is not supported with --{together} "
                             "(fault F14)")
    _refuse_dropped(args, hosts)
    from .codecs import assign as _assign
    mode = _assign.get_mode()
    if args.fast:
        _assign.set_mode("fast")
    elif args.best:
        _assign.set_mode("best")
    try:
        _zip_inputs(args)
    finally:
        _assign.set_mode(mode)


# what `--hosts` workers would not see: genozip_tpu's zip_file_multihost
# opens the input with no reference, datatype or options (F17)
HOSTS_DROPS = (("reference", "--reference"), ("dt", "--input-type"),
               ("threads", "--threads"), ("truncate", "--truncate"),
               ("bamass", "--bamass"), ("optimize", "--optimize"),
               ("store_ref", "--REFERENCE"), ("mesh", "--mesh"),
               ("dp", "--dp"), ("fast", "--fast"), ("best", "--best"),
               ("pair", "--pair"), ("deep", "--deep"), ("tar", "--tar"))


def _refuse_dropped(args, hosts):
    """Fault F17: genozip_tpu's zip runs --pair, --deep and --tar through
    functions that take neither --dp nor --mesh, and --hosts through
    workers that see only the input, the output and --vblock, and drops
    the rest without a word. The port refuses those combinations."""
    if args.mesh and not args.reference:
        raise ValueError("--mesh needs --reference (fault F17: genozip_tpu "
                         "ignores it without one)")
    for opt in ("dp", "mesh"):
        if getattr(args, opt):
            for other in ("pair", "deep", "tar"):
                if getattr(args, other):
                    raise ValueError(f"--{opt} is not supported with "
                                     f"--{other} (fault F17)")
    if hosts:
        for attr, name in HOSTS_DROPS:
            if getattr(args, attr):
                raise ValueError(f"{name} is not supported with --hosts "
                                 "(fault F17)")


def _zip_inputs(args):
    from .zip_pipeline import zip_deep, zip_file, zip_pair
    out = args.output or args.input + ".gxz"
    vb = (args.vblock * (1 << 20)) if args.vblock else None
    if args.biopsy is not None:
        from .biopsy import biopsy_take
        path = biopsy_take(args.input, args.biopsy, dt_name=args.dt,
                           vb_size=vb)
        print(f"biopsy: VB {args.biopsy} -> {path}")
        return
    if args.tar:
        _zip_tar(args, vb)
        return
    if args.deep:
        zip_deep(args.input, list(args.input2), out, vb_size=vb,
                 show_stats=args.stats, reference=args.reference,
                 threads=args.threads)
        if args.test:
            from .piz_pipeline import piz_file
            piz_file(out, None, reference=args.reference)
            print("verified: round-trip digest OK")
        return
    if args.pair:
        zip_pair(args.input, args.input2[0], out, vb_size=vb,
                 show_stats=args.stats, reference=args.reference,
                 threads=args.threads, optimize=args.optimize)
    elif args.hosts is not None and args.hosts > 1:
        from .parallel.multihost import zip_file_multihost
        zip_file_multihost(args.input, out, n_procs=args.hosts, vb_size=vb,
                           device=args.device, show_stats=args.stats)
    else:
        zip_file(args.input, out, vb_size=vb, show_stats=args.stats,
                 threads=args.threads, reference=args.reference,
                 store_ref=args.store_ref, optimize=args.optimize,
                 bamass=args.bamass, dt_name=args.dt,
                 password=args.password, use_md5=args.md5,
                 truncate=args.truncate, dp=args.dp, mesh=args.mesh)
    if args.test or args.replace:
        from .piz_pipeline import piz_file
        piz_file(out, None, reference=args.reference, password=args.password)
        print("verified: round-trip digest OK")
    if args.replace:
        # the inputs go only after the archive's digest verified above
        for path in [args.input, *args.input2]:
            os.unlink(path)


def _zip_tar(args, vb):
    """--tar: each input's own archive (the options genozip_tpu passes
    there: --input-type, --vblock, --reference, --password, --md5) as a
    member named after the input."""
    import tarfile
    import tempfile
    from .zip_pipeline import zip_file
    inputs = [args.input, *args.input2]
    tmp_dir = os.path.dirname(os.path.abspath(args.tar))
    with tarfile.open(args.tar, "w") as tf:
        for inp in inputs:
            with tempfile.NamedTemporaryFile(suffix=".gxz",
                                             dir=tmp_dir) as tmp:
                zip_file(inp, tmp.name, dt_name=args.dt, vb_size=vb,
                         reference=args.reference, password=args.password,
                         use_md5=args.md5)
                tf.add(tmp.name, arcname=inp.rsplit("/", 1)[-1] + ".gxz")
    print(f"tar: {len(inputs)} archive(s) -> {args.tar}")


def _ls(args):
    """Archive metadata from the file header; needs no device."""
    from .format import sections as fmt
    print(f"{'name':30s} {'type':8s} {'txt_len':>14s} {'z_len':>14s} "
          f"{'ratio':>7s} {'lines':>12s}")
    for path in args.inputs:
        with open(path, "rb") as f:
            zr = fmt.ZReader(f)
            payload, _ = zr.read_one(fmt.SEC_FILE_HEADER)
            h = fmt.json_parse(payload)
            zlen = os.path.getsize(path)
            print(f"{h.get('txt_name', path):30s} {h['dt']:8s} "
                  f"{h['txt_len']:>14,} {zlen:>14,} "
                  f"{h['txt_len'] / max(zlen, 1):>6.1f}x {h['num_lines']:>12,}")
            if args.stats and h.get("enc"):
                raise ValueError(f"ls --stats: {path} is encrypted, and so "
                                 "is its stats section")
            if args.stats:
                payload, _ = zr.read_one(fmt.SEC_STATS)
                if payload is not None:
                    per_ctx = fmt.json_parse(payload)
                    for name, (u_, z_) in sorted(per_ctx.items(),
                                                 key=lambda kv: -kv[1][1]):
                        print(f"    {name:14s} z {z_:>12,} "
                              f"({100.0 * z_ / max(zlen, 1):5.1f}%)")
