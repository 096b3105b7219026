"""Datatype plugin registry: FASTQ (single-end or paired), SAM, BAM and VCF,
with or without a reference genome, and FASTA, GFF, BED, 23andMe, LOCS and
generic files.

Counterpart of genozip_tpu/datatypes/__init__.py, with every datatype of
genozip_tpu registered.
Reference parity: src/data_types.h:50-161 DataTypeProperties vtable (~45
callbacks per datatype) — reduced here to the callbacks the engine
actually inverts control through: VB boundary alignment, txt-header split,
whole-VB vectorized seg, whole-VB vectorized recon, plus optional segconf
scanning and special recon callbacks.
"""

import numpy as np


class VBSegResult:
    __slots__ = ("ctxs", "num_lines", "meta")

    def __init__(self, ctxs, num_lines, meta=None):
        self.ctxs = ctxs            # dict[str, contexts.VBCtx]
        self.num_lines = num_lines
        self.meta = meta or {}      # extra per-VB recon info (json-able)


class DataType:
    NAME = "generic"
    EXTS = ()

    def __init__(self, segconf=None):
        self.segconf = segconf or {}
        self.optimize_enabled = False  # --optimize: lossy QUAL binning
        # per-file lazy seg choices (qual demux class, VCF CSQ/int-list/ID
        # layout trials) may commit only while seg is single-threaded;
        # see freeze_lazy_choices()
        self._seg_lazy_frozen = False

    def freeze_lazy_choices(self):
        """Called by the ZIP pipeline after the serial calibration seg and
        before the concurrent VB fan-out: per-file trial-once memos are
        final from here on. A pattern first appearing in a later VB takes
        a deterministic per-VB fallback instead of trial-committing shared
        state under concurrency — archive bytes must never depend on
        thread scheduling (the byte-identity guarantee test_determinism.py
        checks; reference analog: codec.c:179-186 holds VB 1's merge lock
        so first-sight commits happen exactly once)."""
        self._seg_lazy_frozen = True

    # --- ZIP side ---
    def read_txt_header(self, reader) -> bytes:
        """Peel a txt header off the stream reader (e.g. SAM '@' lines,
        VCF '##'). Default: none."""
        return b""

    def vb_boundary(self, data: np.ndarray, is_eof: bool) -> int:
        """Bytes of `data` forming whole records (a VB must contain whole
        records only — reference src/txtfile.c:953). Default: whole lines."""
        if is_eof:
            return data.shape[0]
        nl = np.nonzero(data == ord("\n"))[0]
        return int(nl[-1]) + 1 if nl.shape[0] else 0

    def optimize_vb(self, data: np.ndarray) -> np.ndarray:
        """--optimize hook: lossy per-VB transform applied before seg
        (reference sam_modify.c). Default: identity."""
        return data

    def segconf_scan(self, sample: np.ndarray):
        """Inspect a sample to set segconf knobs (reference src/segconf.c:459
        segconf_calculate — the reference segs a whole sample VB; here a
        cheap whole-buffer scan sets sizing/codec hints, and per-VB seg is
        already adaptive where the reference needed pre-commitment)."""
        if sample.shape[0] == 0:
            return
        nl = np.nonzero(sample == ord("\n"))[0]
        nlines = int(nl.shape[0])
        avg = float(sample.shape[0] / max(nlines, 1))
        self.segconf["avg_line_len"] = round(avg, 1)

    def suggested_vb_size(self) -> int | None:
        """File-size-aware VB sizing (reference segconf.c:101
        segconf_set_vb_size): aim for enough VBs to keep the dispatcher fed
        while amortizing per-VB dict/codec overhead on big files.
        Deterministic — depends only on the recorded size estimate."""
        est = self.segconf.get("txt_size_est")
        if not est:
            return None
        # fixed VB-count target (not cpu_count-derived): the same input must
        # produce the same archive bytes on any host, so sizing may depend
        # only on the recorded size estimate.
        target_vbs = 32
        vb = est // target_vbs
        lo, hi = 4 << 20, 64 << 20
        vb = max(lo, min(hi, vb))
        # round down to a power of two for stable, cache-friendly sizes
        p = 1 << (int(vb).bit_length() - 1)
        return p

    def seg_vb(self, data: np.ndarray) -> VBSegResult:
        raise NotImplementedError

    # --- PIZ side ---
    def recon_vb(self, pctxs: dict, meta: dict) -> bytes:
        raise NotImplementedError

    def split_records(self, data: np.ndarray):
        """Record boundaries for gencomp re-interleaving (each row includes
        its terminator). Default: newline-terminated lines; binary
        datatypes (BAM) override with their record framing."""
        from ..utils.ragged import Col
        nl = np.nonzero(data == ord("\n"))[0]
        if data.shape[0] and (nl.shape[0] == 0 or
                              nl[-1] != data.shape[0] - 1):
            nl = np.concatenate([nl, [data.shape[0] - 1]])
        return Col(data, np.concatenate([[0], nl + 1]))

    def build_sag_store(self, prim_data: np.ndarray):
        """SAG store from the PRIM component's bytes (reference
        src/sam_sag_ingest.c / sam_sag_load.c roles, called identically at
        ZIP and PIZ). Datatypes without gencomp return None."""
        return None


_REGISTRY = {}


def register(cls):
    _REGISTRY[cls.NAME] = cls
    return cls


def get(name: str) -> type:
    from . import (bam, bed, fasta, fastq, generic, gff, locs,  # noqa: F401
                   me23, sam, vcf)
    if name not in _REGISTRY:
        raise ValueError(f"unknown datatype {name!r} (known: "
                         f"{', '.join(sorted(_REGISTRY))})")
    return _REGISTRY[name]


def detect(path: str, head: bytes) -> str:
    """File-type detection by extension then content sniffing
    (reference src/file.c file_get_data_type + src/flags.c --input)."""
    p = path.lower()
    for ext in (".gz", ".bgz", ".bz2", ".xz"):
        if p.endswith(ext):
            p = p[: -len(ext)]
    ext_map = {
        ".fastq": "fastq", ".fq": "fastq",
        ".fasta": "fasta", ".fa": "fasta", ".fna": "fasta", ".ffn": "fasta",
        ".faa": "fasta", ".frn": "fasta",
        ".vcf": "vcf",
        ".sam": "sam", ".bam": "bam",
        ".gff": "gff", ".gff3": "gff", ".gvf": "gff", ".gtf": "gff",
        ".bed": "bed",
        ".locs": "locs",
        ".txt": None, ".genome": None,
    }
    for ext, dt in ext_map.items():
        if p.endswith(ext) and dt:
            return dt
    # content sniffing (head is already decompressed by the input layer)
    if head[:4] == b"BAM\x01":
        return "bam"
    if head[:1] == b">":
        return "fasta"
    if head[:1] == b"@":
        lines = head.split(b"\n")
        if len(lines) >= 3 and lines[2][:1] == b"+":
            return "fastq"
        return "sam"
    if head[:2] == b"##" and b"VCF" in head[:100]:
        return "vcf"
    if head[:15] == b"# This data fil" or p.endswith(".23andme"):
        return "me23"
    return "generic"
