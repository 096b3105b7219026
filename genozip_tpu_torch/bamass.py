"""bamass: compress a FASTQ with the help of an existing BAM's alignments,
without storing the BAM (reference src/fastq_bamass.c:231,366, genozip
--bamass).

genozip_tpu_torch's own copy of genozip_tpu/bamass.py. The BAM gives each
QNAME a placement (genome position, orientation) from its first primary,
mapped alignment with one CIGAR op `<l_seq>M`; FASTQ SEQ is then stored in
the aligner's contexts (SQBITMAP, GPOS, STRAND, mismatch channels against
the reference), so unzip needs only --reference, not the BAM. Reads the BAM
does not place go through the aligner.
"""

import numpy as np

from .datatypes import get
from .datatypes.bam import bam_scan
from .translate import bam_header_to_sam
from .txtfile import TxtReader
from .utils import ragged


class BamAssIndex:
    """qname -> (gpos, is_revcomp) from primary, simple-CIGAR alignments."""

    def __init__(self, ref):
        self.ref = ref
        self.map = {}

    def add_bam_records(self, records: bytes, ref_names):
        data = np.frombuffer(records, np.uint8)
        off, _ = bam_scan(data, 1 << 24)
        n = off.shape[0]
        if n == 0:
            return

        def u16(o):
            return data[o].astype(np.int64) | (data[o + 1].astype(np.int64) << 8)

        def u32(o):
            return (data[o].astype(np.int64) | (data[o + 1].astype(np.int64) << 8)
                    | (data[o + 2].astype(np.int64) << 16)
                    | (data[o + 3].astype(np.int64) << 24))

        refid = u32(off + 4).astype(np.uint32).astype(np.int32)
        pos = u32(off + 8).astype(np.uint32).astype(np.int32)
        l_rn = data[off + 12].astype(np.int64)
        n_cig = u16(off + 16)
        flag = u16(off + 18)
        l_seq = u32(off + 20)
        name = ragged.gather_ranges(data, off + 36, l_rn - 1)
        cig_col = ragged.gather_ranges(data, off + 36 + l_rn, 4 * n_cig)

        # contig gpos bases by refid
        bases = np.full(len(ref_names) + 1, -1, dtype=np.int64)
        for i, nm in enumerate(ref_names):
            c = self.ref.contig_of(nm)
            if c is not None:
                bases[i] = c["gpos"]

        craw = np.frombuffer(cig_col.data.tobytes(), "<u4").astype(np.int64) \
            if cig_col.data.shape[0] else np.zeros(0, np.int64)
        cig_of = np.concatenate([[0], np.cumsum(n_cig)])
        simple = np.zeros(n, dtype=bool)
        if craw.shape[0]:
            first_op = np.zeros(n, dtype=np.int64)
            first_op[n_cig > 0] = craw[cig_of[:-1][n_cig > 0]]
            simple = (n_cig == 1) & ((first_op & 15) == 0) & \
                ((first_op >> 4) == l_seq)
        primary = (flag & 0x900) == 0
        mapped = (flag & 4) == 0
        ridx = np.clip(refid, 0, len(ref_names) - 1)
        ok = simple & primary & mapped & (refid >= 0) & \
            (refid < len(ref_names)) & (bases[ridx] >= 0)
        gpos = bases[ridx] + pos
        rev = (flag & 16) != 0
        for r in np.nonzero(ok)[0]:
            self.map.setdefault(name.row(int(r)), (int(gpos[r]), bool(rev[r])))

    def lookup(self, desc_col):
        """Per FASTQ read: (gpos or -1, is_fwd), found by its qname."""
        n = len(desc_col)
        gpos = np.full(n, -1, dtype=np.int64)
        fwd = np.ones(n, dtype=bool)
        for i in range(n):
            d = desc_col.row(i)
            if d[:1] == b"@":
                d = d[1:]
            sp = d.find(b" ")
            if sp >= 0:
                d = d[:sp]
            e = self.map.get(d)
            if e is None and len(d) > 2 and d[-2:-1] == b"/":
                e = self.map.get(d[:-2])
            if e is not None:
                gpos[i] = e[0]
                fwd[i] = not e[1]
        return gpos, fwd


def build_index(bam_path: str, ref) -> BamAssIndex:
    """The placements of every record of the BAM at `bam_path` against
    genome `ref`, read in 64 MiB blocks."""
    reader = TxtReader(bam_path)
    try:
        dt = get("bam")()
        _, ref_names = bam_header_to_sam(dt.read_txt_header(reader))
        idx = BamAssIndex(ref)
        for data in reader.vblocks(dt, 64 << 20):
            idx.add_bam_records(data.tobytes(), ref_names)
    finally:
        reader.close()
    return idx
