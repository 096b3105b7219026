"""Deep: a BAM and the FASTQ files it was aligned from, in one archive
(reference src/deep.h, src/sam_deep.c:208 sam_deep_zip_merge,
src/fastq_deep.c:680 fastq_deep_seg_SEQ). A FASTQ read whose SEQ (and QUAL)
equal its BAM alignment's stores only a hit flag; SEQ and QUAL come back
from the BAM at PIZ.

genozip_tpu_torch's own copy of genozip_tpu/deep.py. The index maps each
QNAME to the first primary alignment that carries it (seq, qual,
orientation), built from raw BAM records in VB order with the port's
`datatypes/bam.bam_scan`; a FASTQ read finds its row by a dict lookup per
read. R2 of a pair therefore finds R1's row and, unless they are equal,
stores its SEQ and QUAL: the archive bytes depend on that. PIZ rebuilds the
index from the reconstructed BAM component, which comes first.
"""

import threading

import numpy as np

from .datatypes.bam import bam_scan
from .ref.aligner import _rev_seq
from .utils import ragged
from .utils.ragged import Col

FLAG_REVCOMP = 16
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800
SEQ_NIBBLE = b"=ACMGRSVTWYHKDBN"


class DeepIndex:
    """qname -> row in (seq Col, qual Col, revcomp flags). Records are added
    in VB order from one thread; lookups may come from many once the last
    record is in."""

    def __init__(self):
        self.qname2row = {}
        self.seq_parts = []
        self.qual_parts = []
        self.rev_parts = []
        self._built = None
        self._lock = threading.Lock()

    def add_bam_records(self, records: bytes):
        data = np.frombuffer(records, np.uint8)
        off, consumed = bam_scan(data, 1 << 24)
        if consumed != data.shape[0]:
            raise ValueError("deep: BAM VB ends inside a record")
        n = off.shape[0]
        if n == 0:
            return

        def u16(o):
            return data[o].astype(np.int64) | (data[o + 1].astype(np.int64) << 8)

        def u32(o):
            return (data[o].astype(np.int64) | (data[o + 1].astype(np.int64) << 8)
                    | (data[o + 2].astype(np.int64) << 16)
                    | (data[o + 3].astype(np.int64) << 24))

        l_rn = data[off + 12].astype(np.int64)
        n_cig = u16(off + 16)
        flag = u16(off + 18)
        l_seq = u32(off + 20)
        name = ragged.gather_ranges(data, off + 36, l_rn - 1)
        seq_start = off + 36 + l_rn + 4 * n_cig
        seq_bytes = (l_seq + 1) // 2
        qual_start = seq_start + seq_bytes

        # decode 4-bit SEQ to ASCII
        seq_col = ragged.gather_ranges(data, seq_start, seq_bytes)
        nib = np.frombuffer(SEQ_NIBBLE, np.uint8)
        expanded = np.empty(seq_col.data.shape[0] * 2, dtype=np.uint8)
        expanded[0::2] = nib[seq_col.data >> 4]
        expanded[1::2] = nib[seq_col.data & 15]
        seq_txt = ragged.gather_ranges(expanded, seq_col.offsets[:-1] * 2, l_seq)
        qual_col = ragged.gather_ranges(data, qual_start, l_seq)
        qual_txt = Col((qual_col.data + 33).astype(np.uint8), qual_col.offsets)

        primary = (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
        base = sum(len(p) for p in self.seq_parts)
        rows = np.nonzero(primary & (l_seq > 0))[0]
        for j, r in enumerate(rows):
            self.qname2row.setdefault(name.row(int(r)), base + j)
        self.seq_parts.append(ragged.take(seq_txt, rows))
        self.qual_parts.append(ragged.take(qual_txt, rows))
        self.rev_parts.append((flag[rows] & FLAG_REVCOMP) != 0)
        self._built = None

    def _build(self):
        with self._lock:
            if self._built is None:
                def cat(parts):
                    if not parts:
                        return Col.from_list([])
                    data = np.concatenate([p.data for p in parts])
                    lens = np.concatenate([p.lens for p in parts])
                    return Col(data, np.concatenate([[0], np.cumsum(lens)]))
                self._built = (cat(self.seq_parts), cat(self.qual_parts),
                               np.concatenate(self.rev_parts)
                               if self.rev_parts else np.zeros(0, bool))
            return self._built

    def lookup_rows(self, desc_col: Col) -> np.ndarray:
        """qname per FASTQ desc row -> index row (or -1). Strips '@', takes
        the first space-separated token, tries with and without a /1 /2
        suffix."""
        n = len(desc_col)
        out = np.full(n, -1, dtype=np.int64)
        q2r = self.qname2row
        for i in range(n):
            d = desc_col.row(i)
            if d[:1] == b"@":
                d = d[1:]
            sp = d.find(b" ")
            if sp >= 0:
                d = d[:sp]
            r = q2r.get(d)
            if r is None and len(d) > 2 and d[-2:-1] == b"/":
                r = q2r.get(d[:-2])
            out[i] = -1 if r is None else r
        return out

    def fetch(self, rows: np.ndarray):
        """Returns (seq Col, qual Col) for index rows, in FASTQ orientation
        (reverse-complemented back when the alignment was revcomp)."""
        seq, qual, rev = self._build()
        s = ragged.take(seq, rows)
        q = ragged.take(qual, rows)
        rrev = rev[rows]
        if rrev.any():
            ridx = np.nonzero(rrev)[0]
            fwd = np.nonzero(~rrev)[0]
            mat, lens = ragged.to_matrix(ragged.take(s, ridx))
            s = ragged.merge_rows(len(s), [
                (fwd, ragged.take(s, fwd)),
                (ridx, ragged.from_matrix(_rev_seq(mat, lens), lens))])
            qmat, qlens = ragged.to_matrix(ragged.take(q, ridx))
            qrev = np.take_along_axis(
                qmat, np.clip(qlens[:, None] - 1 - np.arange(qmat.shape[1])[None, :],
                              0, qmat.shape[1] - 1), axis=1)
            q = ragged.merge_rows(len(q), [
                (fwd, ragged.take(q, fwd)),
                (ridx, ragged.from_matrix(qrev, qlens))])
        return s, q
