"""Archive translations (reference parity: src/data_types.h:251-262
TRANSLATIONS, src/bai.c): `cat --sam` turns a BAM archive's records into
SAM text, `cat --bam` a SAM archive's lines into BGZF BAM records, `cat
--bam --index` also writes the BAI index of what it wrote, and `cat --vcf`
turns a 23andMe archive's rows into VCF records (src/me23.c).

genozip_tpu_torch's own copy of genozip_tpu/translate.py:
`bam_header_to_sam`, `bam_vb_to_sam` (vectorized fixed fields, a Python
decode of each record's aux), `sam_header_to_bam`, `sam_vb_to_bam`,
`IndexingBgzfWriter`, `build_bai`, `VCF_ME23_HEADER` and `me23_vb_to_vcf`.
The record walk is the port's Python `datatypes/bam.bam_scan`. `synth.py`
and the tests use the SAM -> BAM half too.
"""

import struct

import numpy as np

from .contexts import dedup_col
from .datatypes.bam import bam_scan
from .ops import pack as packops
from .utils import ragged
from .utils.bgzf import EOF_BLOCK, _one_block
from .utils.ragged import Col

CIGAR_OPS = b"MIDNSHP=X"
SEQ_NIBBLE = b"=ACMGRSVTWYHKDBN"

_NIB_OF = np.full(256, 15, np.uint8)       # unknown base -> N
for _i, _b in enumerate(SEQ_NIBBLE):
    _NIB_OF[_b] = _i
    _NIB_OF[_b + 32] = _i
_CIG_OP = np.full(256, 255, np.uint8)
for _i, _b in enumerate(CIGAR_OPS):
    _CIG_OP[_b] = _i
_REF_CONSUME = frozenset(b"MDN=X")


def bam_header_to_sam(bam_header: bytes) -> tuple[bytes, list[str]]:
    """BAM header blob -> (SAM header text, ref name list)."""
    l_text = int.from_bytes(bam_header[4:8], "little")
    text = bam_header[8:8 + l_text]
    off = 8 + l_text
    n_ref = int.from_bytes(bam_header[off:off + 4], "little")
    off += 4
    names = []
    for _ in range(n_ref):
        ln = int.from_bytes(bam_header[off:off + 4], "little")
        names.append(bam_header[off + 4: off + 4 + ln - 1].decode())
        off += 8 + ln
    return text.rstrip(b"\x00"), names


_INT_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}
_ARRAY_FMT = dict(_INT_FMT, f="<f")


def _aux_to_sam(rec: memoryview) -> bytes:
    """One record's aux blob -> SAM text (\\t-joined, leading \\t included)."""
    out = []
    off = 0
    n = len(rec)
    while off + 3 <= n:
        tag = bytes(rec[off:off + 2]).decode()
        t = chr(rec[off + 2])
        off += 3
        if t == "A":
            out.append(f"{tag}:A:{chr(rec[off])}")
            off += 1
        elif t in _INT_FMT:
            fmt = _INT_FMT[t]
            sz = struct.calcsize(fmt)
            v = struct.unpack(fmt, rec[off:off + sz])[0]
            out.append(f"{tag}:i:{v}")
            off += sz
        elif t == "f":
            v = struct.unpack("<f", rec[off:off + 4])[0]
            out.append(f"{tag}:f:{v:g}")
            off += 4
        elif t in "ZH":
            end = off
            while end < n and rec[end] != 0:
                end += 1
            out.append(f"{tag}:{t}:{bytes(rec[off:end]).decode('latin1')}")
            off = end + 1
        elif t == "B":
            st = chr(rec[off])
            cnt = struct.unpack("<I", rec[off + 1:off + 5])[0]
            fmt = _ARRAY_FMT[st]
            sz = struct.calcsize(fmt)
            vals = [struct.unpack(fmt, rec[off + 5 + k * sz: off + 5 + (k + 1) * sz])[0]
                    for k in range(cnt)]
            body = ",".join(f"{v:g}" if st == "f" else str(v) for v in vals)
            out.append(f"{tag}:B:{st},{body}")
            off += 5 + cnt * sz
        else:
            break  # unknown type: stop (malformed aux)
    return ("\t" + "\t".join(out)).encode() if out else b""


VCF_ME23_HEADER = (b"##fileformat=VCFv4.1\n"
                   b"##source=genozip_tpu me23->vcf translation\n"
                   b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                   b"\tSAMPLE\n")


def me23_vb_to_vcf(text: bytes, ref) -> bytes:
    """Translate 23andMe rows (rsid chrom pos genotype) to VCF records. The
    REF base comes from the reference genome; rows whose genotype is not
    SNP-like (indels, '--') or whose position is off the genome are
    dropped, like the reference translator. A last row without its newline
    is translated too (genozip_tpu drops it: fault F13)."""
    data = np.frombuffer(text, np.uint8)
    if data.shape[0] == 0:
        return b""
    nl = np.nonzero(data == ord("\n"))[0]
    if nl.shape[0] == 0 or nl[-1] != data.shape[0] - 1:
        nl = np.concatenate([nl, [data.shape[0]]])
    starts = np.concatenate([[0], nl[:-1] + 1])
    lines = ragged.gather_ranges(data, starts, nl - starts)
    n = len(lines)
    first = np.zeros(n, np.uint8)
    ne = lines.lens > 0
    first[ne] = data[starts[ne]]
    is_data = ne & (first != ord("#"))
    rows = np.nonzero(is_data)[0]
    sub = ragged.take(lines, rows)
    fields = ragged.split_fields_fixed(sub, ord("\t"), 4)
    rsid, chrom, posc, gt = fields
    pv, pok = ragged.atoi(posc)

    # contig gpos per unique chrom (try name, then chr<name>)
    uw, inv = dedup_col(chrom)
    base = np.full(len(uw), -1, dtype=np.int64)
    for w in range(len(uw)):
        nm = uw.row(w).decode("utf-8", "replace")
        c = ref.contig_of(nm) or ref.contig_of("chr" + nm)
        if c is not None:
            base[w] = c["gpos"]
    gbase = base[inv]

    gmat, glens = ragged.to_matrix(gt)
    a1 = gmat[:, 0] if gmat.shape[1] else np.zeros(len(sub), np.uint8)
    a2 = gmat[:, 1] if gmat.shape[1] > 1 else np.zeros(len(sub), np.uint8)
    snp = (packops.IS_ACGT[a1] & ((glens == 1) |
           ((glens == 2) & packops.IS_ACGT[a2])))
    ok = pok & (gbase >= 0) & (pv > 0) & snp & (gbase + pv - 1 < ref.length)
    kidx = np.nonzero(ok)[0]
    if kidx.shape[0] == 0:
        return b""
    refb = packops.ACGT[ref.codes[(gbase + pv - 1)[kidx]]]
    a1k, a2k = a1[kidx], a2[kidx]
    hap = (glens == 1)[kidx]
    out = []
    for i, r in enumerate(kidx):
        rb = refb[i]
        alleles = [int(a1k[i])] + ([] if hap[i] else [int(a2k[i])])
        alts = []
        gt_idx = []
        for al in alleles:
            if al == rb:
                gt_idx.append(0)
            else:
                ch = chr(al)
                if ch not in alts:
                    alts.append(ch)
                gt_idx.append(alts.index(ch) + 1)
        alt_s = ",".join(alts) if alts else "."
        gt_s = "/".join(str(g) for g in gt_idx)
        out.append(b"\t".join([
            chrom.row(int(r)), posc.row(int(r)), rsid.row(int(r)),
            bytes([rb]), alt_s.encode(), b".", b".", b".", b"GT",
            gt_s.encode()]) + b"\n")
    return b"".join(out)


def bam_vb_to_sam(records: bytes, ref_names: list[str]) -> bytes:
    """Translate a VB of raw BAM alignment records to SAM text (vectorized
    fixed fields; per-record aux decode)."""
    data = np.frombuffer(records, np.uint8)
    off, consumed = bam_scan(data, 1 << 24)
    if consumed != data.shape[0]:
        raise ValueError(f"BAM VB ends inside a record ({consumed} of "
                         f"{data.shape[0]} bytes are whole records)")
    n = off.shape[0]
    if n == 0:
        return b""

    def u32(o):
        return (data[o].astype(np.int64) | (data[o + 1].astype(np.int64) << 8)
                | (data[o + 2].astype(np.int64) << 16)
                | (data[o + 3].astype(np.int64) << 24))

    def u16(o):
        return data[o].astype(np.int64) | (data[o + 1].astype(np.int64) << 8)

    def i32(o):
        return u32(o).astype(np.uint32).astype(np.int32).astype(np.int64)

    refid = i32(off + 4)
    pos = i32(off + 8)
    l_rn = data[off + 12].astype(np.int64)
    mapq = data[off + 13].astype(np.int64)
    n_cig = u16(off + 16)
    flag = u16(off + 18)
    l_seq = u32(off + 20)
    nrefid = i32(off + 24)
    npos = i32(off + 28)
    tlen = i32(off + 32)
    block = u32(off)

    names = np.array(["*"] + ref_names)
    rname = names[refid + 1]
    # RNEXT: '=' when same as RNAME and mapped
    rnext = names[nrefid + 1]
    rnext = np.where((nrefid == refid) & (nrefid >= 0), "=", rnext)

    qname = ragged.gather_ranges(data, off + 36, l_rn - 1)
    cig_start = off + 36 + l_rn
    seq_start = cig_start + 4 * n_cig
    seq_bytes = (l_seq + 1) // 2
    qual_start = seq_start + seq_bytes
    aux_start = qual_start + l_seq
    rec_end = off + 4 + block

    # CIGAR: decode u32 ops vectorized
    cig_col = ragged.gather_ranges(data, cig_start, 4 * n_cig)
    craw = np.frombuffer(cig_col.data.tobytes(), "<u4").astype(np.int64)
    op_char = np.frombuffer(CIGAR_OPS, np.uint8)[craw & 15]
    op_len = craw >> 4
    num_col = ragged.itoa(op_len)
    pieces = ragged.interleave(
        [num_col, Col(op_char, np.arange(op_char.shape[0] + 1, dtype=np.int64))])
    # regroup per record: each record's cigar = concat of its n_cig pieces
    piece_of_rec = np.repeat(np.arange(n), n_cig)
    rec_cig_lens = np.bincount(piece_of_rec, weights=pieces.lens,
                               minlength=n).astype(np.int64)
    cigar = Col(pieces.data, np.concatenate([[0], np.cumsum(rec_cig_lens)]))
    has_cig = np.nonzero(n_cig > 0)[0]
    no_cig = np.nonzero(n_cig == 0)[0]
    cigar_txt = ragged.merge_rows(
        n, [(has_cig, ragged.take(cigar, has_cig))] +
           ([(no_cig, Col.from_list([b"*"] * no_cig.shape[0]))]
            if no_cig.shape[0] else []))

    # SEQ: nibble decode
    seq_col = ragged.gather_ranges(data, seq_start, seq_bytes)
    nib_tab = np.frombuffer(SEQ_NIBBLE, np.uint8)
    expanded = np.empty(seq_col.data.shape[0] * 2, dtype=np.uint8)
    expanded[0::2] = nib_tab[seq_col.data >> 4]
    expanded[1::2] = nib_tab[seq_col.data & 15]
    seq_txt = ragged.gather_ranges(expanded, seq_col.offsets[:-1] * 2, l_seq)
    empty_seq = l_seq == 0
    if empty_seq.any():
        seq_txt = ragged.merge_rows(
            n, [(np.nonzero(~empty_seq)[0], ragged.take(seq_txt, np.nonzero(~empty_seq)[0])),
                (np.nonzero(empty_seq)[0], Col.from_list([b"*"] * int(empty_seq.sum())))])

    # QUAL: +33; 0xFF run means '*'
    qual_col = ragged.gather_ranges(data, qual_start, l_seq)
    fq = qual_col.data
    qual_txt = Col((fq + 33).astype(np.uint8), qual_col.offsets)
    first_q = np.where(l_seq > 0, fq[np.minimum(qual_col.offsets[:-1], max(fq.shape[0] - 1, 0))] if fq.shape[0] else 0, 0)
    qmissing = (first_q == 0xFF) | (l_seq == 0)
    if qmissing.any():
        qual_txt = ragged.merge_rows(
            n, [(np.nonzero(~qmissing)[0], ragged.take(qual_txt, np.nonzero(~qmissing)[0])),
                (np.nonzero(qmissing)[0], Col.from_list([b"*"] * int(qmissing.sum())))])

    # aux: per-record python decode (short strings)
    mv = memoryview(records)
    aux = Col.from_list([
        _aux_to_sam(mv[int(aux_start[i]):int(rec_end[i])]) for i in range(n)])

    t = b"\t"
    lines = ragged.interleave(
        [qname, ragged.itoa(flag), Col.from_list([s.encode() for s in rname]),
         ragged.itoa(pos + 1), ragged.itoa(mapq), cigar_txt,
         Col.from_list([s.encode() for s in rnext]),
         ragged.itoa(npos + 1), ragged.itoa(tlen), seq_txt, qual_txt, aux],
        sep_after=[t, t, t, t, t, t, t, t, t, t, None, b"\n"])
    return lines.data.tobytes()



def sam_header_to_bam(sam_text: bytes):
    """SAM header text -> (BAM header blob, {ref name: id})."""
    refs = []
    for line in sam_text.split(b"\n"):
        if line.startswith(b"@SQ"):
            name = ln = None
            for f in line.split(b"\t")[1:]:
                if f.startswith(b"SN:"):
                    name = f[3:]
                elif f.startswith(b"LN:"):
                    ln = int(f[3:])
            if name is not None:
                refs.append((name, ln or 0))
    parts = [b"BAM\x01", len(sam_text).to_bytes(4, "little"), sam_text,
             len(refs).to_bytes(4, "little")]
    for name, ln in refs:
        parts.append((len(name) + 1).to_bytes(4, "little"))
        parts.append(name + b"\x00")
        parts.append(ln.to_bytes(4, "little"))
    name2id = {name: i for i, (name, _) in enumerate(refs)}
    return b"".join(parts), name2id


def _cigar_to_bin(cig: bytes):
    """CIGAR text -> (packed u32 le bytes, n_ops, ref_consumed_len)."""
    if cig == b"*":
        return b"", 0, 0
    ops = []
    ref_len = 0
    num = 0
    for c in cig:
        if 48 <= c <= 57:
            num = num * 10 + (c - 48)
        else:
            op = _CIG_OP[c]
            assert op != 255, f"bad CIGAR op {chr(c)}"
            ops.append((num << 4) | int(op))
            if c in _REF_CONSUME:
                ref_len += num
            num = 0
    return np.asarray(ops, "<u4").tobytes(), len(ops), ref_len


def _aux_to_bam(field: bytes) -> bytes:
    """One SAM aux field 'TG:t:val' -> BAM binary."""
    tag, typ, val = field.split(b":", 2)
    if typ == b"i":
        return tag + b"i" + struct.pack("<i", int(val))
    if typ == b"f":
        return tag + b"f" + struct.pack("<f", float(val))
    if typ == b"A":
        return tag + b"A" + val[:1]
    if typ in (b"Z", b"H"):
        return tag + typ + val + b"\x00"
    if typ == b"B":
        sub, _, rest = val.partition(b",")
        vals = rest.split(b",") if rest else []
        fmt = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H",
               b"i": "<i", b"I": "<I", b"f": "<f"}[sub]
        conv = float if sub == b"f" else int
        return tag + b"B" + sub + struct.pack("<I", len(vals)) + \
            b"".join(struct.pack(fmt, conv(v)) for v in vals)
    raise ValueError(f"unknown aux type {typ!r}")


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning scheme (SAM spec 5.3; bai.c analog)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def sam_vb_to_bam(text: bytes, name2id: dict):
    """A VB of SAM text -> (records blob, per-record (lengths, refid, pos,
    end) arrays for BGZF voffset tracking + BAI)."""
    data = np.frombuffer(text, np.uint8)
    nl = np.nonzero(data == ord("\n"))[0]
    if data.shape[0] and (nl.shape[0] == 0 or nl[-1] != data.shape[0] - 1):
        nl = np.concatenate([nl, [data.shape[0]]])
    starts = np.concatenate([[0], nl[:-1] + 1])
    out = []
    lens = []
    refids = []
    poss = []
    ends = []
    for s, e in zip(starts, nl):
        line = text[s:e]
        f = line.split(b"\t")
        qname, flag, rname, pos1, mapq, cig = f[0], int(f[1]), f[2], \
            int(f[3]), int(f[4]), f[5]
        rnext, pnext1, tlen, seq, qual = f[6], int(f[7]), int(f[8]), f[9], f[10]
        refid = name2id.get(rname, -1) if rname != b"*" else -1
        nrefid = refid if rnext == b"=" else \
            (name2id.get(rnext, -1) if rnext != b"*" else -1)
        cig_bin, n_cig, ref_len = _cigar_to_bin(cig)
        pos = pos1 - 1
        end = pos + max(ref_len, 1)
        bin_ = reg2bin(max(pos, 0), max(end, 1))
        l_seq = 0 if seq == b"*" else len(seq)
        if seq == b"*":
            seq_nib = b""
        else:
            a = np.frombuffer(seq, np.uint8)
            nib = _NIB_OF[a]
            if l_seq & 1:
                nib = np.concatenate([nib, np.zeros(1, np.uint8)])
            seq_nib = ((nib[0::2] << 4) | nib[1::2]).tobytes()
        if qual == b"*" or l_seq == 0:
            qual_b = b"\xff" * l_seq
        else:
            qual_b = (np.frombuffer(qual, np.uint8) - 33).tobytes()
        aux_b = b"".join(_aux_to_bam(x) for x in f[11:])
        body = struct.pack("<iiBBHHHiii", refid, pos, len(qname) + 1, mapq,
                           bin_, n_cig, flag, l_seq, nrefid, pnext1 - 1) + \
            struct.pack("<i", tlen) + qname + b"\x00" + cig_bin + \
            seq_nib + qual_b + aux_b
        rec = struct.pack("<I", len(body)) + body
        out.append(rec)
        lens.append(len(rec))
        refids.append(refid)
        poss.append(pos)
        ends.append(end)
    return (b"".join(out), np.asarray(lens, np.int64),
            np.asarray(refids, np.int64), np.asarray(poss, np.int64),
            np.asarray(ends, np.int64))


class IndexingBgzfWriter:
    """BGZF writer that returns each appended record's virtual offsets
    (coffset << 16 | uoffset): the voffset tracking of src/bai.c. Blocks
    hold BLOCK bytes, the last one what is left at close, each deflated by
    zlib at `level`."""

    BLOCK = 60000

    def __init__(self, fileobj, level: int = 6):
        self.f = fileobj
        self.level = level
        self.buf = bytearray()
        self.file_off = 0          # compressed bytes written so far

    def _flush_full(self):
        """Write every full block of the buffer; returns the file offset
        each one started at."""
        starts = []
        while len(self.buf) >= self.BLOCK:
            starts.append(self.file_off)
            blk = _one_block(bytes(self.buf[: self.BLOCK]), self.level)
            self.f.write(blk)
            self.file_off += len(blk)
            del self.buf[: self.BLOCK]
        return starts

    def write_blob(self, blob: bytes):
        self.buf += blob
        self._flush_full()

    def write_records(self, blob: bytes, rec_lens: np.ndarray):
        """Append records; returns (vbeg, vend) virtual offsets per record.
        A record in a block still buffered gets the offset that block will
        be written at, which holds because blocks are flushed as soon as
        they are full."""
        starts = len(self.buf) + np.concatenate(
            [[0], np.cumsum(rec_lens)[:-1]]).astype(np.int64)
        ends_ = starts + rec_lens
        self.buf += blob
        blk_off = self._flush_full()

        def voff(pos):
            b = (pos // self.BLOCK).astype(np.int64)
            co = np.asarray(blk_off + [self.file_off], np.uint64)[
                np.minimum(b, len(blk_off))]
            return (co << np.uint64(16)) | (pos % self.BLOCK).astype(np.uint64)
        return voff(starts), voff(ends_)

    def close(self):
        """Write the last block and the EOF marker; the file stays open
        (its owner closes it)."""
        if self.buf:
            blk = _one_block(bytes(self.buf), self.level)
            self.f.write(blk)
            self.file_off += len(blk)
            self.buf.clear()
        self.f.write(EOF_BLOCK)


def build_bai(n_ref: int, refids: np.ndarray, poss: np.ndarray,
              ends: np.ndarray, vbeg: np.ndarray, vend: np.ndarray) -> bytes:
    """BAI index blob (SAM spec 5.2; src/bai.c analog): per reference the
    binning index (one coalesced chunk per bin) + 16kb linear index."""
    parts = [b"BAI\x01", struct.pack("<i", n_ref)]
    for r in range(n_ref):
        m = refids == r
        if not m.any():
            parts.append(struct.pack("<ii", 0, 0))
            continue
        rp, re_, rb, rv = poss[m], ends[m], vbeg[m], vend[m]
        bins = np.array([reg2bin(int(b), int(max(e, b + 1)))
                         for b, e in zip(rp, re_)], np.int64)
        ub = np.unique(bins)
        parts.append(struct.pack("<i", ub.shape[0]))
        for b in ub:
            bm = bins == b
            parts.append(struct.pack("<Ii", int(b), 1))
            parts.append(struct.pack("<QQ", int(rb[bm].min()),
                                     int(rv[bm].max())))
        n_intv = int(re_.max() // 16384) + 1
        ioff = np.full(n_intv, np.iinfo(np.uint64).max, np.uint64)
        w0 = (rp // 16384).astype(np.int64)
        w1 = ((np.maximum(re_ - 1, rp)) // 16384).astype(np.int64)
        for b, e, v in zip(w0, w1, rb):
            ioff[b:e + 1] = np.minimum(ioff[b:e + 1], v)
        # fill gaps with the previous value (spec: records may be absent)
        prev = np.uint64(0)
        for k in range(n_intv):
            if ioff[k] == np.iinfo(np.uint64).max:
                ioff[k] = prev
            prev = ioff[k]
        parts.append(struct.pack("<i", n_intv))
        parts.append(ioff.astype("<u8").tobytes())
    return b"".join(parts)
