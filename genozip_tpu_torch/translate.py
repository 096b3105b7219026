"""SAM -> BAM translation (reference parity: src/data_types.h:253-259
SAM2BAM translators): the BAM header from SAM header text, and a VB of SAM
records as BAM records.

genozip_tpu_torch's own copy of the SAM -> BAM half of genozip_tpu/
translate.py (`sam_header_to_bam`, `sam_vb_to_bam` and their helpers);
`synth.py` and the tests use it. The other translations of
genozip_tpu/translate.py (`cat --sam/--bam/--bai/--cram`) are not ported
yet.
"""

import struct

import numpy as np

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
