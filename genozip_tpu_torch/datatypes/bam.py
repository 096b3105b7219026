"""BAM datatype plugin (binary alignment records; BGZF handled by the gz
input layer — correctness bar is byte-exact round-trip of the uncompressed
BAM stream, like the reference's digest over txt data).

Counterpart of genozip_tpu/datatypes/bam.py on its numpy host path.
Reference parity: src/bam_seg.c (record parsing), src/sam.h record layout,
src/bam_seq.c (4-bit SEQ codes). `bam_scan` walks the serial block_size
chain in the C++ host runtime (`native.bam_scan`; `bam_scan_np` is the
Python loop), as do the 4-bit SEQ expansion and its inverse; all field
extraction is then vectorized numpy over record offsets — no per-record
python. Alignment-record layout (SAMv1 spec §4.2):
  u32 block_size; i32 refID, pos; u8 l_read_name, mapq; u16 bin, n_cigar_op,
  flag; u32 l_seq; i32 next_refID, next_pos, tlen; char read_name[l_rn];
  u32 cigar[n_cigar]; u8 seq[(l_seq+1)/2]; u8 qual[l_seq]; aux...
"""

import struct

import numpy as np

from . import DataType, VBSegResult, register
from .. import native
from . import sam_tags
from .sam import SamDT
from ..utils import ragged
from ..utils.ragged import Col
from ..contexts import VBCtx, MODE_DICT, MODE_NUM, MODE_TXT, dedup_col
from ..seg import tokenizer_seg_col, tokenizer_recon_col

MAX_RECORDS_PER_VB = 1 << 22
SEQ_NIBBLE = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
_NIB16 = None  # lazy byte -> uint16 two-letter LUT (little-endian)
NIB_OF = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    NIB_OF[_c] = _i
CIGOPS = np.frombuffer(b"MIDNSHP=X", np.uint8)


def _u32(data, off):
    return (data[off].astype(np.uint32) | (data[off + 1].astype(np.uint32) << 8)
            | (data[off + 2].astype(np.uint32) << 16)
            | (data[off + 3].astype(np.uint32) << 24))


def _u16(data, off):
    return data[off].astype(np.uint32) | (data[off + 1].astype(np.uint32) << 8)


def _i32(data, off):
    return _u32(data, off).astype(np.int32).astype(np.int64)


def bam_scan(data: np.ndarray, max_records: int):
    """Walk the serial BAM block_size chain -> (record offsets, bytes
    consumed by whole records), in the host runtime."""
    return native.bam_scan(data, max_records)


def bam_scan_np(data: np.ndarray, max_records: int):
    """bam_scan as a Python loop (genozip_tpu's fallback,
    native/__init__.py:550-564)."""
    buf = np.ascontiguousarray(data).tobytes()
    length = len(buf)
    offs = []
    off = 0
    unpack = struct.Struct("<I").unpack_from
    while off + 4 <= length and len(offs) < max_records:
        nxt = off + 4 + unpack(buf, off)[0]
        if nxt > length:
            break
        offs.append(off)
        off = nxt
    return np.asarray(offs, np.int64), off


@register
class BamDT(SamDT):
    """Inherits SamDT's SEQ-vs-reference machinery (CIGAR group walk,
    mismatch channels); overrides all parsing/recon for the binary layout."""
    NAME = "bam"

    def read_txt_header(self, reader) -> bytes:
        """Consume magic + SAM header text + reference catalog, verbatim.
        The ref-id -> name catalog rides in segconf so PIZ can map binary
        refIDs back to contig names for the by-reference SEQ path."""
        head = reader.peek(12)
        assert head[:4] == b"BAM\x01", "not a BAM stream"
        l_text = int.from_bytes(head[4:8], "little")
        reader.peek(12 + l_text)
        n_ref = int.from_bytes(reader.peek(12 + l_text)[8 + l_text:12 + l_text], "little")
        # walk refs
        need = 12 + l_text
        names = []
        lens_ = []
        for _ in range(n_ref):
            buf = reader.peek(need + 4)
            l_name = int.from_bytes(buf[need:need + 4], "little")
            buf = reader.peek(need + 8 + l_name)
            names.append(buf[need + 4: need + 4 + l_name - 1].decode(
                "utf-8", "replace"))
            lens_.append(int.from_bytes(
                buf[need + 4 + l_name: need + 8 + l_name], "little"))
            need += 8 + l_name
        hdr = reader.peek(need)[:need]
        reader.buf = reader.buf[need:]
        self.segconf["bam_refs"] = names
        if getattr(self, "ref", None) is None:
            # REF_INTERNAL from the binary reference catalog (reference.c)
            self._init_internal_ref_from_catalog(names, lens_)
        return hdr

    def _init_internal_ref_from_catalog(self, names, lens_):
        from ..ref.refstore import RefGenome
        contigs = []
        g = 0
        for nm, ln in zip(names, lens_):
            if ln <= 0:
                continue
            contigs.append({"name": nm, "gpos": g, "length": ln})
            g += ln
        if not contigs or g == 0 or g > self.INTERNAL_REF_MAX:
            return
        ref = RefGenome(np.zeros(g, np.uint8), contigs)
        ref.is_set = np.zeros(g, bool)
        ref.internal = True
        self.ref = ref

    def _rname_text(self, refid: np.ndarray) -> Col:
        names = self.segconf.get("bam_refs") or []
        cat = Col.from_list([nm.encode() for nm in names] + [b"*"])
        idx = np.where((refid >= 0) & (refid < len(names)), refid, len(names))
        return ragged.take(cat, idx)

    def _cigar_text(self, cigar_bin: Col, n_cig: np.ndarray) -> Col:
        """Binary cigar u32s -> SAM text column ('*' for 0-op rows is NOT
        emitted; empty text keeps those rows out of the by-ref path)."""
        n = n_cig.shape[0]
        u32 = np.ascontiguousarray(cigar_bin.data).view("<u4").astype(np.int64)
        oplen = u32 >> 4
        opch = CIGOPS[np.minimum(u32 & 15, 8)]
        nums = ragged.itoa(oplen)
        piece = ragged.interleave([nums, Col.from_fixed(opch.reshape(-1, 1))])
        op_rec = np.repeat(ragged.arange(n), n_cig)
        rec_lens = np.bincount(op_rec, weights=piece.lens,
                               minlength=n).astype(np.int64)
        return Col(piece.data, np.concatenate([[0], np.cumsum(rec_lens)]))

    def _seq_ascii(self, seq_nib: Col, l_seq: np.ndarray):
        """4-bit codes -> ASCII letters + per-row nibble-exactness (odd-length
        rows whose pad nibble isn't 0 can't round-trip through ASCII)."""
        data, off, ok = native.nib_expand(seq_nib.data, seq_nib.offsets,
                                          l_seq)
        return Col(data, off), ok

    @staticmethod
    def _seq_ascii_np(seq_nib: Col, l_seq: np.ndarray):
        """_seq_ascii in numpy."""
        # single-gather expansion: byte -> two ASCII letters as one uint16
        global _NIB16
        if _NIB16 is None:
            b = np.arange(256, dtype=np.uint8)
            _NIB16 = (SEQ_NIBBLE[b >> 4].astype(np.uint16)
                      | (SEQ_NIBBLE[b & 15].astype(np.uint16) << 8))
        expanded = np.empty(seq_nib.data.shape[0] * 2, np.uint8)
        expanded.view(np.uint16)[:] = _NIB16[seq_nib.data]
        ascii_col = ragged.gather_ranges(expanded, seq_nib.offsets[:-1] * 2,
                                         l_seq)
        # exactness: odd rows need pad nibble == 0
        odd = (l_seq & 1) == 1
        ok = np.ones(len(seq_nib), bool)
        oidx = np.nonzero(odd & (seq_nib.lens > 0))[0]
        if oidx.shape[0]:
            last = seq_nib.data[seq_nib.offsets[1:][oidx] - 1]
            ok[oidx] = (last & 15) == 0
        return ascii_col, ok

    # ------------------------------------------------------------------
    # per-tag binary AUX (reference src/sam_fields.c + bam field types)
    # ------------------------------------------------------------------

    _FIXSZ = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
              ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}
    _BSUB = {ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
             ord("i"): 4, ord("I"): 4, ord("f"): 4}

    def _walk_aux(self, aux: Col):
        """Vectorized field walk over all records at once (one iteration per
        field ordinal, each a whole-column numpy pass). Returns
        (f_rec, f_start, f_vlen arrays in (rec, field) order, bad mask)."""
        n = len(aux)
        data = aux.data
        rec_end = aux.offsets[1:]
        cur = aux.offsets[:-1].copy()
        bad = np.zeros(n, bool)
        active = cur < rec_end
        nulpos = np.nonzero(data == 0)[0]
        dmax = max(data.shape[0] - 1, 0)
        at = lambda p: data[np.minimum(p, dmax)]
        f_rec, f_start, f_vlen = [], [], []
        for _ in range(4096):
            idx = np.nonzero(active)[0]
            if idx.shape[0] == 0:
                break
            c = cur[idx]
            ok = c + 4 <= rec_end[idx]
            ty = at(c + 2)
            vl = np.full(idx.shape[0], -1, np.int64)
            for tch, sz in self._FIXSZ.items():
                vl = np.where(ty == tch, sz, vl)
            zh = (ty == ord("Z")) | (ty == ord("H"))
            if zh.any():
                srch = np.searchsorted(nulpos, c + 3)
                has = srch < nulpos.shape[0]
                npos = np.where(has, nulpos[np.minimum(srch, max(nulpos.shape[0] - 1, 0))], -1)
                goodz = zh & has & (npos < rec_end[idx])
                vl = np.where(goodz, npos - (c + 3) + 1, np.where(zh, -1, vl))
            isb = ty == ord("B")
            if isb.any():
                sub = at(c + 3)
                cnt = (at(c + 4).astype(np.int64) | (at(c + 5).astype(np.int64) << 8)
                       | (at(c + 6).astype(np.int64) << 16)
                       | (at(c + 7).astype(np.int64) << 24))
                elsz = np.full(idx.shape[0], -1, np.int64)
                for sch, sz in self._BSUB.items():
                    elsz = np.where(sub == sch, sz, elsz)
                vl = np.where(isb & (elsz > 0) & (cnt >= 0),
                              5 + cnt * np.maximum(elsz, 1), vl)
            ok &= (vl >= 0) & (c + 3 + vl <= rec_end[idx])
            nb = idx[~ok]
            bad[nb] = True
            active[nb] = False
            gi = idx[ok]
            if gi.shape[0]:
                f_rec.append(gi)
                f_start.append(c[ok])
                f_vlen.append(vl[ok])
                cur[gi] = c[ok] + 3 + vl[ok]
                active[gi] = cur[gi] < rec_end[gi]
        else:
            bad[np.nonzero(active)[0]] = True  # runaway: too many fields
        if not f_rec:
            z = np.zeros(0, np.int64)
            return z, z, z, bad
        fr = np.concatenate(f_rec)
        fs = np.concatenate(f_start)
        fv = np.concatenate(f_vlen)
        order = np.lexsort((fs, fr))     # (rec, field) order
        fr, fs, fv = fr[order], fs[order], fv[order]
        keep = ~bad[fr]
        return fr[keep], fs[keep], fv[keep], bad

    def _seg_aux_bam(self, ctxs, aux: Col, predict=None,
                     l_seq=None, pos_v=None, qual=None, seq_ascii=None,
                     solo_pred=None):
        """One context per binary aux tag; layout word = 3-byte TAG+type
        units per record (AUXL dict); typed value streams: fixed ints ->
        numeric (NM delta-vs-predicted, param=4), f -> raw f32, Z/H ->
        tokenizer (MD:Z -> OK bitmap + exceptions), B -> raw + len stream.
        With `qual` (raw phred): OQ:Z as byte-delta vs QUAL+33
        (src/codec_oq.c role); with `seq_ascii`: t0:Z condensed per SEQ
        homopolymer run (src/codec_t0.c role) — both mirroring the SAM
        text path."""
        n = len(aux)
        data = aux.data
        fr, fs, fv, bad = self._walk_aux(aux)
        nf = np.bincount(fr, minlength=n)
        llens = np.where(bad, 1, 3 * nf)
        loff = np.concatenate([[0], np.cumsum(llens)])
        ldata = np.empty(int(loff[-1]), np.uint8)
        bad_rows = np.nonzero(bad)[0]
        ldata[loff[:-1][bad_rows]] = 0
        F = fr.shape[0]
        if F:
            fidx = ragged.arange(F) - np.concatenate(
                [[0], np.cumsum(nf)])[:-1][fr]
            pdst = loff[:-1][fr] + 3 * fidx
            for b in range(3):
                ldata[pdst + b] = data[fs + b]
        uw, inv = dedup_col(Col(ldata, loff))
        ctxs["AUXL"] = VBCtx("AUXL", MODE_DICT, b250=inv, vb_words=uw,
                             cat="b250")
        if bad_rows.shape[0]:
            uwx, invx = dedup_col(ragged.take(aux, bad_rows))
            ctxs["AUXEXC"] = VBCtx("AUXEXC", MODE_DICT, b250=invx,
                                   vb_words=uwx, cat="text")
        if F == 0:
            return
        key = (data[fs].astype(np.uint32) << 16) \
            | (data[fs + 1].astype(np.uint32) << 8) \
            | data[fs + 2].astype(np.uint32)
        nm_pred = md_col = has_md = None
        if predict is not None:
            nm_pred, md_col, has_md = predict
        as_by_row = None
        for t in np.unique(key):
            sel = np.nonzero(key == t)[0]
            b0, b1, b3 = (int(t) >> 16) & 0xFF, (int(t) >> 8) & 0xFF, int(t) & 0xFF
            name = "AX" + chr(b0) + chr(b1) + chr(b3)
            vs = fs[sel] + 3
            vl = fv[sel]
            rows_t = fr[sel]
            ty = b3
            if ty in (ord("c"), ord("C"), ord("s"), ord("S"), ord("i"),
                      ord("I"), ord("A")):
                w = self._FIXSZ[ty]
                v = np.zeros(sel.shape[0], np.int64)
                for b in range(w):
                    v |= data[vs + b].astype(np.int64) << (8 * b)
                if ty == ord("c"):
                    v = v.astype(np.int8).astype(np.int64)
                elif ty == ord("s"):
                    v = v.astype(np.int16).astype(np.int64)
                elif ty == ord("i"):
                    v = v.astype(np.int32).astype(np.int64)
                tag2 = bytes([b0, b1])
                if nm_pred is not None and tag2 == b"NM" \
                        and ty != ord("A"):
                    ctxs[name] = VBCtx(name, MODE_NUM,
                                       local=v - nm_pred[rows_t],
                                       cat="int", param=4)
                elif tag2 == b"AS" and ty != ord("A") and l_seq is not None:
                    # score model per VB: BWA-class AS ~ read length vs
                    # bowtie2-class AS near 0 (src/sam_bwa.c /
                    # src/sam_bowtie2.c) — pick the smaller residual
                    d = v - l_seq[rows_t]
                    if np.abs(d).sum() <= np.abs(v).sum():
                        ctxs[name] = VBCtx(name, MODE_NUM, local=d,
                                           cat="int",
                                           param=sam_tags.PARAM_AS_VS_SEQLEN)
                    else:
                        ctxs[name] = VBCtx(name, MODE_NUM, local=v,
                                           cat="int")
                    as_by_row = np.zeros(n, np.int64)
                    as_by_row[rows_t] = v
                elif tag2 in sam_tags.AS_DELTA_TAGS and ty != ord("A") and \
                        as_by_row is not None:
                    ctxs[name] = VBCtx(name, MODE_NUM,
                                       local=v - as_by_row[rows_t],
                                       cat="int",
                                       param=sam_tags.PARAM_VS_AS)
                else:
                    ctxs[name] = VBCtx(name, MODE_NUM, local=v, cat="int")
            elif ty in (ord("Z"), ord("H")):
                vals = ragged.gather_ranges(data, vs, vl - 1)  # sans NUL
                if qual is not None and (b0, b1, ty) == (ord("O"), ord("Q"),
                                                         ord("Z")):
                    # OQ:Z = pre-BQSR quals, ASCII: delta vs (QUAL+33)
                    pred = ragged.take(qual, rows_t)
                    fit = vals.lens == pred.lens
                    if fit.mean() > 0.5:
                        ctxs[name + "Q"] = VBCtx(name + "Q", MODE_NUM,
                                                 local=fit.astype(np.int64),
                                                 cat="int")
                        a = ragged.take(vals, np.nonzero(fit)[0])
                        b = ragged.take(pred, np.nonzero(fit)[0])
                        # per-quality channel demux (codec_oq.c:14-20)
                        perm = np.argsort(b.data, kind="stable")
                        ctxs[name] = VBCtx(
                            name, MODE_TXT,
                            local=(a.data - (b.data + 33)).astype(
                                np.uint8)[perm],
                            cat="qual", param=13)
                        if (~fit).any():
                            exc = ragged.take(vals, np.nonzero(~fit)[0])
                            ctxs.update(tokenizer_seg_col(
                                name + "X", exc, single_stream=True))
                        continue
                if seq_ascii is not None and (b0, b1, ty) == (ord("t"),
                                                              ord("0"),
                                                              ord("Z")):
                    handled = self._t0_seg_bam(name, vals,
                                               ragged.take(seq_ascii,
                                                           rows_t))
                    if handled is not None:
                        ctxs.update(handled)
                        continue
                if solo_pred is not None and bytes([b0, b1]) in \
                        solo_pred and ty == ord("Z"):
                    # SAG_BY_SOLO: barcode equals the primary's (store copy)
                    pred = ragged.take(solo_pred[bytes([b0, b1])], rows_t)
                    eq = (pred.lens > 0) & ragged.rows_equal(vals, pred)
                    if eq.mean() > 0.5:
                        ctxs[name + "G"] = VBCtx(
                            name + "G", MODE_NUM, local=eq.astype(np.int64),
                            cat="int")
                        if (~eq).any():
                            ctxs.update(tokenizer_seg_col(
                                name + "X",
                                ragged.take(vals, np.nonzero(~eq)[0]),
                                single_stream=True))
                        continue
                if (b0, b1, ty) == (ord("X"), ord("A"), ord("Z")) and \
                        pos_v is not None:
                    # BWA XA:Z alt-hit list: per-alt sub-contexts with
                    # pos-vs-row-POS deltas (src/sam_bwa.c, shared with
                    # the SAM path via sam_tags.xa_seg)
                    handled = sam_tags.xa_seg(name, vals, pos_v, rows_t)
                    if handled is not None:
                        ctxs.update(handled)
                        continue
                if md_col is not None and (b0, b1, ty) == (ord("M"), ord("D"),
                                                           ord("Z")):
                    pred_vals = ragged.take(md_col, rows_t)
                    eq = (vals.lens == pred_vals.lens) & has_md[rows_t]
                    if eq.any():
                        a = ragged.take(vals, np.nonzero(eq)[0])
                        b = ragged.take(pred_vals, np.nonzero(eq)[0])
                        neq = np.unique(np.searchsorted(
                            a.offsets[1:], np.nonzero(a.data != b.data)[0],
                            side="right"))
                        if neq.shape[0]:
                            ei = np.nonzero(eq)[0]
                            eq[ei[neq]] = False
                    ctxs[name + "K"] = VBCtx(name + "K", MODE_NUM,
                                             local=eq.astype(np.int64),
                                             cat="int")
                    if (~eq).any():
                        exc = ragged.take(vals, np.nonzero(~eq)[0])
                        ctxs.update(tokenizer_seg_col(name, exc,
                                                      single_stream=True))
                else:
                    ctxs.update(tokenizer_seg_col(name, vals,
                                                  single_stream=True))
            else:  # f, B: raw value bytes + len stream (B only; f is fixed)
                raw = ragged.gather_ranges(data, vs, vl)
                cat = "float" if ty == ord("f") else "int"
                ctxs[name] = VBCtx(name, MODE_TXT, local=raw.data, cat=cat)
                if ty == ord("B"):
                    ctxs[name + "L"] = VBCtx(name + "L", MODE_NUM, local=vl,
                                             cat="int")

    def _t0_seg_bam(self, name, vals, seq_t):
        """t0:Z condensed to one byte per SEQ homopolymer run
        (src/codec_t0.c) — the SAM text path's transform on the binary aux
        layout. Returns ctxs or None."""
        run_lens, runs_per_row = self._hp_run_structure(seq_t)
        fit = vals.lens == seq_t.lens
        if not fit.any():
            return None
        first = np.concatenate([[0], np.cumsum(run_lens)])[:-1]
        vo = vals.offsets[:-1]
        so = seq_t.offsets[:-1]
        run_row = np.repeat(np.arange(len(seq_t)), runs_per_row)
        fpos = first - so[run_row]
        cond_bytes = np.zeros(run_lens.shape[0], np.uint8)
        okrun = fit[run_row]
        cond_bytes[okrun] = vals.data[(vo[run_row] + fpos)[okrun]]
        rebuilt = np.repeat(cond_bytes, run_lens)
        byte_row = np.repeat(np.arange(len(seq_t)), seq_t.lens)
        bm = fit[byte_row]
        vb_bytes = np.zeros(seq_t.data.shape[0], np.uint8)
        pos_in = np.arange(seq_t.data.shape[0]) - so[byte_row]
        vb_bytes[bm] = vals.data[(vo[byte_row] + pos_in)[bm]]
        mism = np.zeros(len(seq_t), bool)
        bad_b = bm & (rebuilt != vb_bytes)
        mism[byte_row[bad_b]] = True
        ok = fit & ~mism
        if ok.mean() <= 0.5:
            return None
        from ..codecs.qual import _BASE5
        keep = ok[run_row]
        kb = cond_bytes[keep]
        kkey = (np.minimum(run_lens, 7) * 5
                + _BASE5[seq_t.data[np.minimum(
                    first, max(seq_t.data.shape[0] - 1, 0))]]
                )[keep].astype(np.int16)
        kperm = np.argsort(kkey, kind="stable")
        ctxs = {name + "H": VBCtx(name + "H", MODE_NUM,
                                  local=ok.astype(np.int64), cat="int"),
                name: VBCtx(name, MODE_TXT, local=kb[kperm],
                            cat="qual", param=14)}
        if (~ok).any():
            exc = ragged.take(vals, np.nonzero(~ok)[0])
            ctxs.update(tokenizer_seg_col(name + "X", exc,
                                          single_stream=True))
        return ctxs

    def _t0_recon_bam(self, name, pctxs, seq_t):
        ok = pctxs[name + "H"].nums().astype(bool)
        pc = pctxs[name]
        run_lens, runs_per_row = self._hp_run_structure(seq_t)
        run_row = np.repeat(np.arange(len(seq_t)), runs_per_row)
        keep = ok[run_row]
        cond_bytes = np.zeros(run_lens.shape[0], np.uint8)
        stored = pc.local[: int(keep.sum())]
        if pc.param == 14:    # HP-context demux (see _t0_seg_bam)
            from ..codecs.qual import _BASE5
            first = np.concatenate([[0], np.cumsum(run_lens)])[:-1]
            kkey = (np.minimum(run_lens, 7) * 5
                    + _BASE5[seq_t.data[np.minimum(
                        first, max(seq_t.data.shape[0] - 1, 0))]]
                    )[keep].astype(np.int16)
            kperm = np.argsort(kkey, kind="stable")
            inv = np.empty_like(stored)
            inv[kperm] = stored
            stored = inv
        cond_bytes[keep] = stored
        rl = np.where(keep, run_lens, 0)
        expanded = np.repeat(cond_bytes, rl)
        row_lens = np.where(ok, seq_t.lens, 0)
        okcol = Col(expanded, np.concatenate([[0], np.cumsum(row_lens)]))
        sub = [(np.nonzero(ok)[0], ragged.take(okcol, np.nonzero(ok)[0]))]
        if (~ok).any():
            exc = tokenizer_recon_col(name + "X", pctxs, int((~ok).sum()))
            sub.append((np.nonzero(~ok)[0], exc))
        return ragged.merge_rows(ok.shape[0], sub)

    def _recon_aux_bam(self, pctxs, n, predict=None, l_seq=None,
                       pos_v=None, qual=None, seq_ascii=None,
                       solo_pred=None):
        layout = pctxs["AUXL"].dict_take()
        ld = layout.data
        llen = layout.lens
        bad = llen == 1
        nf = np.where(bad, 0, llen // 3)
        F = int(nf.sum())
        field_row = np.repeat(ragged.arange(n), nf)
        nm_pred = md_col = has_md = None
        if predict is not None:
            nm_pred, md_col, has_md = predict
        if F:
            fidx = ragged.arange(F) - np.concatenate(
                [[0], np.cumsum(nf)])[:-1][field_row]
            pstart = layout.offsets[:-1][field_row] + 3 * fidx
            key = (ld[pstart].astype(np.uint32) << 16) \
                | (ld[pstart + 1].astype(np.uint32) << 8) \
                | ld[pstart + 2].astype(np.uint32)
            parts = []
            as_by_row = None
            for t in np.unique(key):
                sel = np.nonzero(key == t)[0]
                b0, b1, ty = (int(t) >> 16) & 0xFF, (int(t) >> 8) & 0xFF, \
                    int(t) & 0xFF
                name = "AX" + chr(b0) + chr(b1) + chr(ty)
                rows_t = field_row[sel]
                pc = pctxs.get(name)
                if ty in self._FIXSZ and ty != ord("f"):
                    v = pc.nums()
                    if pc.param == 4:
                        v = pc.local.astype(np.int64) + nm_pred[rows_t]
                    elif pc.param == sam_tags.PARAM_AS_VS_SEQLEN:
                        v = pc.local.astype(np.int64) + l_seq[rows_t]
                    elif pc.param == sam_tags.PARAM_VS_AS:
                        v = pc.local.astype(np.int64) + as_by_row[rows_t]
                    if (b0, b1) == (ord("A"), ord("S")) and ty != ord("A"):
                        as_by_row = np.zeros(n, np.int64)
                        as_by_row[rows_t] = v
                    w = self._FIXSZ[ty]
                    m = np.zeros((sel.shape[0], w), np.uint8)
                    uv = v.astype(np.uint64) & ((1 << (8 * w)) - 1)
                    for b in range(w):
                        m[:, b] = (uv >> (8 * b)) & 0xFF
                    col = Col.from_fixed(m)
                elif ty in (ord("Z"), ord("H")):
                    if qual is not None and name + "Q" in pctxs and \
                            (b0, b1, ty) == (ord("O"), ord("Q"), ord("Z")):
                        fit = pctxs[name + "Q"].nums().astype(bool)
                        pred = ragged.take(qual, rows_t)
                        fl = np.where(fit, pred.lens, 0)
                        a = ragged.take(pred, np.nonzero(fit)[0])
                        dd = pctxs[name].local
                        if pctxs[name].param == 13:  # per-quality demux
                            perm = np.argsort(a.data, kind="stable")
                            inv = np.empty_like(dd)
                            inv[perm] = dd
                            dd = inv
                        diff = Col(dd,
                                   np.concatenate([[0], np.cumsum(fl)]))
                        d = ragged.take(diff, np.nonzero(fit)[0])
                        okcol = Col((a.data + 33 + d.data).astype(np.uint8),
                                    a.offsets)
                        sub = [(np.nonzero(fit)[0], okcol)]
                        if (~fit).any():
                            exc = tokenizer_recon_col(name + "X", pctxs,
                                                      int((~fit).sum()))
                            sub.append((np.nonzero(~fit)[0], exc))
                        col = ragged.merge_rows(sel.shape[0], sub)
                    elif seq_ascii is not None and name + "H" in pctxs and \
                            (b0, b1, ty) == (ord("t"), ord("0"), ord("Z")):
                        col = self._t0_recon_bam(
                            name, pctxs, ragged.take(seq_ascii, rows_t))
                    elif solo_pred is not None and bytes([b0, b1]) in \
                            solo_pred and name + "G" in pctxs:
                        eq = pctxs[name + "G"].nums().astype(bool)
                        pred = ragged.take(solo_pred[bytes([b0, b1])],
                                           rows_t)
                        sub = [(np.nonzero(eq)[0],
                                ragged.take(pred, np.nonzero(eq)[0]))]
                        if (~eq).any():
                            exc = tokenizer_recon_col(name + "X", pctxs,
                                                      int((~eq).sum()))
                            sub.append((np.nonzero(~eq)[0], exc))
                        col = ragged.merge_rows(sel.shape[0], sub)
                    elif (b0, b1, ty) == (ord("X"), ord("A"), ord("Z")) and \
                            name + "F" in pctxs and pos_v is not None:
                        col = sam_tags.xa_recon(name, pctxs, pos_v, rows_t)
                    elif name + "K" in pctxs:
                        okf = pctxs[name + "K"].nums().astype(bool)
                        pred_vals = ragged.take(md_col, rows_t)
                        sub = [(np.nonzero(okf)[0],
                                ragged.take(pred_vals, np.nonzero(okf)[0]))]
                        exc_cnt = int((~okf).sum())
                        if exc_cnt:
                            sub.append((np.nonzero(~okf)[0],
                                        tokenizer_recon_col(name, pctxs,
                                                            exc_cnt)))
                        col = ragged.merge_rows(sel.shape[0], sub)
                    else:
                        col = tokenizer_recon_col(name, pctxs, sel.shape[0])
                    col = ragged.interleave([col], sep_after=[b"\x00"])
                elif ty == ord("B"):
                    vl = pctxs[name + "L"].nums()
                    col = pc.txt_col(vl)
                else:  # f
                    col = pc.txt_col(np.full(sel.shape[0], 4, np.int64))
                parts.append((sel, col))
            val_col = ragged.merge_rows(F, parts)
            pref_col = ragged.gather_ranges(ld, pstart,
                                            np.full(F, 3, np.int64))
            fields = ragged.interleave([pref_col, val_col])
            row_lens = np.bincount(field_row, weights=fields.lens,
                                   minlength=n).astype(np.int64)
            aux_col = Col(fields.data,
                          np.concatenate([[0], np.cumsum(row_lens)]))
        else:
            aux_col = Col(np.zeros(0, np.uint8), np.zeros(n + 1, np.int64))
        bad_rows = np.nonzero(bad)[0]
        if bad_rows.shape[0]:
            good_rows = np.nonzero(~bad)[0]
            aux_col = ragged.merge_rows(
                n, [(good_rows, ragged.take(aux_col, good_rows)),
                    (bad_rows, pctxs["AUXEXC"].dict_take())])
        return aux_col

    @staticmethod
    def _renibble(ascii_col: Col) -> Col:
        """ASCII SEQ rows -> 4-bit rows (2-aligned, high nibble first)."""
        out_off = np.concatenate([[0], np.cumsum((ascii_col.lens + 1) // 2)])
        nibbles = native.renibble(ascii_col.data, ascii_col.offsets, NIB_OF,
                                  out_off)
        return Col(nibbles, out_off)

    @staticmethod
    def _renibble_np(ascii_col: Col) -> Col:
        """_renibble in numpy."""
        lens = ascii_col.lens
        nb = (lens + 1) // 2
        padded = np.zeros(ascii_col.data.shape[0] + len(ascii_col), np.uint8)
        # per-row 2-align: copy each row into 2*ceil(len/2) slots
        dst_off = np.concatenate([[0], np.cumsum(2 * nb)])
        total = int(lens.sum())
        if total:
            pos = ragged.arange(total) - np.repeat(ascii_col.offsets[:-1], lens)
            padded_idx = np.repeat(dst_off[:-1], lens) + pos
            buf = np.zeros(int(dst_off[-1]), np.uint8)
            buf[padded_idx] = ascii_col.data
        else:
            buf = np.zeros(0, np.uint8)
        codes = NIB_OF[buf]
        nibbles = (codes[0::2] << 4) | codes[1::2]
        return Col(nibbles, np.concatenate([[0], np.cumsum(nb)]))

    def optimize_vb(self, data: np.ndarray) -> np.ndarray:
        """--optimize: raw-Phred QUAL binning inside each BAM record
        (reference sam_modify.c, is_bam path; 0xFF missing-qual bytes are
        preserved by the raw LUT)."""
        from ..optimize import PHRED_LUT_RAW
        offsets, consumed = bam_scan(data, MAX_RECORDS_PER_VB)
        if offsets.shape[0] == 0:
            return data
        off = offsets
        l_rn = data[off + 12].astype(np.int64)
        n_cig = _u16(data, off + 16).astype(np.int64)
        l_seq = _u32(data, off + 20).astype(np.int64)
        qs = off + 36 + l_rn + 4 * n_cig + (l_seq + 1) // 2
        rows = np.nonzero(l_seq > 0)[0]
        if rows.shape[0] == 0:
            return data
        ql = l_seq[rows]
        total = int(ql.sum())
        idx = ragged.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(ql)])[:-1], ql) + \
            np.repeat(qs[rows], ql)
        data = data.copy() if not data.flags.writeable else data
        data[idx] = PHRED_LUT_RAW[data[idx]]
        return data

    def vb_boundary(self, data: np.ndarray, is_eof: bool) -> int:
        offsets, consumed = bam_scan(data, MAX_RECORDS_PER_VB)
        if is_eof and consumed != data.shape[0]:
            raise ValueError("BAM input ends mid-record")
        return consumed

    def segconf_scan(self, sample: np.ndarray):
        """Binary-record calibration (the BAM side of segconf.c:459): skip
        the header block inside the sample, then scan records for DEPN
        presence (gates the gencomp prescan), sortedness, paired fraction,
        read length and the SAG flavor evidence (SA/NH tag presence)."""
        DataType.segconf_scan(self, sample)
        b = sample.tobytes()
        if b[:4] != b"BAM\x01" or len(b) < 12:
            return
        l_text = int.from_bytes(b[4:8], "little")
        need = 8 + l_text
        if need + 4 > len(b):
            return
        n_ref = int.from_bytes(b[need:need + 4], "little")
        need += 4
        for _ in range(n_ref):
            if need + 4 > len(b):
                return
            l_name = int.from_bytes(b[need:need + 4], "little")
            need += 8 + l_name
        if need >= len(b):
            return
        recs = np.frombuffer(b[need:], np.uint8)
        off, _consumed = bam_scan(recs, 1 << 20)
        if off.shape[0] == 0:
            return
        flag = _u16(recs, off + 18).astype(np.int64)
        refid = _i32(recs, off + 4)
        pos = _i32(recs, off + 8)
        l_seq = _u32(recs, off + 20).astype(np.int64)
        self.segconf["has_depn"] = bool(((flag & 0x900) != 0).any())
        self.segconf["paired_frac"] = round(float(((flag & 1) != 0).mean()), 2)
        depn = (flag & 0x900) != 0
        if depn.any() and (~depn).any():
            # do DEPN qnames reappear on primaries? gates the PRIM-deporting
            # prescan (a second streaming read) — a corpus whose DEPN rows
            # have no primary (e.g. supplementary-only leftovers) gets
            # DEPN-only deportation with no extra read
            from .. import sag as sag_mod
            l_rn_ = recs[off + 12].astype(np.int64)
            names = ragged.gather_ranges(recs, off + 36, l_rn_ - 1)
            h = sag_mod.qname_hash(names)
            self.segconf["depn_prim_pairs"] = bool(
                np.isin(h[depn], h[~depn]).any())
        else:
            self.segconf["depn_prim_pairs"] = False
        if off.shape[0] > 4:
            same = refid[1:] == refid[:-1]
            self.segconf["sorted"] = bool(
                (pos[1:][same] >= pos[:-1][same]).all()) if same.any() \
                else True
        if l_seq.shape[0]:
            self.segconf["read_len_avg"] = round(float(l_seq.mean()), 1)
            self.segconf["is_long_reads"] = bool(l_seq.mean() > 1000)
        # SAG flavor evidence from binary aux tags of the first records
        tags = set()
        l_rn = recs[off + 12].astype(np.int64)
        n_cig = _u16(recs, off + 16).astype(np.int64)
        block_size = _u32(recs, off).astype(np.int64)
        aux_start = off + 36 + l_rn + 4 * n_cig + (l_seq + 1) // 2 + l_seq
        aux = ragged.gather_ranges(recs, aux_start,
                                   np.maximum(off + 4 + block_size
                                              - aux_start, 0))
        fr, fs, fv, _bad = self._walk_aux(aux)
        if fr.shape[0]:
            for t in np.unique((aux.data[fs].astype(np.uint32) << 8)
                               | aux.data[fs + 1]):
                tags.add(chr(int(t) >> 8) + chr(int(t) & 0xFF))
        self.segconf["aux_tags"] = sorted(tags)
        if "SA" in tags:
            self.segconf["sag_type"] = "SA"
        elif self.segconf.get("has_depn") and \
                tags & {"CB", "CR", "UB", "UR", "BX", "RX"}:
            self.segconf["sag_type"] = "SOLO"   # sections.h:32 SAG_BY_SOLO
        elif "NH" in tags:
            self.segconf["sag_type"] = "NH"
        elif "CC" in tags:
            self.segconf["sag_type"] = "CC"
        elif self.segconf.get("has_depn"):
            self.segconf["sag_type"] = "FLAG"

    # ------------------------------------------------------------------
    # gencomp: deportation of binary DEPN/PRIM records (gencomp_zip.c:587
    # applied to the BAM record framing; the SAM text path's exact analog)
    # ------------------------------------------------------------------

    def split_records(self, data: np.ndarray):
        """Record framing for gencomp re-interleaving: the serial
        block_size chain (each row = one whole record incl. its length
        prefix)."""
        offsets, consumed = bam_scan(data, data.shape[0] // 36 + 1)
        assert consumed == data.shape[0], "gencomp stream has partial record"
        block_size = _u32(data, offsets).astype(np.int64) if \
            offsets.shape[0] else np.zeros(0, np.int64)
        return Col(data, np.concatenate([[0], offsets + 4 + block_size]))

    def build_sag_store(self, prim_data: np.ndarray):
        from .. import sag as sag_mod
        return sag_mod.SagStore.from_bam(prim_data,
                                         self.segconf.get("bam_refs"))

    def depn_qname_hashes(self, data: np.ndarray) -> np.ndarray:
        """Prescan: qname hashes of secondary/supplementary records
        (src/sam_sag_scan.c role on the binary layout)."""
        from .. import sag as sag_mod
        off, consumed = bam_scan(data, MAX_RECORDS_PER_VB)
        if off.shape[0] == 0:
            return np.zeros(0, np.uint64)
        flag = _u16(data, off + 18).astype(np.int64)
        depn = (flag & sag_mod.DEPN_MASK) != 0
        if not depn.any():
            return np.zeros(0, np.uint64)
        di = np.nonzero(depn)[0]
        l_rn = data[off + 12].astype(np.int64)
        names = ragged.gather_ranges(data, off[di] + 36, l_rn[di] - 1)
        return sag_mod.qname_hash(names)

    def gencomp_split(self, data: np.ndarray, depn_qnames=None):
        """Deport DEPN records — and, given the prescan qname set, their
        primaries — out of the MAIN VB (gencomp_zip.c:587 on binary
        records). Returns (main, prim, depn, prim_orig_idx, depn_orig_idx)
        record-index positions, or None when nothing deports."""
        from .. import sag as sag_mod
        off, consumed = bam_scan(data, MAX_RECORDS_PER_VB)
        if off.shape[0] == 0 or consumed != data.shape[0]:
            return None
        n = off.shape[0]
        flag = _u16(data, off + 18).astype(np.int64)
        depn = (flag & sag_mod.DEPN_MASK) != 0
        prim = np.zeros(n, bool)
        if depn_qnames is not None and depn_qnames.shape[0]:
            l_rn = data[off + 12].astype(np.int64)
            names = ragged.gather_ranges(data, off + 36, l_rn - 1)
            h = sag_mod.qname_hash(names)
            prim = ~depn & np.isin(h, depn_qnames)
        if not depn.any() and not prim.any():
            return None
        block_size = _u32(data, off).astype(np.int64)
        rec_len = 4 + block_size
        didx = np.nonzero(depn)[0]
        pidx = np.nonzero(prim)[0]
        midx = np.nonzero(~depn & ~prim)[0]
        main = ragged.gather_ranges(data, off[midx], rec_len[midx]).data
        pri = ragged.gather_ranges(data, off[pidx], rec_len[pidx]).data
        dep = ragged.gather_ranges(data, off[didx], rec_len[didx]).data
        return main, pri, dep, pidx.astype(np.int64), didx.astype(np.int64)

    _OPIDX = np.zeros(256, np.uint8)
    for _i, _c in enumerate(b"MIDNSHP=X"):
        _OPIDX[_c] = _i

    @staticmethod
    def _cigar_bin(text: Col):
        """Text CIGAR -> (binary u32-ops Col, per-row op count): the
        inverse of _cigar_text, for rows whose cigar reconstructs from the
        SAG store's SA text (empty rows -> zero ops)."""
        d = text.data
        n = len(text)
        if d.shape[0] == 0:
            return (Col(np.zeros(0, np.uint8), np.zeros(n + 1, np.int64)),
                    np.zeros(n, np.int64))
        isop = ~((d >= ord("0")) & (d <= ord("9")))
        op_pos = np.nonzero(isop)[0]
        row_of = np.searchsorted(text.offsets[1:], op_pos, side="right")
        prev = np.concatenate([[-1], op_pos[:-1]])
        nstart = np.maximum(prev + 1, text.offsets[:-1][row_of])
        v, ok = ragged.atoi(ragged.gather_ranges(d, nstart,
                                                 op_pos - nstart))
        assert ok.all(), "malformed SA cigar"
        u32 = ((v.astype(np.uint32) << 4)
               | BamDT._OPIDX[d[op_pos]].astype(np.uint32))
        n_ops = np.bincount(row_of, minlength=n).astype(np.int64)
        bdata = u32.astype("<u4").view(np.uint8)
        return (Col(bdata, np.concatenate([[0], np.cumsum(4 * n_ops)])),
                n_ops)

    def _ref_catalog(self) -> Col:
        names = self.segconf.get("bam_refs") or []
        return Col.from_list([nm.encode() for nm in names])

    @staticmethod
    def _cigar_ref_span(cigar: Col, n_cig: np.ndarray) -> np.ndarray:
        """Per-record reference span from binary CIGAR: sum of op lens for
        ref-consuming ops M/D/N/=/X (SAMv1 §4.2.2)."""
        n = n_cig.shape[0]
        if cigar.data.shape[0] == 0:
            return np.zeros(n, np.int64)
        u = cigar.data[:cigar.data.shape[0] - cigar.data.shape[0] % 4]
        v = u.view("<u4").astype(np.int64)
        op = v & 0xF
        ln = v >> 4
        consumes = np.isin(op, (0, 2, 3, 7, 8))
        row = np.repeat(np.arange(n), n_cig)
        return np.bincount(row, weights=np.where(consumes, ln, 0),
                           minlength=n).astype(np.int64)

    @staticmethod
    def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
        """Vectorized SAMv1 §5.3 reg2bin."""
        e = end - 1
        conds = [(beg >> 14) == (e >> 14), (beg >> 17) == (e >> 17),
                 (beg >> 20) == (e >> 20), (beg >> 23) == (e >> 23),
                 (beg >> 26) == (e >> 26)]
        vals = [4681 + (beg >> 14), 585 + (beg >> 17), 73 + (beg >> 20),
                9 + (beg >> 23), 1 + (beg >> 26)]
        return np.select(conds, vals, 0).astype(np.int64)

    @staticmethod
    def _flag_demux(pc, flag: np.ndarray) -> np.ndarray:
        """Invert the DEPN-flag mux + delta of a POS-like context."""
        v = pc.local.astype(np.int64)
        if pc.param == 3:
            v = np.cumsum(v)
            depn = (flag & 0x900) != 0
            mux = np.argsort(depn, kind="stable")
            out = np.empty_like(v)
            out[mux] = v
            return out
        return pc.nums()

    def seg_vb(self, data: np.ndarray) -> VBSegResult:
        offsets, consumed = bam_scan(data, MAX_RECORDS_PER_VB)
        assert consumed == data.shape[0]
        off = offsets
        n = off.shape[0]

        refid = _i32(data, off + 4)
        pos = _i32(data, off + 8)
        l_rn = data[off + 12].astype(np.int64)
        mapq = data[off + 13].astype(np.int64)
        bin_ = _u16(data, off + 14).astype(np.int64)
        n_cig = _u16(data, off + 16).astype(np.int64)
        flag = _u16(data, off + 18).astype(np.int64)
        l_seq = _u32(data, off + 20).astype(np.int64)
        nrefid = _i32(data, off + 24)
        npos = _i32(data, off + 28)
        tlen = _i32(data, off + 32)
        block_size = _u32(data, off).astype(np.int64)

        name_start = off + 36
        cig_start = name_start + l_rn
        seq_start = cig_start + 4 * n_cig
        seq_bytes = (l_seq + 1) // 2
        qual_start = seq_start + seq_bytes
        aux_start = qual_start + l_seq
        rec_end = off + 4 + block_size

        # read_name without trailing NUL (re-added at recon)
        name = ragged.gather_ranges(data, name_start, l_rn - 1)
        cigar = ragged.gather_ranges(data, cig_start, 4 * n_cig)
        seq = ragged.gather_ranges(data, seq_start, seq_bytes)
        qual = ragged.gather_ranges(data, qual_start, l_seq)
        aux = ragged.gather_ranges(data, aux_start, rec_end - aux_start)

        ctxs = {}
        # SAG store join (the DEPN-component path, src/sam_sag_ingest.c on
        # binary records): QNAME elided for store hits
        sag = getattr(self, "sag_store", None)
        sag_idx = None
        if sag is not None and n:
            sag_idx = sag.lookup(name, flag)
        if sag_idx is not None:
            ctxs["SAGIDX"] = VBCtx("SAGIDX", MODE_NUM, local=sag_idx,
                                   cat="int")
            miss = np.nonzero(sag_idx < 0)[0]
            ctxs.update(tokenizer_seg_col("QNAME", ragged.take(name, miss)))
        else:
            ctxs.update(tokenizer_seg_col("QNAME", name))
        # SA-first-entry field prediction (sam_sag_zip.c / sections.h:32):
        # a supplementary's RNAME/POS/MAPQ/CIGAR match its primary's first
        # SA:Z entry — elide matching rows behind a 4-bit SAGF bitmap
        cig_t = None
        sagf = None
        if sag_idx is not None:
            saf = self._sa_field_preds(sag, sag_idx, flag)
            if saf is not None:
                from .. import sag as sag_mod
                from ..utils.ragged import cols_equal_rows
                cig_t = self._cigar_text(cigar, n_cig)
                pred_refid = sag_mod.hash_join(self._ref_catalog(),
                                               saf["rname"])
                rn_eq = saf["valid"] & (refid == pred_refid)
                ps_eq = saf["valid"] & (pos + 1 == saf["pos"])
                mq_eq = saf["valid"] & (mapq == saf["mapq"])
                cg_eq = saf["valid"] & cols_equal_rows(cig_t, saf["cigar"])
                v = (rn_eq.astype(np.int64) + ps_eq * 2 + mq_eq * 4
                     + cg_eq * 8)
                if v.any():
                    sagf = v
                    ctxs["SAGF"] = VBCtx("SAGF", MODE_NUM, local=sagf,
                                         cat="int")
        # secondary/supplementary rows carry unrelated positions that wreck
        # the sorted-POS delta chain: mux by the DEPN flag bits so the
        # primary channel deltas stay small (the reference deports these
        # rows to gencomp DEPN components, src/gencomp_zip.c — the mux is
        # the in-VB analog for non-gencomp runs; key recomputed from FLAG
        # at PIZ)
        depn = (flag & 0x900) != 0
        fmux = np.argsort(depn, kind="stable") \
            if depn.any() and not depn.all() else None
        _SAGF_BIT = {"RNAME": 1, "POS": 2, "MAPQ": 4}
        for nm, vals, delta in (("RNAME", refid, False), ("POS", pos, True),
                                ("MAPQ", mapq, False),
                                ("FLAG", flag, False), ("PNEXT", npos, True),
                                ("RNEXT", nrefid, False), ("TLEN", tlen, False),
                                ("NCIG", n_cig, False)):
            if sagf is not None and nm in _SAGF_BIT:
                # store only the rows the SA entry doesn't predict
                kp = np.nonzero(~(sagf & _SAGF_BIT[nm]).astype(bool))[0]
                sub = vals[kp]
                v = np.diff(sub, prepend=np.int64(0)) if delta else sub
                ctxs[nm] = VBCtx(nm, MODE_NUM, local=v, cat="int",
                                 param=1 if delta else 0)
                continue
            if delta and fmux is not None:
                v = np.diff(vals[fmux], prepend=np.int64(0))
                ctxs[nm] = VBCtx(nm, MODE_NUM, local=v, cat="int", param=3)
                continue
            v = np.diff(vals, prepend=np.int64(0)) if delta else vals
            ctxs[nm] = VBCtx(nm, MODE_NUM, local=v, cat="int",
                             param=1 if delta else 0)
        # BIN is a pure function of (POS, ref span) — predict it (SAMv1
        # spec reg2bin; reference src/bam_seg.c bam_seg_bin) and store the
        # residual, which is all-zero for spec-conforming writers
        span = self._cigar_ref_span(cigar, n_cig)
        bin_pred = self._reg2bin(pos, pos + np.maximum(span, 1))
        ctxs["BIN"] = VBCtx("BIN", MODE_NUM, local=bin_ - bin_pred,
                            cat="int", param=4)
        ctxs["SQLEN"] = VBCtx("SQLEN", MODE_NUM,
                              local=np.diff(l_seq, prepend=np.int64(0)),
                              cat="int", param=1)
        if sagf is not None:
            kc = np.nonzero(~(sagf & 8).astype(bool))[0]
            ctxs["CIGAR"] = VBCtx("CIGAR", MODE_TXT,
                                  local=ragged.take(cigar, kc).data,
                                  cat="int")
        else:
            ctxs["CIGAR"] = VBCtx("CIGAR", MODE_TXT, local=cigar.data,
                                  cat="int")
        ref = getattr(self, "ref", None)
        predict = None
        if sag_idx is not None:
            # DEPN SEQ/QUAL vs the primary (orientation + hard-clip slice,
            # predict_depn): matching rows cost one bitmap bit each
            from .. import sag as sag_mod
            from ..utils.ragged import cols_equal_rows
            ascii_col, nibok = self._seq_ascii(seq, l_seq)
            if cig_t is None:
                cig_t = self._cigar_text(cigar, n_cig)
            pred_seq, pred_qual, valid = sag_mod.predict_depn(
                sag, sag_idx, flag, cig_t, l_seq)
            seq_eq = valid & nibok & cols_equal_rows(ascii_col, pred_seq)
            qual_eq = valid & cols_equal_rows(qual, pred_qual)
            ctxs["SAGSEQ"] = VBCtx("SAGSEQ", MODE_NUM,
                                   local=seq_eq.astype(np.int64), cat="int")
            ctxs["SAGQUL"] = VBCtx("SAGQUL", MODE_NUM,
                                   local=qual_eq.astype(np.int64), cat="int")
            sk = np.nonzero(~seq_eq)[0]
            ctxs["SEQBIN"] = VBCtx("SEQBIN", MODE_TXT,
                                   local=ragged.take(seq, sk).data,
                                   cat="seq")
            qk = np.nonzero(~qual_eq)[0]
            ctxs["QUAL"] = self._seg_qual_core(
                ragged.take(qual, qk), ragged.take(ascii_col, qk), flag[qk])
            self._seg_aux_bam(ctxs, aux, None, l_seq,
                              pos_v=pos.astype(np.int64) + 1,
                              qual=qual, seq_ascii=ascii_col,
                              solo_pred=self._sag_solo_pred(sag_idx, n))
            return VBSegResult(ctxs, n, {})
        if ref is not None and n:
            # SEQ-vs-reference through the inherited SAM walk: synthesize
            # text RNAME/POS/CIGAR columns from the binary fields
            rname_t = self._rname_text(refid)
            pos_t = ragged.itoa(pos + 1)
            cig_t = self._cigar_text(cigar, n_cig)
            ascii_col, nibok = self._seq_ascii(seq, l_seq)
            if getattr(ref, "internal", False):
                self._populate_internal_ref(ascii_col, rname_t, pos_t,
                                            cig_t, ref)
            exact = np.nonzero(nibok)[0]
            a2 = ragged.merge_rows(n, [(exact, ragged.take(ascii_col, exact))])
            self._seg_seq_vs_ref(ctxs, a2, rname_t, pos_t, cig_t, ref)
            ctxs["NIBOK"] = VBCtx("NIBOK", MODE_NUM,
                                  local=nibok.astype(np.int64), cat="int")
            if (~nibok).any():
                raw = ragged.take(seq, np.nonzero(~nibok)[0])
                ctxs["SEQBIN"] = VBCtx("SEQBIN", MODE_TXT, local=raw.data,
                                       cat="seq")
            if "SQBITMAP" in ctxs:
                predict = self._predict_from_ctxs(
                    ctxs["SQBITMAP"].local.astype(bool),
                    ctxs["SEQNM"].local, ctxs["SEQMISP"].local,
                    cig_t, pos_t, rname_t, ref)
        else:
            ctxs["SEQBIN"] = VBCtx("SEQBIN", MODE_TXT, local=seq.data,
                                   cat="seq")
        # QUAL: seq-channel demux + strand normalization (codecs/qual.py);
        # ascii SEQ recomputed identically at PIZ from reconstructed nibbles
        qa, _ = self._seq_ascii(seq, l_seq)
        ctxs["QUAL"] = self._seg_qual_core(qual, qa, flag)
        self._seg_aux_bam(ctxs, aux, predict, l_seq,
                          pos_v=pos.astype(np.int64) + 1,
                          qual=qual, seq_ascii=qa)
        return VBSegResult(ctxs, n, {})

    def recon_vb(self, pctxs: dict, meta: dict) -> bytes:
        n = meta["num_lines"]
        sag = getattr(self, "sag_store", None)
        sag_idx = None
        if "SAGIDX" in pctxs:
            assert sag is not None, "DEPN VB needs the SAG store"
            sag_idx = pctxs["SAGIDX"].nums()
            miss = np.nonzero(sag_idx < 0)[0]
            hit = np.nonzero(sag_idx >= 0)[0]
            name = ragged.merge_rows(n, [
                (miss, tokenizer_recon_col("QNAME", pctxs, miss.shape[0])),
                (hit, ragged.take(sag.qname, sag_idx[hit]))])
        else:
            name = tokenizer_recon_col("QNAME", pctxs, n)
        flag = pctxs["FLAG"].nums()
        sagf = saf = None
        if "SAGF" in pctxs:
            # invert the SA-first-entry elision: predicted rows come from
            # the store (rebuilt identically at PIZ), kept rows from ctxs
            from .. import sag as sag_mod
            sagf = pctxs["SAGF"].nums()
            saf = self._sa_field_preds(sag, sag_idx, flag)
            assert saf is not None, "SAGF present but store lacks SA"
            pred_refid = sag_mod.hash_join(self._ref_catalog(),
                                           saf["rname"])

            def _mixnum(bit, ctxname, pred_vals):
                pr = np.nonzero((sagf & bit).astype(bool))[0]
                kp = np.nonzero(~(sagf & bit).astype(bool))[0]
                out = np.empty(n, np.int64)
                out[kp] = pctxs[ctxname].nums()
                out[pr] = pred_vals[pr]
                return out
            refid = _mixnum(1, "RNAME", pred_refid)
            pos = _mixnum(2, "POS", saf["pos"] - 1)
            mapq = _mixnum(4, "MAPQ", saf["mapq"])
        else:
            refid = pctxs["RNAME"].nums()
            pos = self._flag_demux(pctxs["POS"], flag)
            mapq = pctxs["MAPQ"].nums()
        nrefid = pctxs["RNEXT"].nums()
        npos = self._flag_demux(pctxs["PNEXT"], flag)
        tlen = pctxs["TLEN"].nums()
        n_cig = pctxs["NCIG"].nums()
        l_seq = pctxs["SQLEN"].nums()

        l_rn = name.lens + 1
        seq_bytes = (l_seq + 1) // 2
        if sagf is not None:
            pr = np.nonzero((sagf & 8).astype(bool))[0]
            kp = np.nonzero(~(sagf & 8).astype(bool))[0]
            kept_cig = pctxs["CIGAR"].txt_col(4 * n_cig[kp])
            pred_bin, pred_ops = self._cigar_bin(
                ragged.take(saf["cigar"], pr))
            assert (pred_ops == n_cig[pr]).all(), "SA cigar op-count drift"
            cigar = ragged.merge_rows(n, [(kp, kept_cig), (pr, pred_bin)])
        else:
            cigar = pctxs["CIGAR"].txt_col(4 * n_cig)
        bin_ = pctxs["BIN"].nums()
        if pctxs["BIN"].param == 4:
            span = self._cigar_ref_span(cigar, n_cig)
            bin_ = bin_ + self._reg2bin(pos, pos + np.maximum(span, 1))
        if sag_idx is not None:
            from .. import sag as sag_mod
            cig_t = self._cigar_text(cigar, n_cig)
            pred_seq, pred_qual, _valid = sag_mod.predict_depn(
                sag, sag_idx, flag, cig_t, l_seq)
            seq_eq = pctxs["SAGSEQ"].nums().astype(bool)
            qual_eq = pctxs["SAGQUL"].nums().astype(bool)
            se = np.nonzero(seq_eq)[0]
            sk = np.nonzero(~seq_eq)[0]
            parts = []
            if se.shape[0]:
                parts.append((se, self._renibble(ragged.take(pred_seq, se))))
            if sk.shape[0] or not parts:
                parts.append((sk, pctxs["SEQBIN"].txt_col(seq_bytes[sk])))
            seq = ragged.merge_rows(n, parts)
            qe = np.nonzero(qual_eq)[0]
            qk = np.nonzero(~qual_eq)[0]
            qa_all, _ = self._seq_ascii(seq, l_seq)
            qleft = self.qual_col_core(pctxs, ragged.take(qa_all, qk),
                                       l_seq[qk], flag[qk])
            qual = ragged.merge_rows(n, [
                (qe, ragged.take(pred_qual, qe)), (qk, qleft)])
        elif "SQBITMAP" in pctxs:
            n_rec = l_seq.shape[0]
            nibok = pctxs["NIBOK"].nums().astype(bool)
            a_lens = np.where(nibok, l_seq, 0)
            ascii_col = self._recon_seq_vs_ref(
                pctxs, a_lens, ragged.itoa(pos + 1), self._rname_text(refid),
                self._cigar_text(cigar, n_cig))
            nib = self._renibble(ascii_col)
            parts = [(np.nonzero(nibok)[0],
                      ragged.take(nib, np.nonzero(nibok)[0]))]
            bad = np.nonzero(~nibok)[0]
            if bad.shape[0]:
                raw = pctxs["SEQBIN"].txt_col(seq_bytes[bad])
                parts.append((bad, raw))
            seq = ragged.merge_rows(n_rec, parts)
        else:
            seq = pctxs["SEQBIN"].txt_col(seq_bytes)
        if sag_idx is None:
            qa, _ = self._seq_ascii(seq, l_seq)
            qual = self.qual_col_core(pctxs, qa, l_seq, flag)
        else:
            qa = qa_all
        if "AUXL" in pctxs:
            predict = None
            if "SQBITMAP" in pctxs:
                predict = self._predict_from_ctxs(
                    pctxs["SQBITMAP"].nums().astype(bool),
                    pctxs["SEQNM"].nums(), pctxs["SEQMISP"].nums(),
                    self._cigar_text(cigar, n_cig), ragged.itoa(pos + 1),
                    self._rname_text(refid), self.ref)
            aux = self._recon_aux_bam(pctxs, n, predict, l_seq,
                                      pos_v=pos.astype(np.int64) + 1,
                                      qual=qual, seq_ascii=qa,
                                      solo_pred=self._sag_solo_pred(sag_idx,
                                                                    n))
        else:
            aux = pctxs["AUX"].txt_col(pctxs["AUXLEN"].nums())
        aux_lens = aux.lens

        block_size = (32 + l_rn + 4 * n_cig + seq_bytes + l_seq + aux_lens)

        def le(vals, w):
            m = np.zeros((n, w), dtype=np.uint8)
            v = vals.astype(np.uint64) & ((1 << (8 * w)) - 1)
            for b in range(w):
                m[:, b] = (v >> (8 * b)) & 0xFF
            return Col.from_fixed(m)

        fixed = np.zeros((n, 36), dtype=np.uint8)
        for valcol, offb, w in ((block_size, 0, 4), (refid, 4, 4), (pos, 8, 4),
                                (l_rn, 12, 1), (mapq, 13, 1), (bin_, 14, 2),
                                (n_cig, 16, 2), (flag, 18, 2), (l_seq, 20, 4),
                                (nrefid, 24, 4), (npos, 28, 4), (tlen, 32, 4)):
            v = valcol.astype(np.int64).astype(np.uint64) & ((1 << (8 * w)) - 1)
            for b in range(w):
                fixed[:, offb + b] = (v >> (8 * b)) & 0xFF
        out = ragged.interleave(
            [Col.from_fixed(fixed), name, cigar, seq, qual, aux],
            sep_after=[None, b"\x00", None, None, None, None])
        return out.data.tobytes()
