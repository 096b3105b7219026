"""SAM datatype plugin (text alignment records).

Reference parity: src/sam_seg.c (field seg), src/sam_fields.c (aux),
src/sam_cigar.c, src/sam_qual.c, src/sam_header.c. Counterpart of
genozip_tpu/datatypes/sam.py on its numpy host path. Design:
whole-VB column split of the 11 fixed fields + raw aux remainder; QNAME and
CIGAR through the vectorized tokenizer (digit runs -> int streams), aux
through the tokenizer in single-stream mode; SEQ/QUAL as concatenated streams
with per-record length streams. The CIGAR-vs-reference SEQ diff, MD/NM
prediction, mate-copy and SAG/gencomp machinery are later milestones; BAM
binary parsing lives in datatypes/bam.py.
"""

import numpy as np

from . import DataType, VBSegResult, register
from .. import native
from ..utils import ragged
from ..utils.ragged import Col
from ..contexts import VBCtx, MODE_DICT, MODE_NUM, MODE_TXT, dedup_col
from ..seg import tokenizer_seg_col, tokenizer_recon_col

NUM_FIXED = 11


def _lines_of(data: np.ndarray):
    nl = np.nonzero(data == ord("\n"))[0]
    no_final_nl = data.shape[0] and (nl.shape[0] == 0 or nl[-1] != data.shape[0] - 1)
    if no_final_nl:
        nl = np.concatenate([nl, [data.shape[0]]])
    starts = np.concatenate([[0], nl[:-1] + 1])
    return ragged.gather_ranges(data, starts, nl - starts), bool(no_final_nl)


def _num_or_tok(name, col, delta=False):
    """Numeric context when every row parses as a clean integer, else
    tokenizer."""
    vals, ok = ragged.atoi(col)
    if ok.all():
        if delta:
            d = np.diff(vals, prepend=np.int64(0))
            return {name: VBCtx(name, MODE_NUM, local=d, cat="int", param=1)}
        return {name: VBCtx(name, MODE_NUM, local=vals, cat="int", param=0)}
    return tokenizer_seg_col(name, col)


def _recon_num_or_tok(name, pctxs, n):
    pc = pctxs.get(name)
    if pc is not None and pc.mode == MODE_NUM:
        return ragged.itoa(pc.nums())
    return tokenizer_recon_col(name, pctxs, n)


@register
class SamDT(DataType):
    NAME = "sam"

    def segconf_scan(self, sample):
        """SAM calibration (reference src/segconf.c:459 segconf_calculate:
        ~200 fields; the load-bearing subset here): sortedness (gates the
        gencomp prescan), DEPN presence (secondary/supplementary flags),
        paired fraction, aux tags seen, long-read detection, qual
        alphabet."""
        super().segconf_scan(sample)
        nl = np.nonzero(sample == ord("\n"))[0]
        if nl.shape[0] == 0:
            return
        starts = np.concatenate([[0], nl[:-1] + 1])
        lines = ragged.gather_ranges(sample, starts, nl - starts)
        rows = [i for i in range(len(lines)) if lines.row(i)[:1] != b"@"]
        if not rows:
            return
        cols, _aux, good, _bad = ragged.split_first_fields(
            ragged.take(lines, np.asarray(rows)), ord("\t"), NUM_FIXED)
        if good.shape[0] == 0:
            return
        flags, fok = ragged.atoi(cols[1])
        pv, pok = ragged.atoi(cols[3])
        if fok.any():
            f = flags[fok]
            self.segconf["has_depn"] = bool(((f & 0x900) != 0).any())
            self.segconf["paired_frac"] = round(
                float(((f & 1) != 0).mean()), 2)
            depn = fok & ((flags & 0x900) != 0)
            prim = fok & ((flags & 0x900) == 0)
            if depn.any() and prim.any():
                # gates the PRIM-deporting prescan (see datatypes/bam.py)
                from .. import sag as sag_mod
                h = sag_mod.qname_hash(cols[0])
                self.segconf["depn_prim_pairs"] = bool(
                    np.isin(h[depn], h[prim]).any())
            else:
                self.segconf["depn_prim_pairs"] = False
        if pok.sum() > 4:
            # sorted = POS non-decreasing within runs of the same RNAME
            from ..contexts import dedup_col
            _, inv = dedup_col(cols[2])
            p = pv[pok]
            r = inv[pok]
            same = r[1:] == r[:-1]
            self.segconf["sorted"] = bool(
                (p[1:][same] >= p[:-1][same]).all()) if same.any() else True
        sl = cols[9].lens
        if sl.shape[0]:
            self.segconf["read_len_avg"] = round(float(sl.mean()), 1)
            self.segconf["is_long_reads"] = bool(sl.mean() > 1000)
        ql = cols[10]
        if len(ql):
            self.segconf["qual_alphabet"] = int(
                np.unique(ql.data[:65536]).shape[0])
        # aux tags present in the sample (codec/prediction preselection)
        tags = set()
        for i in range(min(len(rows), 100)):
            for fld in lines.row(rows[i]).split(b"\t")[NUM_FIXED:]:
                if len(fld) >= 5 and fld[2:3] == b":":
                    tags.add(fld[:2].decode("latin1"))
        self.segconf["aux_tags"] = sorted(tags)
        # SAG flavor (reference sections.h:32-38 SAG_BY_SA/NH/CC/SOLO/FLAG):
        # which grouping evidence the sample carries. The store itself is
        # flavor-agnostic (qname join); the flavor picks the predictors —
        # BY_SA adds the composed-SA-entry prefix prediction (sam_tags.py
        # sa_pred_seg), BY_NH/CC/FLAG fall back to SEQ/QUAL copy only.
        if "SA" in tags:
            self.segconf["sag_type"] = "SA"
        elif self.segconf.get("has_depn") and \
                tags & {"CB", "CR", "UB", "UR", "BX", "RX"}:
            # SAG_BY_SOLO (sections.h:32, sam_sag_zip.c:877): STARsolo-class
            # files — DEPN rows repeat the primary's barcode tags
            self.segconf["sag_type"] = "SOLO"
        elif "NH" in tags:
            self.segconf["sag_type"] = "NH"
        elif "CC" in tags:
            self.segconf["sag_type"] = "CC"
        elif self.segconf.get("has_depn"):
            self.segconf["sag_type"] = "FLAG"

    def build_sag_store(self, prim_data: np.ndarray):
        from .. import sag as sag_mod
        return sag_mod.SagStore.from_text(prim_data)

    def optimize_vb(self, data: np.ndarray) -> np.ndarray:
        """--optimize: QUAL binning on field 11 of each alignment line
        (reference sam_modify.c). Single-char QUAL ('*' = no qual) rows
        are skipped."""
        from ..optimize import PHRED_LUT
        nl = np.nonzero(data == ord("\n"))[0]
        if nl.shape[0] == 0:
            return data
        starts = np.concatenate([[0], nl[:-1] + 1])
        lines = ragged.gather_ranges(data, starts, nl - starts)
        keep = np.nonzero((lines.lens > 0) & (data[starts] != ord("@")))[0]
        if keep.shape[0] == 0:
            return data
        body = ragged.take(lines, keep)
        cols, _aux, good, _bad = ragged.split_first_fields(
            body, ord("\t"), NUM_FIXED)
        if good.shape[0] == 0:
            return data
        qual = cols[10]
        # QUAL's offset within its line = len of fields 0..9 + their tabs
        pre = np.zeros(good.shape[0], np.int64)
        for c in cols[:10]:
            pre += c.lens + 1
        # skip only the missing-qual sentinel '*' — a legitimate 1-byte QUAL
        # of a 1bp read is still binned (matches the reference's --optimize)
        qs0 = starts[keep][good] + pre
        rows = np.nonzero((qual.lens > 1) |
                          ((qual.lens == 1) & (data[qs0] != ord("*"))))[0]
        if rows.shape[0] == 0:
            return data
        qs = starts[keep][good][rows] + pre[rows]
        ql = qual.lens[rows]
        total = int(ql.sum())
        idx = ragged.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(ql)])[:-1], ql) + \
            np.repeat(qs, ql)
        data = data.copy() if not data.flags.writeable else data
        data[idx] = PHRED_LUT[data[idx]]
        return data

    def read_txt_header(self, reader) -> bytes:
        hdr = reader.read_header_lines(b"@")
        if getattr(self, "ref", None) is None:
            self._maybe_init_internal_ref(hdr)
        return hdr

    # REF_INTERNAL cap: denovo genomes above this are skipped (host RAM;
    # the reference's on-demand ranges relax this later)
    INTERNAL_REF_MAX = 1 << 31

    def _maybe_init_internal_ref(self, hdr: bytes):
        """REF_INTERNAL (reference src/reference.c, flags.h:16-21): SAM
        with no external reference builds a denovo genome from the
        alignments themselves — @SQ contigs allocate a 2-bit genome; each
        VB's pure-match reads populate still-unset positions (first wins,
        before that VB's SEQ diff, so every diffed position is immutable
        afterwards); the populated genome is stored in the archive
        (SEC_REFERENCE) for PIZ."""
        from ..ref.refstore import RefGenome
        contigs = []
        g = 0
        for line in hdr.split(b"\n"):
            if not line.startswith(b"@SQ"):
                continue
            name = ln = None
            for f in line.split(b"\t")[1:]:
                if f.startswith(b"SN:"):
                    name = f[3:]
                elif f.startswith(b"LN:"):
                    try:
                        ln = int(f[3:])
                    except ValueError:
                        ln = None
            if name is not None and ln:
                contigs.append({"name": name.decode("utf-8", "replace"),
                                "gpos": g, "length": ln})
                g += ln
        if not contigs or g == 0 or g > self.INTERNAL_REF_MAX:
            return
        ref = RefGenome(np.zeros(g, np.uint8), contigs)
        ref.is_set = np.zeros(g, bool)
        ref.internal = True
        self.ref = ref

    _POP_BLK = 4096    # block granularity for the saturation fast path

    def _populate_internal_ref(self, seq, rname, pos, cigar, ref):
        """Scatter this VB's pure-match reads into still-unset genome
        positions (ref_lock.c's range locking becomes: populate the whole
        batch, then diff — set positions never change afterwards).
        Saturated 4KB blocks are skipped (on 30x data the genome fills in
        the first VBs; later VBs must not re-scatter everything). A position
        an earlier VB's SEQ was diffed against while it was unset
        (`ref.read_unset`) stays unset: PIZ diffs that VB against the stored
        genome, so its bases must not change afterwards. genozip_tpu
        populates it, and the earlier VB then fails its digest at unzip
        (fault F11)."""
        from ..ops import pack as packops
        if not hasattr(ref, "blk_set"):
            nblk = -(-ref.length // self._POP_BLK)
            ref.blk_set = np.zeros(nblk, np.int64)
            sizes = np.full(nblk, self._POP_BLK, np.int64)
            sizes[-1] = ref.length - (nblk - 1) * self._POP_BLK
            ref.blk_size = sizes
            # pad is_set to a whole number of blocks for 2D recounting
            pad = nblk * self._POP_BLK - ref.length
            if pad:
                ref.is_set = np.concatenate([ref.is_set,
                                             np.zeros(pad, bool)])
        gbase = self._gbase_of(rname, ref)
        pv, pok = ragged.atoi(pos)
        # purity check on UNIQUE cigar templates (real files repeat "150M")
        uw, inv = dedup_col(cigar)
        upure = np.zeros(len(uw), bool)
        for wi in range(len(uw)):
            cw = uw.row(wi)
            upure[wi] = bool(cw) and all(
                48 <= c <= 57 or c in (77, 61, 88) for c in cw)
        pure = upure[inv]
        elig = pure & pok & (gbase >= 0) & (pv >= 1) & \
            (gbase + pv - 1 + seq.lens <= ref.length) & (seq.lens > 0)
        if not elig.any():
            return
        # skip reads whose whole span lies in saturated blocks
        start_all = gbase + pv - 1
        b0 = start_all // self._POP_BLK
        b1 = (start_all + seq.lens - 1) // self._POP_BLK
        full = ref.blk_set >= ref.blk_size
        b0c = np.clip(b0, 0, full.shape[0] - 1)
        b1c = np.clip(b1, 0, full.shape[0] - 1)
        elig &= ~(full[b0c] & full[b1c]) | (b1 - b0 > 1)
        rows = np.nonzero(elig)[0]
        if rows.shape[0] == 0:
            return
        # one pass in the host runtime (`_populate_rows_np` in numpy)
        native.ref_populate(seq.data, seq.offsets, rows, start_all[rows],
                            packops.BASE2BIT, ref.codes, ref.is_set,
                            ref.blk_set, self._POP_BLK,
                            getattr(ref, "read_unset", None))

    def _populate_rows_np(self, seq, rows, start_all, ref):
        """The scatter of _populate_internal_ref in numpy: reads `rows`,
        starting at genome position start_all[rows]."""
        from ..ops import pack as packops
        it = np.int32 if ref.length < (1 << 31) else np.int64
        sub = ragged.take(seq, rows)
        start = start_all[rows].astype(it)
        slens = sub.lens.astype(it)
        byte_row = np.repeat(np.arange(rows.shape[0], dtype=it), slens)
        pos_in = np.arange(sub.data.shape[0], dtype=it) - \
            sub.offsets[:-1].astype(it)[byte_row]
        gp = start[byte_row] + pos_in
        codes = packops.BASE2BIT[sub.data]
        sel = ~ref.is_set[gp]
        if getattr(ref, "read_unset", None) is not None:
            sel &= ~ref.read_unset[gp]
        gsel = gp[sel]
        # duplicate positions within the batch: the last read wins (the
        # stored genome carries it, so native.ref_populate does the same);
        # the diffs read the settled array, so ZIP and PIZ agree
        ref.codes[gsel] = codes[sel]
        ref.is_set[gsel] = True
        # exact per-block recount of the touched blocks (saturation gate)
        touched = np.zeros(ref.blk_set.shape[0], bool)
        touched[gsel // self._POP_BLK] = True
        tb = np.nonzero(touched)[0]
        if tb.shape[0]:
            is2d = ref.is_set.reshape(-1, self._POP_BLK)
            ref.blk_set[tb] = is2d[tb].sum(axis=1)

    def depn_qname_hashes(self, data: np.ndarray) -> np.ndarray:
        """Prescan: qname hashes of secondary/supplementary lines
        (reference parity: src/sam_sag_scan.c — which QNAMEs have SAGs)."""
        from .. import sag as sag_mod
        nl = np.nonzero(data == ord("\n"))[0]
        if data.shape[0] == 0 or nl.shape[0] == 0:
            return np.zeros(0, np.uint64)
        if nl[-1] != data.shape[0] - 1:
            nl = np.concatenate([nl, [data.shape[0]]])
        starts = np.concatenate([[0], nl[:-1] + 1])
        lines = ragged.gather_ranges(data, starts, nl - starts)
        cols, _aux, good_rows, _bad = ragged.split_first_fields(
            lines, ord("\t"), 2)
        flags, fok = ragged.atoi(cols[1])
        depn = fok & ((flags & sag_mod.DEPN_MASK) != 0)
        if not depn.any():
            return np.zeros(0, np.uint64)
        return sag_mod.qname_hash(ragged.take(cols[0], np.nonzero(depn)[0]))

    def gencomp_split(self, data: np.ndarray, depn_qnames=None):
        """Deport secondary/supplementary alignments (DEPN) and — when the
        prescan qname set is given — their primaries (PRIM) out of the MAIN
        VB (reference parity: src/gencomp_zip.c:587 — PRIM/DEPN generated
        components re-interleaved by a recon plan). Returns
        (main_data, prim_data, depn_data, prim_orig_idx, depn_orig_idx)
        or None when nothing to deport. Positions are original line indices
        within this VB's pre-split text."""
        from .. import sag as sag_mod
        nl = np.nonzero(data == ord("\n"))[0]
        if data.shape[0] == 0 or nl.shape[0] == 0 or nl[-1] != data.shape[0] - 1:
            return None  # keep the tail VB simple
        starts = np.concatenate([[0], nl[:-1] + 1])
        lines = ragged.gather_ranges(data, starts, nl - starts)
        n = len(lines)
        cols, aux, good_rows, bad_rows = ragged.split_first_fields(
            lines, ord("\t"), 2)
        flags, fok = ragged.atoi(cols[1])
        depn = np.zeros(n, dtype=bool)
        depn[good_rows] = fok & ((flags & sag_mod.DEPN_MASK) != 0)
        prim = np.zeros(n, dtype=bool)
        if depn_qnames is not None and depn_qnames.shape[0]:
            h = sag_mod.qname_hash(cols[0])
            is_prim = fok & ((flags & sag_mod.DEPN_MASK) == 0) \
                & np.isin(h, depn_qnames)
            prim[good_rows] = is_prim
        if not depn.any() and not prim.any():
            return None
        didx = np.nonzero(depn)[0]
        pidx = np.nonzero(prim)[0]
        midx = np.nonzero(~depn & ~prim)[0]
        # include the trailing newline with each line (raw-data offsets)
        lens = nl - starts + 1
        main = ragged.gather_ranges(data, starts[midx], lens[midx]).data
        pri = ragged.gather_ranges(data, starts[pidx], lens[pidx]).data
        dep = ragged.gather_ranges(data, starts[didx], lens[didx]).data
        return main, pri, dep, pidx.astype(np.int64), didx.astype(np.int64)

    def seg_vb(self, data: np.ndarray) -> VBSegResult:
        lines, no_final_nl = _lines_of(data)
        n = len(lines)
        cols, aux, good_rows, bad_rows = ragged.split_first_fields(
            lines, ord("\t"), NUM_FIXED)
        (qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq,
         qual) = cols

        ctxs = {}
        sag = getattr(self, "sag_store", None)
        sag_idx = None
        if sag is not None and len(qname):
            flags_v, flags_ok = ragged.atoi(flag)
            if flags_ok.all():
                sag_idx = sag.lookup(qname, flags_v)
        if sag_idx is not None:
            # DEPN-vs-primary (reference src/sam_sag_ingest.c): QNAME elided
            # for store hits; SEQ/QUAL elided where the orientation+hardclip
            # slice of the primary predicts them
            from .. import sag as sag_mod
            ctxs["SAGIDX"] = VBCtx("SAGIDX", MODE_NUM, local=sag_idx,
                                   cat="int")
            miss = np.nonzero(sag_idx < 0)[0]
            ctxs.update(tokenizer_seg_col("QNAME", ragged.take(qname, miss)))
        else:
            ctxs.update(tokenizer_seg_col("QNAME", qname))
        ctxs.update(_num_or_tok("FLAG", flag))
        # DEPN RNAME/POS/MAPQ/CIGAR prediction from the primary's first
        # SA:Z entry (reference src/sam_sag_zip.c / sections.h:32 SA-type
        # groups): the SA entry written in the primary describes this
        # supplementary, so matching fields cost one bitmap bit each
        sagf = None
        if sag_idx is not None:
            saf = self._sa_field_preds(sag, sag_idx, flags_v)
            if saf is not None:
                from ..utils.ragged import cols_equal_rows
                pvq, pvok = ragged.atoi(pos)
                mvq, mvok = ragged.atoi(mapq)
                v = saf["valid"]
                rn_eq = v & cols_equal_rows(rname, saf["rname"])
                ps_eq = v & pvok & (pvq == saf["pos"])
                mq_eq = v & mvok & (mvq == saf["mapq"])
                cg_eq = v & cols_equal_rows(cigar, saf["cigar"])
                sagf = (rn_eq.astype(np.int64) + ps_eq * 2 +
                        mq_eq * 4 + cg_eq * 8)
                if sagf.any():
                    ctxs["SAGF"] = VBCtx("SAGF", MODE_NUM, local=sagf,
                                         cat="int")
                else:
                    sagf = None
        uw, inv = dedup_col(rnext)
        ctxs["RNEXT"] = VBCtx("RNEXT", MODE_DICT, b250=inv, vb_words=uw,
                              cat="b250")
        if sagf is not None:
            kr = np.nonzero(~(sagf & 1).astype(bool))[0]
            uw, inv = dedup_col(ragged.take(rname, kr))
            ctxs["RNAME"] = VBCtx("RNAME", MODE_DICT, b250=inv, vb_words=uw,
                                  cat="b250")
            kp = np.nonzero(~(sagf & 2).astype(bool))[0]
            ctxs.update(_num_or_tok("POS", ragged.take(pos, kp), delta=True))
            km = np.nonzero(~(sagf & 4).astype(bool))[0]
            ctxs.update(_num_or_tok("MAPQ", ragged.take(mapq, km)))
            kc = np.nonzero(~(sagf & 8).astype(bool))[0]
            ctxs.update(tokenizer_seg_col("CIGAR", ragged.take(cigar, kc)))
        else:
            uw, inv = dedup_col(rname)
            ctxs["RNAME"] = VBCtx("RNAME", MODE_DICT, b250=inv, vb_words=uw,
                                  cat="b250")
            ctxs.update(_num_or_tok("POS", pos, delta=True))
            ctxs.update(_num_or_tok("MAPQ", mapq))
            ctxs.update(tokenizer_seg_col("CIGAR", cigar))
        # PNEXT as mate-delta vs POS (reference mate-copy snips,
        # sam_seg.c:27-60): insert-size-scale values instead of a delta
        # chain. PNEXT=0 (no mate) encodes as 0; non-negative deltas shift
        # up by 1 to keep 0 free — otherwise unpaired reads store -POS,
        # which anti-compresses.
        pv_, pok_ = ragged.atoi(pos)
        pn_, nok_ = ragged.atoi(pnext)
        if pok_.all() and nok_.all() and len(pos):
            d = pn_ - pv_
            enc = np.where(pn_ == 0, 0, np.where(d >= 0, d + 1, d))
            ctxs["PNEXT"] = VBCtx("PNEXT", MODE_NUM, local=enc,
                                  cat="int", param=3)
        else:
            ctxs.update(_num_or_tok("PNEXT", pnext, delta=True))
        # TLEN as delta vs the proper-pair span prediction
        # (reference sam_seg_TLEN: tlen ~ PNEXT - POS +/- read span): exact
        # for FR proper pairs, harmless delta otherwise
        tv_, tok_ = ragged.atoi(tlen)
        if pok_.all() and nok_.all() and tok_.all() and len(pos):
            span = pn_ - pv_ + np.where(pn_ >= pv_, seq.lens, -seq.lens)
            pred = np.where((pn_ > 0) & (pv_ > 0), span, 0)
            ctxs["TLEN"] = VBCtx("TLEN", MODE_NUM, local=tv_ - pred,
                                 cat="int", param=5)
        else:
            ctxs.update(_num_or_tok("TLEN", tlen))
        ref = getattr(self, "ref", None)
        if ref is not None and getattr(ref, "internal", False) and len(seq):
            self._populate_internal_ref(seq, rname, pos, cigar, ref)
        if sag_idx is not None:
            from .. import sag as sag_mod
            from ..utils.ragged import cols_equal_rows
            pred_seq, pred_qual, valid = sag_mod.predict_depn(
                sag, sag_idx, flags_v, cigar, seq.lens)
            seq_eq = valid & cols_equal_rows(seq, pred_seq)
            qual_eq = valid & cols_equal_rows(qual, pred_qual)
            ctxs["SAGSEQ"] = VBCtx("SAGSEQ", MODE_NUM,
                                   local=seq_eq.astype(np.int64), cat="int")
            ctxs["SAGQUL"] = VBCtx("SAGQUL", MODE_NUM,
                                   local=qual_eq.astype(np.int64), cat="int")
            nonref = ragged.take(seq, np.nonzero(~seq_eq)[0])
            ctxs["NONREF"] = VBCtx("NONREF", MODE_TXT, local=nonref.data,
                                   cat="seq")
            keep = np.nonzero(~qual_eq)[0]
            ctxs["QUAL"] = self._seg_qual_sam(
                ragged.take(qual, keep), ragged.take(seq, keep), flag, keep)
        elif ref is not None and len(seq):
            self._seg_seq_vs_ref(ctxs, seq, rname, pos, cigar, ref)
            ctxs["QUAL"] = self._seg_qual_sam(qual, seq, flag)
        else:
            ctxs["NONREF"] = VBCtx("NONREF", MODE_TXT, local=seq.data, cat="seq")
            ctxs["QUAL"] = self._seg_qual_sam(qual, seq, flag)
        ctxs["SQLEN"] = VBCtx("SQLEN", MODE_NUM,
                              local=np.diff(seq.lens, prepend=np.int64(0)),
                              cat="int", param=1)
        ctxs["QLLEN"] = VBCtx("QLLEN", MODE_NUM,
                              local=np.diff(qual.lens, prepend=np.int64(0)),
                              cat="int", param=1)
        predict = None
        if "SQBITMAP" in ctxs and ref is not None:
            predict = self._predict_from_ctxs(
                ctxs["SQBITMAP"].local.astype(bool), ctxs["SEQNM"].local,
                ctxs["SEQMISP"].local, cigar, pos, rname, ref)
        mate = self.mate_rows(qname, pos, pnext) if len(qname) else None
        sa_pred = self._sa_pred_col(sag_idx, len(qname))
        self._seg_aux(ctxs, aux, predict, qual=qual, seq=seq,
                      cigar=cigar, mate=mate,
                      pos_v=pv_ if (len(pos) and pok_.all()) else None,
                      sa_pred=sa_pred,
                      nh_pred=self._sag_nh_pred(sag_idx, len(qname)),
                      cc_pred=self._sag_cc_pred_col(sag_idx, len(qname)),
                      cp_pred=self._sag_cp_pred(sag_idx, len(qname)),
                      solo_pred=self._sag_solo_pred(sag_idx, len(qname)))

        if bad_rows.shape[0]:
            uw, inv = dedup_col(ragged.take(lines, bad_rows))
            ctxs["EXC"] = VBCtx("EXC", MODE_DICT, b250=inv, vb_words=uw, cat="text")
        gd = np.zeros(n, dtype=np.int64)
        gd[bad_rows] = 1
        ctxs["VARIANT"] = VBCtx("VARIANT", MODE_NUM, local=gd, cat="int")
        return VBSegResult(ctxs, n, {"no_final_nl": no_final_nl})

    def _seg_qual_core(self, qual, seq, flags_v):
        """QUAL with optional machine-orientation normalization
        (codec_normq.c role: reverse revcomped rows so strand-symmetric
        cycle/context channels align) + SEQ-channel demux (the platform
        quality codec family, codecs/qual.py). flags_v: per-qual-row int
        FLAGs or None."""
        from ..codecs import qual as qualmod
        rev = None
        if flags_v is not None:
            r = (flags_v & 0x10) != 0
            if r.any():
                rev = r
        qm = qualmod.orient(qual, rev) if rev is not None else qual
        sm = qualmod.orient(seq, rev, comp=True) if rev is not None else seq
        cls = getattr(self, "_qdmx", "unset")
        if cls == "unset":
            cls = qualmod.choose_class(sm, qm)
            if not self._seg_lazy_frozen:
                self._qdmx = cls   # commit only while seg is single-threaded
        if cls:
            sp = f"qdmx:{cls}:rev" if rev is not None else f"qdmx:{cls}"
            return VBCtx("QUAL", MODE_TXT, local=qualmod.demux(cls, qm, sm),
                         cat="qual", special=sp)
        if rev is not None:
            return VBCtx("QUAL", MODE_TXT, local=qm.data, cat="qual",
                         special="qdmx::rev")
        return VBCtx("QUAL", MODE_TXT, local=qual.data, cat="qual")

    @staticmethod
    def qual_col_core(pctxs, seq, lens, flags_v):
        """PIZ QUAL: undo demux (channels from reconstructed SEQ) and the
        strand normalization (flags reconstruct before QUAL)."""
        from ..codecs import qual as qualmod
        pc = pctxs["QUAL"]
        sp = pc.special or ""
        if not sp.startswith("qdmx:"):
            return pc.txt_col(lens)
        parts = sp.split(":")
        cls, revd = parts[1], len(parts) > 2 and parts[2] == "rev"
        rev = ((flags_v & 0x10) != 0) if revd else None
        sm = qualmod.orient(seq, rev, comp=True) if rev is not None else seq
        offs = np.concatenate([[0], np.cumsum(lens.astype(np.int64))])
        data = qualmod.remux(cls, pc.local, sm, lens) if cls else pc.local
        qm = Col(data, offs)
        return qualmod.orient(qm, rev) if rev is not None else qm

    def _seg_qual_sam(self, qual, seq, flag, subset=None):
        """Text-FLAG wrapper: `subset` = row indices into the VB's flag
        column when qual covers only some rows (SAG path)."""
        flags_v, fok = ragged.atoi(flag)
        fv = None
        if fok.all() and len(flag):
            fv = flags_v if subset is None else flags_v[subset]
        return self._seg_qual_core(qual, seq, fv)

    @staticmethod
    def qual_col_sam(pctxs, seq, lens, flag, subset=None):
        pc = pctxs["QUAL"]
        sp = pc.special or ""
        fv = None
        if sp.endswith(":rev"):
            flags_v, _ = ragged.atoi(flag)
            fv = flags_v if subset is None else flags_v[subset]
        return SamDT.qual_col_core(pctxs, seq, lens, fv)

    # CIGAR op classification (SAMv1): which ops consume read / reference
    _READ_OPS = frozenset(b"MIS=X")
    _REF_OPS = frozenset(b"MDN=X")
    _MATCH_OPS = frozenset(b"M=X")
    _ALL_OPS = frozenset(b"MIDNSHP=X")
    _READ_LUT = np.zeros(256, bool)
    _REF_LUT = np.zeros(256, bool)
    _MATCH_LUT = np.zeros(256, bool)
    _ALLOP_LUT = np.zeros(256, bool)
    _INS_LUT = np.zeros(256, bool)
    for _b in b"MIS=X":
        _READ_LUT[_b] = True
    for _b in b"MDN=X":
        _REF_LUT[_b] = True
    for _b in b"M=X":
        _MATCH_LUT[_b] = True
    for _b in b"MIDNSHP=X":
        _ALLOP_LUT[_b] = True
    for _b in b"IS":
        _INS_LUT[_b] = True

    @staticmethod
    def _seg_excl_cumsum(vals: np.ndarray, seg: np.ndarray, n: int):
        """Exclusive cumsum of vals restarting at each segment (seg ids
        are non-decreasing)."""
        c = np.cumsum(vals)
        excl = c - vals
        if excl.shape[0] == 0:
            return excl
        first = np.ones(seg.shape[0], bool)
        first[1:] = seg[1:] != seg[:-1]
        base = np.repeat(excl[first], np.diff(
            np.concatenate([np.nonzero(first)[0], [seg.shape[0]]])))
        return excl - base

    def _flat_ops(self, cigar, n: int):
        """Flattened CIGAR op table — the vectorized replacement for the
        per-template walks (reference src/sam_cigar.c per-line parse):
        EVERY row's ops live in flat arrays, so seg/recon/MD-NM walks are
        O(total bases) vectorized passes with no per-unique-CIGAR python —
        the structure long-read BAMs need (most templates unique there).
        Returns a dict with letters/oplen/oprow/opidx (per op, (row, op)
        ordered), roff/goff (read/ref offsets before each op within its
        row), row_ok (structurally valid with >=1 match op),
        read_len/ref_len."""
        from ..seg import TOK_MARK, tokenize_col
        tmpl_data, tmpl_lens, vals, _tok, _w = tokenize_col(
            cigar.data, cigar.offsets, 1 << 30)
        toff = np.concatenate([[0], np.cumsum(tmpl_lens)])
        data = tmpl_data
        brow = np.repeat(ragged.arange(n), tmpl_lens)
        pos_in = ragged.arange(data.shape[0]) - toff[:-1][brow]
        ismark = data == TOK_MARK
        k_row = np.bincount(brow[ismark], minlength=n)
        row_ok = (tmpl_lens == 2 * k_row) & (k_row > 0)
        even = (pos_in & 1) == 0
        okb = np.where(even, ismark, self._ALLOP_LUT[data])
        np.logical_and.at(row_ok, brow, okb)
        has_m = np.zeros(n, bool)
        mb = self._MATCH_LUT[data] & ~even
        has_m[brow[mb]] = True
        row_ok &= has_m
        markpos = np.nonzero(ismark)[0]
        dmax = max(data.shape[0] - 1, 0)
        letters = data[np.minimum(markpos + 1, dmax)] if data.shape[0] \
            else np.zeros(0, np.uint8)
        oprow = brow[markpos]
        keep = row_ok[oprow]
        letters = letters[keep]
        oplen = vals[keep].astype(np.int64)
        oprow = oprow[keep]
        kpr = np.bincount(oprow, minlength=n)
        opidx = ragged.arange(oprow.shape[0]) - np.concatenate(
            [[0], np.cumsum(kpr)])[:-1][oprow]
        cr = oplen * self._READ_LUT[letters]
        cf = oplen * self._REF_LUT[letters]
        return {
            "letters": letters, "oplen": oplen, "oprow": oprow,
            "opidx": opidx,
            "roff": self._seg_excl_cumsum(cr, oprow, n),
            "goff": self._seg_excl_cumsum(cf, oprow, n),
            "row_ok": row_ok,
            "read_len": np.bincount(oprow, weights=cr,
                                    minlength=n).astype(np.int64),
            "ref_len": np.bincount(oprow, weights=cf,
                                   minlength=n).astype(np.int64),
        }

    @staticmethod
    def _expand_ops(sel: np.ndarray, oplen: np.ndarray):
        """Per-byte expansion of the selected ops: (flat op-id per byte,
        within-op offset per byte)."""
        L = oplen[sel]
        tot = int(L.sum())
        opid = np.repeat(np.nonzero(sel)[0], L)
        within = ragged.arange(tot) - np.repeat(
            np.concatenate([[0], np.cumsum(L)])[:-1], L)
        return opid, within

    def _gbase_of(self, rname_col, ref):
        uw, inv = dedup_col(rname_col)
        base = np.full(len(uw), -1, dtype=np.int64)
        for w in range(len(uw)):
            c = ref.contig_of(uw.row(w).decode("utf-8", "replace"))
            if c is not None:
                base[w] = c["gpos"]
        return base[inv]

    def _seg_seq_vs_ref(self, ctxs, seq, rname, pos, cigar, ref):
        """CIGAR-driven SEQ-vs-reference diff (reference parity:
        src/sam_seq.c sam_seg_SEQ): general CIGARs grouped by template —
        M/=/X segments diff against the genome (sparse mismatch channels),
        I/S segments ride in NONREF, D/N skip reference. Ineligible rows
        (unmapped, '*', bad contig, length mismatch) stay verbatim in
        NONREF — correctness is never at stake, only ratio."""
        from ..ops import pack as packops

        n = len(seq)
        pv, pok = ragged.atoi(pos)
        gbase = self._gbase_of(rname, ref)
        seq_lens = seq.lens
        gpos0 = gbase + pv - 1
        G = ref.length

        # flat op table: every row's ops in one vectorized pass (no
        # per-unique-CIGAR python — long-read BAMs have unique templates)
        fo = self._flat_ops(cigar, n)
        by_ref = (fo["row_ok"] & pok & (gbase >= 0) & (pv > 0)
                  & (fo["read_len"] == seq_lens)
                  & (gpos0 >= 0) & (gpos0 + fo["ref_len"] <= G))
        if getattr(ref, "track_used", False):
            ref.mark_used(gpos0[by_ref], fo["ref_len"][by_ref])
        internal = getattr(ref, "internal", False) and by_ref.any()
        if internal and getattr(ref, "read_unset", None) is None:
            ref.read_unset = np.zeros(G, bool)
        # one pass in the host runtime (`_seq_diff_np` in numpy); for
        # REF_INTERNAL it marks the bases diffed while unset (fault F11)
        ins_sel = self._INS_LUT[fo["letters"]] & by_ref[fo["oprow"]]
        nonref_cap = int(seq_lens[~by_ref].sum()
                         + fo["oplen"][ins_sel].sum())
        mr, mp, mb, nonref = native.seq_diff(
            seq.data, seq.offsets, by_ref, gpos0, fo["letters"], fo["oplen"],
            fo["oprow"], fo["roff"], fo["goff"], ref.codes, self._MATCH_LUT,
            self._INS_LUT, packops.BASE2BIT, packops.IS_ACGT, nonref_cap,
            is_set=ref.is_set if internal else None,
            read_unset=ref.read_unset if internal else None)
        nm = np.bincount(mr, minlength=n)[by_ref]

        ctxs["SQBITMAP"] = VBCtx("SQBITMAP", MODE_NUM,
                                 local=by_ref.astype(np.int64), cat="int")
        ctxs["SEQNM"] = VBCtx("SEQNM", MODE_NUM, local=nm, cat="int")
        ctxs["SEQMISP"] = VBCtx("SEQMISP", MODE_NUM,
                                local=mp.astype(np.int64), cat="int")
        ctxs["SEQMISB"] = VBCtx("SEQMISB", MODE_TXT, local=mb, cat="text")
        ctxs["NONREF"] = VBCtx("NONREF", MODE_TXT, local=nonref, cat="seq")

    def _seq_diff_np(self, seq, by_ref, gpos0, fo, ref):
        """The diff of _seg_seq_vs_ref in numpy -> (mismatch rows,
        positions, bases, NONREF bytes); marks ref.read_unset as the host
        runtime does."""
        from ..ops import pack as packops
        n = len(seq)
        G = ref.length
        if by_ref.any():
            sel = self._MATCH_LUT[fo["letters"]] & by_ref[fo["oprow"]]
            opid, within = self._expand_ops(sel, fo["oplen"])
            brows = fo["oprow"][opid]
            spos = seq.offsets[:-1][brows] + fo["roff"][opid] + within
            gpos = gpos0[brows] + fo["goff"][opid] + within
            sbase = seq.data[spos]
            mmk = (ref.codes[gpos] != packops.BASE2BIT[sbase]) \
                | ~packops.IS_ACGT[sbase]
            if getattr(ref, "internal", False):
                # REF_INTERNAL: bases diffed while unset must stay as they
                # are (see _populate_internal_ref; fault F11)
                if getattr(ref, "read_unset", None) is None:
                    ref.read_unset = np.zeros(G, bool)
                ref.read_unset[gpos[~ref.is_set[gpos]]] = True
            # ops are (row, opidx)-ordered and bytes ascend within an op,
            # so mismatches are already sorted by (row, read position)
            mr = brows[mmk]
            mp = (fo["roff"][opid] + within)[mmk]
            mb = sbase[mmk]
        else:
            mr = np.zeros(0, np.int64)
            mp = np.zeros(0, np.int64)
            mb = np.zeros(0, np.uint8)
        # NONREF: whole seq for non-by-ref rows; I/S segments for by-ref rows
        return mr, mp, mb, self._nonref_stream(seq, by_ref, n, fo)

    def _nonref_stream(self, seq, by_ref, n, fo):
        """Row-order NONREF bytes: full seq (non-by-ref rows) or I/S segments
        in op order (by-ref rows) — a sorted piece list + one ragged gather."""
        MAXOPS = 1 << 20
        p_starts = [seq.offsets[:-1][~by_ref]]
        p_lens = [seq.lens[~by_ref]]
        p_keys = [np.nonzero(~by_ref)[0] * MAXOPS]
        if fo is not None:
            sel = self._INS_LUT[fo["letters"]] & by_ref[fo["oprow"]]
            if sel.any():
                rows_i = fo["oprow"][sel]
                p_starts.append(seq.offsets[:-1][rows_i] + fo["roff"][sel])
                p_lens.append(fo["oplen"][sel])
                p_keys.append(rows_i * MAXOPS + fo["opidx"][sel] + 1)
        starts = np.concatenate(p_starts)
        lens = np.concatenate(p_lens)
        keys = np.concatenate(p_keys)
        order = np.argsort(keys, kind="stable")
        col = ragged.gather_ranges(seq.data, starts[order], lens[order])
        return col.data

    # ------------------------------------------------------------------
    # per-tag AUX contexts + MD/NM prediction
    # ------------------------------------------------------------------

    def _predict_from_ctxs(self, by_ref, nm_counts, mis_pos, cigar_col,
                           pos_col, rname_col, ref):
        """Derive (nm_pred[n], md_pred Col[n], has_md bool[n]) from the
        *stored* mismatch channels, so ZIP and PIZ compute identical
        predictions (reference src/sam_md.c sam_md_analyze, src/sam_nm.c)."""
        n = by_ref.shape[0]
        mm_row = np.repeat(np.nonzero(by_ref)[0], nm_counts)
        mm_pos = np.asarray(mis_pos, dtype=np.int64)
        pv, _ = ragged.atoi(pos_col)
        gbase = self._gbase_of(rname_col, ref)
        gpos0 = gbase + pv - 1
        return self._md_nm_predict(cigar_col, n, by_ref, gpos0,
                                   mm_row, mm_pos, ref)

    def _md_nm_predict(self, cigar_col, n, by_ref, gpos0, mm_row, mm_pos,
                       ref):
        """Walk CIGAR groups once, producing per-row predicted NM:i (=
        mismatches + inserted + deleted bases) and predicted MD:Z (match-run
        lengths interleaved with ref bases at mismatches and ^-prefixed
        deleted ref bases). Rows outside eligible CIGAR groups get
        has_md=False (their MD stays literal)."""
        from ..ops import pack as packops

        nm_pred = np.zeros(n, np.int64)
        has_md = np.zeros(n, bool)
        total_match = np.zeros(n, np.int64)
        mm_cnt = np.bincount(mm_row, minlength=n)
        nm_pred += mm_cnt

        ev_row, ev_coord, ev_j = [], [], []
        ev_refstart, ev_reflen, ev_isdel = [], [], []

        fo = self._flat_ops(cigar_col, n)
        if fo is not None:
            has_md = by_ref & fo["row_ok"]
            letters, oplen, oprow = fo["letters"], fo["oplen"], fo["oprow"]
            # NM additions: inserted + deleted bases of has_md rows
            selID = ((letters == ord("I")) | (letters == ord("D"))) \
                & has_md[oprow]
            np.add.at(nm_pred, oprow[selID], oplen[selID])
            cm = oplen * self._MATCH_LUT[letters]
            mbefore = self._seg_excl_cumsum(cm, oprow, n)
            total_match = np.bincount(oprow, weights=cm,
                                      minlength=n).astype(np.int64)
            total_match[~has_md] = 0
            # mismatch events: locate each mismatch's containing match op
            # by a sorted-key search over (row, read-offset) op ranges
            msel = self._MATCH_LUT[letters] & has_md[oprow]
            mo = np.nonzero(msel)[0]
            if mo.shape[0] and mm_row.shape[0]:
                BIGP = np.int64(1) << 40
                key_ops = oprow[mo] * BIGP + fo["roff"][mo]
                j = np.searchsorted(key_ops, mm_row * BIGP + mm_pos,
                                    side="right") - 1
                op_g = mo[np.maximum(j, 0)]
                delta = mm_pos - fo["roff"][op_g]
                ev_row.append(mm_row)
                ev_coord.append(mbefore[op_g] + delta)
                ev_j.append(fo["opidx"][op_g])
                ev_refstart.append(gpos0[mm_row] + fo["goff"][op_g] + delta)
                ev_reflen.append(np.ones(mm_row.shape[0], np.int64))
                ev_isdel.append(np.zeros(mm_row.shape[0], bool))
            dsel = (letters == ord("D")) & has_md[oprow] & (oplen > 0)
            if dsel.any():
                dr = oprow[dsel]
                ev_row.append(dr)
                ev_coord.append(mbefore[dsel])
                ev_j.append(fo["opidx"][dsel])
                ev_refstart.append(gpos0[dr] + fo["goff"][dsel])
                ev_reflen.append(oplen[dsel])
                ev_isdel.append(np.ones(int(dsel.sum()), bool))

        if ev_row:
            er = np.concatenate(ev_row)
            ec = np.concatenate(ev_coord)
            ej = np.concatenate(ev_j)
            ers = np.concatenate(ev_refstart)
            erl = np.concatenate(ev_reflen)
            edl = np.concatenate(ev_isdel)
            order = np.lexsort((ej, ec, er))
            er, ec, ej = er[order], ec[order], ej[order]
            ers, erl, edl = ers[order], erl[order], edl[order]
        else:
            er = ec = ej = ers = erl = np.zeros(0, np.int64)
            edl = np.zeros(0, bool)

        # gaps between events: gap_i = coord_i - consumed_after_{i-1}
        consumed_after = ec + (~edl)
        first = np.ones(er.shape[0], bool)
        if er.shape[0] > 1:
            first[1:] = er[1:] != er[:-1]
        prev = np.concatenate([[0], consumed_after[:-1]])
        gaps = ec - np.where(first, 0, prev)
        # trailing number per md row
        ecnt = np.bincount(er, minlength=n) if er.shape[0] else np.zeros(n, np.int64)
        last_consumed = np.zeros(n, np.int64)
        if er.shape[0]:
            last_idx = np.concatenate([[0], np.cumsum(ecnt)])[1:][ecnt > 0] - 1
            last_consumed[ecnt > 0] = consumed_after[last_idx]
        trailing = total_match - last_consumed

        # payload bytes: '^'+bases for deletions, 1 base for mismatches
        pay_lens = erl + edl
        pay_off = np.concatenate([[0], np.cumsum(pay_lens)])
        pay = np.empty(int(pay_off[-1]), np.uint8)
        pay[pay_off[:-1][edl]] = ord("^")
        letters = ragged.gather_ranges(ref.codes, ers, erl)
        # scatter letters after the optional '^'
        if letters.data.shape[0]:
            dst = np.repeat(pay_off[:-1] + edl, erl) + (
                ragged.arange(int(erl.sum()))
                - np.repeat(np.concatenate([[0], np.cumsum(erl)])[:-1], erl))
            pay[dst] = packops.ACGT[letters.data]
        pay_col = Col(pay, pay_off)

        # number pieces: per md row, [gap_0..gap_{c-1}, trailing]
        md_rows = np.nonzero(has_md)[0]
        c_r = ecnt[md_rows]
        num_per_row = c_r + 1
        ntot = int(num_per_row.sum())
        num_vals = np.empty(ntot, np.int64)
        row_num_start = np.concatenate([[0], np.cumsum(num_per_row)])
        slot_of_row = np.full(n, -1, np.int64)
        slot_of_row[md_rows] = ragged.arange(md_rows.shape[0])
        # events are sorted by row => within-row index by subtracting starts
        if er.shape[0]:
            ev_within = ragged.arange(er.shape[0]) - np.concatenate(
                [[0], np.cumsum(ecnt)])[er]
            num_vals[row_num_start[:-1][slot_of_row[er]] + ev_within] = gaps
        num_vals[row_num_start[1:] - 1] = trailing[md_rows]
        num_col = ragged.itoa(num_vals)

        # piece interleave: numbers at key 2*i, payloads at key 2*i+1
        if er.shape[0]:
            num_key = np.empty(ntot, np.int64)
            nwithin = ragged.arange(ntot) - np.repeat(
                row_num_start[:-1], num_per_row)
            num_key[:] = (np.repeat(md_rows, num_per_row) << 24) | (nwithin << 1)
            pay_key = (er << 24) | (ev_within << 1) | 1
            all_data = np.concatenate([num_col.data, pay_col.data])
            all_off = np.concatenate(
                [num_col.offsets[:-1], pay_col.offsets[:-1] + num_col.data.shape[0]])
            all_lens = np.concatenate([num_col.lens, pay_col.lens])
            keys = np.concatenate([num_key, pay_key])
            perm = np.argsort(keys, kind="stable")
            pieces = ragged.gather_ranges(all_data, all_off[perm], all_lens[perm])
            piece_row = (keys[perm] >> 24)
            row_lens = np.bincount(piece_row, weights=pieces.lens,
                                   minlength=n).astype(np.int64)
            md_col = Col(pieces.data,
                         np.concatenate([[0], np.cumsum(row_lens)]))
        else:
            row_lens = np.zeros(n, np.int64)
            row_lens[md_rows] = num_col.lens
            md_col = Col(num_col.data,
                         np.concatenate([[0], np.cumsum(row_lens)]))
        return nm_pred, md_col, has_md

    _ALNUM = np.zeros(256, bool)
    _ALNUM[ord("0"):ord("9") + 1] = True
    _ALNUM[ord("A"):ord("Z") + 1] = True
    _ALNUM[ord("a"):ord("z") + 1] = True

    def _aux_fields(self, aux):
        """Split the raw AUX remainder into per-field (start, end, row)
        arrays + per-row regularity. A regular row is (\\t TG:t:VALUE)* with
        alnum tag/type bytes; irregular rows go verbatim to AUXEXC."""
        n = len(aux)
        data = aux.data
        tp = np.nonzero(data == ord("\t"))[0]
        k = tp.shape[0]
        frow = np.searchsorted(aux.offsets[1:], tp, side="right")
        fs = tp + 1
        if k:
            row_last = np.ones(k, bool)
            row_last[:-1] = frow[1:] != frow[:-1]
            fe = np.where(row_last, aux.offsets[1:][frow],
                          np.concatenate([tp[1:], [0]]))
        else:
            fe = np.zeros(0, np.int64)
        flen = fe - fs
        dmax = max(data.shape[0] - 1, 0)
        at = lambda p: data[np.minimum(p, dmax)] if data.shape[0] else np.zeros(k, np.uint8)
        fok = (flen >= 5) & (at(fs + 2) == ord(":")) & (at(fs + 4) == ord(":")) \
            & self._ALNUM[at(fs)] & self._ALNUM[at(fs + 1)] \
            & self._ALNUM[at(fs + 3)]
        row_ok = np.ones(n, bool)
        np.logical_and.at(row_ok, frow, fok)
        # non-empty rows must start with '\t' and contain at least one tab
        lens = aux.lens
        nonempty = lens > 0
        starts = np.minimum(aux.offsets[:-1], dmax)
        if data.shape[0]:
            row_ok &= ~nonempty | (data[starts] == ord("\t"))
        has_tab = np.zeros(n, bool)
        has_tab[frow] = True
        row_ok &= ~nonempty | has_tab
        return fs, fe, frow, row_ok

    @staticmethod
    def _tag_name(b0, b1, b3):
        return "AX" + chr(b0) + chr(b1) + chr(b3)

    @staticmethod
    def mate_rows(qname, pos_txt, pnext_txt):
        """Per-row index of the MATE row within the VB (-1 if absent):
        mate of i = first row j with the same QNAME and POS_j == PNEXT_i
        (reference mate-copy snips, sam_seg.c:27-60). Vectorized: lexsort
        by (qname hash, pos) + searchsorted for (hash, pnext). Recomputed
        identically at PIZ from reconstructed columns; predictions are
        verified with per-row fit bitmaps, so hash collisions can only
        cost ratio."""
        from .. import sag as sag_mod
        h = sag_mod.qname_hash(qname)
        pv, pok = ragged.atoi(pos_txt)
        nv, nok = ragged.atoi(pnext_txt)
        n = h.shape[0]
        if n == 0 or not (pok.all() and nok.all()):
            return np.full(n, -1, np.int64)
        order = np.lexsort((pv, h))
        hs, ps = h[order], pv[order]
        want_h, want_p = h, nv
        lo = np.searchsorted(hs, want_h, side="left")
        # within the hash run, find pos == pnext
        idx = np.full(n, -1, np.int64)
        # bounded linear probe (hash runs are tiny); 4 steps cover pairs +
        # a few same-qname supplementaries
        self_i = np.arange(n)
        for k in range(4):
            cand = np.clip(lo + k, 0, n - 1)
            crow = order[cand]
            hit = (idx < 0) & (hs[cand] == want_h) & (ps[cand] == want_p) \
                & (crow != self_i)
            idx = np.where(hit, crow, idx)
        return idx

    @staticmethod
    def _hp_run_structure(seq_rows):
        """Per-row homopolymer run structure of a seq Col: returns
        (run_lens flat int64, runs_per_row int64) — runs never cross rows.
        Identical at ZIP and PIZ (recomputed from reconstructed SEQ)."""
        data, lens = seq_rows.data, seq_rows.lens
        total = data.shape[0]
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(len(seq_rows), np.int64)
        row = np.repeat(np.arange(len(seq_rows), dtype=np.int64), lens)
        start = np.zeros(total, bool)
        start[seq_rows.offsets[:-1][lens > 0]] = True
        change = np.ones(total, bool)
        change[1:] = data[1:] != data[:-1]
        change |= start
        starts = np.nonzero(change)[0]
        run_lens = np.diff(np.concatenate([starts, [total]]))
        runs_per_row = np.bincount(row[starts], minlength=len(seq_rows))
        return run_lens.astype(np.int64), runs_per_row.astype(np.int64)

    @staticmethod
    def _sa_field_preds(sag, sag_idx, flags_v):
        """Per-row predicted RNAME/POS/MAPQ/CIGAR for supplementary rows
        with a store hit whose primary carries a parsed SA first entry.
        Pure function of (store, sag_idx, flags) — identical at PIZ."""
        if sag is None or getattr(sag, "sa1_rname", None) is None:
            return None
        hit = (sag_idx >= 0) & ((flags_v & 0x800) != 0)
        if not hit.any():
            return None
        sidx = np.where(hit, sag_idx, 0)
        valid = hit & sag.sa1_valid[sidx]
        if not valid.any():
            return None
        return {"valid": valid,
                "rname": ragged.take(sag.sa1_rname, sidx),
                "pos": sag.sa1_pos[sidx],
                "mapq": sag.sa1_mapq[sidx],
                "cigar": ragged.take(sag.sa1_cigar, sidx)}

    def _sa_pred_col(self, sag_idx, n):
        """Per-row predicted SA:Z leading entry (primary's composed
        'rname,pos,strand,cigar,mapq,nm;'), empty rows where no SAG hit.
        Identical at ZIP and PIZ (both rebuild the store from PRIM text)."""
        sag = getattr(self, "sag_store", None)
        if sag_idx is None or sag is None or sag.rname is None:
            return None
        hit = np.nonzero(sag_idx >= 0)[0]
        if hit.shape[0] == 0:
            return None
        entries = sag.sa_entries(sag_idx[hit])
        return ragged.merge_rows(n, [(hit, entries)])

    def _sag_solo_pred(self, sag_idx, n):
        """Per-tag predicted barcode values from the primary's store row
        (SAG_BY_SOLO, sections.h:32 + sam_sag_zip.c:877 solo_data): DEPN
        rows of a solo-class file repeat their primary's CB/CR/UB/UR/BX/RX
        values — elide them by store copy."""
        sag = getattr(self, "sag_store", None)
        if sag_idx is None or sag is None or not getattr(sag, "solo", None):
            return None
        hit = np.nonzero(sag_idx >= 0)[0]
        if hit.shape[0] == 0:
            return None
        out = {}
        for tag, col in sag.solo.items():
            out[tag] = ragged.merge_rows(
                n, [(hit, ragged.take(col, sag_idx[hit]))])
        return out

    def _sag_nh_pred(self, sag_idx, n):
        """Per-row NH:i prediction = the primary's NH (SAG_BY_NH role);
        0 where no hit or the store has no NH."""
        sag = getattr(self, "sag_store", None)
        nh = getattr(sag, "nh", None) if sag is not None else None
        if sag_idx is None or nh is None:
            return None
        pred = np.zeros(n, np.int64)
        hit = sag_idx >= 0
        pv = nh[np.maximum(sag_idx, 0)]
        pred[hit] = np.where(pv[hit] > 0, pv[hit], 0)
        return pred if (pred != 0).any() else None

    def _sag_cp_pred(self, sag_idx, n):
        """CP:i prediction = the primary's POS (SAG_BY_CC flavor,
        reference sections.h:32: CC/CP point back into the group chain —
        exact for two-element chains, residual otherwise)."""
        sag = getattr(self, "sag_store", None)
        if sag_idx is None or sag is None or sag.pos is None:
            return None
        pred = np.zeros(n, np.int64)
        hit = sag_idx >= 0
        pred[hit] = sag.pos[np.maximum(sag_idx, 0)][hit]
        return pred if (pred != 0).any() else None

    def _sag_cc_pred_col(self, sag_idx, n):
        """CC:Z prediction column = the primary's RNAME (SAG_BY_CC)."""
        sag = getattr(self, "sag_store", None)
        if sag_idx is None or sag is None or sag.rname is None:
            return None
        hit = np.nonzero(sag_idx >= 0)[0]
        if hit.shape[0] == 0:
            return None
        return ragged.merge_rows(
            n, [(hit, ragged.take(sag.rname, sag_idx[hit]))])

    def _seg_aux(self, ctxs, aux, predict=None, qual=None, seq=None,
                 cigar=None, mate=None, pos_v=None, sa_pred=None,
                 nh_pred=None, cc_pred=None, cp_pred=None, solo_pred=None):
        """Per-tag AUX contexts (reference src/sam_fields.c: one context per
        aux tag keyed by DictId). Layout word per row = concatenated 4-byte
        'TG:t' prefixes (AUXL dict); per tag one value context AX<TG><t>.
        With `predict` (from the SEQ-vs-ref walk): NM:i stored as
        delta-vs-predicted (param=4, reference src/sam_nm.c) and MD:Z as an
        OK bitmap + literal exceptions (reference src/sam_md.c). With
        `qual`: OQ:Z stored as byte-delta vs QUAL (src/codec_oq.c role);
        with `seq`: T0:Z condensed to one byte per SEQ homopolymer run
        (src/codec_t0.c role — run structure recomputed at PIZ)."""
        n = len(aux)
        data = aux.data
        fs, fe, frow, row_ok = self._aux_fields(aux)
        sel = row_ok[frow]
        fs_s, fe_s, frow_s = fs[sel], fe[sel], frow[sel]
        F = fs_s.shape[0]

        # layout column
        nf = np.bincount(frow_s, minlength=n)
        llens = np.where(row_ok, 4 * nf, 1)
        loff = np.concatenate([[0], np.cumsum(llens)])
        ldata = np.empty(int(loff[-1]), np.uint8)
        bad_rows = np.nonzero(~row_ok)[0]
        ldata[loff[:-1][bad_rows]] = 0
        if F:
            fidx = ragged.arange(F) - np.concatenate(
                [[0], np.cumsum(nf)])[:-1][frow_s]
            pdst = loff[:-1][frow_s] + 4 * fidx
            for b in range(4):
                ldata[pdst + b] = data[fs_s + b]
        uw, inv = dedup_col(Col(ldata, loff))
        ctxs["AUXL"] = VBCtx("AUXL", MODE_DICT, b250=inv, vb_words=uw,
                             cat="b250")
        if bad_rows.shape[0]:
            uwx, invx = dedup_col(ragged.take(aux, bad_rows))
            ctxs["AUXEXC"] = VBCtx("AUXEXC", MODE_DICT, b250=invx,
                                   vb_words=uwx, cat="text")
        if F == 0:
            return

        key = (data[fs_s].astype(np.uint32) << 16) \
            | (data[fs_s + 1].astype(np.uint32) << 8) \
            | data[fs_s + 3].astype(np.uint32)
        nm_pred = md_col = has_md = None
        if predict is not None:
            nm_pred, md_col, has_md = predict
        from . import sam_tags
        as_by_row = None        # AS:i values scattered by VB row (param=6)
        cb_col = ub_col = None  # CB:Z / UB:Z values by VB row
        for t in np.unique(key):
            idx = np.nonzero(key == t)[0]
            b0, b1, b3 = (int(t) >> 16) & 0xFF, (int(t) >> 8) & 0xFF, int(t) & 0xFF
            name = self._tag_name(b0, b1, b3)
            vals = ragged.gather_ranges(data, fs_s[idx] + 5,
                                        fe_s[idx] - fs_s[idx] - 5)
            rows_t = frow_s[idx]
            tag2 = bytes([b0, b1])
            if b3 == ord("i"):
                iv, iok = ragged.atoi(vals)
                if iok.all():
                    if nh_pred is not None and tag2 == b"NH":
                        # DEPN NH copies the primary's (SAG_BY_NH)
                        ctxs[name] = VBCtx(name, MODE_NUM,
                                           local=iv - nh_pred[rows_t],
                                           cat="int", param=11)
                    elif cp_pred is not None and tag2 == b"CP":
                        # CP:i vs the primary's POS (SAG_BY_CC)
                        ctxs[name] = VBCtx(name, MODE_NUM,
                                           local=iv - cp_pred[rows_t],
                                           cat="int", param=12)
                    elif nm_pred is not None and (b0, b1) == (ord("N"), ord("M")):
                        ctxs[name] = VBCtx(name, MODE_NUM,
                                           local=iv - nm_pred[rows_t],
                                           cat="int", param=4)
                    elif tag2 == b"AS" and seq is not None:
                        # score model per VB: BWA-class AS ~ read length
                        # (src/sam_bwa.c) vs bowtie2/hisat2-class AS <= 0
                        # near zero (src/sam_bowtie2.c) — pick the smaller
                        # residual
                        d = iv - seq.lens[rows_t]
                        if np.abs(d).sum() <= np.abs(iv).sum():
                            ctxs[name] = VBCtx(
                                name, MODE_NUM, local=d, cat="int",
                                param=sam_tags.PARAM_AS_VS_SEQLEN)
                        else:
                            ctxs[name] = VBCtx(name, MODE_NUM, local=iv,
                                               cat="int")
                        as_by_row = np.zeros(n, np.int64)
                        as_by_row[rows_t] = iv
                    elif tag2 in sam_tags.AS_DELTA_TAGS and \
                            as_by_row is not None:
                        # sub-optimal scores track AS (sam_bwa/minimap2/
                        # hisat2 ZS)
                        ctxs[name] = VBCtx(
                            name, MODE_NUM, local=iv - as_by_row[rows_t],
                            cat="int", param=sam_tags.PARAM_VS_AS)
                    elif tag2 == b"YS" and as_by_row is not None and \
                            mate is not None:
                        # bowtie2/hisat2 YS:i = mate's AS
                        # (src/sam_bowtie2.c mate-score)
                        midx = mate[rows_t]
                        base = np.where(midx >= 0,
                                        as_by_row[np.maximum(midx, 0)], 0)
                        ctxs[name] = VBCtx(
                            name, MODE_NUM, local=iv - base, cat="int",
                            param=sam_tags.PARAM_VS_MATE_AS)
                    else:
                        d = np.diff(iv, prepend=np.int64(0))
                        if iv.shape[0] > 4 and (d[1:] >= 0).mean() > 0.9:
                            ctxs[name] = VBCtx(name, MODE_NUM, local=d,
                                               cat="int", param=1)
                        else:
                            ctxs[name] = VBCtx(name, MODE_NUM, local=iv,
                                               cat="int", param=0)
                    continue
            if b3 == ord("Z"):
                # mapper/platform-specific Z-tag predictors (sam_tags.py)
                handled = None
                if tag2 == b"SA" and sa_pred is not None:
                    handled = sam_tags.sa_pred_seg(name, vals, sa_pred,
                                                   rows_t)
                elif tag2 == b"CC" and cc_pred is not None:
                    # CC:Z vs the primary's RNAME (SAG_BY_CC): exact for
                    # two-element chains, prefix-bitmap residual otherwise
                    handled = sam_tags.sa_pred_seg(name, vals, cc_pred,
                                                   rows_t)
                elif tag2 == b"XA" and pos_v is not None:
                    handled = sam_tags.xa_seg(name, vals, pos_v, rows_t)
                elif tag2 == b"CR" and cb_col is not None:
                    handled = sam_tags.barcode_pred_seg(name, vals, cb_col,
                                                        rows_t)
                elif tag2 == b"UR" and ub_col is not None:
                    handled = sam_tags.barcode_pred_seg(name, vals, ub_col,
                                                        rows_t)
                elif tag2 == b"XM" and seq is not None:
                    handled = sam_tags.seqlen_str_seg(name, vals, seq,
                                                      rows_t)
                elif solo_pred is not None and tag2 in solo_pred:
                    # SAG_BY_SOLO: barcode equals the primary's (store copy)
                    pred = ragged.take(solo_pred[tag2], rows_t)
                    eq = (pred.lens > 0) & ragged.rows_equal(vals, pred)
                    if eq.mean() > 0.5:
                        handled = {name + "G": VBCtx(
                            name + "G", MODE_NUM, local=eq.astype(np.int64),
                            cat="int")}
                        if (~eq).any():
                            handled.update(tokenizer_seg_col(
                                name + "X",
                                ragged.take(vals, np.nonzero(~eq)[0]),
                                single_stream=True))
                if handled is None and tag2 in sam_tags.QUAL_Z_TAGS:
                    handled = sam_tags.qualstr_seg(name, vals)
                elif handled is None and tag2 in sam_tags.DICT_Z_TAGS:
                    handled = sam_tags.dict_seg(name, vals)
                    if tag2 == b"CB":
                        cb_col = ragged.merge_rows(n, [(rows_t, vals)])
                    elif tag2 == b"UB":
                        ub_col = ragged.merge_rows(n, [(rows_t, vals)])
                if handled is not None:
                    ctxs.update(handled)
                    continue
            if b3 == ord("B"):
                # numeric array tags (Ultima tp:B:c, ONT ML:B:C —
                # src/sam_ultima.c / array handling in src/sam_fields.c)
                handled = sam_tags.barr_seg(name, vals)
                if handled is not None:
                    ctxs.update(handled)
                    continue
            if b3 == ord("f"):
                # float tags (PacBio rq/ec, minimap2 de —
                # src/sam_pacbio.c / seg_float role)
                handled = sam_tags.float_seg(name, vals)
                if handled is not None:
                    ctxs.update(handled)
                    continue
            if cigar is not None and mate is not None and \
                    (b0, b1, b3) == (ord("M"), ord("C"), ord("Z")):
                # MC:Z = mate's CIGAR (reference mate-copy snips,
                # sam_seg.c:27-60): per-row fit bitmap + exceptions
                midx = mate[rows_t]
                pred = ragged.take(cigar, np.maximum(midx, 0))
                eq = (midx >= 0) & (vals.lens == pred.lens)
                if eq.any():
                    a = ragged.take(vals, np.nonzero(eq)[0])
                    b = ragged.take(pred, np.nonzero(eq)[0])
                    neq = np.nonzero(a.data != b.data)[0]
                    if neq.shape[0]:
                        bad = np.unique(np.searchsorted(
                            a.offsets[1:], neq, side="right"))
                        ei = np.nonzero(eq)[0]
                        eq[ei[bad]] = False
                if eq.mean() > 0.5:
                    ctxs[name + "M"] = VBCtx(name + "M", MODE_NUM,
                                             local=eq.astype(np.int64),
                                             cat="int")
                    if (~eq).any():
                        exc = ragged.take(vals, np.nonzero(~eq)[0])
                        ctxs.update(tokenizer_seg_col(name + "X", exc,
                                                      single_stream=True))
                    continue
            if qual is not None and (b0, b1, b3) == (ord("O"), ord("Q"),
                                                     ord("Z")):
                # OQ:Z = original (pre-BQSR) quals: byte-delta vs QUAL
                # (src/codec_oq.c role); per-row fit bitmap, literal misfits
                pred = ragged.take(qual, rows_t)
                fit = vals.lens == pred.lens
                if fit.mean() > 0.5:
                    ctxs[name + "Q"] = VBCtx(name + "Q", MODE_NUM,
                                             local=fit.astype(np.int64),
                                             cat="int")
                    a = ragged.take(vals, np.nonzero(fit)[0])
                    b = ragged.take(pred, np.nonzero(fit)[0])
                    # per-quality channel demux (src/codec_oq.c:14-20, the
                    # 94 per-quality contexts): group the delta bytes by
                    # their QUAL byte — BQSR's recalibration table makes
                    # OQ near-deterministic within a channel. Permutation
                    # recomputed from the reconstructed QUAL at PIZ.
                    perm = np.argsort(b.data, kind="stable")
                    ctxs[name] = VBCtx(name, MODE_TXT,
                                       local=(a.data - b.data)[perm],
                                       cat="qual", param=13)
                    if (~fit).any():
                        exc = ragged.take(vals, np.nonzero(~fit)[0])
                        ctxs.update(tokenizer_seg_col(name + "X", exc,
                                                      single_stream=True))
                    continue
            if seq is not None and (b0, b1, b3) == (ord("t"), ord("0"),
                                                    ord("Z")):
                # T0:Z constant within SEQ homopolymer runs: one byte per
                # run (src/codec_t0.c role); per-row fit bitmap
                seq_t = ragged.take(seq, rows_t)
                run_lens, runs_per_row = self._hp_run_structure(seq_t)
                fit = vals.lens == seq_t.lens
                if fit.any():
                    first = np.concatenate(
                        [[0], np.cumsum(run_lens)])[:-1]
                    # map run firsts into vals coordinates per fit row,
                    # then verify repeat(first-bytes) reproduces vals
                    vo = vals.offsets[:-1]
                    so = seq_t.offsets[:-1]
                    # byte i of row r: vals byte at vo[r]+ (pos in row)
                    # run first byte position within row = first - so[row]
                    run_row = np.repeat(np.arange(len(seq_t)),
                                        runs_per_row)
                    fpos = first - so[run_row]
                    cond_bytes = np.zeros(run_lens.shape[0], np.uint8)
                    okrun = fit[run_row]
                    cond_bytes[okrun] = vals.data[
                        (vo[run_row] + fpos)[okrun]]
                    rebuilt = np.repeat(cond_bytes, run_lens)
                    # compare only bytes of fit rows
                    byte_row = np.repeat(np.arange(len(seq_t)), seq_t.lens)
                    bm = fit[byte_row]
                    vb_bytes = np.zeros(seq_t.data.shape[0], np.uint8)
                    pos_in = np.arange(seq_t.data.shape[0]) - so[byte_row]
                    vb_bytes[bm] = vals.data[(vo[byte_row] + pos_in)[bm]]
                    mism = np.zeros(len(seq_t), bool)
                    bad_b = bm & (rebuilt != vb_bytes)
                    mism[byte_row[bad_b]] = True
                    expanded_ok = fit & ~mism
                    if expanded_ok.mean() > 0.5:
                        ctxs[name + "H"] = VBCtx(name + "H", MODE_NUM,
                                                 local=expanded_ok.astype(np.int64),
                                                 cat="int")
                        keep_runs = expanded_ok[run_row]
                        # HP-context demux (src/codec_t0.c role refined):
                        # group condensed bytes by (run length, base) —
                        # flow-signal T0 tracks the homopolymer context;
                        # channel recomputed from reconstructed SEQ at PIZ
                        from ..codecs.qual import _BASE5
                        kb = cond_bytes[keep_runs]
                        kkey = (np.minimum(run_lens, 7) * 5
                                + _BASE5[seq_t.data[np.minimum(
                                    first, max(seq_t.data.shape[0] - 1, 0))]]
                                )[keep_runs].astype(np.int16)
                        kperm = np.argsort(kkey, kind="stable")
                        ctxs[name] = VBCtx(name, MODE_TXT,
                                           local=kb[kperm],
                                           cat="qual", param=14)
                        if (~expanded_ok).any():
                            exc = ragged.take(vals,
                                              np.nonzero(~expanded_ok)[0])
                            ctxs.update(tokenizer_seg_col(
                                name + "X", exc, single_stream=True))
                        continue
            if md_col is not None and (b0, b1, b3) == (ord("M"), ord("D"),
                                                       ord("Z")):
                pred_vals = ragged.take(md_col, rows_t)
                eq = (vals.lens == pred_vals.lens) & has_md[rows_t]
                if eq.any():
                    a = ragged.take(vals, np.nonzero(eq)[0])
                    b = ragged.take(pred_vals, np.nonzero(eq)[0])
                    neq_rows = np.unique(np.searchsorted(
                        a.offsets[1:], np.nonzero(a.data != b.data)[0],
                        side="right"))
                    if neq_rows.shape[0]:
                        eq_idx = np.nonzero(eq)[0]
                        eq[eq_idx[neq_rows]] = False
                ctxs[name + "K"] = VBCtx(name + "K", MODE_NUM,
                                         local=eq.astype(np.int64), cat="int")
                if (~eq).any():
                    exc = ragged.take(vals, np.nonzero(~eq)[0])
                    ctxs.update(tokenizer_seg_col(name, exc,
                                                  single_stream=True))
                continue
            ctxs.update(tokenizer_seg_col(name, vals, single_stream=True))

    def _recon_aux(self, pctxs, n, predict=None, qual=None, seq=None,
                   cigar=None, mate=None, pos_v=None, sa_pred=None,
                   nh_pred=None, cc_pred=None, cp_pred=None,
                   solo_pred=None):
        """Rebuild the AUX remainder (leading-\\t convention) from AUXL
        layout + per-tag contexts."""
        layout = pctxs["AUXL"].dict_take()
        ld = layout.data
        llen = layout.lens
        bad = llen == 1
        nf = np.where(bad, 0, llen // 4)
        F = int(nf.sum())
        field_row = np.repeat(ragged.arange(n), nf)
        nm_pred = md_col = has_md = None
        if predict is not None:
            nm_pred, md_col, has_md = predict
        if F:
            fidx = ragged.arange(F) - np.concatenate(
                [[0], np.cumsum(nf)])[:-1][field_row]
            pstart = layout.offsets[:-1][field_row] + 4 * fidx
            key = (ld[pstart].astype(np.uint32) << 16) \
                | (ld[pstart + 1].astype(np.uint32) << 8) \
                | ld[pstart + 3].astype(np.uint32)
            parts = []
            from . import sam_tags
            as_by_row = None
            cb_col = ub_col = None
            for t in np.unique(key):
                idx = np.nonzero(key == t)[0]
                b0, b1, b3 = (int(t) >> 16) & 0xFF, (int(t) >> 8) & 0xFF, \
                    int(t) & 0xFF
                name = self._tag_name(b0, b1, b3)
                rows_t = field_row[idx]
                pc = pctxs.get(name)
                tag2 = bytes([b0, b1])
                if b3 == ord("Z"):
                    # mapper/platform-specific Z-tag predictors (sam_tags.py)
                    col_z = None
                    if tag2 == b"SA" and name + "P" in pctxs and \
                            sa_pred is not None:
                        col_z = sam_tags.sa_pred_recon(name, pctxs, sa_pred,
                                                       rows_t)
                    elif tag2 == b"CC" and name + "P" in pctxs and \
                            cc_pred is not None:
                        col_z = sam_tags.sa_pred_recon(name, pctxs, cc_pred,
                                                       rows_t)
                    elif tag2 == b"XA" and name + "F" in pctxs and \
                            pos_v is not None:
                        col_z = sam_tags.xa_recon(name, pctxs, pos_v, rows_t)
                    elif tag2 == b"CR" and name + "P" in pctxs and \
                            cb_col is not None:
                        col_z = sam_tags.barcode_pred_recon(name, pctxs,
                                                            cb_col, rows_t)
                    elif tag2 == b"UR" and name + "P" in pctxs and \
                            ub_col is not None:
                        col_z = sam_tags.barcode_pred_recon(name, pctxs,
                                                            ub_col, rows_t)
                    elif tag2 == b"XM" and name + "B" in pctxs and \
                            seq is not None:
                        col_z = sam_tags.seqlen_str_recon(name, pctxs, seq,
                                                          rows_t)
                    elif tag2 in sam_tags.QUAL_Z_TAGS and \
                            name + "L" in pctxs:
                        col_z = sam_tags.qualstr_recon(name, pctxs)
                    if col_z is None and solo_pred is not None and \
                            tag2 in solo_pred and name + "G" in pctxs:
                        # SAG_BY_SOLO: primary's barcode, store copy
                        eq = pctxs[name + "G"].nums().astype(bool)
                        pred = ragged.take(solo_pred[tag2], rows_t)
                        sub = [(np.nonzero(eq)[0],
                                ragged.take(pred, np.nonzero(eq)[0]))]
                        if (~eq).any():
                            exc = tokenizer_recon_col(name + "X", pctxs,
                                                      int((~eq).sum()))
                            sub.append((np.nonzero(~eq)[0], exc))
                        col_z = ragged.merge_rows(idx.shape[0], sub)
                    if col_z is not None:
                        parts.append((idx, col_z))
                        continue
                if b3 == ord("B") and name + "W" in pctxs and \
                        name + "V" in pctxs:
                    parts.append((idx, sam_tags.barr_recon(name, pctxs)))
                    continue
                if b3 == ord("f") and name + "W" in pctxs and \
                        name + "I" in pctxs:
                    parts.append((idx, sam_tags.float_recon(name, pctxs)))
                    continue
                if name + "M" in pctxs and cigar is not None and \
                        mate is not None:
                    # MC:Z from the mate's reconstructed CIGAR
                    eq = pctxs[name + "M"].nums().astype(bool)
                    midx = mate[rows_t]
                    pred = ragged.take(cigar, np.maximum(midx, 0))
                    sub = [(np.nonzero(eq)[0],
                            ragged.take(pred, np.nonzero(eq)[0]))]
                    if (~eq).any():
                        exc = tokenizer_recon_col(name + "X", pctxs,
                                                  int((~eq).sum()))
                        sub.append((np.nonzero(~eq)[0], exc))
                    parts.append((idx, ragged.merge_rows(idx.shape[0], sub)))
                    continue
                if name + "Q" in pctxs and qual is not None:
                    # OQ:Z byte-delta vs QUAL (src/codec_oq.c role)
                    fit = pctxs[name + "Q"].nums().astype(bool)
                    pred = ragged.take(qual, rows_t)
                    fl = np.where(fit, pred.lens, 0)
                    diff = Col(pc.local,
                               np.concatenate([[0], np.cumsum(fl)]))
                    a = ragged.take(pred, np.nonzero(fit)[0])
                    dd = pctxs[name].local
                    if pctxs[name].param == 13:   # per-quality demux
                        perm = np.argsort(a.data, kind="stable")
                        inv = np.empty_like(dd)
                        inv[perm] = dd
                        diff = Col(inv, diff.offsets)
                    d = ragged.take(diff, np.nonzero(fit)[0])
                    okcol = Col((a.data + d.data).astype(np.uint8), a.offsets)
                    sub = [(np.nonzero(fit)[0], okcol)]
                    if (~fit).any():
                        exc = tokenizer_recon_col(name + "X", pctxs,
                                                  int((~fit).sum()))
                        sub.append((np.nonzero(~fit)[0], exc))
                    parts.append((idx, ragged.merge_rows(idx.shape[0], sub)))
                    continue
                if name + "H" in pctxs and seq is not None:
                    # T0:Z expanded from one byte per SEQ homopolymer run
                    # (src/codec_t0.c role)
                    ok = pctxs[name + "H"].nums().astype(bool)
                    seq_t = ragged.take(seq, rows_t)
                    run_lens, runs_per_row = self._hp_run_structure(seq_t)
                    run_row = np.repeat(np.arange(len(seq_t)), runs_per_row)
                    keep = ok[run_row]
                    cond_bytes = np.zeros(run_lens.shape[0], np.uint8)
                    stored = pc.local[: int(keep.sum())]
                    if pc.param == 14:    # HP-context demux
                        from ..codecs.qual import _BASE5
                        first = np.concatenate(
                            [[0], np.cumsum(run_lens)])[:-1]
                        kkey = (np.minimum(run_lens, 7) * 5
                                + _BASE5[seq_t.data[np.minimum(
                                    first,
                                    max(seq_t.data.shape[0] - 1, 0))]]
                                )[keep].astype(np.int16)
                        kperm = np.argsort(kkey, kind="stable")
                        inv = np.empty_like(stored)
                        inv[kperm] = stored
                        stored = inv
                    cond_bytes[keep] = stored
                    rl = np.where(keep, run_lens, 0)
                    expanded = np.repeat(cond_bytes, rl)
                    row_lens = np.where(ok, seq_t.lens, 0)
                    okcol = Col(expanded,
                                np.concatenate([[0], np.cumsum(row_lens)]))
                    sub = [(np.nonzero(ok)[0],
                            ragged.take(okcol, np.nonzero(ok)[0]))]
                    if (~ok).any():
                        exc = tokenizer_recon_col(name + "X", pctxs,
                                                  int((~ok).sum()))
                        sub.append((np.nonzero(~ok)[0], exc))
                    parts.append((idx, ragged.merge_rows(idx.shape[0], sub)))
                    continue
                if name + "K" in pctxs:
                    okf = pctxs[name + "K"].nums().astype(bool)
                    pred_vals = ragged.take(md_col, rows_t)
                    exc_cnt = int((~okf).sum())
                    sub = [(np.nonzero(okf)[0],
                            ragged.take(pred_vals, np.nonzero(okf)[0]))]
                    if exc_cnt:
                        exc = tokenizer_recon_col(name, pctxs, exc_cnt)
                        sub.append((np.nonzero(~okf)[0], exc))
                    col = ragged.merge_rows(idx.shape[0], sub)
                elif pc is not None and pc.mode == MODE_NUM:
                    v = pc.nums()
                    if pc.param == 4:
                        v = pc.local.astype(np.int64) + nm_pred[rows_t]
                    elif pc.param == 11:      # NH copies the primary's
                        v = pc.local.astype(np.int64) + nh_pred[rows_t]
                    elif pc.param == 12:      # CP vs the primary's POS
                        v = pc.local.astype(np.int64) + cp_pred[rows_t]
                    elif pc.param == sam_tags.PARAM_AS_VS_SEQLEN:
                        v = pc.local.astype(np.int64) + seq.lens[rows_t]
                    elif pc.param == sam_tags.PARAM_VS_AS:
                        v = pc.local.astype(np.int64) + as_by_row[rows_t]
                    elif pc.param == sam_tags.PARAM_VS_MATE_AS:
                        midx = mate[rows_t]
                        base = np.where(midx >= 0,
                                        as_by_row[np.maximum(midx, 0)], 0)
                        v = pc.local.astype(np.int64) + base
                    if tag2 == b"AS":
                        # track AS for VS_AS / VS_MATE_AS consumers
                        # (tags iterate in sorted order: AS first)
                        as_by_row = np.zeros(n, np.int64)
                        as_by_row[rows_t] = v
                    col = ragged.itoa(v)
                else:
                    col = tokenizer_recon_col(name, pctxs, idx.shape[0])
                    if tag2 == b"CB":
                        cb_col = ragged.merge_rows(n, [(rows_t, col)])
                    elif tag2 == b"UB":
                        ub_col = ragged.merge_rows(n, [(rows_t, col)])
                parts.append((idx, col))
            val_col = ragged.merge_rows(F, parts)
            pref_col = ragged.gather_ranges(ld, pstart,
                                            np.full(F, 4, np.int64))
            zero = Col(np.zeros(0, np.uint8), np.zeros(F + 1, np.int64))
            fields = ragged.interleave([zero, pref_col, val_col],
                                       sep_after=[b"\t", b":", None])
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

    def _recon_seq_vs_ref(self, pctxs, lens, pos_col, rname_col, cigar_col):
        from ..ops import pack as packops

        ref = getattr(self, "ref", None)
        assert ref is not None, "archive needs --reference for unzip"
        by_ref = pctxs["SQBITMAP"].nums().astype(bool)
        n = by_ref.shape[0]
        pv, _ = ragged.atoi(pos_col)
        gbase = self._gbase_of(rname_col, ref)
        gpos0 = gbase + pv - 1
        nm = pctxs["SEQNM"].nums()
        mp = pctxs["SEQMISP"].nums()
        mb = pctxs["SEQMISB"].local
        nonref = pctxs["NONREF"].local

        # flat op table (same pass the ZIP side used; by_ref rows are
        # guaranteed structurally valid)
        fo = self._flat_ops(cigar_col, n)
        letters, oplen, oprow = fo["letters"], fo["oplen"], fo["oprow"]

        # per-row NONREF byte need: full row (non-by-ref) or I/S total
        ins_c = oplen * (self._INS_LUT[letters] & by_ref[oprow])
        need = np.where(~by_ref, lens,
                        np.bincount(oprow, weights=ins_c,
                                    minlength=n).astype(np.int64))
        nr_off = np.concatenate([[0], np.cumsum(need)])
        assert nr_off[-1] == nonref.shape[0], "NONREF stream length mismatch"

        out_off = np.concatenate([[0], np.cumsum(lens.astype(np.int64))])
        # one pass in the host runtime (`_seq_recon_np` in numpy)
        ins_before = self._seg_excl_cumsum(
            oplen * self._INS_LUT[letters], oprow, n)
        out = native.seq_recon(out_off, by_ref, gpos0, letters, oplen, oprow,
                               fo["roff"], fo["goff"], ins_before, ref.codes,
                               packops.ACGT, self._MATCH_LUT, self._INS_LUT,
                               nonref, nr_off)
        # apply all mismatch patches at once (row-major order by build)
        mm_row_of = np.repeat(np.nonzero(by_ref)[0], nm)
        out[out_off[:-1][mm_row_of] + mp] = mb
        return Col(out, out_off)

    def _seq_recon_np(self, fo, by_ref, lens, gpos0, out_off, nonref,
                      nr_off, ref):
        """The rebuild of _recon_seq_vs_ref before its mismatch patches, in
        numpy."""
        from ..ops import pack as packops
        G = ref.length
        letters, oplen, oprow = fo["letters"], fo["oplen"], fo["oprow"]
        n = by_ref.shape[0]
        out = np.zeros(int(out_off[-1]), dtype=np.uint8)

        # non-by-ref rows: one flat copy
        un = np.nonzero(~by_ref)[0]
        if un.shape[0]:
            # one pseudo-op per non-by-ref row
            opid, within = self._expand_ops(~by_ref,
                                            lens.astype(np.int64))
            rows_u = opid
            out[out_off[:-1][rows_u] + within] = \
                nonref[nr_off[rows_u] + within]

        # by-ref rows: match bytes from genome, I/S bytes from NONREF
        msel = self._MATCH_LUT[letters] & by_ref[oprow]
        if msel.any():
            opid, within = self._expand_ops(msel, oplen)
            rows_m = oprow[opid]
            dst = out_off[:-1][rows_m] + fo["roff"][opid] + within
            gsrc = np.clip(gpos0[rows_m] + fo["goff"][opid] + within, 0,
                           max(G - 1, 0))
            out[dst] = packops.ACGT[ref.codes[gsrc]]
        isel = self._INS_LUT[letters] & by_ref[oprow]
        if isel.any():
            # NONREF cursor before each I/S op = row base + prior I/S
            ins_before = self._seg_excl_cumsum(
                oplen * self._INS_LUT[letters], oprow, n)
            opid, within = self._expand_ops(isel, oplen)
            rows_i = oprow[opid]
            dst = out_off[:-1][rows_i] + fo["roff"][opid] + within
            src = nr_off[rows_i] + ins_before[opid] + within
            out[dst] = nonref[src]
        return out

    def recon_vb(self, pctxs: dict, meta: dict) -> bytes:
        n = meta["num_lines"]
        gd = pctxs["VARIANT"].nums()
        good_idx = np.nonzero(gd == 0)[0]
        bad_idx = np.nonzero(gd == 1)[0]
        ng = good_idx.shape[0]

        if ng:
            sag_idx = None
            if "SAGIDX" in pctxs:
                sag = getattr(self, "sag_store", None)
                assert sag is not None, "DEPN VB needs the SAG store"
                sag_idx = pctxs["SAGIDX"].nums()
                miss = np.nonzero(sag_idx < 0)[0]
                hit = np.nonzero(sag_idx >= 0)[0]
                qname = ragged.merge_rows(ng, [
                    (miss, tokenizer_recon_col("QNAME", pctxs, miss.shape[0])),
                    (hit, ragged.take(sag.qname, sag_idx[hit]))])
            else:
                qname = tokenizer_recon_col("QNAME", pctxs, ng)
            flag = _recon_num_or_tok("FLAG", pctxs, ng)
            if "SAGF" in pctxs:
                # invert the SA-first-entry field elision: non-predicted
                # subsets come from the contexts, predicted rows from the
                # store (rebuilt identically at PIZ)
                sagf = pctxs["SAGF"].nums()
                flags_v0, _ = ragged.atoi(flag)
                saf = self._sa_field_preds(sag, sag_idx, flags_v0)
                assert saf is not None, "SAGF present but store lacks SA"

                def _mix(bit, sub_col, pred_col):
                    pr = np.nonzero((sagf & bit).astype(bool))[0]
                    kp = np.nonzero(~(sagf & bit).astype(bool))[0]
                    return ragged.merge_rows(
                        ng, [(kp, sub_col), (pr, ragged.take(pred_col, pr))])
                rname = _mix(1, pctxs["RNAME"].dict_take(), saf["rname"])
                nkp = int((~(sagf & 2).astype(bool)).sum())
                pos = _mix(2, _recon_num_or_tok("POS", pctxs, nkp),
                           ragged.itoa(saf["pos"]))
                nkm = int((~(sagf & 4).astype(bool)).sum())
                mapq = _mix(4, _recon_num_or_tok("MAPQ", pctxs, nkm),
                            ragged.itoa(saf["mapq"]))
                nkc = int((~(sagf & 8).astype(bool)).sum())
                cigar = _mix(8, tokenizer_recon_col("CIGAR", pctxs, nkc),
                             saf["cigar"])
            else:
                rname = pctxs["RNAME"].dict_take()
                pos = _recon_num_or_tok("POS", pctxs, ng)
                mapq = _recon_num_or_tok("MAPQ", pctxs, ng)
                cigar = tokenizer_recon_col("CIGAR", pctxs, ng)
            rnext = pctxs["RNEXT"].dict_take()
            pc_pn = pctxs.get("PNEXT")
            if pc_pn is not None and pc_pn.mode == MODE_NUM and pc_pn.param == 3:
                pv_, _ = ragged.atoi(pos)
                enc = pc_pn.local.astype(np.int64)
                pn_ = np.where(enc == 0, 0,
                               np.where(enc > 0, pv_ + enc - 1, pv_ + enc))
                pnext = ragged.itoa(pn_)
            else:
                pnext = _recon_num_or_tok("PNEXT", pctxs, ng)
            sqlens = pctxs["SQLEN"].nums()
            pc_tl = pctxs.get("TLEN")
            if pc_tl is not None and pc_tl.mode == MODE_NUM and \
                    pc_tl.param == 5:
                pv_, _ = ragged.atoi(pos)
                pn_, _ = ragged.atoi(pnext)
                span = pn_ - pv_ + np.where(pn_ >= pv_, sqlens, -sqlens)
                pred = np.where((pn_ > 0) & (pv_ > 0), span, 0)
                tlen = ragged.itoa(pc_tl.local.astype(np.int64) + pred)
            else:
                tlen = _recon_num_or_tok("TLEN", pctxs, ng)
            qllens = pctxs["QLLEN"].nums()
            if sag_idx is not None:
                from .. import sag as sag_mod
                flags_v, _ = ragged.atoi(flag)
                pred_seq, pred_qual, _valid = sag_mod.predict_depn(
                    sag, sag_idx, flags_v, cigar, sqlens)
                seq_eq = pctxs["SAGSEQ"].nums().astype(bool)
                qual_eq = pctxs["SAGQUL"].nums().astype(bool)
                nr_lens = np.where(seq_eq, 0, sqlens)
                nonref = Col(pctxs["NONREF"].local,
                             np.concatenate([[0], np.cumsum(nr_lens)]))
                seq = ragged.merge_rows(ng, [
                    (np.nonzero(seq_eq)[0],
                     ragged.take(pred_seq, np.nonzero(seq_eq)[0])),
                    (np.nonzero(~seq_eq)[0],
                     ragged.take(nonref, np.nonzero(~seq_eq)[0]))])
                keep = np.nonzero(~qual_eq)[0]
                qleft = self.qual_col_sam(pctxs, ragged.take(seq, keep),
                                          qllens[keep], flag, keep)
                qual = ragged.merge_rows(ng, [
                    (np.nonzero(qual_eq)[0],
                     ragged.take(pred_qual, np.nonzero(qual_eq)[0])),
                    (keep, qleft)])
            elif "SQBITMAP" in pctxs:
                seq = self._recon_seq_vs_ref(pctxs, sqlens, pos, rname, cigar)
                qual = self.qual_col_sam(pctxs, seq, qllens, flag)
            else:
                seq = pctxs["NONREF"].txt_col(sqlens)
                qual = self.qual_col_sam(pctxs, seq, qllens, flag)
            if "AUXL" in pctxs:
                predict = None
                if "SQBITMAP" in pctxs:
                    ref = getattr(self, "ref", None)
                    assert ref is not None, "archive needs --reference"
                    predict = self._predict_from_ctxs(
                        pctxs["SQBITMAP"].nums().astype(bool),
                        pctxs["SEQNM"].nums(), pctxs["SEQMISP"].nums(),
                        cigar, pos, rname, ref)
                mate = self.mate_rows(qname, pos, pnext) if ng else None
                pvr, pokr = ragged.atoi(pos)
                aux = self._recon_aux(pctxs, ng, predict, qual=qual,
                                      seq=seq, cigar=cigar, mate=mate,
                                      pos_v=pvr if (ng and pokr.all())
                                      else None,
                                      sa_pred=self._sa_pred_col(sag_idx, ng),
                                      nh_pred=self._sag_nh_pred(sag_idx, ng),
                                      cc_pred=self._sag_cc_pred_col(sag_idx,
                                                                    ng),
                                      cp_pred=self._sag_cp_pred(sag_idx, ng),
                                      solo_pred=self._sag_solo_pred(sag_idx,
                                                                    ng))
            else:
                aux = tokenizer_recon_col("AUX", pctxs, ng)
            t = b"\t"
            glines = ragged.interleave(
                [qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen,
                 seq, qual, aux],
                sep_after=[t, t, t, t, t, t, t, t, t, t, None, None])
        else:
            glines = Col.from_list([])

        parts = [(good_idx, glines)]
        if bad_idx.shape[0]:
            parts.append((bad_idx, pctxs["EXC"].dict_take()))
        all_lines = ragged.merge_rows(n, parts)
        out = ragged.interleave([all_lines], sep_after=[b"\n"])
        raw = out.data.tobytes()
        if meta.get("no_final_nl"):
            raw = raw[:-1]
        return raw
