"""FASTQ datatype plugin.

Counterpart of genozip_tpu/datatypes/fastq.py: the same seg and recon, so
archives are byte-identical. SEQ is stored verbatim (NONREF) or, with a
reference, as aligner placements plus mismatches (SQBITMAP, GPOS, STRAND,
SEQNM, SEQMISP, SEQMISB, the spliced-alignment contexts and NONREF for
unaligned reads); R2 of a pair gets R1's placements as a hint. With a
--bamass index, the BAM's placements stand in for the aligner's seed search
for the reads they cover (src/fastq_bamass.c). In a --deep archive a read
whose SEQ (and QUAL) equal its BAM alignment's stores only a hit flag
(DEEP), and its SEQ and QUAL come back from the deep index at PIZ
(src/fastq_deep.c).
Reference parity: src/fastq.c (line-quad parsing :1002, seg :1249),
src/fastq_seq.c (SEQ methods), src/fastq_qual.c, src/fastq_desc.c.
Design: the whole VB is parsed in one pass (newline scan →
line-quad columns); DESC goes through the vectorized tokenizer (seg.py)
instead of per-line qname flavor matching; SEQ is one concatenated stream
(ACGT 2-bit pack codec; aligner path added separately); QUAL one stream
(rANS order-1 / PACK); per-read lengths one delta-coded int stream.
"""

import numpy as np

from . import DataType, VBSegResult, register
from ..contexts import VBCtx, MODE_DICT, MODE_NUM, MODE_TXT, dedup_col
from ..ops import pack as packops
from ..ref import aligner as al
from ..seg import tokenizer_seg_col, tokenizer_recon_col
from ..utils import profiler, ragged


@register
class FastqDT(DataType):
    NAME = "fastq"
    EXTS = (".fastq", ".fq")
    ref = None              # RefGenome when zipped or unzipped --reference
    missing_ref = None      # the archive's reference name when none was given
    pair_gpos_hint = None   # R2: R1's GPOS per read (-1 unaligned)
    deep_index = None       # deep.DeepIndex of a --deep archive's BAM
    bamass_index = None     # bamass.BamAssIndex of zip --bamass

    def segconf_scan(self, sample):
        """FASTQ calibration: read-length profile, long-read detection
        (switches VB sizing, reference segconf.is_long_reads), qual alphabet
        size (PACK/DOMQ candidacy)."""
        super().segconf_scan(sample)
        nl = np.nonzero(sample == ord("\n"))[0]
        if nl.shape[0] < 4:
            return
        starts = np.concatenate([[0], nl[:-1] + 1])
        lens = (nl - starts)[1::4]  # seq lines
        if lens.shape[0] == 0:
            return
        self.segconf["read_len_avg"] = round(float(lens.mean()), 1)
        self.segconf["read_len_max"] = int(lens.max())
        self.segconf["is_long_reads"] = bool(lens.mean() > 2000)
        qstarts = starts[3::4]
        qlens = (nl - starts)[3::4]
        k = min(qstarts.shape[0], 200)
        if k:
            qs = ragged.gather_ranges(sample, qstarts[:k], qlens[:k])
            self.segconf["qual_alphabet"] = int(np.unique(qs.data).shape[0])

    def suggested_vb_size(self):
        # long reads want bigger VBs so per-VB dict/codec overheads amortize
        # (reference: vb sizing segconf.c:101,459)
        base = super().suggested_vb_size()
        if self.segconf.get("is_long_reads"):
            return max(base or 0, 64 << 20)
        return base

    def optimize_vb(self, data: np.ndarray) -> np.ndarray:
        """--optimize: Illumina 8-level QUAL binning on line 4 of each
        record (reference sam_modify.c optimize_phred_quality_string)."""
        from ..optimize import PHRED_LUT
        nl = np.nonzero(data == ord("\n"))[0]
        if nl.shape[0] == 0:
            return data
        # qual lines are every 4th line (records are whole in a VB)
        starts = np.concatenate([[0], nl[:-1] + 1])
        q = np.arange(nl.shape[0]) % 4 == 3
        qs, qe = starts[q], nl[q]
        total = int((qe - qs).sum())
        if total == 0:
            return data
        idx = ragged.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(qe - qs)])[:-1], qe - qs) + \
            np.repeat(qs, qe - qs)
        data = data.copy() if not data.flags.writeable else data
        data[idx] = PHRED_LUT[data[idx]]
        return data

    def vb_boundary(self, data: np.ndarray, is_eof: bool) -> int:
        if is_eof:
            return data.shape[0]
        nl = np.nonzero(data == ord("\n"))[0]
        quads = nl.shape[0] // 4
        if quads == 0:
            return 0
        return int(nl[quads * 4 - 1]) + 1

    def seg_vb(self, data: np.ndarray) -> VBSegResult:
        nl = np.nonzero(data == ord("\n"))[0]
        no_final_nl = data.shape[0] and (nl.shape[0] == 0 or nl[-1] != data.shape[0] - 1)
        if no_final_nl:
            nl = np.concatenate([nl, [data.shape[0]]])
        nlines = nl.shape[0]
        if nlines % 4:
            raise ValueError(f"FASTQ line count {nlines} not a multiple of 4")
        n = nlines // 4
        starts = np.concatenate([[0], nl[:-1] + 1])
        lens = nl - starts
        # gather each stream directly from the raw VB (one pass per stream,
        # no intermediate whole-VB lines column)
        desc = ragged.gather_ranges(data, starts[0::4], lens[0::4])
        seq = ragged.gather_ranges(data, starts[1::4], lens[1::4])
        plus = ragged.gather_ranges(data, starts[2::4], lens[2::4])
        qual = ragged.gather_ranges(data, starts[3::4], lens[3::4])

        seq_lens = seq.lens
        qual_lens = qual.lens
        if (seq_lens != qual_lens).any():
            raise ValueError("FASTQ SEQ/QUAL length mismatch")

        ctxs = {}
        self._seg_desc(ctxs, desc, seq_lens, n)
        uw, inv = dedup_col(plus)
        ctxs["PLUS"] = VBCtx("PLUS", MODE_DICT, b250=inv, vb_words=uw, cat="b250")
        d = np.diff(seq_lens, prepend=np.int64(0))
        ctxs["LENS"] = VBCtx("LENS", MODE_NUM, local=d, cat="int", param=1)

        if self.deep_index is not None and n:
            self._seg_deep(ctxs, desc, seq, qual)
        else:
            if self.ref is not None and n:
                self._seg_seq_aligned(ctxs, seq, self.ref, desc)
            else:
                ctxs["NONREF"] = VBCtx("NONREF", MODE_TXT, local=seq.data,
                                       cat="seq")
            ctxs["QUAL"] = self._seg_qual(seq, qual)
        meta = {"no_final_nl": bool(no_final_nl)}
        return VBSegResult(ctxs, n, meta)

    _BARCODE_OK = np.zeros(256, bool)
    for _b in b"ACGTN+-":
        _BARCODE_OK[_b] = True

    def _seg_desc(self, ctxs, desc, seq_lens, n):
        """DESC = QNAME [space SAUX] (reference src/fastq_desc.c /
        src/fastq_saux.c). The Illumina comment's index-barcode tail (the
        last ':'-field when it is an ACGTN+ run, e.g. '1:N:0:ATCCGA+GATC')
        is split into its own sequence-categorized stream so per-read
        barcodes never inflate the template dict; numeric DESC tokens equal
        to the read length ('length=150', qname_flavors.h seq_len items)
        are elided entirely and recomputed from LENS at PIZ."""
        data = desc.data
        sp_first = np.full(n, -1, np.int64)
        if data.shape[0]:
            isp = np.nonzero(data == ord(" "))[0]
            row_sp = np.searchsorted(desc.offsets[1:], isp, side="right")
            first_of = np.ones(isp.shape[0], bool)
            first_of[1:] = row_sp[1:] != row_sp[:-1]
            sp_first[row_sp[first_of]] = isp[first_of]
        has_sp = sp_first >= 0
        if n and has_sp.mean() > 0.9 and has_sp.all():
            qcol = ragged.gather_ranges(
                data, desc.offsets[:-1], sp_first - desc.offsets[:-1])
            scol = ragged.gather_ranges(
                data, sp_first + 1, desc.offsets[1:] - sp_first - 1)
            # barcode tail: bytes after the last ':' when ACGTN+ only
            last_colon = np.full(n, -1, np.int64)
            if scol.data.shape[0]:
                ic = np.nonzero(scol.data == ord(":"))[0]
                rc = np.searchsorted(scol.offsets[1:], ic, side="right")
                np.maximum.at(last_colon, rc, ic)
            tail_s = last_colon + 1
            tail_l = np.where(last_colon >= 0, scol.offsets[1:] - tail_s, 0)
            tail = ragged.gather_ranges(scol.data, np.maximum(tail_s, 0),
                                        tail_l)
            bar_ok = (tail.lens >= 4) & (last_colon >= 0)
            if tail.data.shape[0]:
                badb = ~self._BARCODE_OK[tail.data]
                if badb.any():
                    rows_bad = np.searchsorted(tail.offsets[1:],
                                               np.nonzero(badb)[0],
                                               side="right")
                    bar_ok[np.unique(rows_bad)] = False
            if n and bar_ok.mean() > 0.9:
                head_l = np.where(bar_ok, tail_s - scol.offsets[:-1],
                                  scol.lens)
                head = ragged.gather_ranges(scol.data, scol.offsets[:-1],
                                            head_l)
                dctx = tokenizer_seg_col("SAUX", head)
                bl = np.where(bar_ok, tail.lens, 0)
                bcol = ragged.gather_ranges(scol.data, np.maximum(tail_s, 0),
                                            bl)
                ctxs["SAUXB"] = VBCtx("SAUXB", MODE_TXT, local=bcol.data,
                                      cat="seq")
                ctxs["SAUXBL"] = VBCtx(
                    "SAUXBL", MODE_NUM,
                    local=np.diff(bl, prepend=np.int64(0)),
                    cat="int", param=1)
            else:
                dctx = tokenizer_seg_col("SAUX", scol)
            dctx.update(tokenizer_seg_col("DESC", qcol))
        else:
            dctx = tokenizer_seg_col("DESC", desc)
        # embedded seq_len: a numeric token stream equal to the read length
        for name, c in dctx.items():
            if c.mode != MODE_NUM or c.local.shape[0] != n:
                continue
            v = np.cumsum(c.local) if c.param == 1 else c.local
            if (v == seq_lens).all():
                dctx[name] = VBCtx(name, MODE_NUM,
                                   local=np.zeros(0, np.int64),
                                   cat="int", special="seqlen")
        ctxs.update(dctx)

    def _recon_desc(self, pctxs, lens, n):
        for name, pc in pctxs.items():
            if (pc.special or "") == "seqlen":
                pc.local = lens.astype(np.int64)
                pc.param = 0
        desc = tokenizer_recon_col("DESC", pctxs, n)
        if "SAUX" not in pctxs:
            return desc
        head = tokenizer_recon_col("SAUX", pctxs, n)
        if "SAUXB" in pctxs:
            bl = pctxs["SAUXBL"].nums()
            bcol = pctxs["SAUXB"].txt_col(bl)
            saux = ragged.interleave([head, bcol], sep_after=[None, None])
        else:
            saux = head
        return ragged.interleave([desc, saux], sep_after=[b" ", None])

    def _seg_qual(self, seq, qual):
        """QUAL with optional SEQ-derived channel demux (the platform
        quality codec family, codec_longr/pacb/smux/tmpl/homp.c roles —
        see codecs/qual.py). The class is chosen once, on the first VB
        carrying data, and inherited by later VBs (codec.c:210 analog)."""
        from ..codecs import qual as qualmod
        cls = getattr(self, "_qdmx", "unset")
        if cls == "unset":
            cls = qualmod.choose_class(seq, qual)
            if not self._seg_lazy_frozen:
                self._qdmx = cls   # commit only while seg is single-threaded
        if cls:
            return VBCtx("QUAL", MODE_TXT,
                         local=qualmod.demux(cls, qual, seq),
                         cat="qual", special=f"qdmx:{cls}")
        return VBCtx("QUAL", MODE_TXT, local=qual.data, cat="qual")

    @staticmethod
    def qual_col(pctxs, seq, lens):
        """PIZ QUAL column: undo the channel demux (channels recomputed
        from the already-reconstructed SEQ — zero side data)."""
        from ..codecs import qual as qualmod
        pc = pctxs["QUAL"]
        sp = pc.special or ""
        if sp.startswith("qdmx:"):
            data = qualmod.remux(sp.split(":")[1], pc.local, seq, lens)
            offs = np.concatenate([[0], np.cumsum(lens.astype(np.int64))])
            return ragged.Col(data, offs)
        return pc.txt_col(lens)

    def _seg_deep(self, ctxs, desc, seq, qual):
        """Deep path (reference parity: fastq_deep.c:680 fastq_deep_seg_SEQ):
        reads whose SEQ matches their BAM alignment store only a hit flag
        (0 = miss, 1 = seq hit, 2 = seq+qual hit); the PIZ side re-derives
        the alignment by the same qname lookup, so no id stream is needed."""
        deep = self.deep_index
        with profiler.timer("zip:deep-lookup"):
            rows = deep.lookup_rows(desc)
        fidx = np.nonzero(rows >= 0)[0]
        flag = np.zeros(len(desc), dtype=np.int64)
        if fidx.shape[0]:
            cs, cq = deep.fetch(rows[fidx])
            seq_eq = ragged.cols_equal_rows(ragged.take(seq, fidx), cs)
            qual_eq = ragged.cols_equal_rows(ragged.take(qual, fidx), cq) & \
                seq_eq
            flag[fidx[seq_eq]] = 1
            flag[fidx[qual_eq]] = 2
        ctxs["DEEP"] = VBCtx("DEEP", MODE_NUM, local=flag, cat="int")
        nonref = ragged.take(seq, np.nonzero(flag == 0)[0])
        ctxs["NONREF"] = VBCtx("NONREF", MODE_TXT, local=nonref.data, cat="seq")
        keep_qual = np.nonzero(flag < 2)[0]
        ctxs["QUAL"] = self._seg_qual(ragged.take(seq, keep_qual),
                                      ragged.take(qual, keep_qual))

    def _recon_deep(self, pctxs, desc, lens):
        deep = self.deep_index
        if deep is None:
            raise ValueError("deep archive: the BAM component's index is "
                             "missing")
        flag = pctxs["DEEP"].nums()
        n = flag.shape[0]
        with profiler.timer("piz:deep-lookup"):
            rows = deep.lookup_rows(desc)
        hit = flag >= 1
        if (rows[hit] < 0).any():
            raise ValueError("deep: a read's QNAME is not in the BAM "
                             "component")
        hs, hq = deep.fetch(rows[hit])
        miss_idx = np.nonzero(~hit)[0]
        nonref = pctxs["NONREF"].txt_col(lens[miss_idx])
        seq = ragged.merge_rows(n, [(np.nonzero(hit)[0], hs),
                                    (miss_idx, nonref)])
        qkeep_idx = np.nonzero(flag < 2)[0]
        qv = self.qual_col(pctxs, ragged.take(seq, qkeep_idx),
                           lens[qkeep_idx])
        hit2 = np.nonzero(flag == 2)[0]
        parts = [(qkeep_idx, qv)]
        if hit2.shape[0]:
            parts.append((hit2, ragged.take(hq, np.nonzero(flag[hit] == 2)[0])))
        return seq, ragged.merge_rows(n, parts)

    def _seg_seq_aligned(self, ctxs, seq, ref, desc):
        """Reference-based SEQ seg (reference parity: fastq_seq.c:45
        fastq_seg_SEQ aligner path; aligner.c:767 aligner_seg_seq). With a
        bamass index (fastq_bamass.c), BAM placements replace the seed
        search for the reads they cover; the rest go through the aligner,
        unspliced and without a pair hint."""
        seq_mat, lens = ragged.to_matrix(seq)
        codes = packops.BASE2BIT[seq_mat]
        if self.bamass_index is not None:
            gpos, is_fwd = self.bamass_index.lookup(desc)
            aligned = (gpos >= 0) & (gpos + lens <= ref.length)
            rest = np.nonzero(~aligned)[0]
            if rest.shape[0]:
                with profiler.timer("zip:align"):
                    sub = al.align_batch(ref, codes[rest], lens[rest])
                aligned[rest] = sub["aligned"]
                gpos[rest] = sub["gpos"]
                is_fwd[rest] = sub["is_fwd"]
            gpos2, junction = gpos, lens.astype(np.int64)
        else:
            pair_hint = self.pair_gpos_hint
            if pair_hint is not None and pair_hint.shape[0] != len(seq):
                pair_hint = None
            with profiler.timer("zip:align"):
                res = al.align_batch(ref, codes, lens, pair_gpos=pair_hint,
                                     splice=True)
            aligned, gpos, is_fwd = res["aligned"], res["gpos"], res["is_fwd"]
            gpos2, junction = res["gpos2"], res["junction"]
        if ref.track_used:      # REF_EXT_STORE: the genome ranges used
            ref.mark_used(gpos[aligned], junction[aligned])
            sp2 = aligned & (junction < lens)
            if sp2.any():
                ref.mark_used(gpos2[sp2], (lens - junction)[sp2])
        ridx, mpos, mbase = al.mismatch_lists(
            ref, seq_mat, codes, lens, gpos, is_fwd, aligned, gpos2, junction)
        nm = np.bincount(ridx, minlength=len(seq))[aligned]

        ctxs["SQBITMAP"] = VBCtx("SQBITMAP", MODE_NUM,
                                 local=aligned.astype(np.int64), cat="int")
        ctxs["GPOS"] = VBCtx("GPOS", MODE_NUM, local=gpos[aligned], cat="int")
        ctxs["STRAND"] = VBCtx("STRAND", MODE_NUM,
                               local=is_fwd[aligned].astype(np.int64), cat="int")
        ctxs["SEQNM"] = VBCtx("SEQNM", MODE_NUM, local=nm, cat="int")
        ctxs["SEQMISP"] = VBCtx("SEQMISP", MODE_NUM, local=mpos, cat="int")
        ctxs["SEQMISB"] = VBCtx("SEQMISB", MODE_TXT, local=mbase, cat="text")
        spliced = aligned & (junction < lens)
        if spliced.any():
            # 2-segment (intron) alignments (aligner.c:514): per aligned
            # read a spliced flag; per spliced read junction + signed gap
            ctxs["SPLICED"] = VBCtx("SPLICED", MODE_NUM,
                                    local=spliced[aligned].astype(np.int64),
                                    cat="int")
            ctxs["SPLJ"] = VBCtx("SPLJ", MODE_NUM, local=junction[spliced],
                                 cat="int")
            ctxs["SPLG"] = VBCtx("SPLG", MODE_NUM,
                                 local=gpos2[spliced] - gpos[spliced],
                                 cat="int")
        nonref = ragged.take(seq, np.nonzero(~aligned)[0])
        ctxs["NONREF"] = VBCtx("NONREF", MODE_TXT, local=nonref.data, cat="seq")

    def _recon_seq_aligned(self, pctxs, lens):
        """PIZ aligner path (reference parity: fastq_seq.c:346
        fastq_recon_aligned_SEQ: genome gather + mismatch patches)."""
        ref = self.ref
        if ref is None:
            name = f" {self.missing_ref}" if self.missing_ref else ""
            raise ValueError(f"archive was compressed with --reference{name}:"
                             " give that reference with --reference")
        aligned = pctxs["SQBITMAP"].nums().astype(bool)
        n = aligned.shape[0]
        gpos = pctxs["GPOS"].nums()
        is_fwd = pctxs["STRAND"].nums().astype(bool)
        nm = pctxs["SEQNM"].nums()
        mpos = pctxs["SEQMISP"].nums()
        mbase = pctxs["SEQMISB"].local
        a_lens = lens[aligned]
        mm_ridx = np.repeat(np.arange(gpos.shape[0]), nm)
        gpos2 = junction = None
        if "SPLICED" in pctxs:
            spl = pctxs["SPLICED"].nums().astype(bool)
            junction = a_lens.astype(np.int64).copy()
            junction[spl] = pctxs["SPLJ"].nums()
            gpos2 = gpos.copy()
            gpos2[spl] = gpos[spl] + pctxs["SPLG"].nums()
        with profiler.timer("piz:ref-recon"):
            mat = al.reconstruct_batch(ref, gpos, a_lens, is_fwd,
                                       mm_ridx, mpos, mbase, gpos2, junction)
        a_col = ragged.from_matrix(mat, a_lens)
        un_idx = np.nonzero(~aligned)[0]
        nonref = pctxs["NONREF"].txt_col(lens[un_idx])
        return ragged.merge_rows(n, [(np.nonzero(aligned)[0], a_col),
                                     (un_idx, nonref)])

    def recon_vb(self, pctxs: dict, meta: dict) -> bytes:
        n = meta["num_lines"]
        lens = pctxs["LENS"].nums()
        desc = self._recon_desc(pctxs, lens, n)
        plus = pctxs["PLUS"].dict_take()
        if "DEEP" in pctxs:
            seq, qual = self._recon_deep(pctxs, desc, lens)
        else:
            if "SQBITMAP" in pctxs:
                seq = self._recon_seq_aligned(pctxs, lens)
            else:
                seq = pctxs["NONREF"].txt_col(lens)
            qual = self.qual_col(pctxs, seq, lens)
        out = ragged.interleave([desc, seq, plus, qual],
                                sep_after=[b"\n", b"\n", b"\n", b"\n"])
        raw = out.data.tobytes()
        if meta.get("no_final_nl"):
            raw = raw[:-1]
        return raw
