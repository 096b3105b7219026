"""VCF datatype plugin.

Counterpart of genozip_tpu/datatypes/vcf.py on its numpy host path: the same
seg and recon, so archives are byte-identical. Reference parity:
src/vcf_seg.c, src/vcf_info.c, src/vcf_samples.c, src/vcf_header.c.
Design: tab-split whole-VB columns; CHROM/REF/ALT/FILTER/FORMAT as dict
contexts; POS delta-coded; ID predicted from POS (dbSNP-style ids); INFO
split per key with the AC/AN/AF, END and DP relations and VEP/snpEff
annotations split per field; the sample matrix split per FORMAT tag, GT
through the PBWT haplotype transform, the other tags muxed by GT dosage and
predicted across tags (DP from AD, GQ from PL). With a reference, REF
bases equal to the genome cost one flag bit. Rows whose tab count differs
from the VB's dominant shape round-trip via a verbatim exception context.
"""

import numpy as np

from . import DataType, VBSegResult, register
from .. import native
from ..contexts import (VBCtx, MODE_DICT, MODE_NUM, dedup_col,
                        est_ctxs_size)
from ..ops.pbwt import pbwt_decode, pbwt_encode
from ..seg import tokenizer_seg_col, tokenizer_recon_col
from ..utils import profiler, ragged
from ..utils.ragged import Col

FIELD_CTXS = ["CHROM", None, "ID", "REF", "ALT", None, "FILTER", None]  # dict ones


def _lines_of(data: np.ndarray):
    nl = np.nonzero(data == ord("\n"))[0]
    no_final_nl = data.shape[0] and (nl.shape[0] == 0 or nl[-1] != data.shape[0] - 1)
    if no_final_nl:
        nl = np.concatenate([nl, [data.shape[0]]])
    starts = np.concatenate([[0], nl[:-1] + 1])
    return ragged.gather_ranges(data, starts, nl - starts), bool(no_final_nl)


@register
class VcfDT(DataType):
    NAME = "vcf"
    ref = None              # RefGenome when zipped or unzipped --reference
    missing_ref = None      # the archive's reference name when none was given

    def read_txt_header(self, reader) -> bytes:
        return reader.read_header_lines(b"#")

    def segconf_scan(self, sample: np.ndarray):
        """VCF calibration (reference src/segconf.h:88-340 VCF subset +
        src/vcf_header.c): sample count from the #CHROM line, annotator
        detection from ##INFO definitions (VEP CSQ / snpEff ANN), FORMAT
        tags + GT presence/ploidy from the first data rows."""
        super().segconf_scan(sample)
        sc = self.segconf
        text = sample.tobytes()
        data_rows = []
        for ln in text.split(b"\n"):
            if ln.startswith(b"##"):
                if ln.startswith(b"##INFO=<ID=CSQ"):
                    sc["annotator"] = "vep"
                elif ln.startswith(b"##INFO=<ID=ANN"):
                    sc["annotator"] = "snpeff"
                elif b"source=" in ln[:40]:
                    src = ln.split(b"source=", 1)[1][:32]
                    for caller in (b"GATK", b"DRAGEN", b"manta",
                                   b"DeepVariant", b"freebayes"):
                        if caller.lower() in src.lower():
                            sc["caller"] = caller.decode().lower()
            elif ln.startswith(b"#CHROM"):
                ncols = ln.count(b"\t") + 1
                sc["n_samples"] = max(ncols - 9, 0)
            elif ln and not ln.startswith(b"#"):
                data_rows.append(ln)
                if len(data_rows) >= 50:
                    break
        fmt_tags = set()
        ploidy = None
        for ln in data_rows:
            cols = ln.split(b"\t")
            if len(cols) > 9:
                for t in cols[8].split(b":"):
                    if t:
                        fmt_tags.add(t.decode("latin1", "replace"))
                if b"GT" in cols[8].split(b":"):
                    gt = cols[9].split(b":")[0]
                    ploidy = gt.count(b"/") + gt.count(b"|") + 1
        if fmt_tags:
            sc["format_tags"] = sorted(fmt_tags)
            sc["has_gt"] = "GT" in fmt_tags
        if ploidy is not None:
            sc["ploidy"] = ploidy

    def suggested_vb_size(self):
        # many-sample VCFs amortize dict/codec overhead (and the PBWT
        # haplotype matrix gains context depth) with bigger VBs — but VBs
        # are also the unit of parallelism, and an over-sized VB serializes
        # the whole file through one worker. 6MB measured within ~2.5% of
        # the 32MB ratio on the 200-sample bench corpus at ~1.7x the MB/s
        # both directions.
        base = super().suggested_vb_size()
        if self.segconf.get("n_samples", 0) >= 64:
            return max(base or 0, 6 << 20)
        return base

    def seg_vb(self, data: np.ndarray) -> VBSegResult:
        lines, no_final_nl = _lines_of(data)
        n = len(lines)
        tabs = ragged.count_sep_per_row(lines, ord("\t"))
        counts = np.bincount(tabs)
        dominant = int(np.argmax(counts)) if counts.shape[0] else 0
        good = tabs == dominant
        good_idx = np.nonzero(good)[0]
        exc_idx = np.nonzero(~good)[0]

        ctxs = {}
        nf = dominant + 1
        glines = ragged.take(lines, good_idx)
        # good rows all have exactly nf-1 tabs, so the tab positions reshape
        # to (ng, nf-1) directly — no searchsorted, no per-field split for
        # the (possibly hundreds of) sample columns
        fields = []
        sep_pos = None
        ng = len(glines)
        if ng:
            sep_pos = np.nonzero(glines.data == ord("\t"))[0]
            sep_pos = sep_pos.reshape(ng, nf - 1) if nf > 1 \
                else sep_pos.reshape(ng, 0)
            nfix = min(nf, 9)
            bounds = np.empty((ng, nfix + 1), dtype=np.int64)
            bounds[:, 0] = glines.offsets[:-1]
            bounds[:, 1:nfix + 1] = sep_pos[:, :nfix] + 1 if nf > nfix \
                else np.concatenate([sep_pos + 1,
                                     glines.offsets[1:, None] + 1], axis=1)
            for f in range(nfix):
                fields.append(ragged.gather_ranges(
                    glines.data, bounds[:, f],
                    bounds[:, f + 1] - 1 - bounds[:, f]))

        if fields:
            pos_vals = None
            info_col = None
            for fi, fname in enumerate(["CHROM", "POS", "ID", "REF", "ALT",
                                        "QUAL", "FILTER", "INFO", "FORMAT"][:min(nf, 9)]):
                col = fields[fi]
                if fname == "REF" and self.ref is not None:
                    self._seg_ref_vs_genome(ctxs, fields, col)
                elif fname in ("CHROM", "REF", "ALT", "FILTER", "FORMAT"):
                    uw, inv = dedup_col(col)
                    ctxs[fname] = VBCtx(fname, MODE_DICT, b250=inv, vb_words=uw, cat="b250")
                elif fname == "POS":
                    vals, ok = ragged.atoi(col)
                    if ok.all():
                        pos_vals = vals
                        d = np.diff(vals, prepend=np.int64(0))
                        ctxs["POS"] = VBCtx("POS", MODE_NUM, local=d, cat="int", param=1)
                    else:
                        ctxs.update(tokenizer_seg_col("POS", col))
                elif fname == "ID":
                    self._seg_id(ctxs, col, pos_vals)
                elif fname == "QUAL":
                    ctxs.update(tokenizer_seg_col(fname, col))
                elif fname == "INFO":
                    # deferred: the INFO DP <- sum(FORMAT DP) relation
                    # (src/vcf_gatk.c) needs the sample matrix segged first
                    info_col = col
            dp_row = None
            if nf > 9:
                # sample cells gathered SAMPLE-MAJOR in one pass straight
                # from the line bytes (the reference's LT_UINT8_TR
                # sample-matrix transpose as a layout choice,
                # src/vcf_samples.c) — no per-sample python loop
                S = nf - 9
                st = sep_pos[:, 8:] + 1                      # (ng, S)
                en = np.concatenate([sep_pos[:, 9:],
                                     glines.offsets[1:, None]], axis=1)
                cells = ragged.gather_ranges(
                    glines.data, np.ascontiguousarray(st.T).ravel(),
                    np.ascontiguousarray((en - st).T).ravel())
                dp_row = self._seg_samples(ctxs, fields[8], cells, S)
                if dp_row is False:
                    # fallback: the raw sample region (all cells joined by
                    # \t = the original row suffix), one tokenized column
                    smp = ragged.gather_ranges(
                        glines.data, sep_pos[:, 8] + 1,
                        glines.offsets[1:] - sep_pos[:, 8] - 1)
                    ctxs.update(tokenizer_seg_col("SMP", smp,
                                                  single_stream=True))
                    dp_row = None
            if info_col is not None:
                if not self._seg_info(ctxs, info_col, pos_vals=pos_vals,
                                      dp_row=dp_row):
                    ctxs.update(tokenizer_seg_col("INFO", info_col,
                                                  max_tokens=64))

        if exc_idx.shape[0]:
            uw, inv = dedup_col(ragged.take(lines, exc_idx))
            ctxs["EXC"] = VBCtx("EXC", MODE_DICT, b250=inv, vb_words=uw, cat="text")
        gd = np.zeros(n, dtype=np.int64)
        gd[good_idx] = 0
        gd[exc_idx] = 1
        ctxs["VARIANT"] = VBCtx("VARIANT", MODE_NUM, local=gd, cat="int")
        meta = {"no_final_nl": no_final_nl, "nf": nf}
        return VBSegResult(ctxs, n, meta)

    def _seg_id(self, ctxs, col, pos_vals):
        """ID column with dbSNP-style POS prediction (reference
        src/vcf_seg.c seg of VCF_ID + the gnomAD-style embedded-POS ids):
        rows whose ID ends with the row's POS digits store only the prefix
        (usually a constant like "rs") behind a match bitmap; the rest ride
        the tokenizer. Trial-both once per file."""
        memo = getattr(self, "_id_choice", None)
        if memo is None:
            memo = self._id_choice = {}
        choice = memo.get("ID")
        if choice is None and self._seg_lazy_frozen:
            choice = "tok"   # post-calibration: deterministic fallback, no commit
        cand = None
        if pos_vals is not None and len(col) >= 8 and choice in (None, "pos"):
            pos_txt = ragged.itoa(pos_vals)
            plen = pos_txt.lens
            can = col.lens >= plen
            # suffix compare via two gathers (only candidate rows)
            ci = np.nonzero(can)[0]
            if ci.shape[0]:
                a = ragged.gather_ranges(col.data,
                                         col.offsets[:-1][ci] +
                                         (col.lens - plen)[ci], plen[ci])
                b = ragged.take(pos_txt, ci)
                eq = np.zeros(len(col), bool)
                # rows have equal lens by construction: compare flat
                eq[ci] = ragged.rows_equal(a, b)
            else:
                eq = np.zeros(len(col), bool)
            if eq.mean() >= 0.5:
                cand = {"IDB": VBCtx("IDB", MODE_NUM,
                                     local=eq.astype(np.int64), cat="int")}
                pfx = ragged.gather_ranges(
                    col.data, col.offsets[:-1][eq],
                    (col.lens - plen)[eq])
                uw, inv = dedup_col(pfx)
                cand["IDPFX"] = VBCtx("IDPFX", MODE_DICT, b250=inv,
                                      vb_words=uw, cat="b250")
                if (~eq).any():
                    exc = ragged.take(col, np.nonzero(~eq)[0])
                    cand.update(tokenizer_seg_col("IDX", exc))
        if cand is not None and choice is None:
            tok = tokenizer_seg_col("ID", col)
            if est_ctxs_size(cand) < est_ctxs_size(tok):
                memo["ID"] = choice = "pos"
            else:
                memo["ID"] = choice = "tok"
                ctxs.update(tok)
                return
        elif choice is None:
            memo["ID"] = choice = "tok"
        if cand is not None and choice == "pos":
            ctxs.update(cand)
            return
        ctxs.update(tokenizer_seg_col("ID", col))

    def _recon_id(self, pctxs, pos_vals, ng) -> Col:
        eq = pctxs["IDB"].nums().astype(bool)
        pfx = pctxs["IDPFX"].dict_take()
        pos_txt = ragged.take(ragged.itoa(pos_vals), np.nonzero(eq)[0])
        matched = ragged.interleave([pfx, pos_txt], sep_after=[None, None])
        parts = [(np.nonzero(eq)[0], matched)]
        if (~eq).any():
            exc = tokenizer_recon_col("IDX", pctxs, int((~eq).sum()))
            parts.append((np.nonzero(~eq)[0], exc))
        return ragged.merge_rows(ng, parts)

    def _gpos_of(self, chrom_col, pos_col, ref):
        """Per-row genome position (or -1) from CHROM/POS."""
        pv, pok = ragged.atoi(pos_col)
        uw, inv = dedup_col(chrom_col)
        base = np.full(len(uw), -1, dtype=np.int64)
        for w in range(len(uw)):
            nm = uw.row(w).decode("utf-8", "replace")
            c = ref.contig_of(nm) or ref.contig_of("chr" + nm)
            if c is not None:
                base[w] = c["gpos"]
        g = np.where(pok & (base[inv] >= 0) & (pv > 0), base[inv] + pv - 1, -1)
        return np.where(g < ref.length, g, -1)

    def _seg_ref_vs_genome(self, ctxs, fields, ref_col):
        """REF column vs the reference genome (reference parity: RefAlt
        prediction, src/vcf_refalt.c): single-base REFs matching the genome
        at POS cost one flag bit; the rest stay in the dict."""
        from ..ops import pack as packops
        ref = self.ref
        gpos = self._gpos_of(fields[0], fields[1], ref)
        mat, lens = ragged.to_matrix(ref_col)
        first = mat[:, 0] if mat.shape[1] else np.zeros(len(ref_col), np.uint8)
        gb = packops.ACGT[ref.codes[np.clip(gpos, 0, max(ref.length - 1, 0))]]
        same = (lens == 1) & (gpos >= 0) & (first == gb)
        if getattr(ref, "track_used", False):  # REF_EXT_STORE tracking
            ok_g = gpos >= 0
            ref.mark_used(gpos[ok_g], np.ones(int(ok_g.sum()), np.int64))
        ctxs["REFSAME"] = VBCtx("REFSAME", MODE_NUM,
                                local=same.astype(np.int64), cat="int")
        rest = ragged.take(ref_col, np.nonzero(~same)[0])
        uw, inv = dedup_col(rest)
        ctxs["REF"] = VBCtx("REF", MODE_DICT, b250=inv, vb_words=uw, cat="b250")

    def _recon_ref_vs_genome(self, pctxs, chrom_col, pos_col, ng):
        from ..ops import pack as packops
        ref = self.ref
        if ref is None:
            name = f" {self.missing_ref}" if self.missing_ref else ""
            raise ValueError(f"archive was compressed with --reference{name}:"
                             " give that reference with --reference")
        same = pctxs["REFSAME"].nums().astype(bool)
        gpos = self._gpos_of(chrom_col, pos_col, ref)
        gb = packops.ACGT[ref.codes[np.clip(gpos, 0, max(ref.length - 1, 0))]]
        same_col = Col(gb[same], np.arange(int(same.sum()) + 1, dtype=np.int64))
        rest = pctxs["REF"].dict_take()
        return ragged.merge_rows(ng, [(np.nonzero(same)[0], same_col),
                                      (np.nonzero(~same)[0], rest)])

    MAX_FMT_TAGS = 24

    # ------------------------------------------------------------------
    # per-tag INFO contexts (reference src/vcf_info.c: one context per tag)
    # ------------------------------------------------------------------

    @staticmethod
    def _info_ctx_name(key: bytes) -> str:
        s = "".join(ch if ch.isalnum() else "_"
                    for ch in key[:6].decode("latin-1"))
        return "I" + (s or "_")

    def _seg_info(self, ctxs, col, pos_vals=None, dp_row=None) -> bool:
        """INFO split into KEY[=VALUE] fields on ';'; layout word = INFO
        text with each VALUE elided to a \\x01 mark (INFOL dict); one value
        context per key (name collisions after truncation are harmless:
        both keys share a stream in deterministic global field order)."""
        from ..seg import TOK_MARK
        n = len(col)
        data = col.data
        if n == 0 or (data.shape[0] and (data == TOK_MARK).any()):
            return False
        sp = np.nonzero(data == ord(";"))[0]
        frow = np.searchsorted(col.offsets[1:], sp, side="right")
        # field boundaries per row: starts at row start and after each ';'
        nf = np.bincount(frow, minlength=n) + 1
        F = int(nf.sum())
        f_of = np.repeat(ragged.arange(n), nf)
        first = np.concatenate([[0], np.cumsum(nf)])[:-1]
        fidx = ragged.arange(F) - first[f_of]
        sp_base = np.concatenate([[0], np.cumsum(nf - 1)])[:-1]
        fs = np.where(fidx == 0, col.offsets[:-1][f_of], 0)
        nz = np.nonzero(fidx > 0)[0]
        if nz.shape[0]:
            fs[nz] = sp[sp_base[f_of[nz]] + fidx[nz] - 1] + 1
        fe = np.empty(F, np.int64)
        last = fidx == nf[f_of] - 1
        fe[last] = col.offsets[1:][f_of[last]]
        nz = np.nonzero(~last)[0]
        if nz.shape[0]:
            fe[nz] = sp[sp_base[f_of[nz]] + fidx[nz]]
        # first '=' within each field
        eqp = np.nonzero(data == ord("="))[0]
        if eqp.shape[0]:
            srch = np.searchsorted(eqp, fs)
            has = srch < eqp.shape[0]
            eqpos = np.where(
                has, eqp[np.minimum(srch, eqp.shape[0] - 1)], 1 << 62)
        else:
            eqpos = np.full(F, 1 << 62, np.int64)
        valued = eqpos < fe
        kend = np.where(valued, eqpos, fe)
        # layout: KEY (+ '=' + mark) joined by ';'
        klen = kend - fs
        piece = klen + np.where(valued, 2, 0)
        row_llen = np.bincount(f_of, weights=piece, minlength=n) \
            .astype(np.int64) + (nf - 1)
        loff = np.concatenate([[0], np.cumsum(row_llen)])
        ldata = np.empty(int(loff[-1]), np.uint8)
        # destination start of each field within the layout
        dst = np.empty(F, np.int64)
        cum_in_row = np.zeros(F, np.int64)
        # per-row prefix of (piece + 1) for separator accounting
        adv = piece + 1
        cadv = np.cumsum(adv) - adv
        cum_in_row = cadv - cadv[first[f_of]]
        dst = loff[:-1][f_of] + cum_in_row
        tot_k = int(klen.sum())
        if tot_k:
            pos = ragged.arange(tot_k) - np.repeat(
                np.concatenate([[0], np.cumsum(klen)])[:-1], klen)
            ldata[np.repeat(dst, klen) + pos] = \
                data[np.repeat(fs, klen) + pos]
        v = np.nonzero(valued)[0]
        ldata[dst[v] + klen[v]] = ord("=")
        ldata[dst[v] + klen[v] + 1] = TOK_MARK
        nl = np.nonzero(~last)[0]
        ldata[dst[nl] + piece[nl]] = ord(";")
        new_ctxs = {}
        uw, inv = dedup_col(Col(ldata, loff))
        new_ctxs["INFOL"] = VBCtx("INFOL", MODE_DICT, b250=inv, vb_words=uw,
                                  cat="b250")
        # per-key value streams (valued fields only), global field order
        if v.shape[0]:
            keys = ragged.gather_ranges(data, fs[v], klen[v])
            kw, kinv = dedup_col(keys)
            names = [self._info_ctx_name(kw.row(w)) for w in range(len(kw))]
            if len(set(names)) != len(names):
                return False  # 6-char truncation collision: tokenizer path
            by_key, ac_pending = {}, None
            for w, name in enumerate(names):
                sel = v[kinv == w]
                vals = ragged.gather_ranges(data, kend[sel] + 1,
                                            fe[sel] - kend[sel] - 1)
                if kw.row(w) in (b"CSQ", b"ANN", b"BCSQ"):
                    # trial both ONCE per file (VB 1 segs alone, so the
                    # committed choice is visible to later VBs — the
                    # codec-assignment first-sight pattern, src/codec.c):
                    # per-position splitting wins on diverse annotations,
                    # the whole-value template dict on repetitive ones —
                    # measure, don't guess
                    memo = getattr(self, "_csq_choice", None)
                    if memo is None:
                        memo = self._csq_choice = {}
                    choice = memo.get(name)
                    if choice is None and self._seg_lazy_frozen:
                        choice = "tok"   # no trial-commit under concurrency
                    cand = self._seg_csq(name, vals) \
                        if choice in (None, "csq") else None
                    if cand is not None and choice is None:
                        tok = tokenizer_seg_col(name, vals,
                                                single_stream=True)
                        if est_ctxs_size(cand) < est_ctxs_size(tok):
                            memo[name] = choice = "csq"
                        else:
                            memo[name] = choice = "tok"
                            new_ctxs.update(tok)
                            continue
                    elif choice is None:
                        memo[name] = choice = "tok"
                    if cand is not None and choice == "csq":
                        new_ctxs.update(cand)
                        continue
                iv, iok = ragged.atoi(vals)
                if vals.data.shape[0] and iok.all():
                    key = kw.row(w)
                    rows = f_of[sel]
                    if key == b"DP" and dp_row is not None:
                        # INFO DP == sum of FORMAT DPs in GATK-family
                        # output (src/vcf_gatk.c) — store the residual
                        new_ctxs[name] = VBCtx(name, MODE_NUM,
                                               local=iv - dp_row[rows],
                                               cat="int", param=8)
                    elif key == b"END" and pos_vals is not None:
                        # END rides as a delta vs the row's POS
                        # (src/vcf_info.c END=POS+length relation)
                        new_ctxs[name] = VBCtx(name, MODE_NUM,
                                               local=iv - pos_vals[rows],
                                               cat="int", param=9)
                    elif key == b"AC":
                        ac_pending = (name, sel, iv)
                        continue
                    else:
                        new_ctxs[name] = VBCtx(name, MODE_NUM, local=iv,
                                               cat="int")
                else:
                    new_ctxs.update(tokenizer_seg_col(name, vals,
                                                      single_stream=True))
                by_key[kw.row(w)] = (sel, vals, iv if iok.all() else None)
            # AC ~= round(AN * AF) (src/vcf_info.c AC/AN/AF relation);
            # prediction uses the TEXT of AF parsed identically at PIZ
            if ac_pending is not None:
                name, sel, iv = ac_pending
                pred = self._ac_pred(n, f_of, sel, by_key)
                new_ctxs[name] = VBCtx(name, MODE_NUM, local=iv - pred,
                                       cat="int", param=7)
        if set(new_ctxs) & set(ctxs):
            return False  # name clash with fixed-field contexts
        ctxs.update(new_ctxs)
        return True

    @staticmethod
    def _parse_floats(col) -> np.ndarray:
        """Per-row float parse (nan where unparseable) — must be identical
        at ZIP and PIZ (both parse the same text bytes)."""
        out = np.full(len(col), np.nan)
        for i in range(len(col)):
            try:
                out[i] = float(col.row(i))
            except ValueError:
                pass
        return out

    @classmethod
    def _ac_pred(cls, n, f_of, sel, by_key) -> np.ndarray:
        """AC prediction = round(AN * AF) on rows carrying all three."""
        pred = np.zeros(sel.shape[0], np.int64)
        an = by_key.get(b"AN")
        af = by_key.get(b"AF")
        if an is None or af is None or an[2] is None:
            return pred
        an_row = np.full(n, -1, np.int64)
        an_row[f_of[an[0]]] = an[2]
        af_row = np.full(n, np.nan)
        af_row[f_of[af[0]]] = cls._parse_floats(af[1])
        rows = f_of[sel]
        have = (an_row[rows] >= 0) & ~np.isnan(af_row[rows])
        pred[have] = np.rint(an_row[rows][have] *
                             af_row[rows][have]).astype(np.int64)
        return pred

    def _seg_csq(self, name, vals):
        """VEP CSQ= / snpEff ANN= / bcftools BCSQ= structured segging
        (reference src/vcf_vep.c / vcf_snpeff.c role): value =
        "f0|f1|...|fP(,f0|...)*" — transcripts split on ',', fields on '|',
        one sub-context per field position (annotations repeat heavily per
        position: gene symbols, consequences, impacts). Rows whose
        transcripts don't all share the dominant pipe count P ride a
        tokenized exception stream behind a fit bitmap."""
        from ..seg import TOK_MARK
        n = len(vals)
        data = vals.data
        if n < 4 or data.shape[0] == 0 or (data == TOK_MARK).any():
            return None
        ctxs = {}
        # transcripts: split on ','
        ntr = ragged.count_sep_per_row(vals, ord(",")) + 1
        T = int(ntr.sum())
        tr_row = np.repeat(ragged.arange(n), ntr)
        cp = np.nonzero(data == ord(","))[0]
        base = np.concatenate([[0], np.cumsum(ntr - 1)])[:-1]
        tidx = ragged.arange(T) - np.concatenate([[0], np.cumsum(ntr)])[:-1][tr_row]
        ts = np.where(tidx == 0, vals.offsets[:-1][tr_row], 0)
        nz = np.nonzero(tidx > 0)[0]
        if nz.shape[0]:
            ts[nz] = cp[base[tr_row[nz]] + tidx[nz] - 1] + 1
        te = np.empty(T, np.int64)
        lastt = tidx == ntr[tr_row] - 1
        te[lastt] = vals.offsets[1:][tr_row[lastt]]
        nz = np.nonzero(~lastt)[0]
        if nz.shape[0]:
            te[nz] = cp[base[tr_row[nz]] + tidx[nz]]
        trs = ragged.gather_ranges(data, ts, te - ts)
        # dominant pipe count P
        np_pipe = ragged.count_sep_per_row(trs, ord("|"))
        cnts = np.bincount(np_pipe)
        P = int(np.argmax(cnts)) if cnts.shape[0] else 0
        if P == 0:
            return None
        tr_ok = np_pipe == P
        fit = vals.lens > 0
        np.logical_and.at(fit, tr_row, tr_ok)
        if fit.mean() <= 0.5:
            return None
        keep = fit[tr_row]
        ktrs = ragged.take(trs, np.nonzero(keep)[0])
        K = len(ktrs)
        # field bounds: pipe positions reshape (K, P)
        pp = np.nonzero(ktrs.data == ord("|"))[0].reshape(K, P)
        bounds = np.empty((K, P + 2), np.int64)
        bounds[:, 0] = ktrs.offsets[:-1]
        bounds[:, 1:P + 1] = pp + 1
        bounds[:, P + 1] = ktrs.offsets[1:] + 1
        ctxs[name + "_VB"] = VBCtx(name + "_VB", MODE_NUM,
                                   local=fit.astype(np.int64), cat="int")
        ctxs[name + "_VT"] = VBCtx(name + "_VT", MODE_NUM,
                                   local=ntr[fit], cat="int")
        ctxs[name + "_VP"] = VBCtx(name + "_VP", MODE_NUM,
                                   local=np.full(1, P, np.int64), cat="int")
        for p in range(P + 1):
            colp = ragged.gather_ranges(
                ktrs.data, bounds[:, p], bounds[:, p + 1] - 1 - bounds[:, p])
            ctxs.update(tokenizer_seg_col(f"{name}_V{p}", colp,
                                          single_stream=True))
        if (~fit).any():
            exc = ragged.take(vals, np.nonzero(~fit)[0])
            ctxs.update(tokenizer_seg_col(name + "_VX", exc,
                                          single_stream=True))
        return ctxs

    def _recon_csq(self, pctxs, name, n) -> Col:
        fit = pctxs[name + "_VB"].nums().astype(bool)
        ntr = pctxs[name + "_VT"].nums()
        P = int(pctxs[name + "_VP"].nums()[0])
        K = int(ntr.sum())
        cols = [tokenizer_recon_col(f"{name}_V{p}", pctxs, K)
                for p in range(P + 1)]
        trs = ragged.interleave(cols, sep_after=[b"|"] * P + [b","])
        # transcripts of a row are adjacent: row = bytes minus trailing ','
        tr_of = np.repeat(np.arange(ntr.shape[0]), ntr)
        row_lens = np.bincount(tr_of, weights=trs.lens,
                               minlength=ntr.shape[0]).astype(np.int64) - 1
        row_starts = trs.offsets[np.concatenate(
            [[0], np.cumsum(ntr)])[:-1]]
        fit_col = ragged.gather_ranges(trs.data, row_starts, row_lens)
        sub = [(np.nonzero(fit)[0], fit_col)]
        if (~fit).any():
            exc = tokenizer_recon_col(name + "_VX", pctxs, int((~fit).sum()))
            sub.append((np.nonzero(~fit)[0], exc))
        return ragged.merge_rows(n, sub)

    def _recon_info(self, pctxs, ng, pos_vals=None, dp_row=None) -> Col:
        from ..seg import TOK_MARK
        layout = pctxs["INFOL"].dict_take()
        ld = layout.data
        marks = np.nonzero(ld == TOK_MARK)[0]
        if marks.shape[0] == 0:
            return layout
        mrow = np.searchsorted(layout.offsets[1:], marks, side="right")
        # key of each mark: bytes between the previous ';'/row-start and '='
        # (mark is always preceded by '=')
        keq = marks - 1
        # find key start: previous ';' + 1 or row start
        semis = np.nonzero(ld == ord(";"))[0]
        si = np.searchsorted(semis, keq)
        prev_semi = np.where(si > 0,
                             semis[np.minimum(np.maximum(si - 1, 0),
                                              max(semis.shape[0] - 1, 0))]
                             if semis.shape[0] else -1, -1)
        row_start = layout.offsets[:-1][mrow]
        ks = np.maximum(prev_semi + 1, row_start)
        keys = ragged.gather_ranges(ld, ks, keq - ks)
        kw, kinv = dedup_col(keys)
        parts = []
        by_key = {}
        # AC last: its prediction needs AN's ints and AF's text (mirrors
        # the ZIP-side deferral — src/vcf_info.c AC/AN/AF relation)
        order = sorted(range(len(kw)), key=lambda w: kw.row(w) == b"AC")
        for w in order:
            key = kw.row(w)
            name = self._info_ctx_name(key)
            sel = np.nonzero(kinv == w)[0]
            pc = pctxs.get(name)
            if name + "_VB" in pctxs and name + "_VT" in pctxs:
                vcol = self._recon_csq(pctxs, name, sel.shape[0])
            elif pc is not None and pc.mode == MODE_NUM and pc.b250 is None:
                iv = pc.nums()
                if pc.param == 8 and dp_row is not None:
                    iv = iv + dp_row[mrow[sel]]
                elif pc.param == 9 and pos_vals is not None:
                    iv = iv + pos_vals[mrow[sel]]
                elif pc.param == 7:
                    f_of = mrow  # mark row of each field
                    iv = iv + self._ac_pred(ng, f_of, sel, by_key)
                vcol = ragged.itoa(iv)
                by_key[key] = (sel, vcol, iv)
                parts.append((sel, vcol))
                continue
            else:
                vcol = tokenizer_recon_col(name, pctxs, sel.shape[0])
            by_key[key] = (sel, vcol, None)
            parts.append((sel, vcol))
        val_col = ragged.merge_rows(marks.shape[0], parts)
        # splice values over marks
        piece_lens = np.ones(ld.shape[0], np.int64)
        piece_lens[marks] = val_col.lens
        dsto = np.concatenate([[0], np.cumsum(piece_lens)])
        out = np.empty(int(dsto[-1]), np.uint8)
        nonmark = np.ones(ld.shape[0], bool)
        nonmark[marks] = False
        out[dsto[:-1][nonmark]] = ld[nonmark]
        vl = val_col.lens
        tot = int(vl.sum())
        if tot:
            pos = ragged.arange(tot) - np.repeat(val_col.offsets[:-1], vl)
            out[np.repeat(dsto[:-1][marks], vl) + pos] = val_col.data
        extra = np.zeros(ng, np.int64)
        np.add.at(extra, mrow, val_col.lens - 1)
        new_lens = layout.lens + extra
        return Col(out, np.concatenate([[0], np.cumsum(new_lens)]))

    @staticmethod
    def _comma_ints(col):
        """Parse each row as a comma-separated int list in the host runtime
        (`native.int_list_parse`). Returns (flat_vals, seg_row,
        vals_per_row, ok_row); ok_row marks rows that are exactly
        int(,int)* with canonical items — only their values are in
        flat_vals, and vals_per_row is 0 elsewhere. A 0x01 byte anywhere
        fails every row, as in `_comma_ints_np`."""
        from ..seg import TOK_MARK
        n = len(col)
        if col.data.shape[0] and (col.data == TOK_MARK).any():
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(n, np.int64), np.zeros(n, bool))
        vals, nv, ok = native.int_list_parse(col.data, col.offsets)
        return vals, np.repeat(ragged.arange(n), nv), nv, ok

    @staticmethod
    def _comma_ints_np(col):
        """_comma_ints in numpy (one tokenizer scan): vals and seg_row also
        hold the kept tokens of the rows that fail, and vals_per_row counts
        them."""
        from ..seg import tokenize_col, TOK_MARK
        n = len(col)
        if col.data.shape[0] and (col.data == TOK_MARK).any():
            # a literal 0x01 byte desyncs tok_row vs the vals stream
            # (tokenizer_seg_col guards this with its verbatim fallback;
            # here the whole trial just bails)
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(n, np.int64), np.zeros(n, bool))
        nseg = ragged.count_sep_per_row(col, ord(",")) + 1
        tmpl_data, tmpl_lens, vals, _tok, wid = tokenize_col(
            col.data, col.offsets, 1 << 62)
        toff = np.concatenate([[0], np.cumsum(tmpl_lens)])
        tmpl_col = Col(tmpl_data, toff)
        kept = ragged.count_sep_per_row(tmpl_col, TOK_MARK)
        ok_row = (kept == nseg) & (tmpl_lens == 2 * nseg - 1) & \
            (col.lens > 0)
        # zero-padded ints are now tokenized (width-tagged) — but the
        # int-list columns store bare values, so rows with a non-canonical
        # token must stay on the exception path
        wi = wid.astype(np.int64)
        canon = (wi <= 1) | (vals >= 10 ** np.maximum(wi - 1, 0))
        if not canon.all():
            tok_row = np.repeat(ragged.arange(n), kept)
            ok_row[tok_row[~canon]] = False
        # byte-pattern check ("\x01(,\x01)*") on the UNIQUE templates only —
        # cells share a handful of shapes, so this is a tiny python loop
        # instead of a per-byte pass over millions of cells
        uw, inv = dedup_col(tmpl_col)
        pat_ok = np.zeros(len(uw), bool)
        for w in range(len(uw)):
            r = uw.row(w)
            pat_ok[w] = (len(r) % 2 == 1 and
                         all(b == TOK_MARK for b in r[0::2]) and
                         all(b == ord(",") for b in r[1::2]))
        ok_row &= pat_ok[inv]
        f_of = np.repeat(ragged.arange(n), kept)
        return vals, f_of, kept, ok_row

    @staticmethod
    def _int_list_stats(col):
        """native.int_list_stats of the rows; every row fails where the
        column holds a 0x01 byte, as in `_comma_ints_np`."""
        from ..seg import TOK_MARK
        if col.data.shape[0] and (col.data == TOK_MARK).any():
            n = len(col)
            big = np.full(n, np.iinfo(np.int64).max)
            return (np.zeros(n, np.int64), big, big.copy(),
                    np.zeros(n, np.int32), np.zeros(n, bool))
        return native.int_list_stats(col.data, col.offsets)

    @classmethod
    def _ad_sums(cls, col):
        """Per-row sum of a comma-int list (AD); pred for DP
        (reference src/vcf_gatk.c: DP == sum of AD in GATK output)."""
        sums, _m1, _m2, _nv, ok = cls._int_list_stats(col)
        return sums, ok

    @classmethod
    def _ad_sums_np(cls, col):
        """_ad_sums in numpy."""
        vals, f_of, _nseg, ok = cls._comma_ints_np(col)
        sums = np.bincount(f_of, weights=np.where(ok[f_of], vals, 0),
                           minlength=len(col)).astype(np.int64)
        return np.where(ok, sums, 0), ok

    @classmethod
    def _pl_gq(cls, col):
        """GATK GQ prediction: second-lowest PL minus lowest, capped at 99
        (reference src/vcf_gatk.c GQ-from-PL)."""
        _s, m1, m2, nv, ok = cls._int_list_stats(col)
        ok = ok & (nv >= 2)
        return np.where(ok, np.minimum(m2 - m1, 99), 0), ok

    @classmethod
    def _pl_gq_np(cls, col):
        """_pl_gq in numpy: per-row mins via reduceat, no global sort."""
        n = len(col)
        vals, f_of, nseg, ok = cls._comma_ints_np(col)
        ok &= nseg >= 2
        pred = np.zeros(n, np.int64)
        if vals.shape[0] == 0 or not ok.any():
            return pred, ok
        BIG = np.int64(1) << 60
        first = np.concatenate([[0], np.cumsum(nseg)])[:-1]
        vp = np.concatenate([vals, [BIG]])
        idx = np.minimum(first, vals.shape[0])
        m1 = np.minimum.reduceat(vp, idx)
        # second-lowest: min with the FIRST occurrence of the row min masked
        ismin = vals == m1[f_of]
        prior = np.cumsum(ismin) - ismin
        base = prior[np.minimum(first, max(vals.shape[0] - 1, 0))] \
            if vals.shape[0] else prior
        firstmin = ismin & (prior - base[f_of] == 0)
        v2 = np.concatenate([np.where(firstmin, BIG, vals), [BIG]])
        m2 = np.minimum.reduceat(v2, idx)
        pred = np.where(ok, np.minimum(m2 - m1, 99), 0)
        return pred, ok

    @staticmethod
    def _ilist_pred0(s: np.ndarray, d: np.ndarray) -> np.ndarray:
        """Predicted first item of a comma-int list from its sum and the
        cell's GT dosage (reference src/vcf_samples.c AD model): hom-ref
        cells put everything in item 0, hets split evenly, hom-alt cells
        put nothing there. Exact-int at both ends."""
        return np.select([d == 0, d == 1, d == 2],
                         [s, s - s // 2, np.zeros_like(s)], 0)

    def _seg_int_list(self, name, vals, dos):
        """Column decomposition of a comma-int-list tag: per-row sum (the
        real entropy) + first-item delta vs the dosage-share prediction +
        middle items raw; the LAST item is derived (sum minus the rest).
        Rows not matching int(,int)xR ride a tokenizer exception stream
        behind a fit bitmap. Returns ctxs dict or None."""
        n = len(vals)
        if n < 8:
            return None
        flat, f_of, nseg, ok = self._comma_ints(vals)
        if not ok.any():
            return None
        cnt = np.bincount(nseg[ok])
        R = int(np.argmax(cnt))
        ok = ok & (nseg == R)
        if R < 2 or R > 8 or ok.mean() < 0.7:
            return None
        sel = np.nonzero(ok)[0]
        M = flat[ok[f_of]].reshape(-1, R)
        s = M.sum(axis=1)
        d = dos[sel]
        ctxs = {
            name + "LR": VBCtx(name + "LR", MODE_NUM,
                               local=np.full(1, R, np.int64), cat="int"),
            name + "LF": VBCtx(name + "LF", MODE_NUM,
                               local=ok.astype(np.int64), cat="int"),
            name + "LS": VBCtx(name + "LS", MODE_NUM, local=s, cat="int"),
            name + "LD0": VBCtx(name + "LD0", MODE_NUM,
                                local=M[:, 0] - self._ilist_pred0(s, d),
                                cat="int"),
        }
        for k in range(1, R - 1):
            ctxs[name + f"LD{k}"] = VBCtx(name + f"LD{k}", MODE_NUM,
                                          local=M[:, k], cat="int")
        if (~ok).any():
            exc = ragged.take(vals, np.nonzero(~ok)[0])
            ctxs.update(tokenizer_seg_col(name + "LX", exc,
                                          single_stream=True))
        return ctxs

    def _recon_int_list(self, pctxs, name, dos) -> Col:
        okb = pctxs[name + "LF"].nums().astype(bool)
        R = int(pctxs[name + "LR"].nums()[0])
        s = pctxs[name + "LS"].nums()
        d = dos[okb]
        cols = [pctxs[name + "LD0"].nums() + self._ilist_pred0(s, d)]
        for k in range(1, R - 1):
            cols.append(pctxs[name + f"LD{k}"].nums())
        cols.append(s - np.sum(cols, axis=0))
        col = ragged.interleave([ragged.itoa(c) for c in cols],
                                sep_after=[b","] * (R - 1) + [None])
        if (~okb).any():
            exc = tokenizer_recon_col(name + "LX", pctxs, int((~okb).sum()))
            col = ragged.merge_rows(
                okb.shape[0], [(np.nonzero(okb)[0], col),
                               (np.nonzero(~okb)[0], exc)])
        return col

    @staticmethod
    def _cell_fields(cells, T):
        """Split each sample cell on ':' into its FORMAT fields, in one pass
        of the host runtime -> (fields per cell, 0 where the cell is empty
        or has more than T; those cells' mask; {t: the cells with a field
        t}; {t: their field t})."""
        f_start, f_len, nf = native.split_fields(cells.data, cells.offsets,
                                                 ord(":"), T)
        ncnt = nf.astype(np.int64)
        bad = (ncnt > T) | (cells.lens == 0)
        ncnt = np.where(bad, 0, ncnt)
        sel_by_t, vals_by_t = {}, {}
        for t in range(T):
            sel = np.nonzero(ncnt > t)[0]
            if sel.shape[0]:
                sel_by_t[t] = sel
                vals_by_t[t] = ragged.gather_ranges(
                    cells.data, f_start[t][sel],
                    f_len[t][sel].astype(np.int64))
        return ncnt, bad, sel_by_t, vals_by_t

    @staticmethod
    def _cell_fields_np(cells, T):
        """_cell_fields in numpy, from the colon positions."""
        data = cells.data
        ncol = ragged.count_sep_per_row_np(cells, ord(":"))
        ncnt = ncol + 1
        bad = (ncnt > T) | (cells.lens == 0)
        ncnt = np.where(bad, 0, ncnt)
        cp = np.nonzero(data == ord(":"))[0]
        fc = np.concatenate([[0], np.cumsum(ncol)])  # first colon of cell
        cpx = np.concatenate([cp, [0]])  # safe index
        sel_by_t, vals_by_t = {}, {}
        for t in range(T):
            sel = np.nonzero(ncnt > t)[0]
            if sel.shape[0] == 0:
                continue
            st = np.where(t == 0, cells.offsets[:-1][sel],
                          cpx[fc[sel] + t - 1] + 1)
            en = np.where(ncnt[sel] - 1 == t, cells.offsets[1:][sel],
                          cpx[np.minimum(fc[sel] + t, cp.shape[0] - 1
                                         if cp.shape[0] else 0)])
            vals_by_t[t] = ragged.gather_ranges(data, st, en - st)
            sel_by_t[t] = sel
        return ncnt, bad, sel_by_t, vals_by_t

    def _seg_samples(self, ctxs, fmt_col, cells, S):
        """Per-FORMAT-tag sample sub-contexts (reference parity:
        src/vcf_samples.c:1601 per-tag contexts + transpose). Requires one
        FORMAT word per VB; each cell splits on ':' into per-tag streams
        (trailing tags may be dropped per spec — a per-cell count stream
        handles ragged cells). GT goes through the PBWT haplotype transform
        (src/codec_pbwt.c, src/vcf_format_GT.c) with per-cell exceptions.
        `cells` arrive sample-major (all rows of sample 0, then 1, ...)."""
        uw, _inv = dedup_col(fmt_col)
        if len(uw) != 1:
            return False
        tags = uw.row(0).split(b":")
        T = len(tags)
        if T == 0 or T > self.MAX_FMT_TAGS or any(len(t) == 0 for t in tags):
            return False
        C = len(cells)
        ncnt, bad, sel_by_t, vals_by_t = self._cell_fields(cells, T)
        if bad.any():
            uwx, invx = dedup_col(ragged.take(cells, np.nonzero(bad)[0]))
            ctxs["SMPEXC"] = VBCtx("SMPEXC", MODE_DICT, b250=invx,
                                   vb_words=uwx, cat="text")
        if bad.any() or (ncnt != T).any():
            ctxs["SMPNC"] = VBCtx("SMPNC", MODE_NUM, local=ncnt.astype(np.int64),
                                  cat="int")
        # GATK cross-tag predictions (src/vcf_gatk.c:915 analog): per-cell
        # DP pred = sum(AD), GQ pred = 2nd-lowest PL - lowest, capped 99.
        # Both are recomputed at PIZ from the reconstructed AD/PL streams.
        dp_pred = gq_pred = None
        if b"AD" in tags and tags.index(b"AD") in vals_by_t:
            ta = tags.index(b"AD")
            s_, ok_ = self._ad_sums(vals_by_t[ta])
            dp_pred = np.zeros(C, np.int64)
            dp_pred[sel_by_t[ta]] = np.where(ok_, s_, 0)
        if b"PL" in tags and tags.index(b"PL") in vals_by_t:
            tp = tags.index(b"PL")
            p_, ok_ = self._pl_gq(vals_by_t[tp])
            gq_pred = np.zeros(C, np.int64)
            gq_pred[sel_by_t[tp]] = np.where(ok_, p_, 0)
        # mux by dosage (reference src/vcf_samples.c seg_mux_init
        # VCF_SPECIAL_MUX_BY_DOSAGE, applied to PL/GL/DS/GP/AD/...):
        # each non-GT tag's cells are stored grouped by the cell's GT
        # dosage (0 / 1 / 2 / other) — within a dosage channel the value
        # distribution is far tighter (hom-ref PL starts with 0, het AD is
        # balanced, ...). The permutation costs NO side data: PIZ
        # recomputes the dosage from the reconstructed GT.
        tg = tags.index(b"GT") if b"GT" in tags else None
        dosage = np.full(C, 3, np.int8)
        if tg is not None and tg in vals_by_t:
            dosage[sel_by_t[tg]] = self._gt_dosage(vals_by_t[tg])
        # per-cell DP value for the dosage x DP mux of likelihood vectors
        # (reference VCF_SPECIAL_MUX_BY_DOSAGExDP for PL under --best)
        td = tags.index(b"DP") if b"DP" in tags else None
        dpv_cell = None
        if td is not None and td in vals_by_t:
            ivd, iokd = ragged.atoi(vals_by_t[td])
            dpv_cell = np.zeros(C, np.int64)
            dpv_cell[sel_by_t[td]] = np.where(iokd, ivd, 0)
        for t, vals in vals_by_t.items():
            sel = sel_by_t[t]
            name = f"FS{t}"
            if tags[t] == b"GT" and sel.shape[0] == C and \
                    self._seg_gt_pbwt(ctxs, vals, C // S, S, name):
                continue
            mux = None
            if tg is not None and t != tg:
                # int8/uint16 keys keep numpy's stable argsort on the
                # O(n) radix path; the DP-mux key packs dosage(2b)+DP(14b,
                # clamped) into u16 — identical at ZIP and PIZ
                key = dosage[sel]
                if tags[t] in (b"PL", b"GL", b"GP", b"GQ") and \
                        dpv_cell is not None:
                    key = (key.astype(np.uint16) << 14) | np.minimum(
                        np.abs(dpv_cell[sel]), 16383).astype(np.uint16)
                if key.shape[0] > 2 and (key != key[0]).any():
                    mux = np.argsort(key, kind="stable")
                    vals = ragged.take(vals, mux)
            iv, iok = ragged.atoi(vals)
            if vals.data.shape[0] and not iok.all():
                # comma-int-list tag (AD/PL/...): try sum+share column
                # decomposition (reference src/vcf_samples.c AD prediction:
                # the list's sum carries the entropy, each item is a
                # dosage-determined share of it, the last item is derived).
                # Trial-both ONCE per file per tag, like the CSQ choice.
                dsel = dosage[sel]
                if mux is not None:
                    dsel = dsel[mux]
                memo = getattr(self, "_ilist_choice", None)
                if memo is None:
                    memo = self._ilist_choice = {}
                choice = memo.get(name)
                if choice is None and self._seg_lazy_frozen:
                    choice = "tok"   # no trial-commit under concurrency
                cand = self._seg_int_list(name, vals, dsel) \
                    if choice in (None, "ilist") else None
                if cand is not None and choice is None:
                    tok = tokenizer_seg_col(name, vals, single_stream=True)
                    if est_ctxs_size(cand) < est_ctxs_size(tok):
                        memo[name] = choice = "ilist"
                    else:
                        memo[name] = choice = "tok"
                        ctxs.update(tok)
                        continue
                elif choice is None:
                    memo[name] = choice = "tok"
                if cand is not None and choice == "ilist":
                    ctxs.update(cand)
                    continue
            if vals.data.shape[0] and iok.all():
                if tags[t] == b"DP" and dp_pred is not None:
                    pred = dp_pred[sel]
                    ctxs[name] = VBCtx(name, MODE_NUM,
                                       local=iv - (pred[mux] if mux is not None
                                                   else pred),
                                       cat="int", param=8)
                elif tags[t] == b"GQ" and gq_pred is not None:
                    pred = gq_pred[sel]
                    ctxs[name] = VBCtx(name, MODE_NUM,
                                       local=iv - (pred[mux] if mux is not None
                                                   else pred),
                                       cat="int", param=9)
                else:
                    ctxs[name] = VBCtx(name, MODE_NUM, local=iv, cat="int")
            else:
                ctxs.update(tokenizer_seg_col(name, vals, single_stream=True))
        # per-ROW sum of FORMAT DP cells — feeds the INFO DP prediction
        # (src/vcf_gatk.c INFO/DP == sum of sample DPs in GATK output);
        # cells are sample-major, so row = cell_index mod ng
        if dpv_cell is not None and S > 0:
            ng = C // S
            rows_of_cell = ragged.arange(C) % ng
            return np.bincount(rows_of_cell, weights=dpv_cell,
                               minlength=ng).astype(np.int64)
        return None

    @staticmethod
    def _gt_dosage(col) -> np.ndarray:
        """Per-cell GT dosage channel: 0/1/2 alt alleles for clean diploid
        single-char genotypes, 3 otherwise (missing, multiallelic text,
        haploid). Computed identically at ZIP (original GT text) and PIZ
        (reconstructed GT text) — the mux permutation needs no side data."""
        mat, lens = ragged.to_matrix(col)
        n = len(col)
        w = mat.shape[1]
        z = np.zeros(n, np.uint8)
        a1 = mat[:, 0] if w > 0 else z
        sep = mat[:, 1] if w > 1 else z
        a2 = mat[:, 2] if w > 2 else z
        num1 = (a1 >= ord("0")) & (a1 <= ord("9"))
        num2 = (a2 >= ord("0")) & (a2 <= ord("9"))
        ok = (lens == 3) & num1 & num2 & \
            ((sep == ord("/")) | (sep == ord("|")))
        d = (a1 != ord("0")).astype(np.int8) + (a2 != ord("0")).astype(np.int8)
        return np.where(ok, d, 3).astype(np.int8)

    def _seg_gt_pbwt(self, ctxs, vals, n, S, name):
        """PBWT the GT subfields when they're diploid single-char alleles
        (vals: sample-major n*S rows). Cells deviating from the `a<sep>b`
        pattern ride a per-cell exception bitmap + tokenizer channel; the
        PBWT matrix gets placeholders."""
        mat, lens = ragged.to_matrix(vals)
        if mat.shape[1] < 3:
            return False
        a1, sep, a2 = mat[:, 0], mat[:, 1], mat[:, 2]
        is_allele = ((a1 >= ord("0")) & (a1 <= ord("9"))) | (a1 == ord("."))
        is_allele2 = ((a2 >= ord("0")) & (a2 <= ord("9"))) | (a2 == ord("."))
        good = (lens == 3) & is_allele & is_allele2 & \
            ((sep == ord("/")) | (sep == ord("|")))
        if good.mean() < 0.5:
            return False  # mostly non-diploid: generic path wins
        conv = lambda c: np.where(c == ord("."), 10, c - ord("0")).astype(np.uint8)
        # cells are sample-major: reshape (S, n) then transpose to (n, 2S)
        A = np.empty((n, 2 * S), dtype=np.uint8)
        a1m = np.where(good, conv(a1), 10).reshape(S, n)
        a2m = np.where(good, conv(a2), 10).reshape(S, n)
        ph = np.where(good, (sep == ord("|")).astype(np.uint8), 0).reshape(S, n)
        A[:, 0::2] = a1m.T
        A[:, 1::2] = a2m.T
        with profiler.timer("zip:pbwt"):
            Y = pbwt_encode(A)
        ctxs["PBWT"] = VBCtx("PBWT", MODE_NUM,
                             local=Y.reshape(-1).astype(np.int64), cat="pbwt")
        ctxs["GTPHASE"] = VBCtx("GTPHASE", MODE_NUM,
                                local=ph.reshape(-1).astype(np.int64),
                                cat="int")
        if (~good).any():
            ctxs["GTEXC"] = VBCtx("GTEXC", MODE_NUM,
                                  local=(~good).astype(np.int64), cat="int")
            exc = ragged.take(vals, np.nonzero(~good)[0])
            ctxs.update(tokenizer_seg_col(name, exc, single_stream=True))
        return True

    @staticmethod
    def _join_cells_np(subs, sub_off, nsub, C):
        """Each cell's subfields joined with ':', in numpy (the oracle of
        native.join_cells)."""
        total_subs = len(subs)
        last_of_cell = np.zeros(total_subs, bool)
        if total_subs:
            last_of_cell[sub_off[1:][nsub > 0] - 1] = True
        piece_lens = subs.lens + (~last_of_cell)
        dst = np.concatenate([[0], np.cumsum(piece_lens)])
        out = np.empty(int(dst[-1]), np.uint8)
        sep_at = dst[:-1][~last_of_cell] + subs.lens[~last_of_cell]
        out[sep_at] = ord(":")
        tot = int(subs.lens.sum())
        if tot:
            pos = ragged.arange(tot) - np.repeat(subs.offsets[:-1],
                                                 subs.lens)
            out[np.repeat(dst[:-1], subs.lens) + pos] = subs.data
        cell_lens = np.zeros(C, np.int64)
        if total_subs:
            sub_cell = np.repeat(ragged.arange(C), nsub)
            cell_lens = np.bincount(sub_cell, weights=piece_lens,
                                    minlength=C).astype(np.int64)
        return Col(out, np.concatenate([[0], np.cumsum(cell_lens)]))

    def _recon_samples(self, pctxs, ng, nf):
        """Rebuild the sample matrix from per-tag contexts."""
        fmt = pctxs["FORMAT"].dict_take()
        S = nf - 9
        C = ng * S
        tags = (fmt.row(0) if ng else b"").split(b":")
        T = len(tags)
        if "SMPNC" in pctxs:
            ncnt = pctxs["SMPNC"].nums()
        else:
            ncnt = np.full(C, T, np.int64)
        bad = ncnt == 0
        # subfield slots per cell
        nsub = np.maximum(ncnt, 0)
        sub_off = np.concatenate([[0], np.cumsum(nsub)])
        total_subs = int(sub_off[-1])
        parts = []
        cols_by_t, cells_by_t = {}, {}
        # dependency order (src/vcf_samples.c MUX_BY_DOSAGE /
        # MUX_BY_DOSAGExDP + the GATK cross-tag predictions): GT's text
        # drives every de-mux; DP's delta needs AD; PL's mux needs DP;
        # GQ's delta needs PL
        tg = tags.index(b"GT") if b"GT" in tags else None
        order = list(range(T))
        for dep in (b"PL", b"DP", b"AD"):
            if dep in tags:
                order.remove(tags.index(dep))
                order = [tags.index(dep)] + order
        if tg is not None:
            order.remove(tg)
            order = [tg] + order
        dosage = np.full(C, 3, np.int8)
        td = tags.index(b"DP") if b"DP" in tags else None
        dpv_cell = None
        dp_pred = gq_pred = None
        for t in order:
            cells_t = np.nonzero(ncnt > t)[0]
            if cells_t.shape[0] == 0:
                continue
            cells_by_t[t] = cells_t
            name = f"FS{t}"
            pc = pctxs.get(name)
            mux = None
            if tg is not None and t != tg:
                # int8 key keeps the stable argsort on numpy's O(n)
                # radix path (same ORDER as the int64 form — only the
                # sort algorithm differs, so ZIP/PIZ stay compatible)
                key = dosage[cells_t]
                if tags[t] in (b"PL", b"GL", b"GP", b"GQ") and td is not None \
                        and td in cols_by_t:
                    if dpv_cell is None:
                        ivd, iokd = ragged.atoi(cols_by_t[td])
                        dpv_cell = np.zeros(C, np.int64)
                        dpv_cell[cells_by_t[td]] = np.where(iokd, ivd, 0)
                    key = (key.astype(np.uint16) << 14) | np.minimum(
                        np.abs(dpv_cell[cells_t]), 16383).astype(np.uint16)
                if key.shape[0] > 2 and (key != key[0]).any():
                    mux = np.argsort(key, kind="stable")
            if tags[t] == b"GT" and "PBWT" in pctxs:
                col = self._recon_gt_cells(pctxs, ng, S, name)
            elif name + "LS" in pctxs:
                dsel = dosage[cells_t]
                if mux is not None:
                    dsel = dsel[mux]
                col = self._recon_int_list(pctxs, name, dsel)
            elif pc is not None and pc.mode == MODE_NUM:
                local = pc.local.astype(np.int64)
                if mux is not None:
                    inv = np.empty_like(mux)
                    inv[mux] = np.arange(mux.shape[0])
                    local = local[inv]
                    mux = None
                if pc.param == 8:     # DP = delta + sum(AD)
                    if dp_pred is None:
                        ta = tags.index(b"AD")
                        s_, ok_ = self._ad_sums(cols_by_t[ta])
                        dp_pred = np.zeros(C, np.int64)
                        dp_pred[cells_by_t[ta]] = np.where(ok_, s_, 0)
                    local = local + dp_pred[cells_t]
                elif pc.param == 9:   # GQ = delta + GQ-from-PL
                    if gq_pred is None:
                        tp = tags.index(b"PL")
                        p_, ok_ = self._pl_gq(cols_by_t[tp])
                        gq_pred = np.zeros(C, np.int64)
                        gq_pred[cells_by_t[tp]] = np.where(ok_, p_, 0)
                    local = local + gq_pred[cells_t]
                elif pc.param == 1:
                    local = np.cumsum(local)
                col = ragged.itoa(local)
            else:
                col = tokenizer_recon_col(name, pctxs, cells_t.shape[0])
            if mux is not None:
                inv = np.empty_like(mux)
                inv[mux] = np.arange(mux.shape[0])
                col = ragged.take(col, inv)
            cols_by_t[t] = col
            if t == tg:
                dosage[cells_t] = self._gt_dosage(col)
        for t, col in cols_by_t.items():
            parts.append((sub_off[:-1][cells_by_t[t]] + t, col))
        subs = ragged.merge_rows(total_subs, parts)
        # join each cell's subfields with ':' (one pass in the host runtime)
        cells = Col(*native.join_cells(subs.data, subs.offsets, nsub,
                                       ord(":")))
        if bad.any():
            cells = ragged.merge_rows(
                C, [(np.nonzero(~bad)[0], ragged.take(cells, np.nonzero(~bad)[0])),
                    (np.nonzero(bad)[0], pctxs["SMPEXC"].dict_take())])
        # per-row FORMAT DP sum for the INFO DP prediction (mirrors the
        # ZIP-side computation in _seg_samples exactly)
        dp_row = None
        if td is not None and td in cols_by_t:
            if dpv_cell is None:
                ivd, iokd = ragged.atoi(cols_by_t[td])
                dpv_cell = np.zeros(C, np.int64)
                dpv_cell[cells_by_t[td]] = np.where(iokd, ivd, 0)
            rows_of_cell = ragged.arange(C) % ng
            dp_row = np.bincount(rows_of_cell, weights=dpv_cell,
                                 minlength=ng).astype(np.int64)
        # sample-major cells -> per-sample columns -> tab-joined rows
        cols = [ragged.take(cells, ragged.arange(ng) + s * ng)
                for s in range(S)]
        return ragged.interleave(
            cols, sep_after=[b"\t"] * (S - 1) + [None]), dp_row

    def _recon_gt_cells(self, pctxs, ng, S, name):
        """Sample-major GT subfield column from PBWT + phase + exceptions."""
        Y = pctxs["PBWT"].nums().astype(np.uint8).reshape(ng, 2 * S)
        with profiler.timer("piz:pbwt"):
            A = pbwt_decode(Y)
        phase = pctxs["GTPHASE"].nums().astype(np.uint8).reshape(S, ng)
        unconv = lambda c: np.where(c == 10, ord("."), c + ord("0")).astype(np.uint8)
        gt3 = np.empty((S, ng, 3), dtype=np.uint8)
        gt3[:, :, 0] = unconv(A[:, 0::2].T)
        gt3[:, :, 1] = np.where(phase == 1, ord("|"), ord("/"))
        gt3[:, :, 2] = unconv(A[:, 1::2].T)
        col = Col.from_fixed(gt3.reshape(ng * S, 3))
        if "GTEXC" in pctxs:
            excm = pctxs["GTEXC"].nums().astype(bool)
            exc_idx = np.nonzero(excm)[0]
            exc = tokenizer_recon_col(name, pctxs, exc_idx.shape[0])
            col = ragged.merge_rows(
                ng * S, [(np.nonzero(~excm)[0],
                          ragged.take(col, np.nonzero(~excm)[0])),
                         (exc_idx, exc)])
        return col

    def recon_vb(self, pctxs: dict, meta: dict) -> bytes:
        n = meta["num_lines"]
        nf = meta["nf"]
        gd = pctxs["VARIANT"].nums()
        good_idx = np.nonzero(gd == 0)[0]
        exc_idx = np.nonzero(gd == 1)[0]
        ng = good_idx.shape[0]

        cols, seps = [], []
        if ng:
            # samples first: the INFO DP prediction (src/vcf_gatk.c) needs
            # the per-row FORMAT DP sum before INFO is reconstructed
            smp_col = dp_row = None
            if nf > 9:
                if "SMP" in pctxs:
                    smp_col = tokenizer_recon_col("SMP", pctxs, ng)
                else:
                    smp_col, dp_row = self._recon_samples(pctxs, ng, nf)
            pos_vals = None
            if "POS" in pctxs and pctxs["POS"].mode == MODE_NUM:
                pos_vals = pctxs["POS"].nums()
            names = ["CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
                     "INFO", "FORMAT"][:min(nf, 9)]
            for fname in names:
                if fname == "REF" and "REFSAME" in pctxs:
                    cols.append(self._recon_ref_vs_genome(
                        pctxs, cols[0], cols[1], ng))
                elif fname in ("CHROM", "REF", "ALT", "FILTER", "FORMAT"):
                    cols.append(pctxs[fname].dict_take())
                elif fname == "POS" and pos_vals is not None:
                    cols.append(ragged.itoa(pos_vals))
                elif fname == "ID" and "IDB" in pctxs:
                    cols.append(self._recon_id(pctxs, pos_vals, ng))
                elif fname == "INFO" and "INFOL" in pctxs:
                    cols.append(self._recon_info(pctxs, ng,
                                                 pos_vals=pos_vals,
                                                 dp_row=dp_row))
                else:
                    cols.append(tokenizer_recon_col(fname, pctxs, ng))
                seps.append(b"\t")
            if smp_col is not None:
                cols.append(smp_col)
                seps.append(None)
            else:
                seps[-1] = None
            glines = ragged.interleave(cols, sep_after=seps)
        else:
            glines = Col.from_list([])

        parts = [(good_idx, glines)]
        if exc_idx.shape[0]:
            parts.append((exc_idx, pctxs["EXC"].dict_take()))
        lines = ragged.merge_rows(n, parts)
        out = ragged.interleave([lines], sep_after=[b"\n"])
        raw = out.data.tobytes()
        if meta.get("no_final_nl"):
            raw = raw[:-1]
        return raw
