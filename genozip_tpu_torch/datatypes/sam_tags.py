"""Mapper/platform-specific AUX tag prediction (whole-VB vectorized).

Reference parity: the reference dedicates ~25 per-mapper files to aux-tag
prediction (src/sam_bwa.c:423 XA/AS/XS, src/sam_minimap2.c ms/s1,
src/sam_10xGenomics.c:991 CB/CR/UB/UR/CY/UY barcode machinery,
src/sam_bismark.c XM/XR/XG, src/sam_fields.c generic routing). Those are
per-line C callbacks; here every predictor is a whole-VB numpy pass over
ragged columns, and every prediction is guarded by a per-row fit bitmap so
a wrong guess only costs ratio, never correctness.

Predictor families:
- score family: AS:i stored as delta vs the row's SEQ length (BWA's AS ==
  read length for a perfect match, src/sam_bwa.c sam_seg_AS_field); XS:i /
  ms:i / s1:i / ZS:i stored as delta vs the row's AS (sub-optimal scores
  track the optimal one).
- XA:Z (BWA alternative hits "rname,±pos,cigar,nm;..."): structured into
  per-alt sub-contexts — rname dict, strand bit, pos delta vs the row POS,
  cigar dict, NM ints — instead of one opaque string (src/sam_bwa.c:423).
- 10x barcodes: CB:Z/UB:Z (corrected) go to verbatim dicts (cell barcodes
  repeat across a VB); CR:Z is predicted from CB:Z minus its "-N" suffix,
  UR:Z from UB:Z; CY:Z/UY:Z/QT:Z are quality strings routed to the QUAL
  codec family with their own length stream (src/sam_10xGenomics.c).
- Bismark XM:Z (methylation call string, same length as SEQ) rides the
  QUAL codec path with lengths predicted from SEQ; XR:Z/XG:Z are tiny
  dicts (src/sam_bismark.c).
"""

import numpy as np

from ..utils import ragged
from ..utils.ragged import Col
from ..contexts import VBCtx, MODE_DICT, MODE_NUM, MODE_TXT, dedup_col
from ..seg import tokenizer_seg_col, tokenizer_recon_col

# Z-tags whose values repeat heavily -> verbatim dict (param=5 makes
# tokenizer_recon_col return the dict words untouched)
DICT_Z_TAGS = {b"CB", b"BX", b"RX", b"GX", b"GN", b"TX", b"AN", b"UB",
               b"XR", b"XG", b"RG", b"LB", b"SM", b"BC", b"MI", b"CO"}
# Z-tags holding phred strings -> QUAL codec family + length stream
QUAL_Z_TAGS = {b"CY", b"UY", b"QT", b"QX", b"BZ"}
# i-tags stored as delta vs the row's AS:i
AS_DELTA_TAGS = {b"XS", b"ZS", b"ms", b"s1"}

PARAM_AS_VS_SEQLEN = 6   # AS:i = local + seq_len(row)
PARAM_VS_AS = 7          # tag:i = local + AS(row)
PARAM_VS_MATE_AS = 10    # tag:i = local + AS(mate row) (bowtie2 YS)


def sa_pred_seg(name: str, vals: Col, pred_by_row: Col,
                rows_t: np.ndarray) -> dict:
    """SA:Z of a DEPN row leads with its primary's composed entry
    'rname,pos,strand,cigar,mapq,nm;' (reference src/sam_sag.c SAG_BY_SA):
    store a per-row fit bitmap + only the remainder after the predicted
    prefix. The prefix is recomputed at PIZ from the SAG store."""
    from ..utils.ragged import cols_equal_rows
    pred = ragged.take(pred_by_row, rows_t)
    can = (pred.lens > 0) & (vals.lens >= pred.lens)
    head = ragged.gather_ranges(vals.data, vals.offsets[:-1],
                                np.where(can, pred.lens, 0))
    # compare only rows where the prefix could fit (others have empty head)
    eq = can & cols_equal_rows(head, pred)
    rest_start = vals.offsets[:-1] + np.where(eq, pred.lens, 0)
    rest = ragged.gather_ranges(vals.data, rest_start,
                                vals.offsets[1:] - rest_start)
    out = {name + "P": VBCtx(name + "P", MODE_NUM,
                             local=eq.astype(np.int64), cat="int")}
    out.update(tokenizer_seg_col(name, rest, single_stream=True))
    return out


def sa_pred_recon(name: str, pctxs, pred_by_row: Col,
                  rows_t: np.ndarray) -> Col:
    eq = pctxs[name + "P"].nums().astype(bool)
    rest = tokenizer_recon_col(name, pctxs, rows_t.shape[0])
    pred = ragged.take(pred_by_row, rows_t)
    pm = ragged.gather_ranges(pred.data, pred.offsets[:-1],
                              np.where(eq, pred.lens, 0))
    return ragged.interleave([pm, rest])


def dict_seg(name: str, vals: Col) -> dict:
    uw, inv = dedup_col(vals)
    return {name: VBCtx(name, MODE_DICT, b250=inv, vb_words=uw,
                        cat="b250", param=5)}


def qualstr_seg(name: str, vals: Col) -> dict:
    """Phred-string tag: byte payload through the QUAL codec family plus a
    delta-coded length stream."""
    return {
        name: VBCtx(name, MODE_TXT, local=vals.data, cat="qual"),
        name + "L": VBCtx(name + "L", MODE_NUM,
                          local=np.diff(vals.lens, prepend=np.int64(0)),
                          cat="int", param=1),
    }


def qualstr_recon(name: str, pctxs) -> Col:
    lens = pctxs[name + "L"].nums()
    return pctxs[name].txt_col(lens)


def _strip_suffix(col: Col) -> Col:
    """Barcode minus its '-N' gem-group suffix (bytes from the last '-');
    rows without '-' pass through unchanged."""
    data, lens = col.data, col.lens
    n = len(col)
    if data.shape[0] == 0:
        return col
    isdash = data == ord("-")
    pos_in_row = np.arange(data.shape[0], dtype=np.int64) - np.repeat(
        col.offsets[:-1], lens)
    last_dash = np.full(n, -1, np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    np.maximum.at(last_dash, rows[isdash], pos_in_row[isdash])
    new_lens = np.where(last_dash >= 0, last_dash, lens)
    return ragged.gather_ranges(data, col.offsets[:-1], new_lens)


def barcode_pred_seg(name: str, vals: Col, base_by_row: Col,
                     rows_t: np.ndarray) -> dict | None:
    """CR:Z predicted = CB:Z of the same row minus suffix (UR from UB
    verbatim works through the same path: UB has no suffix). Fit bitmap +
    tokenized exceptions; None when the prediction mostly misses."""
    from ..utils.ragged import cols_equal_rows
    pred = _strip_suffix(ragged.take(base_by_row, rows_t))
    fit = cols_equal_rows(vals, pred)
    if fit.mean() <= 0.5:
        return None
    ctxs = {name + "P": VBCtx(name + "P", MODE_NUM,
                              local=fit.astype(np.int64), cat="int")}
    if (~fit).any():
        exc = ragged.take(vals, np.nonzero(~fit)[0])
        ctxs.update(tokenizer_seg_col(name + "X", exc, single_stream=True))
    return ctxs


def barcode_pred_recon(name: str, pctxs, base_by_row: Col,
                       rows_t: np.ndarray) -> Col:
    fit = pctxs[name + "P"].nums().astype(bool)
    pred = _strip_suffix(ragged.take(base_by_row, rows_t))
    sub = [(np.nonzero(fit)[0], ragged.take(pred, np.nonzero(fit)[0]))]
    if (~fit).any():
        exc = tokenizer_recon_col(name + "X", pctxs, int((~fit).sum()))
        sub.append((np.nonzero(~fit)[0], exc))
    return ragged.merge_rows(fit.shape[0], sub)


def seqlen_str_seg(name: str, vals: Col, seq: Col,
                   rows_t: np.ndarray) -> dict | None:
    """SEQ-length string tag (bismark XM:Z): lengths predicted from SEQ,
    payload through the QUAL codec family (tiny alphabet, position
    correlated). Fit bitmap on length only."""
    pred_lens = seq.lens[rows_t]
    fit = vals.lens == pred_lens
    if fit.mean() <= 0.5:
        return None
    ctxs = {name + "B": VBCtx(name + "B", MODE_NUM,
                              local=fit.astype(np.int64), cat="int"),
            name: VBCtx(name, MODE_TXT,
                        local=ragged.take(vals, np.nonzero(fit)[0]).data,
                        cat="qual")}
    if (~fit).any():
        exc = ragged.take(vals, np.nonzero(~fit)[0])
        ctxs.update(tokenizer_seg_col(name + "X", exc, single_stream=True))
    return ctxs


def seqlen_str_recon(name: str, pctxs, seq: Col, rows_t: np.ndarray) -> Col:
    fit = pctxs[name + "B"].nums().astype(bool)
    lens = np.where(fit, seq.lens[rows_t], 0)
    okcol = Col(pctxs[name].local,
                np.concatenate([[0], np.cumsum(lens)]))
    sub = [(np.nonzero(fit)[0], ragged.take(okcol, np.nonzero(fit)[0]))]
    if (~fit).any():
        exc = tokenizer_recon_col(name + "X", pctxs, int((~fit).sum()))
        sub.append((np.nonzero(~fit)[0], exc))
    return ragged.merge_rows(fit.shape[0], sub)


def barr_seg(name: str, vals: Col) -> dict | None:
    """B-array tag "X,i1,i2,..." (Ultima tp:B:c, ONT ML:B:C, 10x fz:B:S —
    reference src/sam_ultima.c / src/sam_fields.c array handling): subtype
    dict + per-row count stream + ONE value stream, instead of per-row
    templates whose shapes never repeat. Numeric subtypes only (f stays on
    the tokenizer). Fit bitmap + tokenized exceptions."""
    n = len(vals)
    data = vals.data
    if n == 0 or data.shape[0] == 0:
        return None
    first = data[np.minimum(vals.offsets[:-1], data.shape[0] - 1)]
    sub_ok = np.isin(first, np.frombuffer(b"cCsSiI", np.uint8))
    second = data[np.minimum(vals.offsets[:-1] + 1,
                             data.shape[0] - 1)]
    sub_ok &= (vals.lens >= 3) & (second == ord(","))
    # count + split the int list after "X,"
    body = ragged.gather_ranges(data, vals.offsets[:-1] + 2,
                                np.where(sub_ok, vals.lens - 2, 0))
    ncom = ragged.count_sep_per_row(body, ord(","))
    cnt = np.where(sub_ok, ncom + 1, 0)
    T = int(cnt.sum())
    if T == 0:
        return None
    t_row = np.repeat(ragged.arange(n), cnt)
    cp = np.nonzero(body.data == ord(","))[0]
    base = np.concatenate([[0], np.cumsum(np.maximum(cnt - 1, 0))])[:-1]
    tidx = ragged.arange(T) - np.concatenate([[0], np.cumsum(cnt)])[:-1][t_row]
    ts = np.where(tidx == 0, body.offsets[:-1][t_row], 0)
    nz = np.nonzero(tidx > 0)[0]
    if nz.shape[0]:
        ts[nz] = cp[base[t_row[nz]] + tidx[nz] - 1] + 1
    te = np.empty(T, np.int64)
    lastt = tidx == cnt[t_row] - 1
    te[lastt] = body.offsets[1:][t_row[lastt]]
    nz = np.nonzero(~lastt)[0]
    if nz.shape[0]:
        te[nz] = cp[base[t_row[nz]] + tidx[nz]]
    segs = ragged.gather_ranges(body.data, ts, te - ts)
    iv, iok = ragged.atoi(segs)
    iok &= segs.lens > 0
    fit = sub_ok.copy()
    np.logical_and.at(fit, t_row, iok)
    if fit.mean() <= 0.5:
        return None
    keep = fit[t_row]
    ctxs = {
        name + "W": VBCtx(name + "W", MODE_NUM, local=fit.astype(np.int64),
                          cat="int"),
        name + "A": VBCtx(name + "A", MODE_NUM,
                          local=first[fit].astype(np.int64), cat="int"),
        name + "N": VBCtx(name + "N", MODE_NUM, local=cnt[fit], cat="int"),
        name + "V": VBCtx(name + "V", MODE_NUM, local=iv[keep], cat="int"),
    }
    if (~fit).any():
        exc = ragged.take(vals, np.nonzero(~fit)[0])
        ctxs.update(tokenizer_seg_col(name + "X", exc, single_stream=True))
    return ctxs


def barr_recon(name: str, pctxs) -> Col:
    fit = pctxs[name + "W"].nums().astype(bool)
    sub = pctxs[name + "A"].nums().astype(np.uint8)
    cnt = pctxs[name + "N"].nums()
    iv = pctxs[name + "V"].nums()
    K = int(fit.sum())
    nums = ragged.itoa(iv)
    # per-item rendering ",<int>"; a row's items are then CONTIGUOUS
    items = ragged.interleave(
        [Col(np.full(iv.shape[0], ord(","), np.uint8),
             np.arange(iv.shape[0] + 1, dtype=np.int64)), nums],
        sep_after=[None, None])
    cbnd = np.concatenate([[0], np.cumsum(cnt)])
    row_start = items.offsets[cbnd[:-1]]
    row_end = items.offsets[cbnd[1:]]
    body = ragged.gather_ranges(items.data, row_start, row_end - row_start)
    subcol = Col(sub, np.arange(K + 1, dtype=np.int64))
    okcol = ragged.interleave([subcol, body], sep_after=[None, None])
    subps = [(np.nonzero(fit)[0], okcol)]
    if (~fit).any():
        exc = tokenizer_recon_col(name + "X", pctxs, int((~fit).sum()))
        subps.append((np.nonzero(~fit)[0], exc))
    return ragged.merge_rows(fit.shape[0], subps)


def float_seg(name: str, vals: Col) -> dict | None:
    """f-type text tag (PacBio rq:f/ec:f, minimap2 de:f — reference
    src/sam_pacbio.c / seg_float role): strict "[-]?INT.FRAC" decomposes
    into an int stream + zero-padded-fraction int stream + fraction-length
    stream, preserving leading fraction zeros the tokenizer can't."""
    n = len(vals)
    data = vals.data
    if n == 0 or data.shape[0] == 0:
        return None
    ndots = ragged.count_sep_per_row(vals, ord("."))
    first = data[np.minimum(vals.offsets[:-1], data.shape[0] - 1)]
    neg = first == ord("-")
    dot1 = ndots == 1
    dp = np.zeros(n, np.int64)
    dpos = np.nonzero(data == ord("."))[0]
    if dpos.shape[0]:
        drow = np.searchsorted(vals.offsets[1:], dpos, side="right")
        sel = dot1[drow]
        dp[drow[sel]] = dpos[sel]
    istart = vals.offsets[:-1] + neg
    ilen = np.where(dot1, dp - istart, 0)
    flen = np.where(dot1, vals.offsets[1:] - dp - 1, 0)
    ipart = ragged.gather_ranges(data, istart, np.maximum(ilen, 0))
    fpart = ragged.gather_ranges(data, dp + 1, np.maximum(flen, 0))
    iv, iok = ragged.atoi(ipart)
    fv, fok = ragged.atoi(fpart)
    # no leading zero in the int part (unless exactly "0"), frac <= 18
    lead0 = (ilen > 1) & (ipart.data[np.minimum(
        ipart.offsets[:-1], max(ipart.data.shape[0] - 1, 0))] == ord("0")) \
        if ipart.data.shape[0] else np.zeros(n, bool)
    fit = dot1 & iok & fok & (ilen > 0) & (flen > 0) & (flen <= 18) & ~lead0
    if fit.mean() <= 0.5:
        return None
    sgn = np.where(neg[fit], -1, 1)
    ctxs = {
        name + "W": VBCtx(name + "W", MODE_NUM, local=fit.astype(np.int64),
                          cat="int"),
        name + "I": VBCtx(name + "I", MODE_NUM, local=iv[fit] * sgn,
                          cat="int"),
        name + "D": VBCtx(name + "D", MODE_NUM, local=fv[fit], cat="int"),
        name + "L": VBCtx(name + "L", MODE_NUM, local=flen[fit], cat="int"),
    }
    if (~fit).any():
        exc = ragged.take(vals, np.nonzero(~fit)[0])
        ctxs.update(tokenizer_seg_col(name + "X", exc, single_stream=True))
    return ctxs


def float_recon(name: str, pctxs) -> Col:
    fit = pctxs[name + "W"].nums().astype(bool)
    iv = pctxs[name + "I"].nums()
    fv = pctxs[name + "D"].nums()
    fl = pctxs[name + "L"].nums()
    ints = ragged.itoa(iv)
    fr = ragged.itoa(fv)
    # zero-pad fractions to their recorded length
    pad = fl - fr.lens
    padded_lens = fl
    off = np.concatenate([[0], np.cumsum(padded_lens)])
    fdata = np.full(int(off[-1]), ord("0"), np.uint8)
    total = int(fr.lens.sum())
    if total:
        pos = ragged.arange(total) - np.repeat(fr.offsets[:-1], fr.lens)
        fdata[np.repeat(off[:-1] + pad, fr.lens) + pos] = fr.data
    frac = Col(fdata, off)
    okcol = ragged.interleave([ints, frac], sep_after=[b".", None])
    subps = [(np.nonzero(fit)[0], okcol)]
    if (~fit).any():
        exc = tokenizer_recon_col(name + "X", pctxs, int((~fit).sum()))
        subps.append((np.nonzero(~fit)[0], exc))
    return ragged.merge_rows(fit.shape[0], subps)


# ---------------------------------------------------------------- XA:Z ----

def xa_seg(name: str, vals: Col, row_pos: np.ndarray,
           rows_t: np.ndarray) -> dict | None:
    """BWA XA:Z = "(rname,[+-]pos,cigar,nm;)+" split into per-alt
    sub-contexts (src/sam_bwa.c:423). Rows that don't parse exactly go to a
    tokenized exception stream behind the fit bitmap."""
    n = len(vals)
    data = vals.data
    lens = vals.lens
    # candidate rows: non-empty, ';'-terminated
    dmax = max(data.shape[0] - 1, 0)
    last = np.minimum(vals.offsets[1:] - 1, dmax)
    cand = (lens > 0) & (data[last] == ord(";")) if data.shape[0] else \
        np.zeros(n, bool)
    semis = np.nonzero(data == ord(";"))[0]
    semi_row = np.searchsorted(vals.offsets[1:], semis, side="right")
    # alt spans: [prev ';'+1 or row start, this ';')
    prev = np.concatenate([[-1], semis[:-1]])
    row_first = np.ones(semis.shape[0], bool)
    row_first[1:] = semi_row[1:] != semi_row[:-1]
    alt_start = np.where(row_first, vals.offsets[:-1][semi_row], prev + 1)
    alt_len = semis - alt_start
    keep_alt = cand[semi_row] & (alt_len > 0)
    alt_start, alt_len = alt_start[keep_alt], alt_len[keep_alt]
    alt_row = semi_row[keep_alt]
    A = alt_start.shape[0]
    if A == 0:
        return None
    alts = ragged.gather_ranges(data, alt_start, alt_len)
    cols3, rest, good_alts, _bad = ragged.split_first_fields(
        alts, ord(","), 3)
    rn, sp, cg = cols3
    # rest includes its leading ',' (or is empty for 2-comma alts)
    has_nm = rest.lens >= 2
    nm_txt = ragged.gather_ranges(
        rest.data, rest.offsets[:-1] + 1,
        np.where(has_nm, rest.lens - 1, 0))
    nm_v, nm_ok = ragged.atoi(nm_txt)
    nm_ok &= has_nm
    if rest.data.shape[0]:
        nm_ok &= rest.data[np.minimum(rest.offsets[:-1],
                                      rest.data.shape[0] - 1)] == ord(",")
    # strand+pos field: leading +/-, digits after
    sp_ok = sp.lens >= 2
    if sp.data.shape[0]:
        first = sp.data[np.minimum(sp.offsets[:-1], sp.data.shape[0] - 1)]
    else:
        first = np.zeros(len(sp), np.uint8)
    is_fwd = first == ord("+")
    sp_ok &= is_fwd | (first == ord("-"))
    pos_txt = ragged.gather_ranges(sp.data, sp.offsets[:-1] + 1,
                                   np.where(sp_ok, sp.lens - 1, 0))
    pos_v, pos_ok = ragged.atoi(pos_txt)
    ok_g = nm_ok & sp_ok & pos_ok & (rn.lens > 0) & (cg.lens > 0)
    alt_ok = np.zeros(A, bool)
    alt_ok[good_alts] = ok_g
    # a row fits iff it was a candidate, has >=1 alt, and every alt parses
    fit = cand.copy()
    np.logical_and.at(fit, alt_row, alt_ok)
    fit &= np.bincount(alt_row, minlength=n) > 0
    if fit.mean() <= 0.5:
        return None
    # keep good alts of fit rows, in (row, alt) order (good_alts is sorted)
    row_g = alt_row[good_alts]
    keep_g = fit[row_g]
    ki = np.nonzero(keep_g)[0]
    nalts = np.bincount(row_g[keep_g], minlength=n)[fit]
    uw, inv = dedup_col(ragged.take(rn, ki))
    uwc, invc = dedup_col(ragged.take(cg, ki))
    ctxs = {
        name + "F": VBCtx(name + "F", MODE_NUM, local=fit.astype(np.int64),
                          cat="int"),
        name + "C": VBCtx(name + "C", MODE_NUM, local=nalts, cat="int"),
        name + "R": VBCtx(name + "R", MODE_DICT, b250=inv, vb_words=uw,
                          cat="b250"),
        name + "G": VBCtx(name + "G", MODE_DICT, b250=invc, vb_words=uwc,
                          cat="b250"),
        name + "S": VBCtx(name + "S", MODE_NUM,
                          local=is_fwd[keep_g].astype(np.int64), cat="int"),
        name + "O": VBCtx(name + "O", MODE_NUM,
                          local=pos_v[keep_g]
                          - row_pos[rows_t[row_g[keep_g]]],
                          cat="int"),
        name + "N": VBCtx(name + "N", MODE_NUM, local=nm_v[keep_g],
                          cat="int"),
    }
    if (~fit).any():
        exc = ragged.take(vals, np.nonzero(~fit)[0])
        ctxs.update(tokenizer_seg_col(name + "X", exc, single_stream=True))
    return ctxs


def xa_recon(name: str, pctxs, row_pos: np.ndarray,
             rows_t: np.ndarray) -> Col:
    fit = pctxs[name + "F"].nums().astype(bool)
    nalts = pctxs[name + "C"].nums()
    A = int(nalts.sum())
    rn = pctxs[name + "R"].dict_take()
    cg = pctxs[name + "G"].dict_take()
    fwd = pctxs[name + "S"].nums().astype(bool)
    alt_fit_row = np.repeat(np.nonzero(fit)[0], nalts)
    pos_v = pctxs[name + "O"].nums() + row_pos[rows_t[alt_fit_row]]
    nm_v = pctxs[name + "N"].nums()
    strand = Col(np.where(fwd, ord("+"), ord("-")).astype(np.uint8),
                 np.arange(A + 1, dtype=np.int64))
    alts = ragged.interleave(
        [rn, strand, ragged.itoa(pos_v), cg, ragged.itoa(nm_v)],
        sep_after=[b",", None, b",", b",", b";"])
    alt_lens_per_row = np.bincount(alt_fit_row, weights=alts.lens,
                                   minlength=fit.shape[0]).astype(np.int64)
    fit_col = Col(alts.data,
                  np.concatenate([[0],
                                  np.cumsum(alt_lens_per_row[fit])]))
    sub = [(np.nonzero(fit)[0], fit_col)]
    if (~fit).any():
        exc = tokenizer_recon_col(name + "X", pctxs, int((~fit).sum()))
        sub.append((np.nonzero(~fit)[0], exc))
    return ragged.merge_rows(fit.shape[0], sub)
