"""Shared segmentation helpers: the vectorized tokenizer.

Reference parity: src/tokenizer.c (fallback field splitter), src/qname.c +
src/qname_flavors.h (70 qname flavor templates), src/seg.c seg helpers.
Counterpart of genozip_tpu/seg.py, unchanged in behaviour.

Design: instead of per-line flavor matching, a whole column is
split in one pass into digit-runs and a *template* (digit runs replaced by a
placeholder byte). Rows sharing a template hit the same dict word; numeric
runs become per-position integer streams (delta-coded when monotonic). Rows
whose run structure disagrees with nothing — every row maps independently —
so any mix of flavors works; uniform flavors (the common case) produce a
1-word template dict + K numeric streams, which is exactly what the flavor
system achieves, without the template catalog.
"""

import numpy as np

from . import native
from .utils import ragged
from .utils.ragged import Col
from .contexts import VBCtx, MODE_DICT, MODE_NUM, dedup_col

TOK_MARK = 0x01          # placeholder byte for a numeric run inside a template
MAX_NUM_LEN = 18         # digit runs longer than this stay literal
_POW10 = 10 ** np.arange(1, 19, dtype=np.int64)
MAX_TOKENS = 32          # digit runs beyond this stay literal


def _tokenize_np(data: np.ndarray, offsets: np.ndarray, max_tokens: int):
    """Vectorized numpy tokenizer, bit-exact with genozip_tpu's C++
    gxz_tokenize (same keep rules, same output streams).
    Returns (tmpl_data u8, tmpl_lens i64, vals i64, tok_idx i32, widths
    u8): kept digit runs are replaced by TOK_MARK in the template and
    emitted row-major with their run width (so zero-padded fixed-width
    fields — BGI-style names, the reference's fixed-width flavor items —
    re-render exactly); a run is kept iff len <= 18 and fewer than
    max_tokens runs were already kept in its row."""
    n = offsets.shape[0] - 1
    isd = (data >= ord("0")) & (data <= ord("9"))
    prev = np.concatenate([[False], isd[:-1]])
    row_start = np.zeros(data.shape[0] + 1, dtype=bool)
    row_start[offsets[:-1]] = True
    runstart = isd & (~prev | row_start[:-1])
    start_pos = np.nonzero(runstart)[0]
    isd_ext = np.concatenate([isd, [False]])
    runend_mask = isd & (~isd_ext[1:] | row_start[1:data.shape[0] + 1])
    end_pos = np.nonzero(runend_mask)[0] + 1
    run_len = end_pos - start_pos
    run_row = np.searchsorted(offsets[1:], start_pos, side="right")
    keep0 = run_len <= MAX_NUM_LEN
    # gxz_tokenize semantics: the token counter advances on KEPT runs only, so the
    # cap admits the first max_tokens runs per row that pass the base filter
    kept_rank = np.cumsum(keep0) - keep0  # exclusive cumcount of kept runs
    row_base = np.zeros(start_pos.shape[0], np.int64)
    if start_pos.shape[0]:
        first = np.ones(start_pos.shape[0], bool)
        first[1:] = run_row[1:] != run_row[:-1]
        fidx = np.nonzero(first)[0]
        row_base = np.repeat(kept_rank[fidx], np.diff(
            np.concatenate([fidx, [start_pos.shape[0]]])))
    tok_idx_all = kept_rank - row_base
    keep = keep0 & (tok_idx_all < max_tokens)
    # recompute rank among the FINAL keep set (cap can only trim the tail of
    # a row's kept runs, so ranks below the cap are unchanged)
    kept_starts, kept_lens = start_pos[keep], run_len[keep]
    tok_idx = tok_idx_all[keep].astype(np.int32)
    vals = np.zeros(kept_starts.shape[0], np.int64)
    if kept_starts.shape[0]:
        # per-digit accumulation (atoi is canonical-strict and would
        # reject zero-padded runs): <=18 vectorized passes
        for k in range(int(kept_lens.max())):
            sel = kept_lens > k
            vals[sel] = vals[sel] * 10 + \
                (data[kept_starts[sel] + k].astype(np.int64) - ord("0"))
    # template: drop kept-run bytes except the first, which becomes TOK_MARK
    drop = np.zeros(data.shape[0], dtype=bool)
    mark = np.zeros(data.shape[0], dtype=bool)
    if kept_starts.shape[0]:
        total = int(kept_lens.sum())
        pos = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(kept_lens)])[:-1], kept_lens)
        drop[np.repeat(kept_starts, kept_lens) + pos] = True
        mark[kept_starts] = True
    keep_byte = ~drop | mark
    tmpl_data = np.where(mark, TOK_MARK, data)[keep_byte]
    kept_per_row = np.zeros(n, dtype=np.int64)
    np.add.at(kept_per_row, run_row[keep], run_len[keep] - 1)
    tmpl_lens = (offsets[1:] - offsets[:-1]) - kept_per_row
    return tmpl_data, tmpl_lens, vals, tok_idx, kept_lens.astype(np.uint8)


def tokenize_col(data: np.ndarray, offsets: np.ndarray, max_tokens: int):
    """One-pass tokenizer scan in the host runtime (`_tokenize_np`'s
    streams). Returns (tmpl_data, tmpl_lens, vals, tok_idx, widths)."""
    return native.tokenize(data, offsets, max_tokens)


def tokenizer_seg_col(prefix: str, col: Col, single_stream: bool = False,
                      max_tokens: int = MAX_TOKENS):
    """Segment a ragged string column into template dict + numeric streams.
    Returns dict of ctx_name -> VBCtx. Recon counterpart: tokenizer_recon_col.

    single_stream=True routes ALL numeric runs (uncapped, any count per row)
    into one value stream in (row, position) order — for fields with many or
    variable-count numbers per row (VCF INFO/sample matrices), where one
    section beats hundreds of per-position sections.
    """
    n = len(col)
    data = col.data
    ctxs = {}
    if data.shape[0] and (data == TOK_MARK).any():
        # rows containing the placeholder byte can't be templated; store the
        # whole column as a plain dict (correct, just less compact).
        # param=5 tells recon the words are verbatim (their \x01 bytes are
        # literal, not numeric-run marks)
        uw, inv = dedup_col(col)
        ctxs[prefix] = VBCtx(prefix, MODE_DICT, b250=inv, vb_words=uw,
                             cat="b250", param=5)
        return ctxs
    if n == 0 or data.shape[0] == 0:
        tmpl_col = Col.from_list([b""] * n) if n else Col.from_list([])
        uw, inv = dedup_col(tmpl_col)
        ctxs[prefix] = VBCtx(prefix, MODE_DICT, b250=inv, vb_words=uw, cat="b250")
        return ctxs

    cap = (1 << 62) if single_stream else max_tokens
    tmpl_data, tmpl_lens, vals, new_tok, wid = tokenize_col(
        data, col.offsets, cap)
    tmpl_col = Col(tmpl_data, np.concatenate([[0], np.cumsum(tmpl_lens)]))
    uw, inv = dedup_col(tmpl_col)
    ctxs[prefix] = VBCtx(prefix, MODE_DICT, b250=inv, vb_words=uw, cat="b250")
    if vals.shape[0] == 0:
        return ctxs
    # zero-pad widths beyond the canonical rendering (fixed-width fields:
    # BGI-style names, the reference's qname_flavors.h width items) —
    # stored row-major as a delta stream, absent when all-canonical
    canon = np.searchsorted(_POW10, vals, side="right") + 1  # digit count
    pad = wid.astype(np.int64) - canon
    if (pad != 0).any():
        ctxs[f"{prefix}W"] = VBCtx(f"{prefix}W", MODE_NUM, local=pad,
                                   cat="int")
    if single_stream:
        # uniform per-row counts -> store column-major (the sample-matrix
        # transpose, reference LT_UINT8_TR-style: per-column value
        # distributions stay coherent for the entropy coder)
        k = int(new_tok.max()) + 1
        if n and vals.shape[0] == n * k and \
                (new_tok == np.tile(np.arange(k, dtype=new_tok.dtype), n)).all():
            ctxs[f"{prefix}S"] = VBCtx(
                f"{prefix}S", MODE_NUM,
                local=np.ascontiguousarray(vals.reshape(n, k).T).reshape(-1),
                cat="int", param=2)
        else:
            ctxs[f"{prefix}S"] = VBCtx(f"{prefix}S", MODE_NUM, local=vals,
                                       cat="int", param=0)
        return ctxs
    ntok = int(new_tok.max()) + 1
    for t in range(ntok):
        v = vals[new_tok == t]
        name = f"{prefix}{t}"
        d = np.diff(v, prepend=np.int64(0))
        use_delta = v.shape[0] > 4 and (d[1:] >= 0).mean() > 0.9
        if use_delta:
            ctxs[name] = VBCtx(name, MODE_NUM, local=d, cat="int", param=1)
        else:
            ctxs[name] = VBCtx(name, MODE_NUM, local=v, cat="int", param=0)
    return ctxs


def tokenizer_recon_col(prefix: str, pctxs, n: int) -> Col:
    """Rebuild the column from template dict + numeric streams."""
    tc = pctxs[prefix]
    if tc.param != 5 and len(tc.dict_col) == 1 and n and \
            f"{prefix}W" not in pctxs:
        # fast path: one shared template (comma-int lists, uniform
        # formats) — per-ROW interleave of k rendered number columns with
        # the template's constant inter-mark pieces, instead of the
        # generic per-BYTE splice (the dominant VCF sample-matrix shape)
        t = bytes(tc.dict_col.row(0))
        k = t.count(bytes([TOK_MARK]))
        if k:
            pieces = t.split(bytes([TOK_MARK]))   # k+1 constant chunks
            if f"{prefix}S" in pctxs:
                pc = pctxs[f"{prefix}S"]
                vals = pc.local.astype(np.int64)
                if vals.shape[0] == n * k:
                    if pc.param == 2:   # column-major (transposed)
                        cols_v = [np.ascontiguousarray(vals[i * n:(i + 1) * n])
                                  for i in range(k)]
                    else:
                        m = vals.reshape(n, k)
                        cols_v = [np.ascontiguousarray(m[:, i])
                                  for i in range(k)]
                else:
                    cols_v = None
            else:
                cols_v = []
                for i in range(k):
                    pc = pctxs.get(f"{prefix}{i}")
                    if pc is None or pc.local.shape[0] != n:
                        cols_v = None
                        break
                    cols_v.append(pc.nums())
            if cols_v is not None:
                cols = [ragged.itoa(v) for v in cols_v]
                seps = [pieces[i + 1] or None for i in range(k)]
                if pieces[0]:
                    pre = np.frombuffer(pieces[0], np.uint8)
                    cols.insert(0, Col.from_fixed(
                        np.broadcast_to(pre, (n, pre.shape[0]))))
                    seps.insert(0, None)
                return ragged.interleave(cols, sep_after=seps)
    tmpl = tc.dict_take()  # Col of per-row templates
    if tc.param == 5:      # verbatim fallback: \x01 bytes are literal
        return tmpl
    data = tmpl.data
    marks = np.nonzero(data == TOK_MARK)[0]
    if marks.shape[0] == 0:
        return tmpl
    mark_row = np.searchsorted(tmpl.offsets[1:], marks, side="right")
    if f"{prefix}S" in pctxs:   # single-stream mode: marks in row-major order
        pc = pctxs[f"{prefix}S"]
        val_of_mark = pc.local.astype(np.int64)
        if pc.param == 2:       # column-major (transposed) storage
            k = val_of_mark.shape[0] // max(n, 1)
            val_of_mark = np.ascontiguousarray(
                val_of_mark.reshape(k, n).T).reshape(-1)
        assert val_of_mark.shape[0] == marks.shape[0]
    else:
        per_row = np.bincount(mark_row, minlength=n)
        tok_of_mark = np.arange(marks.shape[0]) - np.concatenate(
            [[0], np.cumsum(per_row)])[mark_row]
        ntok = int(tok_of_mark.max()) + 1
        # decode each numeric stream, then scatter values to marks
        val_of_mark = np.zeros(marks.shape[0], dtype=np.int64)
        for t in range(ntok):
            name = f"{prefix}{t}"
            pc = pctxs[name]
            v = pc.nums()
            m = tok_of_mark == t
            assert m.sum() == v.shape[0], f"{name}: {m.sum()} marks vs {v.shape[0]} vals"
            val_of_mark[m] = v
    num_col = ragged.itoa(val_of_mark)
    wc = pctxs.get(f"{prefix}W")
    if wc is not None:
        # zero-pad widths (fixed-width fields): left-pad each rendered
        # number with '0' to canonical+pad digits (row-major mark order)
        pad = wc.nums()
        assert pad.shape[0] == marks.shape[0]
        if (pad != 0).any():
            nlp = num_col.lens + pad
            offp = np.concatenate([[0], np.cumsum(nlp)])
            outp = np.full(int(offp[-1]), ord("0"), np.uint8)
            ragged.copy_rows(num_col.data, num_col.offsets[:-1], outp,
                             offp[:-1] + pad, num_col.lens)
            num_col = Col(outp, offp)
    # splice: replace each TOK_MARK byte with its rendered number, as range
    # copies of the template's pieces between marks and of the numbers;
    # shift[j] is how far the template's bytes after j marks move
    nl = num_col.lens
    shift = np.concatenate([[0], np.cumsum(nl - 1)])
    piece_start = np.concatenate([[0], marks + 1])
    piece_lens = np.concatenate([marks, [data.shape[0]]]) - piece_start
    out = np.empty(data.shape[0] + int(shift[-1]), dtype=np.uint8)
    ragged.copy_rows(data, piece_start, out, piece_start + shift, piece_lens)
    ragged.copy_rows(num_col.data, num_col.offsets[:-1], out,
                     marks + shift[:-1], nl)
    # new row offsets
    row_extra = np.zeros(n, dtype=np.int64)
    np.add.at(row_extra, mark_row, num_col.lens - 1)
    new_lens = tmpl.lens + row_extra
    return Col(out, np.concatenate([[0], np.cumsum(new_lens)]))
