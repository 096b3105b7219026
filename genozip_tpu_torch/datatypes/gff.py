"""GFF3/GTF/GVF datatype plugin (reference parity: src/gff.c).

Counterpart of genozip_tpu/datatypes/gff.py on its numpy host path.

The ATTRS column gets per-attribute sub-contexts (src/gff.c:161-250): each
row's key layout becomes a dict template ("ID=\\x01;Parent=\\x01;..."),
values group per key into their own tokenizer sub-contexts (numeric ID
suffixes get the tokenizer's monotone delta), and Parent values that equal
the most recent row's ID elide behind a bitmap (gff.c ID/Parent copy —
exons point at their transcript). Rows that don't parse as
key[=value](;...)* fall back per-row to the verbatim template path.
"""

import zlib

import numpy as np

from . import register
from .tabular import TabularDT
from .. import native
from ..utils import ragged
from ..utils.ragged import Col
from ..contexts import VBCtx, MODE_DICT, MODE_NUM, dedup_col
from ..seg import tokenizer_seg_col, tokenizer_recon_col, TOK_MARK


def _split_pairs(col: Col):
    """Split each row on ';' -> (pairs Col in row-major order, pair_row,
    npair per row). Empty rows produce one empty pair."""
    d = col.data
    n = len(col)
    semis = np.nonzero(d == ord(";"))[0]
    npair = ragged.count_sep_per_row(col, ord(";")) + 1
    total = int(npair.sum())
    first_of = np.concatenate([[0], np.cumsum(npair)])[:-1]
    starts = np.empty(total, np.int64)
    ends = np.empty(total, np.int64)
    starts[first_of] = col.offsets[:-1]
    m = np.ones(total, bool)
    m[first_of] = False
    starts[m] = semis + 1
    last_of = first_of + npair - 1
    ends[last_of] = col.offsets[1:]
    m2 = np.ones(total, bool)
    m2[last_of] = False
    ends[m2] = semis
    pair_row = np.repeat(ragged.arange(n), npair)
    return ragged.gather_ranges(d, starts, ends - starts), pair_row, npair


def _sanitize(key: bytes) -> str:
    """Short deterministic context-name stem for an attribute key. Budget:
    the archive dict_id is 16 bytes and the tokenizer appends up to 2 more
    chars ("S"/"W"/stream digits) after the "ATTRS" prefix — so the stem
    stays <= 9. Rare (prefix, crc16) collisions just share a context
    (grouping keeps recon exact, ratio pays a little)."""
    base = "".join(c if c.isalnum() else "_"
                   for c in key.decode("latin1"))[:4]
    return f"A{base}{zlib.crc32(key) & 0xFFFF:04x}"


@register
class GffDT(TabularDT):
    NAME = "gff"
    FIELDS = [("SEQID", "dict"), ("SOURCE", "dict"), ("TYPE", "dict"),
              ("START", "num_delta"), ("END", "num_delta"), ("SCORE", "tok"),
              ("STRAND", "dict"), ("PHASE", "dict"), ("ATTRS", "attrs")]
    COMMENT_PREFIXES = (b"#", b">")  # '##FASTA' tail sections stay verbatim

    def seg_field(self, name, kind, col):
        if kind != "attrs":
            return super().seg_field(name, kind, col)
        n = len(col)
        if n == 0 or col.data.shape[0] == 0 or \
                (col.data == TOK_MARK).any():
            return tokenizer_seg_col(name, col, single_stream=True)
        pairs, pair_row, npair = _split_pairs(col)
        eqpos = np.full(len(pairs), -1, np.int64)
        eqs = np.nonzero(pairs.data == ord("="))[0]
        if eqs.shape[0]:
            prow = np.searchsorted(pairs.offsets[1:], eqs, side="right")
            pfirst = np.ones(eqs.shape[0], bool)
            pfirst[1:] = prow[1:] != prow[:-1]
            eqpos[prow[pfirst]] = eqs[pfirst] - pairs.offsets[:-1][prow[pfirst]]
        has_eq = eqpos >= 0
        klen = np.where(has_eq, eqpos + 1, pairs.lens)   # incl. '='
        keys = ragged.gather_ranges(pairs.data, pairs.offsets[:-1], klen)
        vals = ragged.gather_ranges(pairs.data,
                                    pairs.offsets[:-1] + klen,
                                    pairs.lens - klen)
        # layout template: row with every value replaced by one TOK_MARK
        piece_lens = klen + has_eq.astype(np.int64)      # key= + mark
        row_tlens = np.bincount(pair_row, weights=piece_lens,
                                minlength=n).astype(np.int64) + (npair - 1)
        toff = np.concatenate([[0], np.cumsum(row_tlens)])
        tdata = np.full(int(toff[-1]), ord(";"), np.uint8)
        # destination start of each pair's template piece
        intra = piece_lens + 1                            # piece + ';'
        dst = np.empty(len(pairs), np.int64)
        first_of = np.concatenate([[0], np.cumsum(npair)])[:-1]
        cum = np.cumsum(intra) - intra
        dst = toff[:-1][pair_row] + (cum - cum[first_of][pair_row])
        tot = int(keys.lens.sum())
        if tot >= ragged.NATIVE_MIN_BYTES:
            native.copy_ranges(keys.data, keys.offsets[:-1], tdata, dst,
                               keys.lens)
        elif tot:
            pos = ragged.arange(tot) - np.repeat(keys.offsets[:-1], keys.lens)
            tdata[np.repeat(dst, keys.lens) + pos] = keys.data
        tdata[(dst + klen)[has_eq]] = TOK_MARK
        tmpl = Col(tdata, toff)
        uw, inv = dedup_col(tmpl)
        ctxs = {name: VBCtx(name, MODE_DICT, b250=inv, vb_words=uw,
                            cat="b250", param=7)}
        # per-key value sub-contexts; Parent elides vs the most recent ID
        vp = np.nonzero(has_eq)[0]
        if vp.shape[0] == 0:
            return ctxs
        vkeys = ragged.take(keys, vp)
        vvals = ragged.take(vals, vp)
        vrows = pair_row[vp]
        ukeys, kinv = dedup_col(vkeys)
        names = [_sanitize(ukeys.row(w)[:-1]) for w in range(len(ukeys))]
        # ID values per row (forward-filled) for the Parent prediction
        id_w = next((w for w in range(len(ukeys))
                     if ukeys.row(w) == b"ID="), None)
        prev_id_of_row = None
        if id_w is not None:
            sel = np.nonzero(kinv == id_w)[0]
            idv = ragged.take(vvals, sel)
            id_rows = vrows[sel]
            # prev_id_of_row[r] = index into idv of the last ID at row < r
            prev = np.searchsorted(id_rows, np.arange(n), side="left") - 1
            prev_id_of_row = (idv, prev)
        done_names = set()
        for w in range(len(ukeys)):
            nm = names[w]
            if nm in done_names:
                continue
            done_names.add(nm)
            grp = [w2 for w2 in range(len(ukeys)) if names[w2] == nm]
            sel = np.nonzero(np.isin(kinv, grp))[0]
            gv = ragged.take(vvals, sel)
            sub = name + nm
            if ukeys.row(w) == b"Parent=" and prev_id_of_row is not None:
                idv, prev = prev_id_of_row
                p = prev[vrows[sel]]
                pred = ragged.take(idv, np.maximum(p, 0))
                eq = (p >= 0) & ragged.rows_equal(gv, pred)
                if eq.mean() > 0.5:
                    ctxs[sub + "P"] = VBCtx(sub + "P", MODE_NUM,
                                            local=eq.astype(np.int64),
                                            cat="int")
                    if (~eq).any():
                        exc = ragged.take(gv, np.nonzero(~eq)[0])
                        ctxs.update(tokenizer_seg_col(sub, exc,
                                                      single_stream=True))
                    continue
            ctxs.update(tokenizer_seg_col(sub, gv, single_stream=True))
        return ctxs

    def recon_field(self, name, kind, pctxs, n):
        if kind != "attrs":
            return super().recon_field(name, kind, pctxs, n)
        tc = pctxs[name]
        if tc.mode != MODE_DICT or tc.param != 7:
            return tokenizer_recon_col(name, pctxs, n)   # legacy/fallback
        tmpl = tc.dict_take()
        d = tmpl.data
        marks = np.nonzero(d == TOK_MARK)[0]
        if marks.shape[0] == 0:
            return tmpl
        mark_row = np.searchsorted(tmpl.offsets[1:], marks, side="right")
        # key of each mark: bytes from the previous ';' (or row start) up
        # to and including the '=' right before the mark
        row_start = tmpl.offsets[:-1][mark_row]
        prev_semi = np.full(marks.shape[0], -1, np.int64)
        semis = np.nonzero(d == ord(";"))[0]
        if semis.shape[0]:
            at = np.searchsorted(semis, marks)
            has_prev = at > 0
            prev_semi[has_prev] = semis[np.maximum(at - 1, 0)][has_prev]
        kstart = np.maximum(row_start, prev_semi + 1)
        keys = ragged.gather_ranges(d, kstart, marks - kstart)  # incl. '='
        ukeys, kinv = dedup_col(keys)
        names = [_sanitize(ukeys.row(w)[:-1]) for w in range(len(ukeys))]
        val_col = None
        parts = []
        id_done = {}
        # group marks by sanitized name, reconstruct each group's values
        done = set()
        for w in range(len(ukeys)):
            nm = names[w]
            if nm in done:
                continue
            done.add(nm)
            grp = [w2 for w2 in range(len(ukeys)) if names[w2] == nm]
            sel = np.nonzero(np.isin(kinv, grp))[0]
            sub = name + nm
            if sub + "P" in pctxs:
                # Parent == most recent ID (reconstructed first: ID marks
                # precede Parent marks in template order within a row only
                # if ID comes first — recompute from the ID group instead)
                idg = [w2 for w2 in range(len(ukeys))
                       if ukeys.row(w2) == b"ID="]
                isel = np.nonzero(np.isin(kinv, idg))[0]
                key_i = tuple(idg)
                if key_i not in id_done:
                    id_done[key_i] = tokenizer_recon_col(
                        name + _sanitize(b"ID"), pctxs, isel.shape[0]) \
                        if idg else None
                idv = id_done[key_i]
                id_rows = mark_row[isel]
                eq = pctxs[sub + "P"].nums().astype(bool)
                prev = np.searchsorted(id_rows, mark_row[sel],
                                       side="left") - 1
                pred = ragged.take(idv, np.maximum(prev, 0))
                subparts = [(np.nonzero(eq)[0],
                             ragged.take(pred, np.nonzero(eq)[0]))]
                if (~eq).any():
                    exc = tokenizer_recon_col(sub, pctxs, int((~eq).sum()))
                    subparts.append((np.nonzero(~eq)[0], exc))
                gv = ragged.merge_rows(sel.shape[0], subparts)
            else:
                gv = tokenizer_recon_col(sub, pctxs, sel.shape[0])
            parts.append((sel, gv))
        val_col = ragged.merge_rows(marks.shape[0], parts)
        # splice values at marks (the tokenizer splice, whole-value tokens)
        piece_lens = np.ones(d.shape[0], np.int64)
        piece_lens[marks] = val_col.lens
        dst_off = np.concatenate([[0], np.cumsum(piece_lens)])
        out = np.empty(int(dst_off[-1]), np.uint8)
        nonmark = np.ones(d.shape[0], bool)
        nonmark[marks] = False
        out[dst_off[:-1][nonmark]] = d[nonmark]
        nl = val_col.lens
        tot = int(nl.sum())
        if tot:
            pos = ragged.arange(tot) - np.repeat(val_col.offsets[:-1], nl)
            out[np.repeat(dst_off[:-1][marks], nl) + pos] = val_col.data
        row_extra = np.zeros(n, np.int64)
        np.add.at(row_extra, mark_row, val_col.lens - 1)
        new_lens = tmpl.lens + row_extra
        return Col(out, np.concatenate([[0], np.cumsum(new_lens)]))
