"""Shared tabular (TSV-record) datatype machinery for GFF/BED/23andMe.

Counterpart of genozip_tpu/datatypes/tabular.py, unchanged in behaviour.

Reference parity: src/gff.c, src/bed.c, src/me23.c — each is a tab-separated
record format with typed per-column contexts. One vectorized implementation:
rows matching the VB-dominant column count are column-split into typed
contexts (dict / delta-int / tokenizer); comment rows and ragged rows
round-trip via a verbatim exception context.

Column kinds: 'dict', 'num' (int, raw), 'num_delta' (int, delta-coded),
'tok' (per-position tokenizer), 'tok1' (single-stream tokenizer).
"""

import numpy as np

from . import DataType, VBSegResult
from ..utils import ragged
from ..utils.ragged import Col
from ..contexts import VBCtx, MODE_DICT, MODE_NUM, dedup_col
from ..seg import tokenizer_seg_col, tokenizer_recon_col


def _lines_of(data: np.ndarray):
    nl = np.nonzero(data == ord("\n"))[0]
    no_final_nl = data.shape[0] and (nl.shape[0] == 0 or nl[-1] != data.shape[0] - 1)
    if no_final_nl:
        nl = np.concatenate([nl, [data.shape[0]]])
    starts = np.concatenate([[0], nl[:-1] + 1])
    return ragged.gather_ranges(data, starts, nl - starts), bool(no_final_nl)


def _seg_one(name, kind, col):
    if kind == "dict":
        uw, inv = dedup_col(col)
        return {name: VBCtx(name, MODE_DICT, b250=inv, vb_words=uw, cat="b250")}
    if kind in ("num", "num_delta"):
        vals, ok = ragged.atoi(col)
        if ok.all():
            if kind == "num_delta":
                d = np.diff(vals, prepend=np.int64(0))
                return {name: VBCtx(name, MODE_NUM, local=d, cat="int", param=1)}
            return {name: VBCtx(name, MODE_NUM, local=vals, cat="int", param=0)}
        return tokenizer_seg_col(name, col)
    if kind == "tok1":
        return tokenizer_seg_col(name, col, single_stream=True)
    return tokenizer_seg_col(name, col)


def _recon_one(name, kind, pctxs, n):
    if kind == "dict":
        return pctxs[name].dict_take()
    pc = pctxs.get(name)
    if kind in ("num", "num_delta") and pc is not None and pc.mode == MODE_NUM:
        return ragged.itoa(pc.nums())
    return tokenizer_recon_col(name, pctxs, n)


class TabularDT(DataType):
    FIELDS: list = []            # [(name, kind)] for the leading columns
    EXTRA_KIND = "tok"           # kind for columns beyond FIELDS
    COMMENT_PREFIXES = (b"#",)   # rows starting with these -> exception rows

    # per-column seg/recon, overridable for datatype-special columns
    # (e.g. GFF attributes, src/gff.c:161-250)
    def seg_field(self, name, kind, col):
        return _seg_one(name, kind, col)

    def recon_field(self, name, kind, pctxs, n):
        return _recon_one(name, kind, pctxs, n)

    def _field_plan(self, nf: int):
        plan = list(self.FIELDS[:nf])
        for i in range(len(plan), nf):
            plan.append((f"COL{i}", self.EXTRA_KIND))
        return plan

    def seg_vb(self, data: np.ndarray) -> VBSegResult:
        lines, no_final_nl = _lines_of(data)
        n = len(lines)
        first = np.zeros(n, dtype=np.uint8)
        nonempty = lines.lens > 0
        starts = lines.offsets[:-1]
        first[nonempty] = data[starts[nonempty]] if data.shape[0] else 0
        is_comment = np.zeros(n, dtype=bool)
        for p in self.COMMENT_PREFIXES:
            is_comment |= first == p[0]

        tabs = ragged.count_sep_per_row(lines, ord("\t"))
        cand = ~is_comment & nonempty
        if cand.any():
            counts = np.bincount(tabs[cand])
            dominant = int(np.argmax(counts))
        else:
            dominant = 0
        good = cand & (tabs == dominant)
        good_idx = np.nonzero(good)[0]
        exc_idx = np.nonzero(~good)[0]

        ctxs = {}
        nf = dominant + 1
        plan = self._field_plan(nf)
        if good_idx.shape[0]:
            glines = ragged.take(lines, good_idx)
            fields = ragged.split_fields_fixed(glines, ord("\t"), nf)
            for (name, kind), col in zip(plan, fields):
                ctxs.update(self.seg_field(name, kind, col))
        if exc_idx.shape[0]:
            uw, inv = dedup_col(ragged.take(lines, exc_idx))
            ctxs["EXC"] = VBCtx("EXC", MODE_DICT, b250=inv, vb_words=uw, cat="text")
        gd = np.zeros(n, dtype=np.int64)
        gd[exc_idx] = 1
        ctxs["VARIANT"] = VBCtx("VARIANT", MODE_NUM, local=gd, cat="int")
        return VBSegResult(ctxs, n, {"no_final_nl": no_final_nl, "nf": nf})

    def recon_vb(self, pctxs: dict, meta: dict) -> bytes:
        n = meta["num_lines"]
        nf = meta["nf"]
        gd = pctxs["VARIANT"].nums()
        good_idx = np.nonzero(gd == 0)[0]
        exc_idx = np.nonzero(gd == 1)[0]
        ng = good_idx.shape[0]
        plan = self._field_plan(nf)
        if ng:
            cols = [self.recon_field(name, kind, pctxs, ng)
                    for name, kind in plan]
            seps = [b"\t"] * (nf - 1) + [None]
            glines = ragged.interleave(cols, sep_after=seps)
        else:
            glines = Col.from_list([])
        parts = [(good_idx, glines)]
        if exc_idx.shape[0]:
            parts.append((exc_idx, pctxs["EXC"].dict_take()))
        all_lines = ragged.merge_rows(n, parts)
        out = ragged.interleave([all_lines], sep_after=[b"\n"])
        raw = out.data.tobytes()
        if meta.get("no_final_nl"):
            raw = raw[:-1]
        return raw
