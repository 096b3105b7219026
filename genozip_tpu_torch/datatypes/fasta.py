"""FASTA datatype plugin: a FASTA as a file to compress (a reference is
made by ref/refstore.make_reference). Counterpart of
genozip_tpu/datatypes/fasta.py.

Reference parity: src/fasta.c (DESC/COMMENT/SEQ contexts, line-based seg).
Per-line type stream (desc '>' / comment ';' / sequence), tokenizer for
descriptions, concatenated sequence stream with per-line lengths (wrapping
preserved byte-exactly), ACGT codec for the sequence payload.
"""

import numpy as np

from . import DataType, VBSegResult, register
from ..utils import ragged
from ..contexts import VBCtx, MODE_DICT, MODE_NUM, MODE_TXT, dedup_col
from ..seg import tokenizer_seg_col, tokenizer_recon_col


@register
class FastaDT(DataType):
    NAME = "fasta"

    def seg_vb(self, data: np.ndarray) -> VBSegResult:
        nl = np.nonzero(data == ord("\n"))[0]
        no_final_nl = data.shape[0] and (nl.shape[0] == 0 or nl[-1] != data.shape[0] - 1)
        if no_final_nl:
            nl = np.concatenate([nl, [data.shape[0]]])
        n = nl.shape[0]
        starts = np.concatenate([[0], nl[:-1] + 1])
        lines = ragged.gather_ranges(data, starts, nl - starts)

        first = np.zeros(n, dtype=np.uint8)
        nonempty = lines.lens > 0
        first[nonempty] = data[starts[nonempty]]
        is_desc = first == ord(">")
        is_comment = first == ord(";")
        is_seq = ~is_desc & ~is_comment

        ctxs = {}
        desc_idx = np.nonzero(is_desc)[0]
        com_idx = np.nonzero(is_comment)[0]
        seq_idx = np.nonzero(is_seq)[0]
        ctxs.update(tokenizer_seg_col("DESC", ragged.take(lines, desc_idx)))
        if com_idx.shape[0]:
            uw, inv = dedup_col(ragged.take(lines, com_idx))
            ctxs["COMMENT"] = VBCtx("COMMENT", MODE_DICT, b250=inv, vb_words=uw, cat="text")
        seq_lines = ragged.take(lines, seq_idx)
        ctxs["NONREF"] = VBCtx("NONREF", MODE_TXT, local=seq_lines.data, cat="seq")
        d = np.diff(seq_lines.lens, prepend=np.int64(0))
        ctxs["LENS"] = VBCtx("LENS", MODE_NUM, local=d, cat="int", param=1)
        # line type stream: 0=seq 1=desc 2=comment
        ltype = np.where(is_desc, 1, np.where(is_comment, 2, 0)).astype(np.int64)
        ctxs["LINETYPE"] = VBCtx("LINETYPE", MODE_NUM, local=ltype, cat="int", param=0)
        return VBSegResult(ctxs, n, {"no_final_nl": bool(no_final_nl)})

    def recon_vb(self, pctxs: dict, meta: dict) -> bytes:
        n = meta["num_lines"]
        lt = pctxs["LINETYPE"].nums()
        desc_idx = np.nonzero(lt == 1)[0]
        com_idx = np.nonzero(lt == 2)[0]
        seq_idx = np.nonzero(lt == 0)[0]
        parts = []
        desc = tokenizer_recon_col("DESC", pctxs, desc_idx.shape[0])
        parts.append((desc_idx, desc))
        if com_idx.shape[0]:
            parts.append((com_idx, pctxs["COMMENT"].dict_take()))
        lens = pctxs["LENS"].nums()
        parts.append((seq_idx, pctxs["NONREF"].txt_col(lens)))
        lines = ragged.merge_rows(n, parts)
        out = ragged.interleave([lines], sep_after=[b"\n"])
        raw = out.data.tobytes()
        if meta.get("no_final_nl"):
            raw = raw[:-1]
        return raw
