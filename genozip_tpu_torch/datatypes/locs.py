"""Illumina .locs cluster-position datatype plugin; counterpart of
genozip_tpu/datatypes/locs.py.

Reference parity: src/locs.c — 12-byte header (u32 1, f32 1.0, u32 n) then
n (f32 x, f32 y) pairs; the x/y planes compress via byte-plane striping.
"""

import numpy as np

from . import DataType, VBSegResult, register
from ..contexts import VBCtx, MODE_TXT

HDR = 12
REC = 8


@register
class LocsDT(DataType):
    NAME = "locs"

    def read_txt_header(self, reader) -> bytes:
        hdr = reader.peek(HDR)[:HDR]
        reader.buf = reader.buf[len(hdr):]
        return hdr

    def vb_boundary(self, data: np.ndarray, is_eof: bool) -> int:
        n = (data.shape[0] // REC) * REC
        if is_eof and n != data.shape[0]:
            return data.shape[0]  # trailing garbage kept verbatim
        return n if n else (data.shape[0] if is_eof else 0)

    def seg_vb(self, data: np.ndarray) -> VBSegResult:
        n = data.shape[0] // REC
        body = data[: n * REC]
        tail = data[n * REC:]
        xy = np.frombuffer(body.tobytes(), "<f4").reshape(n, 2)
        ctxs = {
            "LOCSX": VBCtx("LOCSX", MODE_TXT,
                           local=np.ascontiguousarray(xy[:, 0]).view(np.uint8),
                           cat="float"),
            "LOCSY": VBCtx("LOCSY", MODE_TXT,
                           local=np.ascontiguousarray(xy[:, 1]).view(np.uint8),
                           cat="float"),
        }
        if tail.shape[0]:
            ctxs["TAIL"] = VBCtx("TAIL", MODE_TXT, local=tail, cat="text")
        return VBSegResult(ctxs, n, {"n": n, "tail": int(tail.shape[0])})

    def recon_vb(self, pctxs: dict, meta: dict) -> bytes:
        n = meta["n"]
        x = np.frombuffer(pctxs["LOCSX"].local.tobytes(), "<f4")
        y = np.frombuffer(pctxs["LOCSY"].local.tobytes(), "<f4")
        xy = np.empty((n, 2), dtype="<f4")
        xy[:, 0] = x
        xy[:, 1] = y
        out = xy.tobytes()
        if meta.get("tail"):
            out += pctxs["TAIL"].local.tobytes()
        return out
