"""Generic datatype: whole-VB blob with codec auto-selection; counterpart
of genozip_tpu/datatypes/generic.py.

Reference parity: src/generic.c (whole-file blob with header sniffing).
"""

import numpy as np

from . import DataType, VBSegResult, register
from ..contexts import VBCtx, MODE_TXT


@register
class GenericDT(DataType):
    NAME = "generic"

    def vb_boundary(self, data: np.ndarray, is_eof: bool) -> int:
        return data.shape[0]

    def seg_vb(self, data: np.ndarray) -> VBSegResult:
        ctxs = {"DATA": VBCtx("DATA", MODE_TXT, local=data, cat="text")}
        return VBSegResult(ctxs, 1, {"len": int(data.shape[0])})

    def recon_vb(self, pctxs: dict, meta: dict) -> bytes:
        return pctxs["DATA"].local.tobytes()
