"""--biopsy: write one VB's exact raw text to a file, for reproducing a bug.

Counterpart of genozip_tpu/biopsy.py: the VBs are the ones `zip` would
make of the input at the same VB size. Reference parity: src/biopsy.c
biopsy_take :77.
"""

from .datatypes import detect, get
from .txtfile import TxtReader, DEFAULT_VB_SIZE


def biopsy_take(in_path: str, vb_n: int, dt_name=None,
                vb_size: int | None = DEFAULT_VB_SIZE) -> str:
    """Write VB `vb_n` (1-based) of `in_path` to `in_path`.vb<vb_n>; returns
    that path."""
    reader = TxtReader(in_path)
    try:
        head = reader.peek(64 * 1024)
        dt = get(dt_name or detect(in_path, head))()
        dt.read_txt_header(reader)
        out_path = f"{in_path}.vb{vb_n}"
        for i, data in enumerate(reader.vblocks(dt, vb_size), start=1):
            if i == vb_n:
                with open(out_path, "wb") as f:
                    f.write(data.tobytes())
                return out_path
    finally:
        reader.close()
    raise ValueError(f"input has fewer than {vb_n} VBs")
