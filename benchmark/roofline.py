"""The least time the card could take for the rANS coders' work.

A frozen copy of `chip_smoke.py`'s `HBM_BPS`, `INT_OPS`, `OPS_PER_SYMBOL`,
`stream_bytes` and `bound_ms`. The peaks are one NVIDIA H100 SXM's at its
700 W limit: 3.35 TB/s of HBM3, and 32-bit integer operations at 64 lanes an
SM a clock x 132 SMs x 1.98 GHz. A coder must read each symbol and write
each coded word once (or the reverse), read its tables, and do about ten
32-bit operations a symbol (a table lookup, a multiply-add, a compare, a
rank and a store), whatever its kernels do beyond that.
"""

HBM_BPS = 3.35e12          # bytes a second
INT_OPS = 16.7e12          # 32-bit integer operations a second
OPS_PER_SYMBOL = 10


def tab_bytes(order: int, streams: int) -> int:
    """The frequency and cumulative tables of `streams` streams as the
    kernels take them: int32 (R, 2, 256) for order 0, (R, 2, 256, 256) for
    order 1."""
    return streams * 2 * 4 * (256 if order == 0 else 65536)


def stream_bytes(symbols: int, coded: int, tables: int) -> int:
    """Bytes a coder must move: the symbols, the coded streams and the
    tables, each once."""
    return symbols + coded + tables


def bound_s(nbytes: int, ops: int) -> float:
    """Least seconds on the card: bytes over HBM_BPS against operations over
    INT_OPS, whichever is longer."""
    return max(nbytes / HBM_BPS, ops / INT_OPS)


def call_bound_s(order: int, streams: int, symbols: int, coded: int) -> float:
    """The bound of one batched coder call of `streams` streams holding
    `symbols` symbols and `coded` bytes of coded streams in all."""
    return bound_s(stream_bytes(symbols, coded, tab_bytes(order, streams)),
                   symbols * OPS_PER_SYMBOL)
