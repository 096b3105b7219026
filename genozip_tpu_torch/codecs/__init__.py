"""Codec registry: entropy and transform codecs for section payloads.

Counterpart of genozip_tpu/codecs/__init__.py (codec ids, payload layouts and
bytes are the same). rANS payloads of `min_size` bytes or more go to the
kernels of `ops.rans_cuda` on the device set by `enable_device_rans`; smaller
ones, and all of them while no device is set, go to the host coder of the
C++ host runtime (`native.rans_encode`, whose bytes are `ops.rans_np`'s).
ARITH, PACK and ACGT and the byte histogram also run there, as in
genozip_tpu with its native runtime. Every stream takes
`rans_np.choose_num_lanes(n)` lanes and is never padded, so the device route
writes the same bytes as the host route. A failure of the device route raises
`DeviceKernelError`; nothing falls back to the host coder.

Every compress() returns a self-contained payload; the codec id travels in the
section header (format/sections.py), `uncomp_len` with it.
"""

import bz2 as _bz2
import lzma as _lzma
import zlib as _zlib

import numpy as np
import torch

from .. import native
from ..ops import rans_cuda
from ..ops.rans_cuda import DeviceKernelError  # noqa: F401  (re-export)

# codec ids (u8), stable on-disk values
NONE = 0
RANS0 = 1     # wide-interleaved rANS order-0
RANS1 = 2     # order-1
PACK0 = 3     # <=16 distinct symbols: bit-pack, then rANS order-0 on packed
PACK1 = 4     # bit-pack, then rANS order-1 on packed
ZLIB = 5
BZ2 = 6
LZMA = 7
ACGT = 8      # DNA 2-bit pack + exception channel
DELTA_RANS = 9   # byte-wise delta then rANS order-0 (pos-like streams)
RLE0 = 10     # run-length (value,run) pairs, each rANS'd — long-run streams
DOMQ = 11     # dominant-symbol quality: RLE'd dom-mask + rANS'd exceptions
STRIPE4 = 12  # 4-byte-plane transpose then order-1 rANS (u32/f32 arrays)
ARITH0 = 13   # wide-interleaved adaptive range coder, order-0
ARITH1 = 14   # order-1 (context = previous byte)
BWT = 15      # block-sorting + adaptive coder (codecs/bwt.py)
ACGT_LZ = 16  # 2-bit pack + LZMA-1 over the packed stream

NAMES = {NONE: "NONE", RANS0: "RANS0", RANS1: "RANS1", PACK0: "PACK0",
         PACK1: "PACK1", ZLIB: "ZLIB", BZ2: "BZ2", LZMA: "LZMA", ACGT: "ACGT",
         DELTA_RANS: "DELTA", RLE0: "RLE0", DOMQ: "DOMQ", STRIPE4: "STRIPE4",
         ARITH0: "ARITH0", ARITH1: "ARITH1", BWT: "BWT", ACGT_LZ: "ACGTLZ"}

_OFF = 1 << 62
_device = None     # torch.device of the rANS kernels; None = host coders only
_min_size = _OFF


def enable_device_rans(device, min_size: int = 256 * 1024):
    """Route rANS payloads of `min_size` bytes or more to the kernels on
    `device` ('cuda' or 'cpu'; on the CPU the kernels' plain versions run).
    Raises when 'cuda' is asked for and no GPU is present."""
    global _device, _min_size
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA GPU is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    _device, _min_size = dev, min_size


def disable_device_rans():
    global _device, _min_size
    _device, _min_size = None, _OFF


def device():
    """The kernels' device (None: host coders only, and the plain AES on the
    CPU)."""
    return _device


def device_batch_min() -> int:
    """Payload size from which rANS goes to the device (0 = no device)."""
    return _min_size if _device is not None else 0


def compress_many_rans(payloads, order: int) -> list:
    """Encode any number of payloads in one kernel launch; each stream equals
    the host coder's."""
    return rans_cuda.encode_many(payloads, order, _device)


def decompress_many_rans(blobs) -> list:
    """Decode any number of rANS streams of one order in one launch."""
    return rans_cuda.decode_many(blobs, _device)


def _rans_encode(data: bytes, order: int) -> bytes:
    if _device is not None and len(data) >= _min_size:
        return compress_many_rans([data], order)[0]
    return native.rans_encode(data, order)


def _rans_decode(blob) -> bytes:
    n = int.from_bytes(bytes(blob[2:6]), "little")
    if _device is not None and n >= _min_size:
        return decompress_many_rans([blob])[0]
    return native.rans_decode(blob)


def _byte_hist(a: np.ndarray) -> np.ndarray:
    return native.byte_hist(a)


def _pack_encode(data: bytes, order: int) -> bytes:
    a = np.frombuffer(data, np.uint8)
    syms = np.nonzero(_byte_hist(a))[0].astype(np.uint8)
    ns = syms.shape[0]
    if ns <= 2:
        width = 1
    elif ns <= 4:
        width = 2
    elif ns <= 16:
        width = 4
    else:
        raise ValueError("PACK needs <=16 distinct symbols")
    lut = np.zeros(256, np.uint8)
    lut[syms] = np.arange(ns, dtype=np.uint8)
    packed = native.pack_lut(a, lut, width)
    sub = _rans_encode(packed.tobytes(), order)
    head = bytes([ns, width]) + len(a).to_bytes(8, "little") + syms.tobytes()
    return head + sub


def _pack_decode(blob) -> bytes:
    blob = memoryview(blob)
    ns, width = blob[0], blob[1]
    n = int.from_bytes(blob[2:10], "little")
    syms = np.frombuffer(blob[10:10 + ns], np.uint8)
    packed = np.frombuffer(_rans_decode(blob[10 + ns:]), np.uint8)
    return native.unpack_lut(packed, n, width, syms).tobytes()


def _acgt_encode(data: bytes, packed_lz: bool = False) -> bytes:
    a = np.frombuffer(data, np.uint8)
    packed, exc_pos, exc_bytes = native.acgt_pack(a)
    p = _lzma.compress(packed.tobytes(), preset=1) if packed_lz \
        else _rans_encode(packed.tobytes(), 0)
    e_pos = _rans_encode(np.diff(exc_pos, prepend=np.uint32(0)).astype("<u4").tobytes(), 0)
    e_b = _rans_encode(exc_bytes.tobytes(), 0)
    head = len(a).to_bytes(8, "little") + len(exc_pos).to_bytes(8, "little") + \
        len(p).to_bytes(8, "little") + len(e_pos).to_bytes(8, "little")
    return head + p + e_pos + e_b


def _acgt_decode(blob, packed_lz: bool = False) -> bytes:
    blob = memoryview(blob)
    n = int.from_bytes(blob[0:8], "little")
    ne = int.from_bytes(blob[8:16], "little")
    lp = int.from_bytes(blob[16:24], "little")
    lep = int.from_bytes(blob[24:32], "little")
    off = 32
    packed = np.frombuffer(
        _lzma.decompress(bytes(blob[off:off + lp])) if packed_lz
        else _rans_decode(blob[off:off + lp]), np.uint8)
    off += lp
    exc_pos = np.cumsum(np.frombuffer(_rans_decode(blob[off:off + lep]), "<u4")[:ne].astype(np.int64))
    off += lep
    exc_bytes = np.frombuffer(_rans_decode(blob[off:]), np.uint8)[:ne]
    if exc_pos.shape[0] != ne:
        raise ValueError("ACGT exception channel length mismatch")
    return native.acgt_unpack(packed, n, exc_pos, exc_bytes).tobytes()


def _delta_encode(data: bytes) -> bytes:
    a = np.frombuffer(data, np.uint8)
    d = np.diff(a, prepend=np.uint8(0))
    return _rans_encode(d.tobytes(), 0)


def _delta_decode(blob) -> bytes:
    d = np.frombuffer(_rans_decode(blob), np.uint8)
    return np.cumsum(d.astype(np.uint64)).astype(np.uint8).tobytes()


def _rle_encode(data: bytes) -> bytes:
    a = np.frombuffer(data, np.uint8)
    if a.shape[0] == 0:
        return (0).to_bytes(8, "little")
    change = np.concatenate([[True], a[1:] != a[:-1]])
    starts = np.nonzero(change)[0]
    vals = a[starts]
    runs = np.diff(np.concatenate([starts, [a.shape[0]]]))
    # u32 runs, striped by byte plane so order-0 rANS sees each byte
    # position's own distribution (hi planes are ~all zero)
    v = _rans_encode(vals.tobytes(), 0)
    rb = np.ascontiguousarray(runs.astype("<u4").view(np.uint8).reshape(-1, 4).T)
    r = _rans_encode(rb.tobytes(), 0)
    return len(vals).to_bytes(8, "little") + len(v).to_bytes(8, "little") + v + r


def _rle_decode(blob) -> bytes:
    blob = memoryview(blob)
    nr = int.from_bytes(blob[0:8], "little")
    if nr == 0:
        return b""
    lv = int.from_bytes(blob[8:16], "little")
    vals = np.frombuffer(_rans_decode(blob[16:16 + lv]), np.uint8)[:nr]
    rb = np.frombuffer(_rans_decode(blob[16 + lv:]), np.uint8)[:4 * nr]
    runs = np.ascontiguousarray(rb.reshape(4, -1).T).view("<u4").reshape(-1).astype(np.int64)
    return np.repeat(vals, runs).tobytes()


def _domq_encode(data: bytes) -> bytes:
    """Dominant-quality codec: the dom-run structure (RLE of the dom mask)
    plus the exception bytes order-1 coded."""
    a = np.frombuffer(data, np.uint8)
    if a.shape[0] == 0:
        return bytes([0]) + (0).to_bytes(8, "little")
    counts = _byte_hist(a)
    dom = int(np.argmax(counts))
    mask = (a == dom).astype(np.uint8)
    exc = a[mask == 0]
    m = _rle_encode(mask.tobytes())
    e = _rans_encode(exc.tobytes(), 1)
    return bytes([dom]) + len(m).to_bytes(8, "little") + m + e


def _domq_decode(blob) -> bytes:
    blob = memoryview(blob)
    dom = blob[0]
    lm = int.from_bytes(blob[1:9], "little")
    if lm == 0 and len(blob) == 9:
        return b""
    mask = np.frombuffer(_rle_decode(blob[9:9 + lm]), np.uint8)
    exc = np.frombuffer(_rans_decode(blob[9 + lm:]), np.uint8)
    out = np.full(mask.shape[0], dom, dtype=np.uint8)
    nex = int((mask == 0).sum())
    out[mask == 0] = exc[:nex]
    return out.tobytes()


def _stripe4_encode(data: bytes) -> bytes:
    """Byte-plane transpose for 4-byte-element arrays: each byte position
    gets its own run of the stream for order-1 rANS. Tail bytes (len%4)
    pass through uncoded."""
    n4 = len(data) // 4
    head = data[: n4 * 4]
    tail = data[n4 * 4:]
    a = np.frombuffer(head, np.uint8).reshape(-1, 4)
    planes = np.ascontiguousarray(a.T).tobytes()
    sub = _rans_encode(planes, 1)
    return len(tail).to_bytes(1, "little") + tail + sub


def _stripe4_decode(blob) -> bytes:
    blob = memoryview(blob)
    lt = blob[0]
    tail = bytes(blob[1:1 + lt])
    planes = np.frombuffer(_rans_decode(blob[1 + lt:]), np.uint8)
    n4 = planes.shape[0] // 4
    a = np.ascontiguousarray(planes[:4 * n4].reshape(4, -1).T)
    return a.tobytes() + tail


def compress(data: bytes, codec: int) -> bytes:
    if codec == NONE:
        return bytes(data)
    if codec == RANS0:
        return _rans_encode(data, 0)
    if codec == RANS1:
        return _rans_encode(data, 1)
    if codec == PACK0:
        return _pack_encode(data, 0)
    if codec == PACK1:
        return _pack_encode(data, 1)
    if codec == ZLIB:
        return _zlib.compress(bytes(data), 6)
    if codec == BZ2:
        return _bz2.compress(bytes(data), 9)
    if codec == LZMA:
        return _lzma.compress(bytes(data), preset=6)
    if codec == ACGT:
        return _acgt_encode(data)
    if codec == ACGT_LZ:
        return _acgt_encode(data, packed_lz=True)
    if codec == DELTA_RANS:
        return _delta_encode(data)
    if codec == RLE0:
        return _rle_encode(data)
    if codec == DOMQ:
        return _domq_encode(data)
    if codec == STRIPE4:
        return _stripe4_encode(data)
    if codec == ARITH0:
        return native.arith_encode(data, 0)
    if codec == ARITH1:
        return native.arith_encode(data, 1)
    if codec == BWT:
        from . import bwt
        return bwt.compress(bytes(data), ARITH1)
    raise ValueError(f"unknown codec {codec}")


def decompress(blob, codec: int, uncomp_len: int) -> bytes:
    if codec == NONE:
        out = bytes(blob)
    elif codec in (RANS0, RANS1):
        out = _rans_decode(blob)
    elif codec in (PACK0, PACK1):
        out = _pack_decode(blob)
    elif codec == ZLIB:
        out = _zlib.decompress(bytes(blob))
    elif codec == BZ2:
        out = _bz2.decompress(bytes(blob))
    elif codec == LZMA:
        out = _lzma.decompress(bytes(blob))
    elif codec == ACGT:
        out = _acgt_decode(blob)
    elif codec == ACGT_LZ:
        out = _acgt_decode(blob, packed_lz=True)
    elif codec == DELTA_RANS:
        out = _delta_decode(blob)
    elif codec == RLE0:
        out = _rle_decode(blob)
    elif codec == DOMQ:
        out = _domq_decode(blob)
    elif codec == STRIPE4:
        out = _stripe4_decode(blob)
    elif codec in (ARITH0, ARITH1):
        out = native.arith_decode(blob)
    elif codec == BWT:
        from . import bwt
        out = bwt.decompress(blob)
    else:
        raise ValueError(f"unknown codec {codec}")
    if len(out) > uncomp_len and codec in (RANS0, RANS1, DELTA_RANS):
        out = out[:uncomp_len]  # archives whose writer padded device streams
    if len(out) != uncomp_len:
        raise ValueError(f"codec {NAMES.get(codec)} length mismatch: "
                         f"{len(out)} != {uncomp_len}")
    return out
