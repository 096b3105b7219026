"""The port's C++ host runtime: gxz_host.cpp, bound with ctypes.

Counterpart of genozip_tpu/native/: the host functions that genozip_tpu
sends to its C++ runtime, under the same names, returning what the port's
numpy versions return (each stays in its module as the tests' oracle). The
port's modules call these where genozip_tpu has its `native.available()`
branches; archive bytes are those of the numpy path.

The library is built at first use with g++ from the source beside this file
into genozip_tpu_torch/build/libgxz_host.so, with the C++ standard library
only (no zlib or libdeflate: deflate stays in Python's zlib). The build holds
an flock on a lock file in build/ (test workers and child processes build at
the same time), writes a per-process temporary file and renames it, and runs
again when the source or the flags change. A failed build or load raises
HostRuntimeError with g++'s message; nothing falls back to numpy.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
import zlib

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "gxz_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
LIB = os.path.join(BUILD_DIR, "libgxz_host.so")
CXXFLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# -DGXZ_NO_AVX512 compiles the AVX-512 rANS cores out
NO_AVX512 = ("-DGXZ_NO_AVX512",)

_O1_RAW_CAP = 32 + 256 * (32 + 512)

_lock = threading.Lock()
_lib = None
build_seconds = 0.0      # the last build's g++ time in this process


class HostRuntimeError(RuntimeError):
    """The host runtime failed to build or load, or refused its input."""


def _key(flags) -> str:
    with open(SOURCE, "rb") as f:
        src = f.read()
    return hashlib.sha256(src + "\0".join(flags).encode()).hexdigest()


def build(out: str = LIB, flags=CXXFLAGS) -> float:
    """Compile gxz_host.cpp into `out` unless it is up to date with the
    source and `flags`; returns g++'s seconds (0.0 when up to date)."""
    global build_seconds
    os.makedirs(os.path.dirname(out), exist_ok=True)
    key = _key(flags)
    stamp = out + ".key"
    with open(out + ".lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            with open(stamp) as f:
                if f.read() == key and os.path.exists(out):
                    return 0.0
        except OSError:
            pass
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", *flags, SOURCE, "-o", tmp]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise HostRuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise HostRuntimeError(
                f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
        with open(stamp + f".{os.getpid()}", "w") as f:
            f.write(key)
        os.replace(stamp + f".{os.getpid()}", stamp)
        build_seconds = time.perf_counter() - t0
        return build_seconds


_vp, _i64, _int, _u8 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_uint8)
_SIGS = {
    "gxz_host_avx512": (_int, []),
    "gxz_host_avx512_compiled": (_int, []),
    "gxz_rans_log_lanes": (_int, [_i64]),
    "gxz_rans_freqs": (_i64, [_vp, _i64, _int, _vp]),
    "gxz_rans_encode": (_i64, [_vp, _i64, _int, _vp, _i64, _vp, _i64]),
    "gxz_rans_decode": (_i64, [_vp, _i64, _vp, _i64, _i64, _vp, _i64]),
    "gxz_arith_encode": (_i64, [_vp, _i64, _int, _vp, _i64]),
    "gxz_arith_decode": (_i64, [_vp, _i64, _vp, _i64]),
    "gxz_byte_hist": (None, [_vp, _i64, _vp]),
    "gxz_pack_lut": (None, [_vp, _i64, _vp, _int, _vp]),
    "gxz_unpack_lut": (_int, [_vp, _i64, _i64, _int, _vp, _int, _vp]),
    "gxz_acgt_pack": (_i64, [_vp, _i64, _vp, _vp, _vp]),
    "gxz_acgt_unpack": (_int, [_vp, _i64, _i64, _vp, _vp, _i64, _vp]),
    "gxz_bwt_walk": (None, [_vp, _vp, _i64, _i64, _vp]),
    "gxz_pbwt_encode": (None, [_vp, _i64, _i64, _vp]),
    "gxz_pbwt_decode": (None, [_vp, _i64, _i64, _vp]),
    "gxz_bam_scan": (_i64, [_vp, _i64, _vp, _i64, _vp]),
    "gxz_nib_expand": (_i64, [_vp, _i64, _vp, _vp, _i64, _vp, _vp]),
    "gxz_renibble": (None, [_vp, _vp, _i64, _vp, _vp, _vp]),
    "gxz_seq_diff": (_i64, [_vp, _vp, _i64, _vp, _vp, _vp, _vp, _vp, _vp,
                            _vp, _i64, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                            _vp, _vp, _vp, _i64, _vp, _vp]),
    "gxz_seq_recon": (_int, [_vp, _i64, _vp, _i64, _vp, _vp, _vp, _vp, _vp,
                             _vp, _vp, _vp, _i64, _vp, _i64, _vp, _vp, _vp,
                             _vp, _i64, _vp]),
    "gxz_ref_populate": (None, [_vp, _vp, _vp, _vp, _i64, _vp, _vp, _vp,
                                _vp, _vp, _i64, _i64]),
    "gxz_copy_ranges": (_int, [_vp, _vp, _vp, _vp, _vp, _i64, _i64, _i64,
                               _int]),
    "gxz_count_eq": (None, [_vp, _vp, _i64, _u8, _vp]),
    "gxz_atoi": (None, [_vp, _i64, _vp, _i64, _vp, _vp]),
    "gxz_itoa": (_i64, [_vp, _i64, _vp, _vp]),
    "gxz_tokenize": (_i64, [_vp, _vp, _i64, _i64, _vp, _vp, _vp, _vp, _vp,
                            _vp]),
    "gxz_row_hash": (None, [_vp, _vp, _i64, _vp]),
    "gxz_rows_equal_rep": (_int, [_vp, _vp, _vp, _i64]),
    "gxz_reverse_rows": (None, [_vp, _vp, _vp, _i64, _vp]),
    "gxz_stride_boundary": (_i64, [_vp, _i64, _i64]),
    "gxz_int_list_stats": (None, [_vp, _vp, _i64, _vp, _vp, _vp, _vp, _vp]),
    "gxz_int_list_parse": (None, [_vp, _vp, _i64, _vp, _vp, _vp, _vp]),
    "gxz_split_fields": (None, [_vp, _vp, _i64, _u8, _int, _vp, _vp, _vp]),
    "gxz_join_cells": (None, [_vp, _vp, _vp, _i64, _u8, _vp, _vp]),
    "gxz_xxh64": (ctypes.c_uint64, [ctypes.c_uint64, _vp, _i64]),
}


def load(path: str = LIB):
    """ctypes handle of a built library, with its signatures set; `.avx`
    says whether its rANS calls take the AVX-512 cores."""
    try:
        L = ctypes.CDLL(path)
    except OSError as e:
        raise HostRuntimeError(f"cannot load {path}: {e}") from e
    for name, (res, args) in _SIGS.items():
        fn = getattr(L, name)
        fn.restype = res
        fn.argtypes = args
    L.avx = bool(L.gxz_host_avx512())
    return L


def lib():
    """The runtime, built on first use."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                build()
                _lib = load()
    return _lib


def avx512() -> bool:
    """The rANS calls take the AVX-512 cores (compiled in, and the CPU has
    avx512f/bw/vl)."""
    return lib().avx


def _u8a(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.reshape(-1).view(np.uint8))
    return np.frombuffer(data, np.uint8)


def _c(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


def _p(a: np.ndarray) -> int:
    return a.ctypes.data


def _offsets(offsets, size: int) -> np.ndarray:
    """Row offsets as contiguous int64, checked to lie in [0, size] and not
    to decrease (the C++ side trusts them)."""
    off = _c(offsets, np.int64)
    if off.shape[0] and (off[0] < 0 or off[-1] > size
                         or (off[1:] < off[:-1]).any()):
        raise ValueError("row offsets outside their data or decreasing")
    return off


def _indices(idx, n: int) -> np.ndarray:
    """Row indices as contiguous int64, checked to lie in [0, n)."""
    idx = _c(idx, np.int64)
    if idx.shape[0] and (idx.min() < 0 or idx.max() >= n):
        raise IndexError("row index out of range")
    return idx


def _check_genome(codes: np.ndarray):
    # the 2-bit genome is read in place (copying it a VB would cost more
    # than the diff)
    if codes.dtype != np.uint8 or not codes.flags.c_contiguous:
        raise ValueError("the genome codes must be contiguous uint8")


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def rans_encode(data, order: int = 0, so=None) -> bytes:
    """ops.rans_np.encode(data, order)'s bytes. `so`, a build from `load`,
    takes the place of the runtime (a NO_AVX512 build: the scalar coder)."""
    L = so or lib()
    a = _u8a(data)
    n = a.shape[0]
    raw = np.empty(_O1_RAW_CAP, np.uint8)
    rl = L.gxz_rans_freqs(_p(a), n, order, _p(raw))
    raw = raw[:rl]
    if order:
        comp = zlib.compress(raw.tobytes(), 6)
        ftab = rl.to_bytes(4, "little") + len(comp).to_bytes(4, "little") \
            + comp
    else:
        ftab = raw.tobytes()
    N = 1 << L.gxz_rans_log_lanes(n)
    cap = 2 * (n + 2 * N + 8)
    out = np.empty(cap, np.uint8)
    r = L.gxz_rans_encode(_p(a), n, order, _p(raw), rl, _p(out), cap)
    if r < 0:
        raise HostRuntimeError(f"rans encode failed ({r})")
    head = bytes([L.gxz_rans_log_lanes(n), order]) + n.to_bytes(4, "little")
    return head + ftab + out[:r].tobytes()


def rans_decode(blob, so=None) -> bytes:
    """ops.rans_np.decode(blob); ValueError on a damaged stream. `so` as in
    rans_encode."""
    L = so or lib()
    a = _u8a(blob)
    if a.shape[0] < 6:
        raise ValueError("rANS stream shorter than its header")
    order = int(a[1])
    n = int.from_bytes(a[2:6].tobytes(), "little")
    raw1 = np.zeros(1, np.uint8)
    words_off = 0
    if order == 1:
        rawlen = int.from_bytes(a[6:10].tobytes(), "little")
        clen = int.from_bytes(a[10:14].tobytes(), "little")
        raw = zlib.decompress(a[14:14 + clen].tobytes())
        if len(raw) != rawlen:
            raise ValueError("rANS order-1 table length mismatch")
        raw1 = np.frombuffer(raw, np.uint8)
        words_off = 14 + clen
    out = np.empty(max(n, 1), np.uint8)
    r = L.gxz_rans_decode(_p(a), a.shape[0], _p(raw1), raw1.shape[0],
                          words_off, _p(out), n)
    if r != n:
        raise ValueError(f"damaged rANS stream ({r})")
    return out[:n].tobytes()


def arith_encode(data, order: int = 0) -> bytes:
    """ops.arith_np.encode(data, order)'s bytes."""
    a = _u8a(data)
    n = a.shape[0]
    cap = 2 * n + (1 << 12)
    while True:         # a symbol costs at most 15 bits; room is retried
        out = np.empty(cap, np.uint8)
        r = lib().gxz_arith_encode(_p(a), n, order, _p(out), cap)
        if r >= 0:
            return out[:r].tobytes()
        cap *= 2


def arith_decode(blob) -> bytes:
    """ops.arith_np.decode(blob); ValueError on a damaged stream."""
    a = _u8a(blob)
    if a.shape[0] < 6:
        raise ValueError("arith stream shorter than its header")
    n = int.from_bytes(a[2:6].tobytes(), "little")
    out = np.empty(max(n, 1), np.uint8)
    r = lib().gxz_arith_decode(_p(a), a.shape[0], _p(out), n)
    if r != n:
        raise ValueError(f"damaged arith stream ({r})")
    return out[:n].tobytes()


def byte_hist(a: np.ndarray) -> np.ndarray:
    """np.bincount(a, minlength=256) of a uint8 array."""
    a = _c(a, np.uint8)
    out = np.empty(256, np.int64)
    lib().gxz_byte_hist(_p(a), a.shape[0], _p(out))
    return out


def pack_lut(data: np.ndarray, lut: np.ndarray, width: int) -> np.ndarray:
    """ops.pack.pack_np(lut[data], width)."""
    data = _c(data, np.uint8)
    lut = _c(lut, np.uint8)
    n = data.shape[0]
    per = 8 // width
    out = np.empty((n + per - 1) // per, np.uint8)
    lib().gxz_pack_lut(_p(data), n, _p(lut), width, _p(out))
    return out


def unpack_lut(packed: np.ndarray, n: int, width: int,
               syms: np.ndarray) -> np.ndarray:
    """syms[ops.pack.unpack_np(packed, width, n)]; ValueError where a code
    has no symbol or the packed bytes are short."""
    packed = _c(packed, np.uint8)
    full = np.zeros(16, np.uint8)
    full[:syms.shape[0]] = syms
    out = np.empty(max(n, 1), np.uint8)
    if lib().gxz_unpack_lut(_p(packed), packed.shape[0], n, width, _p(full),
                            syms.shape[0], _p(out)) < 0:
        raise ValueError("PACK payload does not match its symbols")
    return out[:n]


def acgt_pack(seq: np.ndarray):
    """ops.pack.seq_pack_2bit(seq): (packed, exception positions u32,
    exception bytes)."""
    seq = _c(seq, np.uint8)
    n = seq.shape[0]
    packed = np.empty((n + 3) // 4, np.uint8)
    exc_pos = np.empty(max(n, 1), np.uint32)
    exc_bytes = np.empty(max(n, 1), np.uint8)
    ne = lib().gxz_acgt_pack(_p(seq), n, _p(packed), _p(exc_pos),
                             _p(exc_bytes))
    return packed, exc_pos[:ne].copy(), exc_bytes[:ne].copy()


def acgt_unpack(packed: np.ndarray, n: int, exc_pos: np.ndarray,
                exc_bytes: np.ndarray) -> np.ndarray:
    """ops.pack.seq_unpack_2bit(packed, n, exc_pos, exc_bytes)."""
    packed = _c(packed, np.uint8)
    ep = _c(exc_pos, np.int64)
    eb = _c(exc_bytes, np.uint8)
    if eb.shape[0] < ep.shape[0]:
        raise ValueError("ACGT exception channel length mismatch")
    out = np.empty(max(n, 1), np.uint8)
    if lib().gxz_acgt_unpack(_p(packed), packed.shape[0], n, _p(ep), _p(eb),
                             ep.shape[0], _p(out)) < 0:
        raise ValueError("ACGT payload does not match its length")
    return out[:n]


def perm_walk(lf: np.ndarray, li: np.ndarray, prim: int,
              n: int) -> np.ndarray:
    """The inverse-BWT walk of codecs/bwt.bwt_inverse over its LF mapping
    (rows 0..n)."""
    lf = _c(lf, np.int64)
    li = _c(li, np.int64)
    if lf.shape[0] != n + 1 or li.shape[0] != n + 1 or not 0 <= prim <= n:
        raise ValueError("BWT block does not match its primary index")
    out = np.empty(max(n, 1), np.uint8)
    lib().gxz_bwt_walk(_p(lf), _p(li), prim, n, _p(out))
    return out[:n]


def pbwt_encode(A: np.ndarray) -> np.ndarray:
    """ops.pbwt.pbwt_encode_np(A)."""
    A = _c(A, np.uint8)
    n, H = A.shape
    Y = np.empty_like(A)
    lib().gxz_pbwt_encode(_p(A), n, H, _p(Y))
    return Y


def pbwt_decode(Y: np.ndarray) -> np.ndarray:
    """ops.pbwt.pbwt_decode_np(Y)."""
    Y = _c(Y, np.uint8)
    n, H = Y.shape
    A = np.empty_like(Y)
    lib().gxz_pbwt_decode(_p(Y), n, H, _p(A))
    return A


# ---------------------------------------------------------------------------
# BAM and SAM
# ---------------------------------------------------------------------------

def bam_scan(data: np.ndarray, max_records: int):
    """Walk the BAM block_size chain -> (record offsets, bytes of whole
    records)."""
    data = _c(data, np.uint8)
    cap = max(0, min(max_records, data.shape[0] // 4 + 1))
    offsets = np.empty(max(cap, 1), np.int64)
    consumed = ctypes.c_int64(0)
    cnt = lib().gxz_bam_scan(_p(data), data.shape[0], _p(offsets), cap,
                             ctypes.byref(consumed))
    return offsets[:cnt].copy(), int(consumed.value)


def nib_expand(nib_data, offsets, lseq):
    """BAM 4-bit SEQ rows -> (ASCII data, ASCII offsets, per-row ok)."""
    nib_data = _c(nib_data, np.uint8)
    offsets = _offsets(offsets, nib_data.shape[0])
    lseq = _c(lseq, np.int64)
    if lseq.shape[0] != offsets.shape[0] - 1 or (lseq < 0).any():
        raise ValueError("nib_expand: a length a row, none negative")
    n = offsets.shape[0] - 1
    out_off = np.concatenate([[0], np.cumsum(lseq)]).astype(np.int64)
    out = np.empty(max(int(out_off[-1]), 1), np.uint8)
    ok = np.empty(max(n, 1), np.uint8)
    r = lib().gxz_nib_expand(_p(nib_data), nib_data.shape[0], _p(offsets),
                             _p(lseq), n, _p(out), _p(ok))
    if r < 0:
        raise IndexError("BAM SEQ row reads past its record data")
    return out[:out_off[-1]], out_off, ok[:n].view(bool)


def renibble(data, offsets, nib_of, out_off) -> np.ndarray:
    """ASCII SEQ rows -> BAM nibble rows at out_off."""
    data = _c(data, np.uint8)
    offsets = _offsets(offsets, data.shape[0])
    nib_of = _c(nib_of, np.uint8)
    out_off = _c(out_off, np.int64)
    if out_off.shape[0] != offsets.shape[0] or (
            out_off[1:] - out_off[:-1] < (offsets[1:] - offsets[:-1] + 1)
            // 2).any():
        raise ValueError("renibble: out_off leaves no room for a row")
    out = np.zeros(max(int(out_off[-1]), 1), np.uint8)
    lib().gxz_renibble(_p(data), _p(offsets), offsets.shape[0] - 1,
                       _p(nib_of), _p(out), _p(out_off))
    return out[:out_off[-1]]


def seq_diff(seq_data, seq_off, by_ref, gpos0, letters, oplen, oprow, roff,
             goff, ref_codes, match_lut, ins_lut, base2bit, is_acgt,
             nonref_cap: int, is_set=None, read_unset=None):
    """SEQ against the genome in one pass over the op table -> (mismatch
    rows i32, positions i32, bases u8, NONREF bytes). With is_set and
    read_unset (REF_INTERNAL), the bases compared while unset are marked in
    read_unset."""
    n = seq_off.shape[0] - 1
    seq_data = _c(seq_data, np.uint8)
    a = [_offsets(seq_off, seq_data.shape[0]), _c(by_ref, np.uint8),
         _c(gpos0, np.int64),
         _c(letters, np.uint8), _c(oplen, np.int64), _c(oprow, np.int64),
         _c(roff, np.int64), _c(goff, np.int64)]
    luts = [_c(x, np.uint8) for x in (match_lut, ins_lut, base2bit, is_acgt)]
    _check_genome(ref_codes)
    iset = rset = 0
    if is_set is not None:
        iset = _p(is_set.view(np.uint8))
        rset = _p(read_unset.view(np.uint8))
    nonref = np.empty(max(nonref_cap, 1), np.uint8)
    nr_len = ctypes.c_int64(0)
    cap = max(4096, seq_data.shape[0] // 16)
    while True:
        mm_row = np.empty(cap, np.int32)
        mm_pos = np.empty(cap, np.int32)
        mm_base = np.empty(cap, np.uint8)
        cnt = lib().gxz_seq_diff(
            _p(seq_data), _p(a[0]), n, _p(a[1]), _p(a[2]), _p(a[3]),
            _p(a[4]), _p(a[5]), _p(a[6]), _p(a[7]), a[3].shape[0],
            _p(ref_codes), *[_p(x) for x in luts], iset, rset,
            _p(mm_row), _p(mm_pos), _p(mm_base), cap, _p(nonref),
            ctypes.byref(nr_len))
        if cnt <= cap:
            return (mm_row[:cnt], mm_pos[:cnt], mm_base[:cnt],
                    nonref[:nr_len.value])
        cap = int(cnt)
        iset = rset = 0     # already marked


def seq_recon(out_off, by_ref, gpos0, letters, oplen, oprow, roff, goff,
              ins_before, ref_codes, acgt, match_lut, ins_lut, nonref,
              nr_off) -> np.ndarray:
    """The inverse of seq_diff before the mismatch patches; IndexError where
    a row does not fit its buffers."""
    out_off = _c(out_off, np.int64)
    n = out_off.shape[0] - 1
    total = int(out_off[-1])
    out = np.zeros(max(total, 1), np.uint8)
    a = [_c(by_ref, np.uint8), _c(gpos0, np.int64), _c(letters, np.uint8),
         _c(oplen, np.int64), _c(oprow, np.int64), _c(roff, np.int64),
         _c(goff, np.int64), _c(ins_before, np.int64)]
    acgt4 = _c(acgt, np.uint8)
    if acgt4.shape[0] != 4:
        raise ValueError("seq_recon: acgt must have 4 letters")
    _check_genome(ref_codes)
    nonref = _c(nonref, np.uint8)
    nr_off = _c(nr_off, np.int64)
    m_lut, i_lut = _c(match_lut, np.uint8), _c(ins_lut, np.uint8)
    r = lib().gxz_seq_recon(
        _p(out), total, _p(out_off), n, *[_p(x) for x in a],
        a[2].shape[0], _p(ref_codes), ref_codes.shape[0], _p(acgt4),
        _p(m_lut), _p(i_lut), _p(nonref), nonref.shape[0], _p(nr_off))
    if r < 0:
        raise IndexError("SEQ op outside its row or the NONREF stream")
    return out[:total]


def ref_populate(seq_data, seq_off, rows, starts, base2bit, ref_codes,
                 is_set, blk_set, blk: int, read_unset=None):
    """Write pure reads into the genome where it was unset (REF_INTERNAL),
    the last read winning, bases in read_unset left alone; recount blk_set
    over the touched blocks. ref_codes, is_set (bool, padded to whole
    blocks) and blk_set are updated in place."""
    seq_data = _c(seq_data, np.uint8)
    seq_off = _offsets(seq_off, seq_data.shape[0])
    rows = _indices(rows, seq_off.shape[0] - 1)
    starts = _c(starts, np.int64)
    lens = seq_off[rows + 1] - seq_off[rows]
    if rows.shape[0] and (starts.shape[0] != rows.shape[0] or starts.min() < 0
                          or (starts + lens).max() > ref_codes.shape[0]):
        raise IndexError("ref_populate: a read outside the genome")
    b2b = _c(base2bit, np.uint8)
    for arr in (ref_codes, is_set, blk_set):
        if not arr.flags.c_contiguous or not arr.flags.writeable:
            raise ValueError("genome arrays must be contiguous and writable")
    if blk_set.dtype != np.int64 or is_set.shape[0] < blk_set.shape[0] * blk:
        raise ValueError("blk_set must be int64 over whole blocks")
    if read_unset is not None and read_unset.shape[0] < ref_codes.shape[0]:
        raise ValueError("ref_populate: read_unset shorter than the genome")
    ru = _p(read_unset.view(np.uint8)) if read_unset is not None else 0
    lib().gxz_ref_populate(_p(seq_data), _p(seq_off), _p(rows), _p(starts),
                           rows.shape[0], _p(b2b), _p(ref_codes),
                           _p(is_set.view(np.uint8)), ru, _p(blk_set),
                           blk_set.shape[0], blk)


# ---------------------------------------------------------------------------
# ragged columns
# ---------------------------------------------------------------------------

def copy_ranges(src: np.ndarray, src_starts, dst: np.ndarray, dst_starts,
                lens, packed: bool = False):
    """dst[dst_starts[i]:+lens[i]] = src[src_starts[i]:+lens[i]] for each
    row; IndexError (and nothing copied) when a range leaves its buffer.
    `packed`: the rows go to dst in order, back to back (a gather), so a
    short row is copied as 16 bytes that the next rows overwrite."""
    src = _c(src, np.uint8)
    ss = _c(src_starts, np.int64)
    ds = _c(dst_starts, np.int64)
    ln = _c(lens, np.int64)
    if not dst.flags.c_contiguous or dst.dtype != np.uint8:
        raise ValueError("copy_ranges: dst must be contiguous uint8")
    if lib().gxz_copy_ranges(_p(src), _p(ss), _p(dst), _p(ds), _p(ln),
                             ln.shape[0], src.shape[0], dst.shape[0],
                             int(packed)) < 0:
        raise IndexError("copy_ranges: a range leaves its buffer")


def count_eq(data, offsets, sep: int) -> np.ndarray:
    """Per-row count of bytes equal to sep."""
    data = _c(data, np.uint8)
    offsets = _offsets(offsets, data.shape[0])
    n = offsets.shape[0] - 1
    out = np.empty(max(n, 1), np.int64)
    lib().gxz_count_eq(_p(data), _p(offsets), n, sep, _p(out))
    return out[:n]


def atoi(data, offsets):
    """ragged.atoi's (int64 values, ok)."""
    data = _c(data, np.uint8)
    offsets = _offsets(offsets, data.shape[0])
    if data.shape[0] == 0:
        data = np.zeros(1, np.uint8)   # numpy's rows read a 0 there
    n = offsets.shape[0] - 1
    vals = np.empty(max(n, 1), np.int64)
    ok = np.empty(max(n, 1), np.uint8)
    lib().gxz_atoi(_p(data), data.shape[0], _p(offsets), n, _p(vals),
                   _p(ok))
    return vals[:n], ok[:n].view(bool)


def itoa(vals):
    """int64 rows -> (ASCII data, offsets)."""
    vals = _c(vals, np.int64)
    n = vals.shape[0]
    offsets = np.empty(n + 1, np.int64)
    L = lib()
    total = L.gxz_itoa(_p(vals), n, _p(offsets), None)
    out = np.empty(max(int(total), 1), np.uint8)
    L.gxz_itoa(_p(vals), n, _p(offsets), _p(out))
    return out[:total], offsets


def tokenize(data: np.ndarray, offsets: np.ndarray, max_tokens: int):
    """seg._tokenize_np's (template, template lengths, values, token
    indices, widths) in one pass."""
    data = _c(data, np.uint8)
    offsets = _offsets(offsets, data.shape[0])
    n = offsets.shape[0] - 1
    dl = data.shape[0]
    tmpl = np.empty(dl + 1, np.uint8)
    tmpl_lens = np.empty(max(n, 1), np.int64)
    cap = dl + 1            # a run a byte where every row is one digit
    values = np.empty(cap, np.int64)
    tok_idx = np.empty(cap, np.int32)
    widths = np.empty(cap, np.uint8)
    tmpl_total = ctypes.c_int64(0)
    nv = lib().gxz_tokenize(_p(data), _p(offsets), n,
                            min(max_tokens, (1 << 62)), _p(tmpl),
                            _p(tmpl_lens), _p(values), _p(tok_idx),
                            ctypes.byref(tmpl_total), _p(widths))
    return (tmpl[:tmpl_total.value], tmpl_lens[:n], values[:nv],
            tok_idx[:nv], widths[:nv])


def row_hash(data: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """A 64-bit hash of each row."""
    data = _c(data, np.uint8)
    offsets = _offsets(offsets, data.shape[0])
    n = offsets.shape[0] - 1
    out = np.empty(max(n, 1), np.uint64)
    lib().gxz_row_hash(_p(data), _p(offsets), n, _p(out))
    return out[:n]


def rows_equal_rep(data: np.ndarray, offsets: np.ndarray,
                   rep: np.ndarray) -> bool:
    """Every row equals row rep[i]."""
    data = _c(data, np.uint8)
    offsets = _offsets(offsets, data.shape[0])
    rep = _indices(rep, offsets.shape[0] - 1)
    if rep.shape[0] != offsets.shape[0] - 1:
        raise ValueError("rows_equal_rep: one representative a row")
    return bool(lib().gxz_rows_equal_rep(_p(data), _p(offsets), _p(rep),
                                         offsets.shape[0] - 1))


def reverse_rows(data: np.ndarray, offsets, rows, comp_lut=None):
    """Reverse (and complement through comp_lut) the selected rows of data
    in place."""
    if not data.flags.c_contiguous or data.dtype != np.uint8:
        raise ValueError("reverse_rows: data must be contiguous uint8")
    offsets = _offsets(offsets, data.shape[0])
    rows = _indices(rows, offsets.shape[0] - 1)
    lut = _c(comp_lut, np.uint8) if comp_lut is not None else None
    lib().gxz_reverse_rows(_p(data), _p(offsets), _p(rows), rows.shape[0],
                           _p(lut) if lut is not None else None)


def stride_boundary(data: np.ndarray, stride: int) -> int:
    """Offset just past the last newline whose ordinal is a multiple of
    stride (0 if none)."""
    data = _c(data, np.uint8)
    return int(lib().gxz_stride_boundary(_p(data), data.shape[0], stride))


# ---------------------------------------------------------------------------
# VCF
# ---------------------------------------------------------------------------

def int_list_stats(data: np.ndarray, offsets: np.ndarray):
    """Per-row (sum, lowest, second lowest, count, ok) of "int(,int)*"
    lists; the sum as np.bincount(weights=) computes it."""
    data = _c(data, np.uint8)
    offsets = _offsets(offsets, data.shape[0])
    C = offsets.shape[0] - 1
    sums, m1, m2 = (np.empty(max(C, 1), np.int64) for _ in range(3))
    nv = np.empty(max(C, 1), np.int32)
    ok = np.empty(max(C, 1), np.uint8)
    lib().gxz_int_list_stats(_p(data), _p(offsets), C, _p(sums), _p(m1),
                             _p(m2), _p(nv), _p(ok))
    return sums[:C], m1[:C], m2[:C], nv[:C], ok[:C].view(bool)


def int_list_parse(data: np.ndarray, offsets: np.ndarray):
    """(values of the rows that parse, values per row (0 elsewhere), ok)."""
    data = _c(data, np.uint8)
    offsets = _offsets(offsets, data.shape[0])
    C = offsets.shape[0] - 1
    cap = int(np.count_nonzero(data == ord(","))) + C + 1
    vals = np.empty(cap, np.int64)
    nv = np.empty(max(C, 1), np.int32)
    ok = np.empty(max(C, 1), np.uint8)
    total = np.zeros(1, np.int64)
    lib().gxz_int_list_parse(_p(data), _p(offsets), C, _p(vals), _p(nv),
                             _p(ok), _p(total))
    return (vals[:int(total[0])], nv[:C].astype(np.int64),
            ok[:C].view(bool))


def split_fields(data: np.ndarray, offsets: np.ndarray, sep: int, T: int):
    """Split each row on sep into at most T fields -> (f_start (T, C) i64,
    f_len (T, C) i32, nfields (C,) i32: T + 1 where a row has more)."""
    data = _c(data, np.uint8)
    offsets = _offsets(offsets, data.shape[0])
    C = offsets.shape[0] - 1
    f_start = np.empty((T, C), np.int64)
    f_len = np.empty((T, C), np.int32)
    nfields = np.empty(max(C, 1), np.int32)
    lib().gxz_split_fields(_p(data), _p(offsets), C, sep, T, _p(f_start),
                           _p(f_len), _p(nfields))
    return f_start, f_len, nfields[:C]


def join_cells(data: np.ndarray, offsets: np.ndarray, nsub: np.ndarray,
               sep: int):
    """Cell i = its nsub[i] consecutive rows joined by sep -> (bytes, cell
    offsets)."""
    data = _c(data, np.uint8)
    offsets = _offsets(offsets, data.shape[0])
    nsub32 = _c(nsub, np.int32)
    C = nsub32.shape[0]
    if int(nsub32.sum()) != offsets.shape[0] - 1:
        raise ValueError("join_cells: cells do not cover the rows")
    total = int(offsets[-1] - offsets[0]) + \
        int(np.maximum(nsub32.astype(np.int64) - 1, 0).sum())
    out = np.empty(max(total, 1), np.uint8)
    cell_off = np.empty(C + 1, np.int64)
    lib().gxz_join_cells(_p(data), _p(offsets), _p(nsub32), C, sep, _p(out),
                         _p(cell_off))
    return out[:total], cell_off


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of a bytes-like or array (the "x64" VB digest)."""
    a = _u8a(data)
    return int(lib().gxz_xxh64(seed, _p(a), a.shape[0]))
