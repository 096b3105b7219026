"""The plain reference of the rANS-W32x16 stream format, in numpy.

A frozen copy of `genozip_tpu_torch/ops/rans_np.py` (itself a copy of
`genozip_tpu/ops/rans_np.py`), the normative specification of the format
that the rANS kernels (`genozip_tpu_torch/csrc/rans.cu`) write and read. The
benchmark decodes the streams that the card coded in a run with `decode`
and compares them with what the program handed the card (zip) or got back
from it (unzip). It imports nothing of the program.

Stream format
-------------
  header:
    u8   log2(num_lanes)
    u8   order (0 or 1)
    u32  n  (number of symbols)
    freq tables (see _freqs_serialize)
  body (u16 words, little-endian):
    2*N words: per-lane initial decoder states, lane-ascending, (hi, lo) pairs
    data words: renorm words in decoder read order = step-ascending, lane-ascending

Coder parameters: 32-bit state x in [2^16, 2^32); scale M = 12 bits; renorm emits
one u16 when x >= (freq << 20). Lane l covers the contiguous symbol chunk
[l*K, min((l+1)*K, n)), K = ceil(n/N); order-1 context = previous byte within the
lane's chunk (context 0 for each chunk's first byte).
"""

import numpy as np

SCALE_BITS = 12
SCALE = 1 << SCALE_BITS
RANS_L = 1 << 16  # lower bound of state interval


def choose_num_lanes(n: int) -> int:
    """Pick the lane count for an n-symbol stream (the decoder reads the
    actual count from the header, so this is a free choice). Piecewise:
    device-sized streams get many lanes (wide vectors), small host-side
    streams get few (the 2N flushed state words are pure overhead)."""
    if n <= 0:
        return 16
    target = max(1, n // (128 if n >= (1 << 20) else 256))
    k = int(np.ceil(np.log2(target))) if target > 1 else 4
    return 1 << max(4, min(13, k))


def normalize_freqs(hist: np.ndarray, scale_bits: int = SCALE_BITS) -> np.ndarray:
    """Normalize a 256-bin histogram to sum to 2^scale_bits, every nonzero bin >= 1.
    Deterministic largest-remainder style normalization."""
    hist = hist.astype(np.uint64)
    total = int(hist.sum())
    scale = 1 << scale_bits
    if total == 0:
        f = np.zeros(256, dtype=np.uint32)
        f[0] = scale
        return f
    f = (hist * scale // total).astype(np.int64)
    f[(hist > 0) & (f == 0)] = 1
    diff = scale - int(f.sum())
    if diff != 0:
        # adjust the largest bins (deterministically: by (count, symbol) order)
        order = np.lexsort((np.arange(256), -hist.astype(np.int64)))
        i = 0
        step = 1 if diff > 0 else -1
        remaining = abs(diff)
        while remaining > 0:
            s = order[i % 256]
            if hist[s] > 0 and (step > 0 or f[s] > 1):
                f[s] += step
                remaining -= 1
            i += 1
    assert f.sum() == scale
    return f.astype(np.uint32)


def _freqs_serialize(freq: np.ndarray) -> bytes:
    """Bitmap of present symbols (32B) + u16 per present symbol."""
    present = freq > 0
    bitmap = np.packbits(present.astype(np.uint8), bitorder="little").tobytes()
    vals = freq[present].astype("<u2").tobytes()
    return bitmap + vals


def _freqs_deserialize(buf: memoryview, off: int):
    bitmap = np.frombuffer(buf[off:off + 32], dtype=np.uint8)
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    cnt = int(present.sum())
    vals = np.frombuffer(buf[off + 32: off + 32 + 2 * cnt], dtype="<u2")
    freq = np.zeros(256, dtype=np.uint32)
    freq[present] = vals
    return freq, off + 32 + 2 * cnt


def lane_layout(n: int, num_lanes: int):
    """Returns (K, lane_len) — steps per lane and per-lane symbol counts."""
    K = (n + num_lanes - 1) // num_lanes if n > 0 else 0
    lanes = np.arange(num_lanes, dtype=np.int64)
    lane_len = np.clip(n - lanes * K, 0, K) if K > 0 else np.zeros(num_lanes, np.int64)
    return K, lane_len


def _to_matrix(data: np.ndarray, num_lanes: int):
    """Arrange symbols as (K, N): m[t, l] = data[l*K + t]; tail padded with 0."""
    n = data.shape[0]
    K, lane_len = lane_layout(n, num_lanes)
    m = np.zeros((K, num_lanes), dtype=np.uint8)
    if K:
        padded = np.zeros(num_lanes * K, dtype=np.uint8)
        padded[:n] = data
        m = padded.reshape(num_lanes, K).T.copy()
    return m, K, lane_len


def encode(data: bytes | np.ndarray, order: int = 0,
           n_lanes: int | None = None) -> bytes:
    data = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    N = n_lanes or choose_num_lanes(n)
    m, K, lane_len = _to_matrix(data, N)

    if order == 0:
        freq = normalize_freqs(np.bincount(data, minlength=256))
        cum = np.concatenate([[0], np.cumsum(freq)[:-1]]).astype(np.uint32)
        ftab = _freqs_serialize(freq)
        freq_of = lambda ctx, s: (freq[s], cum[s])
    else:
        # context matrix: previous byte within the lane's chunk, 0 for first
        ctx_m = np.zeros_like(m)
        ctx_m[1:] = m[:-1]
        hist2 = np.zeros((256, 256), dtype=np.int64)
        active_all = np.arange(K)[:, None] < lane_len[None, :]
        np.add.at(hist2, (ctx_m[active_all], m[active_all]), 1)
        freq2 = np.zeros((256, 256), dtype=np.uint32)
        cum2 = np.zeros((256, 256), dtype=np.uint32)
        used_ctx = hist2.sum(axis=1) > 0
        for c in np.nonzero(used_ctx)[0]:
            freq2[c] = normalize_freqs(hist2[c])
            cum2[c] = np.concatenate([[0], np.cumsum(freq2[c])[:-1]])
        parts = [np.packbits(used_ctx.astype(np.uint8), bitorder="little").tobytes()]
        for c in np.nonzero(used_ctx)[0]:
            parts.append(_freqs_serialize(freq2[c]))
        import zlib
        raw = b"".join(parts)
        comp = zlib.compress(raw, 6)
        ftab = len(raw).to_bytes(4, "little") + len(comp).to_bytes(4, "little") + comp
        freq_of = None  # handled inline below

    x = np.full(N, RANS_L, dtype=np.uint64)
    # output words, written logically backward; we collect per-step then reverse
    out_words = np.zeros(n + 2 * N + 8, dtype=np.uint16)
    p = out_words.shape[0]  # backward write pointer

    for t in range(K - 1, -1, -1):
        active = t < lane_len
        s = m[t]
        if order == 0:
            f = freq[s].astype(np.uint64)
            c = cum[s].astype(np.uint64)
        else:
            cc = ctx_m[t]
            f = freq2[cc, s].astype(np.uint64)
            c = cum2[cc, s].astype(np.uint64)
        f = np.where(active, f, 1)  # avoid div-by-zero on inactive lanes
        x_max = f << 20
        emit = active & (x >= x_max)
        S = int(emit.sum())
        if S:
            # decoder reads step-ascending, lane-ascending; we write backward,
            # so ascending-lane emitters get positions p-S .. p-1
            rank = np.cumsum(emit) - 1
            idx = p - S + rank[emit]
            out_words[idx] = (x[emit] & 0xFFFF).astype(np.uint16)
            x = np.where(emit, x >> 16, x)
            p -= S
        xa = ((x // f) << SCALE_BITS) + (x % f) + c
        x = np.where(active, xa, x)

    # flush states: decoder reads lane-ascending (hi, lo)
    st = np.empty(2 * N, dtype=np.uint16)
    st[0::2] = (x >> 16).astype(np.uint16)
    st[1::2] = (x & 0xFFFF).astype(np.uint16)
    body = st.tobytes() + out_words[p:].tobytes()

    header = bytes([int(np.log2(N)), order]) + int(n).to_bytes(4, "little") + ftab
    return header + body


def decode(buf: bytes | memoryview) -> bytes:
    buf = memoryview(buf)
    logN = buf[0]
    order = buf[1]
    N = 1 << logN
    n = int.from_bytes(buf[2:6], "little")
    off = 6
    if order == 0:
        freq, off = _freqs_deserialize(buf, off)
        cum = np.concatenate([[0], np.cumsum(freq)[:-1]]).astype(np.uint32)
        slot2sym = np.repeat(np.arange(256, dtype=np.uint8), freq)
        ftab = (freq.astype(np.uint64), cum.astype(np.uint64), slot2sym)
    else:
        import zlib
        rawlen = int.from_bytes(buf[off:off + 4], "little")
        clen = int.from_bytes(buf[off + 4:off + 8], "little")
        raw = memoryview(zlib.decompress(bytes(buf[off + 8: off + 8 + clen])))
        assert len(raw) == rawlen
        off += 8 + clen
        used_ctx = np.unpackbits(np.frombuffer(raw[:32], np.uint8), bitorder="little").astype(bool)
        freq2 = np.zeros((256, 256), dtype=np.uint64)
        cum2 = np.zeros((256, 256), dtype=np.uint64)
        slot2sym2 = np.zeros((256, SCALE), dtype=np.uint8)
        o2 = 32
        for c in np.nonzero(used_ctx)[0]:
            fr, o2 = _freqs_deserialize(raw, o2)
            freq2[c] = fr
            cum2[c] = np.concatenate([[0], np.cumsum(fr)[:-1]])
            slot2sym2[c] = np.repeat(np.arange(256, dtype=np.uint8), fr)

    words = np.frombuffer(buf[off:], dtype="<u2").astype(np.uint64)
    x = (words[0:2 * N:2] << 16) | words[1:2 * N:2]
    p = 2 * N
    K, lane_len = lane_layout(n, N)

    out = np.zeros((K, N), dtype=np.uint8)
    if order == 1:
        ctx = np.zeros(N, dtype=np.uint8)
    for t in range(K):
        active = t < lane_len
        slot = (x & (SCALE - 1)).astype(np.int64)
        if order == 0:
            freq_u, cum_u, slot2sym = ftab
            s = slot2sym[slot]
            f = freq_u[s]
            c = cum_u[s]
        else:
            s = slot2sym2[ctx, slot]
            f = freq2[ctx, s]
            c = cum2[ctx, s]
        f = np.where(active, f, 1)
        xa = f * (x >> SCALE_BITS) + (x & (SCALE - 1)) - np.where(active, c, 0)
        x = np.where(active, xa, x)
        need = active & (x < RANS_L)
        S = int(need.sum())
        if S:
            rank = np.cumsum(need) - 1
            idx = p + rank[need]
            got = np.zeros(N, dtype=np.uint64)
            got[need] = words[idx]
            x = np.where(need, (x << 16) | got, x)
            p += S
        out[t] = np.where(active, s, 0)
        if order == 1:
            ctx = np.where(active, s, ctx).astype(np.uint8)
    flat = out.T.reshape(-1)[:n] if K else np.zeros(0, dtype=np.uint8)
    return flat.tobytes()
