"""RANS-W32x16 host framing and the plain PyTorch versions of the four coders.

The stream format is normative in `ops.rans_np`. A batch of R
streams is laid out flat for one launch:

* encode: `prepare_encode` builds the per-stream tables and headers on the
  host and packs the symbols, `meta` rows and tables into tensors; a coder
  (`encode_plain`, or the kernel behind `ops.rans_cuda`) fills the backward
  word buffer, the first-word pointers and the final states; `finish_encode`
  copies them back (`fetch_encode`) and frames header + states (hi, lo,
  lane-ascending) + words (`frame_encode`).
* decode: `prepare_decode` parses each stream's header and serialized tables
  (the same bytes `rans_np._freqs_deserialize` reads) into freq/cum tables
  and packs the word bodies; a coder turns the tables into packed slot
  entries (`slot_entries`: symbol | (f-1) << 8 | (slot-cum) << 20, one
  lookup per symbol) and fills the output.

The plain versions run the same integer arithmetic on a (R, N) batch with the
32-bit state held in int64, on whatever device their tensors are on. They are
the CPU path and the oracle the kernels are held to.
"""

import zlib

import numpy as np
import torch

from . import rans_np

SCALE_BITS = rans_np.SCALE_BITS
RANS_L = rans_np.RANS_L
MAX_LANES = 1 << 13          # rans_np.choose_num_lanes' ceiling
META = 8                     # int64 words per stream in `meta`
ROW_STEPS = 8                # steps a lane's row word holds (SB, rans_common.cuh)
ENC_PAD = ROW_STEPS * MAX_LANES + 64   # encoders' scratch between streams


class EncodeBatch:
    """Host side of one batched encode. Tensors are on the CPU; the caller
    moves them to the coder's device."""

    def __init__(self, headers, data, meta, tab, n_words, n_states):
        self.headers = headers     # per-stream header bytes (incl. tables)
        self.data = data           # uint8, all streams' symbols back to back
        self.meta = meta           # int64 (R, 8)
        self.tab = tab             # int32 (R, 2, 256) or (R, 2, 256, 256)
        self.n_words = n_words     # u16 words in the output buffer
        self.n_states = n_states   # final states over all streams


class DecodeBatch:
    def __init__(self, order, words, meta, tab, n_out, lens):
        self.order = order
        self.words = words         # int16 (u16 bits), all stream bodies
        self.meta = meta           # int64 (R, 8)
        self.tab = tab             # int32 (R, 2, 256) or (R, 2, 256, 256)
        self.n_out = n_out         # output bytes over all streams
        self.lens = lens           # per-stream n


def _cum(freq: np.ndarray) -> np.ndarray:
    """Exclusive cumulative frequency along the last axis."""
    c = np.cumsum(freq, axis=-1) - freq
    return c.astype(np.int32)


def order0_tables(a: np.ndarray):
    """(freq, serialized table bytes) for an order-0 stream."""
    freq = rans_np.normalize_freqs(np.bincount(a, minlength=256))
    return freq, rans_np._freqs_serialize(freq)


def order1_tables(a: np.ndarray, K: int):
    """(freq2 (256, 256), serialized zlib table block) for an order-1
    stream: the context is the previous byte within the lane's chunk of K
    symbols, 0 at each chunk start."""
    n = a.shape[0]
    ctx = np.zeros(n, np.int64)
    if n:
        ctx[1:] = a[:-1]
        ctx[::K] = 0
    hist2 = np.bincount(ctx * 256 + a, minlength=65536).reshape(256, 256)
    used = hist2.sum(axis=1) > 0
    freq2 = np.zeros((256, 256), np.uint32)
    parts = [np.packbits(used.astype(np.uint8), bitorder="little").tobytes()]
    for c in np.nonzero(used)[0]:
        freq2[c] = rans_np.normalize_freqs(hist2[c])
        parts.append(rans_np._freqs_serialize(freq2[c]))
    raw = b"".join(parts)
    comp = zlib.compress(raw, 6)
    return freq2, (len(raw).to_bytes(4, "little") +
                   len(comp).to_bytes(4, "little") + comp)


def prepare_encode(datas, order: int, n_lanes: int | None = None) -> EncodeBatch:
    """Tables, headers and flat layout for encoding `datas` in one launch.
    Each stream takes `n_lanes`, or `rans_np.choose_num_lanes(n)` as the host
    coder does, so the bytes equal `rans_np.encode(d, order)`."""
    R = len(datas)
    arrs = [np.frombuffer(d, np.uint8) if not isinstance(d, np.ndarray)
            else np.ascontiguousarray(d, np.uint8).reshape(-1) for d in datas]
    meta = np.zeros((R, META), np.int64)
    tshape = (R, 2, 256) if order == 0 else (R, 2, 256, 256)
    tab = np.zeros(tshape, np.int32)
    headers = []
    doff = ooff = soff = 0
    for r, a in enumerate(arrs):
        n = a.shape[0]
        N = n_lanes or rans_np.choose_num_lanes(n)
        if N < 16 or N > MAX_LANES or N & (N - 1):
            raise ValueError(f"lane count {N} not a power of two in [16, 8192]")
        K = (n + N - 1) // N
        if order == 0:
            freq, ftab = order0_tables(a)
        else:
            freq, ftab = order1_tables(a, max(K, 1))
        tab[r, 0] = freq
        tab[r, 1] = _cum(freq.astype(np.int64))
        headers.append(bytes([N.bit_length() - 1, order]) +
                       int(n).to_bytes(4, "little") + ftab)
        out_len = n + 2 * N + 8
        meta[r] = (doff, n, N, K, ooff, soff, out_len, 0)
        doff += n
        ooff += out_len
        soff += N
    data = np.concatenate(arrs) if R else np.zeros(0, np.uint8)
    return EncodeBatch(headers, torch.from_numpy(np.ascontiguousarray(data)),
                       torch.from_numpy(meta), torch.from_numpy(tab),
                       ooff, soff)


def fetch_encode(batch: EncodeBatch, words: torch.Tensor, p: torch.Tensor,
                 states: torch.Tensor):
    """The copy back of an encode: the first-word pointers, then only the
    written words ([p, out_len) of each stream) and the final states, as
    host arrays (p, words u16, states u32); waits for the coder."""
    meta = batch.meta.numpy()
    p = p.cpu().numpy()
    spans = [(int(m[4] + pr), int(m[4] + m[6])) for m, pr in zip(meta, p)]
    w = torch.cat([words[a:b] for a, b in spans]) if spans else words[:0]
    return (p, w.cpu().numpy().view(np.uint16),
            states.cpu().numpy().view(np.uint32))


def frame_encode(batch: EncodeBatch, p: np.ndarray, w: np.ndarray,
                 st: np.ndarray) -> list:
    """Frame each stream from `fetch_encode`'s arrays: header, (hi, lo)
    states lane-ascending, then its written words."""
    meta = batch.meta.numpy()
    outs = []
    at = 0
    for r, hdr in enumerate(batch.headers):
        N, soff = int(meta[r, 2]), int(meta[r, 5])
        x = st[soff:soff + N]
        flush = np.empty(2 * N, np.uint16)
        flush[0::2] = x >> 16
        flush[1::2] = x & 0xFFFF
        nw = int(meta[r, 6] - p[r])
        outs.append(hdr + flush.tobytes() + w[at:at + nw].tobytes())
        at += nw
    return outs


def finish_encode(batch: EncodeBatch, words: torch.Tensor, p: torch.Tensor,
                  states: torch.Tensor) -> list:
    """Frame each stream: header, (hi, lo) states lane-ascending, then the
    words the coder wrote at [p, out_len) (`fetch_encode`, then
    `frame_encode`)."""
    return frame_encode(batch, *fetch_encode(batch, words, p, states))


def parse_stream(buf):
    """Header of one stream: (N, order, n, freq, table end offset). For
    order 1, freq is (256, 256) [ctx][sym]; contexts not in the stream are
    all zero."""
    buf = memoryview(buf)
    if len(buf) < 6:
        raise ValueError("rANS stream shorter than its header")
    N = 1 << buf[0]
    order = buf[1]
    n = int.from_bytes(buf[2:6], "little")
    if order == 0:
        freq, off = rans_np._freqs_deserialize(buf, 6)
        if int(freq.sum()) != 1 << SCALE_BITS:
            raise ValueError("order-0 table does not sum to 4096")
        return N, 0, n, freq, off
    if order != 1:
        raise ValueError(f"rANS order {order} unknown")
    rawlen = int.from_bytes(buf[6:10], "little")
    clen = int.from_bytes(buf[10:14], "little")
    raw = memoryview(zlib.decompress(bytes(buf[14:14 + clen])))
    if len(raw) != rawlen:
        raise ValueError("order-1 table block length mismatch")
    used = np.unpackbits(np.frombuffer(raw[:32], np.uint8),
                         bitorder="little").astype(bool)
    freq2 = np.zeros((256, 256), np.uint32)
    o2 = 32
    for c in np.nonzero(used)[0]:
        freq2[c], o2 = rans_np._freqs_deserialize(raw, o2)
        if int(freq2[c].sum()) != 1 << SCALE_BITS:
            raise ValueError(f"order-1 table of context {c} does not sum to 4096")
    return N, 1, n, freq2, 14 + clen


def prepare_decode(bufs) -> DecodeBatch:
    """Parse R streams of one order into one decode launch."""
    R = len(bufs)
    parsed = [parse_stream(b) for b in bufs]
    orders = {p[1] for p in parsed}
    if len(orders) > 1:
        raise ValueError("a decode batch takes streams of one order")
    order = orders.pop() if orders else 0
    meta = np.zeros((R, META), np.int64)
    tshape = (R, 2, 256) if order == 0 else (R, 2, 256, 256)
    tab = np.zeros(tshape, np.int32)
    bodies = []
    woff = ooff = 0
    for r, (buf, (N, _, n, freq, off)) in enumerate(zip(bufs, parsed)):
        if N < 16 or N > MAX_LANES:
            raise ValueError(f"lane count {N} outside [16, 8192]")
        body = bytes(memoryview(buf)[off:])
        if len(body) & 1 or len(body) < 4 * N:
            raise ValueError("rANS stream body truncated")
        w = np.frombuffer(body, "<u2")
        K = (n + N - 1) // N
        tab[r, 0] = freq
        tab[r, 1] = _cum(freq.astype(np.int64))
        meta[r] = (woff, w.shape[0], n, N, K, ooff, 0, 0)
        bodies.append(w)
        woff += w.shape[0]
        ooff += n
    words = np.concatenate(bodies) if bodies else np.zeros(0, np.uint16)
    return DecodeBatch(order, torch.from_numpy(words.view(np.int16).copy()),
                       torch.from_numpy(meta), torch.from_numpy(tab),
                       ooff, [p[2] for p in parsed])


def frame_decode(batch: DecodeBatch, o: np.ndarray) -> list:
    """Each stream's bytes out of every stream's symbols `o`, copied back
    to the host."""
    meta = batch.meta.numpy()
    return [o[int(meta[r, 5]):int(meta[r, 5]) + n].tobytes()
            for r, n in enumerate(batch.lens)]


def finish_decode(batch: DecodeBatch, out: torch.Tensor) -> list:
    return frame_decode(batch, out.cpu().numpy())


# --- plain versions ---------------------------------------------------------

def _lanes(meta: torch.Tensor, n_col: int, N_col: int, K_col: int):
    """(R, Nmax) lane grid: lane index, lane base offset l*K, chunk length."""
    n, N, K = meta[:, n_col], meta[:, N_col], meta[:, K_col]
    Nmax = int(N.max()) if meta.shape[0] else 0
    lane = torch.arange(Nmax, device=meta.device, dtype=torch.int64)[None, :]
    base = lane * K[:, None]
    ln = torch.clamp(n[:, None] - base, min=0)
    ln = torch.minimum(ln, K[:, None])
    ln = torch.where(lane < N[:, None], ln, torch.zeros_like(ln))
    return lane, base, ln


def _as_i16(v: torch.Tensor) -> torch.Tensor:
    """u16 values (int64) -> int16 with the same bits."""
    return (v - ((v >> 15) << 16)).to(torch.int16)


def _as_i32(v: torch.Tensor) -> torch.Tensor:
    """u32 values (int64) -> int32 with the same bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def encode_plain(order: int, data: torch.Tensor, meta: torch.Tensor,
                 tab: torch.Tensor, n_words: int, n_states: int):
    """Plain version of rans_encode_o0/o1: returns (words int16 (n_words,),
    p int64 (R,), states int32 (n_states,))."""
    dev = data.device
    R = meta.shape[0]
    words = torch.zeros(n_words, dtype=torch.int16, device=dev)
    states = torch.zeros(n_states, dtype=torch.int32, device=dev)
    if R == 0:
        return words, torch.zeros(0, dtype=torch.int64, device=dev), states
    doff, n, N, K = meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 3]
    ooff, soff, olen = meta[:, 4], meta[:, 5], meta[:, 6]
    lane, base, ln = _lanes(meta, 1, 2, 3)
    ftab = tab[:, 0].reshape(R, -1).to(torch.int64)
    ctab = tab[:, 1].reshape(R, -1).to(torch.int64)
    rows = torch.arange(R, device=dev)[:, None]
    x = torch.full(ln.shape, RANS_L, dtype=torch.int64, device=dev)
    p = olen.clone()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(int(K.max()) - 1, -1, -1):
        active = t < ln
        idx = torch.where(active, doff[:, None] + base + t, zero)
        s = data[idx].to(torch.int64)
        if order == 1:
            prev = data[torch.where(active & (t > 0), idx - 1, zero)]
            ctx = prev.to(torch.int64) if t > 0 else torch.zeros_like(s)
            s = ctx * 256 + s
        f = torch.where(active, ftab[rows, s], torch.ones_like(s))
        c = ctab[rows, s]
        emit = active & (x >= (f << 20))
        S = emit.sum(dim=1)
        rank = torch.cumsum(emit, dim=1) - 1
        pos = (ooff + p - S)[:, None] + rank
        words[pos[emit]] = _as_i16(x[emit] & 0xFFFF)
        x = torch.where(emit, x >> 16, x)
        p = p - S
        xa = ((x // f) << SCALE_BITS) + (x % f) + c
        x = torch.where(active, xa, x)
    live = lane < N[:, None]
    states[(soff[:, None] + lane)[live]] = _as_i32(x[live])
    return words, p, states


def enc_bases(meta: torch.Tensor) -> torch.Tensor:
    """Each encode stream's place in the encoders' scratch (`enc_base` in
    csrc/rans_common.cuh): its rows at that byte, 16-byte aligned, at least
    n + ENC_PAD - 15 bytes after the stream before."""
    r = torch.arange(meta.shape[0], dtype=torch.int64, device=meta.device)
    return (meta[:, 0] + r * ENC_PAD + 15) & ~15


def stripe_rows(data: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Plain version of stripe_kernel: each encode stream's symbols as rows
    of 8-step words, rows[base + (t // 8) * 8N + 8l + t % 8] =
    data[data_off + l*K + t], 0 past the lane's chunk and in the top block's
    steps K .. Kp-1 (Kp = K rounded up to 8), at base = enc_bases(meta)[r],
    in a uint8 buffer of the rows region's length (n + R * ENC_PAD rounded
    up to 64)."""
    R = meta.shape[0]
    T = (data.numel() + R * ENC_PAD + 63) & ~63
    rows = torch.zeros(T, dtype=torch.uint8, device=data.device)
    if R == 0:
        return rows
    lane, base, ln = _lanes(meta, 1, 2, 3)
    Kmax = int(meta[:, 3].max())
    t = torch.arange(Kmax, dtype=torch.int64, device=data.device)[None, :, None]
    N = meta[:, 2, None, None]
    live = t < ln[:, None, :]
    src = meta[:, 0, None, None] + base[:, None, :] + t
    dst = enc_bases(meta)[:, None, None] + (t // ROW_STEPS) * ROW_STEPS * N \
        + lane[:, None, :] * ROW_STEPS + t % ROW_STEPS
    rows[dst[live]] = data[src[live]]
    return rows


def enc_entries(tab: torch.Tensor) -> torch.Tensor:
    """Packed encode entries of a (freq, cum) table, as the encode kernels
    build them (`enc_entry` in csrc/rans_common.cuh): (R, 2, 256) -> (R, 256,
    2) or (R, 2, 256, 256) -> (R, 256, 256, 2), int64 holding u32 values
    [f | bias << 13 | shift << 26, m]. With l = ceil(log2 f), m = ceil(2^(32+l)
    / f) - 2^32 and shift = l - 1, bias = cum, so that hi = umulhi(x, m), q =
    (hi + ((x - hi) >> 1)) >> shift = x // f and x' = x + bias + q * (4096 -
    f); f = 1 takes m = 2^32 - 1, shift 0 (q = x - 1) and bias = cum + 4095.
    f = 0 gives [0, 0]."""
    f = tab[:, 0].to(torch.int64)
    c = tab[:, 1].to(torch.int64)
    powers = torch.ones(13, dtype=torch.int64, device=tab.device) << \
        torch.arange(13, dtype=torch.int64, device=tab.device)
    lg = (f[..., None] > powers).sum(dim=-1)            # ceil(log2 f), f >= 1
    M = ((1 << (32 + lg)) + f - 1) // torch.clamp(f, min=1)
    one = f == 1
    m = torch.where(one, torch.full_like(f, 0xFFFFFFFF), M - (1 << 32))
    sh = torch.where(one, torch.zeros_like(f), lg - 1)
    bias = torch.where(one, c + (1 << SCALE_BITS) - 1, c)
    lo = f | (bias << 13) | (sh << 26)
    ent = torch.stack([lo, m], dim=-1)
    return torch.where((f > 0)[..., None], ent, torch.zeros_like(ent))


def slot_entries(tab: torch.Tensor) -> torch.Tensor:
    """Packed slot entries of a (freq, cum) table, as the decode kernels build
    them: (R, 2, 256) -> (R, 4096) or (R, 2, 256, 256) -> (R, 256, 4096),
    int64 holding u32 values symbol | (f - 1) << 8 | (slot - cum) << 20, where
    symbol s has cum[s] <= slot < cum[s] + f. Rows whose frequencies do not
    sum to 4096 (order-1 contexts absent from the stream) are 0."""
    f = tab[:, 0].reshape(-1, 256).to(torch.int64)
    c = tab[:, 1].reshape(-1, 256).to(torch.int64)
    rows = f.shape[0]
    slot = torch.arange(1 << SCALE_BITS, dtype=torch.int64,
                        device=tab.device).expand(rows, -1).contiguous()
    s = torch.searchsorted(c, slot, right=True) - 1
    fs, cs = f.gather(1, s), c.gather(1, s)
    e = s | (((fs - 1) & 0xFFF) << 8) | ((slot - cs) << 20)
    used = f.sum(dim=1, keepdim=True) == (1 << SCALE_BITS)
    e = torch.where(used, e, torch.zeros_like(e))
    return e.reshape(tab.shape[:1] + tab.shape[2:-1] + (1 << SCALE_BITS,))


def decode_plain(order: int, words: torch.Tensor, meta: torch.Tensor,
                 tab: torch.Tensor, n_out: int):
    """Plain version of rans_decode_o0/o1: returns out uint8 (n_out,)."""
    dev = words.device
    R = meta.shape[0]
    out = torch.zeros(n_out, dtype=torch.uint8, device=dev)
    if R == 0:
        return out
    woff, nw, N, K, ooff = meta[:, 0], meta[:, 1], meta[:, 3], meta[:, 4], meta[:, 5]
    lane, base, ln = _lanes(meta, 2, 3, 4)
    live = lane < N[:, None]
    w = words.to(torch.int64) & 0xFFFF
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    hi = w[torch.where(live, woff[:, None] + 2 * lane, zero)]
    lo = w[torch.where(live, woff[:, None] + 2 * lane + 1, zero)]
    x = (hi << 16) | lo
    ent = slot_entries(tab).reshape(R, -1)
    rows = torch.arange(R, device=dev)[:, None]
    ctx = torch.zeros_like(x)
    p = 2 * N
    mask = (1 << SCALE_BITS) - 1
    for t in range(int(K.max()) if R else 0):
        active = t < ln
        slot = x & mask
        e = ent[rows, slot if order == 0 else (ctx << SCALE_BITS) + slot]
        s = e & 0xFF
        f = ((e >> 8) & 0xFFF) + 1
        x = torch.where(active, f * (x >> SCALE_BITS) + (e >> 20), x)
        need = active & (x < RANS_L)
        S = need.sum(dim=1)
        rank = torch.cumsum(need, dim=1) - 1
        q = p[:, None] + rank
        ok = need & (q < nw[:, None])
        got = w[torch.where(ok, woff[:, None] + q, zero)]
        got = torch.where(ok, got, torch.zeros_like(got))
        x = torch.where(need, (x << 16) | got, x)
        p = p + S
        out[(ooff[:, None] + base + t)[active]] = s[active].to(torch.uint8)
        if order == 1:
            ctx = torch.where(active, s, ctx)
    return out
