"""Wide-interleaved adaptive range coder — bit-exact numpy reference model.

genozip_tpu_torch's own copy of genozip_tpu/ops/arith_np.py, unchanged. This
is the normative specification of the GXZ adaptive-arithmetic stream
format ("ARITH-W32"). It fills the role of the reference's adaptive
arithmetic coder (htscodecs arith_dynamic.c +
c_range_coder.h + c_simple_model.h) with a TPU-first redesign: instead of
ONE serial coder with a per-symbol-updated model, we run N independent
carryless range-coder lanes (Subbotin-style, 32-bit) over contiguous symbol
chunks in LOCKSTEP, all lanes sharing ONE adaptive model whose update is
batched per step (the histogram of the N symbols coded at that step).
Every step is a handful of wide vector ops; the model update is a
scatter-add — both map directly onto TPU vector units (ops/arith_jax.py
is the device twin and must produce byte-identical streams).

Adaptivity granularity is therefore N symbols instead of 1 — a deliberate
trade: compression is within ~1-2% of the serial coder on genomic payloads
while decode parallelism is N-wide instead of 1.

Stream format
-------------
  header:
    u8   log2(num_lanes)
    u8   order (0 or 1)
    u32  n (number of symbols)
  body (bytes, in DECODER consumption order):
    4*N initial bytes: lane-ascending, 4 bytes each (big-endian code fill)
    event bytes: for each (step, renorm-iteration) in ascending order, the
      renorming lanes' next bytes, lane-ascending.  The encoder rebuilds
      this order from its per-lane emission lists (each lane's j-th renorm
      event consumes that lane's (4+j)-th byte; the final 4 bytes of every
      lane are the coder flush).

Coder: low/range 32-bit wrapping; TOP=2^24, BOT=2^16; renorm emits
(low>>24) while ((low^(low+range))<TOP) or (range<BOT, with the carryless
range clamp range=(-low)&(BOT-1)).  Model: 256-entry frequency table per
context (order-0: one context; order-1: context = previous byte in the
lane's chunk, 0 for the first), init all-1, +INC per coded symbol batched
per step, halved ((f+1)>>1) while total > MAX_TOTAL.  total <= MAX_TOTAL
< BOT guarantees range//total >= 1 after renorm.
"""

import numpy as np

TOP = np.uint32(1 << 24)
BOT = np.uint32(1 << 16)
INC = 24
MAX_TOTAL = 1 << 15


def choose_num_lanes(n: int) -> int:
    """Lane count: wide enough to vectorize, narrow enough that the
    batched model update still adapts quickly. Decoder reads the actual
    count from the header."""
    if n < (1 << 12):
        return 16
    if n < (1 << 18):
        return 64
    return 256


def _lane_layout(n: int, num_lanes: int):
    K = (n + num_lanes - 1) // num_lanes if n > 0 else 0
    lanes = np.arange(num_lanes, dtype=np.int64)
    lane_len = np.clip(n - lanes * K, 0, K) if K > 0 else np.zeros(num_lanes, np.int64)
    return K, lane_len


def _to_matrix(data: np.ndarray, num_lanes: int):
    n = data.shape[0]
    K, lane_len = _lane_layout(n, num_lanes)
    m = np.zeros((K, num_lanes), dtype=np.uint8)
    if K:
        padded = np.zeros(num_lanes * K, dtype=np.uint8)
        padded[:n] = data
        m = padded.reshape(num_lanes, K).T.copy()
    return m, K, lane_len


class _Model:
    """Shared adaptive frequency model, updated in deterministic batches."""

    def __init__(self, order: int):
        self.order = order
        nctx = 256 if order else 1
        self.freq = np.ones((nctx, 256), dtype=np.uint32)
        self.total = np.full(nctx, 256, dtype=np.uint32)

    def lookup(self, ctx: np.ndarray, sym: np.ndarray):
        """(freq, cumfreq, total) per lane for the syms about to be coded."""
        if self.order == 0:
            cum = np.concatenate([[0], np.cumsum(self.freq[0])[:-1]]).astype(np.uint32)
            return self.freq[0][sym], cum[sym], np.full(sym.shape[0], self.total[0], np.uint32)
        rows = self.freq[ctx]                       # (N, 256)
        cums = np.cumsum(rows, axis=1, dtype=np.uint32)
        f = rows[np.arange(sym.shape[0]), sym]
        c = (cums[np.arange(sym.shape[0]), sym] - f).astype(np.uint32)
        return f, c, self.total[ctx]

    def cum_rows(self, ctx: np.ndarray):
        """Exclusive-cum rows per lane (decode symbol search)."""
        if self.order == 0:
            cum = np.cumsum(self.freq[0], dtype=np.uint32)
            return np.broadcast_to(cum, (ctx.shape[0], 256)), \
                np.full(ctx.shape[0], self.total[0], np.uint32)
        rows = self.freq[ctx]
        return np.cumsum(rows, axis=1, dtype=np.uint32), self.total[ctx]

    def update(self, ctx: np.ndarray, sym: np.ndarray, active: np.ndarray):
        """Batched post-step update: +INC per (ctx, sym) coded, then halve
        any context whose total exceeds MAX_TOTAL. Deterministic."""
        if not active.any():
            return
        c = ctx[active] if self.order else np.zeros(int(active.sum()), np.int64)
        s = sym[active]
        np.add.at(self.freq, (c, s), np.uint32(INC))
        np.add.at(self.total, c, np.uint32(INC))
        over = np.unique(c[self.total[c] > MAX_TOTAL]) if self.order else \
            (np.zeros(1, np.int64) if self.total[0] > MAX_TOTAL else np.zeros(0, np.int64))
        while over.shape[0]:
            self.freq[over] = (self.freq[over] + 1) >> 1
            self.total[over] = self.freq[over].sum(axis=1)
            over = over[self.total[over] > MAX_TOTAL]


def encode(data: bytes | np.ndarray, order: int = 0,
           n_lanes: int | None = None) -> bytes:
    data = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    N = n_lanes or choose_num_lanes(n)
    m, K, lane_len = _to_matrix(data, N)
    header = bytes([int(np.log2(N)), order]) + int(n).to_bytes(4, "little")

    low = np.zeros(N, dtype=np.uint32)
    rng = np.full(N, 0xFFFFFFFF, dtype=np.uint32)
    model = _Model(order)
    ev_lane = []        # per renorm event (global order): lane index
    ev_byte = []        # the byte that lane emitted at that event
    with np.errstate(over="ignore"):
        for t in range(K):
            active = t < lane_len
            sym = m[t].astype(np.int64)
            ctx = m[t - 1].astype(np.int64) if (order and t) else np.zeros(N, np.int64)
            f, c, total = model.lookup(ctx, sym)
            r = np.where(active, rng // np.maximum(total, 1), rng)
            low = np.where(active, low + c.astype(np.uint32) * r, low)
            rng = np.where(active, f.astype(np.uint32) * r, rng)
            while True:
                c1 = (low ^ (low + rng)) < TOP
                c2 = rng < BOT
                go = active & (c1 | c2)
                if not go.any():
                    break
                adj = go & ~c1
                rng[adj] = (np.uint32(0) - low[adj]) & (BOT - np.uint32(1))
                lanes = np.nonzero(go)[0]
                ev_lane.append(lanes)
                ev_byte.append((low[lanes] >> 24).astype(np.uint8))
                low[go] <<= np.uint32(8)
                rng[go] <<= np.uint32(8)
            model.update(ctx, sym, active)
        # flush: 4 bytes per lane
        flush = np.empty((N, 4), dtype=np.uint8)
        for k in range(4):
            flush[:, k] = (low >> 24).astype(np.uint8)
            low <<= np.uint32(8)

    ev_lane = np.concatenate(ev_lane) if ev_lane else np.zeros(0, np.int64)
    ev_byte = np.concatenate(ev_byte) if ev_byte else np.zeros(0, np.uint8)
    return bytes(header) + assemble_stream(ev_lane, ev_byte, flush, N)


def assemble_stream(ev_lane: np.ndarray, ev_byte: np.ndarray,
                    flush: np.ndarray, N: int) -> bytes:
    """Lay the emitted bytes out in DECODER consumption order: 4 initial
    bytes per lane, then for global event e of lane l its (4+j)-th byte
    (j = the lane's running event index). Shared by the numpy spec and the
    JAX twin (ops/arith_jax.py)."""
    n_ev = np.bincount(ev_lane, minlength=N).astype(np.int64)
    lane_bytes = np.zeros((N, int(n_ev.max() if n_ev.shape[0] else 0) + 4),
                          dtype=np.uint8)
    # j-th event of lane l -> lane_bytes[l, j]; flush occupies the last 4
    order_in_lane = np.zeros(ev_lane.shape[0], np.int64)
    if ev_lane.shape[0]:
        # stable per-lane running index
        idx_sort = np.argsort(ev_lane, kind="stable")
        srt = ev_lane[idx_sort]
        pos = np.arange(srt.shape[0]) - np.repeat(
            np.concatenate([[0], np.cumsum(np.bincount(srt, minlength=N))[:-1]]), n_ev)
        order_in_lane[idx_sort] = pos
        lane_bytes[ev_lane, order_in_lane] = ev_byte
    lane_bytes[np.arange(N)[:, None], (n_ev[:, None] + np.arange(4)[None, :])] = flush

    out = bytearray(lane_bytes[:, :4].tobytes())   # initial fill, lane-major
    out += lane_bytes[ev_lane, order_in_lane + 4].tobytes()
    return bytes(out)


def decode(buf: bytes | memoryview) -> bytes:
    buf = memoryview(buf)
    logN, order = buf[0], buf[1]
    N = 1 << logN
    n = int.from_bytes(buf[2:6], "little")
    body = np.frombuffer(buf[6:], dtype=np.uint8)
    K, lane_len = _lane_layout(n, N)
    out = np.zeros((K, N), dtype=np.uint8)

    init = body[: 4 * N].reshape(N, 4).astype(np.uint32)
    code = (init[:, 0] << 24) | (init[:, 1] << 16) | (init[:, 2] << 8) | init[:, 3]
    ptr = 4 * N
    low = np.zeros(N, dtype=np.uint32)
    rng = np.full(N, 0xFFFFFFFF, dtype=np.uint32)
    model = _Model(order)
    prev = np.zeros(N, np.int64)
    with np.errstate(over="ignore"):
        for t in range(K):
            active = t < lane_len
            ctx = prev if (order and t) else np.zeros(N, np.int64)
            cums, total = model.cum_rows(ctx)
            total = np.maximum(total, 1)
            r = rng // total
            v = np.minimum((code - low) // np.maximum(r, 1), total - 1)
            # symbol s: cum_exclusive[s] <= v < cum_inclusive[s]
            sym = (cums <= v[:, None]).sum(axis=1).astype(np.int64)
            sym = np.clip(sym, 0, 255)
            f = np.take_along_axis(cums, sym[:, None], axis=1)[:, 0] - \
                np.where(sym > 0, np.take_along_axis(
                    cums, np.maximum(sym - 1, 0)[:, None], axis=1)[:, 0], 0)
            c = np.take_along_axis(cums, sym[:, None], axis=1)[:, 0] - f
            low = np.where(active, low + c.astype(np.uint32) * r, low)
            rng = np.where(active, f.astype(np.uint32) * r, rng)
            out[t] = np.where(active, sym, 0).astype(np.uint8)
            while True:
                c1 = (low ^ (low + rng)) < TOP
                c2 = rng < BOT
                go = active & (c1 | c2)
                if not go.any():
                    break
                adj = go & ~c1
                rng[adj] = (np.uint32(0) - low[adj]) & (BOT - np.uint32(1))
                lanes = np.nonzero(go)[0]
                nb = body[ptr: ptr + lanes.shape[0]].astype(np.uint32)
                ptr += lanes.shape[0]
                code[lanes] = (code[lanes] << np.uint32(8)) | nb
                low[go] <<= np.uint32(8)
                rng[go] <<= np.uint32(8)
            model.update(ctx, out[t].astype(np.int64), active)
            prev = out[t].astype(np.int64)
    return out.T.reshape(-1)[:n].tobytes()
