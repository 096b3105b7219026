"""ARITH-W32 in plain PyTorch: the plain version of the `arith_encode` and
`arith_decode` kernels (csrc/arith.cu), and the host framing both routes
share (the launch table, the stream header, the output slices).

The function is genozip_tpu's N-lane adaptive range coder
(`genozip_tpu/ops/arith_jax.py` `_encode_device` :86 and `_decode_device`
:124, XLA device functions; the normative spec is `ops/arith_np.py`): N
carryless 32-bit range-coder lanes over contiguous chunks of the input, in
lockstep, sharing one adaptive frequency model (order 0: one context; order
1: the previous byte of the lane's chunk, 0 first) that is updated once a
step by the histogram of the symbols the active lanes coded (+INC each),
then halved ((f + 1) >> 1) while a context's total exceeds MAX_TOTAL. Each
step renormalises with `while any(go)`, and the bytes go out in the order
(step, iteration, lane). The states are u32 values held in int64 tensors
(`torch.uint32` has no shifts, division or comparisons on the CPU), masked
to 32 bits after each add and shift. The stream is laid out by
`arith_np.assemble_stream`, the spec's own.

A launch of the kernels codes R streams of one order through a table of
int64 rows (`META` columns): encode (offset of the symbols, n, offset of the
output, its capacity, log2 N, 0); decode (offset of the stream's body, its
length, offset of the symbols, n, log2 N, 0). The encoder's output is each
stream whole, header included, in a slot of `encode_capacity` bytes; its
length comes back per stream (negative: the slot overflowed). The decoder
returns n per stream, or a negative code for a stream that ran out of
bytes.
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import arith_np
from .arith_np import INC, MAX_TOTAL, choose_num_lanes

TOP = 1 << 24
BOT = 1 << 16
MASK = 0xFFFFFFFF
HEADER = 6
# one thread a lane: a block holds at most 1024 threads, and the model's
# u16 frequencies need MAX_TOTAL + N * INC < 2^16 (the JAX module asserts
# N * INC < MAX_TOTAL, which allows at most 1024 for a power of two)
MAX_LANES = 1024
META = 6
BYTES_PER_SYMBOL = 8     # room the encoder's slot gives each symbol
TRUNCATED = -1           # decoder status: the body ran out of bytes


def check_lanes(N: int):
    if N < 1 or N & (N - 1) or N > MAX_LANES:
        raise ValueError(f"n_lanes {N}: a power of two up to {MAX_LANES}")


def header(N: int, order: int, n: int) -> bytes:
    return bytes([N.bit_length() - 1, order]) + int(n).to_bytes(4, "little")


def parse_header(buf) -> tuple:
    """(N, order, n) of a stream; ValueError where the kernels cannot take
    it (short, order not 0 or 1, more than MAX_LANES lanes, a body shorter
    than the 4 N initial bytes)."""
    if len(buf) < HEADER:
        raise ValueError("arith stream shorter than its header")
    log_n, order = buf[0], buf[1]
    if order not in (0, 1):
        raise ValueError(f"arith stream of order {order}")
    if log_n > MAX_LANES.bit_length() - 1:
        raise ValueError(f"arith stream of 2^{log_n} lanes")
    N = 1 << log_n
    n = int.from_bytes(bytes(buf[2:6]), "little")
    if len(buf) - HEADER < 4 * N:
        raise ValueError("arith stream shorter than its initial bytes")
    return N, order, n


def encode_capacity(n: int, N: int) -> int:
    return HEADER + 4 * N + BYTES_PER_SYMBOL * n


def _lane_layout(n: int, N: int, device):
    K = (n + N - 1) // N if n else 0
    lanes = torch.arange(N, dtype=torch.int64, device=device)
    return K, (n - lanes * K).clamp(0, K)


class _Model:
    """The shared adaptive models of R streams coded side by side: (R,
    nctx, 256) frequencies and (R, nctx) totals, int64 on the coder's
    device; stream r's lanes read and update only model r."""

    def __init__(self, order: int, R: int, device):
        self.order = order
        nctx = 256 if order else 1
        self.freq = torch.ones((R, nctx, 256), dtype=torch.int64,
                               device=device)
        self.total = torch.full((R, nctx), 256, dtype=torch.int64,
                                device=device)
        self.r = torch.arange(R, device=device)[:, None]

    def rows(self, ctx):
        """Inclusive cumulative rows and totals of the lanes' contexts,
        (R, L, 256) and (R, L): L = 1 (every lane's row) at order 0."""
        if self.order == 0:
            return self.freq[:, 0].cumsum(-1)[:, None], self.total[:, :1]
        return self.freq[self.r, ctx].cumsum(-1), self.total[self.r, ctx]

    def update(self, ctx, sym, active):
        """+INC for each (context, symbol) an active lane coded, then halve
        every context whose total exceeds MAX_TOTAL until none does (only a
        context coded in this step can be over). Masked by `active`, so
        that the one host sync a step is the halving test."""
        c = ctx if self.order else torch.zeros_like(ctx)
        inc = torch.where(active, INC, 0)
        r = self.r.expand_as(c)
        self.freq.index_put_((r, c, sym), inc, accumulate=True)
        self.total.index_put_((r, c), inc, accumulate=True)
        over = self.total > MAX_TOTAL
        while bool(over.any()):
            self.freq = torch.where(over[..., None], (self.freq + 1) >> 1,
                                    self.freq)
            self.total = torch.where(over, self.freq.sum(-1), self.total)
            over = self.total > MAX_TOTAL


def _lookup(cum, sym):
    """(f, exclusive cum) of each lane's symbol, (R, N), from inclusive
    rows (R, 1 or N, 256)."""
    rows = cum.expand(*sym.shape, 256)
    inc = rows.gather(-1, sym[..., None])[..., 0]
    prev = rows.gather(-1, (sym - 1).clamp(min=0)[..., None])[..., 0]
    exc = torch.where(sym > 0, prev, torch.zeros_like(prev))
    return inc - exc, exc


def _renorm_masks(low, rng, active):
    c1 = (low ^ ((low + rng) & MASK)) < TOP
    go = active & (c1 | (rng < BOT))
    return go, go & ~c1


def encode_plain(data, order: int = 0, n_lanes: int | None = None) -> bytes:
    """One stream, equal to `arith_np.encode(data, order, n_lanes)`, computed
    on the device of `data` (uint8, 1-D)."""
    return _encode_group([data], order, n_lanes)[0]


def _encode_group(datas, order: int, n_lanes: int | None) -> list:
    """R streams of one length n (uint8 tensors on one device), coded side
    by side at one lane count, each with its own model; a stream's renorm
    loop ends when none of its lanes goes, and the extra iterations that
    other streams take move none of its lanes."""
    if order not in (0, 1):
        raise ValueError(f"order {order}")
    R, n = len(datas), datas[0].numel()
    N = n_lanes or choose_num_lanes(n)
    check_lanes(N)
    dev = datas[0].device
    K, lane_len = _lane_layout(n, N, dev)
    if K:
        m = torch.zeros((R, K * N), dtype=torch.int64, device=dev)
        m[:, :n] = torch.stack(datas).to(torch.int64)
        m = m.view(R, N, K).permute(2, 0, 1)            # (K, R, N)
    low = torch.zeros((R, N), dtype=torch.int64, device=dev)
    rng = torch.full((R, N), MASK, dtype=torch.int64, device=dev)
    zero = torch.zeros((R, N), dtype=torch.int64, device=dev)
    model = _Model(order, R, dev)
    goes, byts = [], []     # each renorm iteration's lanes and their bytes
    for t in range(K):
        active = (lane_len > t).expand(R, N)
        sym = m[t]
        ctx = m[t - 1] if (order and t) else zero
        cum, total = model.rows(ctx)
        f, c = _lookup(cum, sym)
        r = torch.where(active, rng // total.clamp(min=1), rng)
        low = torch.where(active, (low + c * r) & MASK, low)
        rng = torch.where(active, f * r, rng)
        while True:
            go, adj = _renorm_masks(low, rng, active)
            if not bool(go.any()):
                break
            rng = torch.where(adj, (-low) & (BOT - 1), rng)
            goes.append(go)
            byts.append(low >> 24)
            low = torch.where(go, (low << 8) & MASK, low)
            rng = torch.where(go, (rng << 8) & MASK, rng)
        model.update(ctx, sym, active)
    flush = torch.stack([(low << (8 * k) & MASK) >> 24 for k in range(4)],
                        -1).to(torch.uint8).cpu().numpy()
    # a stream's events in the order (step, iteration, lane): the row-major
    # nonzeros of its lanes in the iterations' masks
    go = torch.stack(goes, 1) if goes else \
        torch.zeros((R, 0, N), dtype=torch.bool, device=dev)
    ev = torch.stack(byts, 1) if byts else torch.zeros(go.shape, device=dev)
    out = []
    for i in range(R):
        lanes = go[i].nonzero()[:, 1].cpu().numpy()
        b = ev[i][go[i]].to(torch.uint8).cpu().numpy()
        out.append(header(N, order, n) +
                   arith_np.assemble_stream(lanes, b, flush[i], N))
    return out


def decode_plain(buf, device="cpu") -> bytes:
    """One stream (bytes-like or a uint8 tensor, whose device it then runs
    on), equal to `arith_np.decode(buf)`; ValueError on a stream the
    decoder cannot read or that runs out of bytes."""
    if isinstance(buf, torch.Tensor):
        device = buf.device
        buf = buf.cpu().numpy().tobytes()
    [(out, status)] = _decode_group([bytes(buf)], torch.device(device))
    if status < 0:
        raise ValueError("damaged arith stream: its body ran out of bytes")
    return out.cpu().numpy().tobytes()


def _decode_group(bufs, dev) -> list:
    """R streams of one order, lane count and n, decoded side by side:
    [(symbols uint8 tensor on dev, n or TRUNCATED)]."""
    (N, order, n), R = parse_header(bufs[0]), len(bufs)
    if any(parse_header(b) != (N, order, n) for b in bufs):
        raise ValueError("a decode group of streams of other shapes")
    blen = torch.tensor([len(b) - HEADER for b in bufs], device=dev)
    body = torch.zeros((R, int(blen.max())), dtype=torch.int64, device=dev)
    for i, b in enumerate(bufs):
        body[i, :len(b) - HEADER] = torch.frombuffer(
            bytearray(b[HEADER:]), dtype=torch.uint8).to(dev)
    K, lane_len = _lane_layout(n, N, dev)
    out = torch.zeros((max(K, 1), R, N), dtype=torch.int64, device=dev)
    init = body[:, :4 * N].view(R, N, 4)
    code = (init[..., 0] << 24) | (init[..., 1] << 16) | \
        (init[..., 2] << 8) | init[..., 3]
    ptr = torch.full((R, 1), 4 * N, dtype=torch.int64, device=dev)
    short = torch.zeros(R, dtype=torch.bool, device=dev)
    low = torch.zeros((R, N), dtype=torch.int64, device=dev)
    rng = torch.full((R, N), MASK, dtype=torch.int64, device=dev)
    prev = torch.zeros((R, N), dtype=torch.int64, device=dev)
    model = _Model(order, R, dev)
    for t in range(K):
        active = (lane_len > t).expand(R, N)
        ctx = prev if (order and t) else torch.zeros_like(prev)
        cum, total = model.rows(ctx)
        total = total.clamp(min=1)
        r = rng // total
        v = torch.minimum(((code - low) & MASK) // r.clamp(min=1), total - 1)
        sym = (cum <= v[..., None]).sum(-1).clamp(0, 255)
        f, c = _lookup(cum, sym)
        low = torch.where(active, (low + c * r) & MASK, low)
        rng = torch.where(active, f * r, rng)
        out[t] = torch.where(active, sym, 0)
        while True:
            go, adj = _renorm_masks(low, rng, active)
            if not bool(go.any()):
                break
            rng = torch.where(adj, (-low) & (BOT - 1), rng)
            # the going lanes read their stream's body at ptr + their rank
            pos = ptr + go.cumsum(1) - 1
            short |= (go & (pos >= blen[:, None])).any(1)
            byte = body.gather(1, torch.minimum(pos, blen[:, None] - 1))
            code = torch.where(go, ((code << 8) & MASK) | byte, code)
            ptr = ptr + go.sum(1, keepdim=True)
            low = torch.where(go, (low << 8) & MASK, low)
            rng = torch.where(go, (rng << 8) & MASK, rng)
        model.update(ctx, out[t], active)
        prev = out[t]
    short = short.cpu().tolist()
    return [(out.new_zeros(0, dtype=torch.uint8), TRUNCATED) if short[i]
            else (out[:K, i].t().reshape(-1)[:n].to(torch.uint8), n)
            for i in range(R)]


# --- the launch table, shared by the kernels and their plain versions -------

@dataclass
class EncodeBatch:
    data: torch.Tensor      # uint8, the streams' symbols one after another
    meta: torch.Tensor      # int64 (R, META)
    out_len: int            # bytes of the output buffer


@dataclass
class DecodeBatch:
    bufs: torch.Tensor      # uint8, the streams one after another
    meta: torch.Tensor      # int64 (R, META)
    n_out: int              # symbols of every stream
    order: int


def _as_u8(d) -> np.ndarray:
    if isinstance(d, torch.Tensor):
        return d.cpu().numpy().astype(np.uint8, copy=False).reshape(-1)
    if isinstance(d, (bytes, bytearray, memoryview)):
        return np.frombuffer(d, dtype=np.uint8)
    return np.asarray(d, dtype=np.uint8).reshape(-1)


def _concat(datas):
    """The symbols of R streams one after another, and each stream's n: on
    the streams' device when all are tensors on one device, else on the
    host."""
    if datas and all(isinstance(d, torch.Tensor) for d in datas) and \
            len({d.device for d in datas}) == 1:
        flats = [d.reshape(-1).to(torch.uint8) for d in datas]
        return torch.cat(flats), [f.numel() for f in flats]
    arrs = [_as_u8(d) for d in datas]
    data = torch.from_numpy(np.concatenate(arrs)) if arrs else \
        torch.zeros(0, dtype=torch.uint8)
    return data, [a.shape[0] for a in arrs]


def prepare_encode(datas, order: int, n_lanes: int | None = None):
    """The launch table of R streams of one order; each stream's lane count
    is `n_lanes` or `choose_num_lanes(n)`. The symbols stay on their device
    when every stream is a tensor on one device."""
    if order not in (0, 1):
        raise ValueError(f"order {order}")
    data, sizes = _concat(datas)
    meta = np.zeros((len(sizes), META), np.int64)
    off = out = 0
    for i, n in enumerate(sizes):
        N = n_lanes or choose_num_lanes(n)
        check_lanes(N)
        cap = encode_capacity(n, N)
        meta[i] = (off, n, out, cap, N.bit_length() - 1, 0)
        off += n
        out += cap
    return EncodeBatch(data, torch.from_numpy(meta), out)


def finish_encode(b: EncodeBatch, out: torch.Tensor, lens: torch.Tensor):
    """The R streams as bytes; RuntimeError where a slot overflowed."""
    lens = lens.cpu().tolist()
    if any(x < 0 for x in lens):
        raise RuntimeError(f"arith_encode: output slot overflowed ({lens})")
    host = out.cpu().numpy()
    return [host[o:o + ln].tobytes()
            for o, ln in zip(b.meta[:, 2].tolist(), lens)]


def prepare_decode(bufs) -> list:
    """One DecodeBatch per order present, each with the indices of its
    streams in `bufs`: [(batch, indices)]. ValueError on a stream whose
    header the kernels cannot take."""
    groups = {}
    for i, buf in enumerate(bufs):
        N, order, n = parse_header(buf)
        groups.setdefault(order, []).append((i, bytes(buf), N, n))
    out = []
    for order, items in sorted(groups.items()):
        meta = np.zeros((len(items), META), np.int64)
        off = sym = 0
        for j, (_, buf, N, n) in enumerate(items):
            meta[j] = (off + HEADER, len(buf) - HEADER, sym, n,
                       N.bit_length() - 1, 0)
            off += len(buf)
            sym += n
        flat = np.frombuffer(b"".join(it[1] for it in items), np.uint8)
        out.append((DecodeBatch(torch.from_numpy(flat.copy()),
                                torch.from_numpy(meta), sym, order),
                    [it[0] for it in items]))
    return out


def finish_decode(b: DecodeBatch, out: torch.Tensor, status: torch.Tensor):
    """The R streams' symbols as bytes; ValueError where a stream ran out of
    bytes."""
    status = status.cpu().tolist()
    if any(s < 0 for s in status):
        raise ValueError(f"damaged arith stream (status {status})")
    host = out.cpu().numpy()
    return [host[o:o + n].tobytes()
            for o, n in zip(b.meta[:, 2].tolist(), b.meta[:, 3].tolist())]


def check_meta(meta: torch.Tensor, n_in: int, n_out: int, decode: bool):
    """ValueError unless every row of a launch table lies inside its
    buffers: the input span in the n_in bytes of input, at least 4 N body
    bytes to decode (the kernel reads them unchecked) or a slot of at least
    the header and 4 N bytes to encode, the output span in n_out, at most
    MAX_LANES lanes."""
    for r, (a, alen, o, olen, log_n, _) in enumerate(meta.cpu().tolist()):
        N = 1 << log_n if 0 <= log_n <= 10 else 0
        n = olen if decode else alen
        body = alen if decode else olen - HEADER
        if not N or min(a, alen, o, olen) < 0 or a + alen > n_in or \
                o + olen > n_out or body < 4 * N or (decode and n < 0):
            raise ValueError(f"launch table row {r} ({a}, {alen}, {o}, "
                             f"{olen}, {log_n}) outside its buffers")


def _groups(meta, n_col):
    """Row indices of a launch table grouped by (n, log2 N): each group is
    coded side by side."""
    groups = {}
    for i, row in enumerate(meta.tolist()):
        groups.setdefault((row[n_col], row[4]), []).append(i)
    return groups.values()


def encode_batch_plain(data, meta, order: int, out_len: int):
    """The plain version of one `arith_encode` launch: (out uint8
    (out_len,), lens int64 (R,)) on the device of `data`."""
    dev = data.device
    out = torch.zeros(out_len, dtype=torch.uint8, device=dev)
    lens = torch.zeros(meta.shape[0], dtype=torch.int64, device=dev)
    rows = meta.tolist()
    for idx in _groups(meta, 1):
        streams = _encode_group([data[rows[i][0]:rows[i][0] + rows[i][1]]
                                 for i in idx], order, 1 << rows[idx[0]][4])
        for i, st in zip(idx, streams):
            o, cap = rows[i][2], rows[i][3]
            if len(st) > cap:
                lens[i] = -1
                continue
            out[o:o + len(st)] = torch.frombuffer(
                bytearray(st), dtype=torch.uint8).to(dev)
            lens[i] = len(st)
    return out, lens


def decode_batch_plain(bufs, meta, order: int, n_out: int):
    """The plain version of one `arith_decode` launch: (out uint8 (n_out,),
    status int64 (R,)) on the device of `bufs`."""
    dev = bufs.device
    out = torch.zeros(n_out, dtype=torch.uint8, device=dev)
    status = torch.zeros(meta.shape[0], dtype=torch.int64, device=dev)
    host = bufs.cpu().numpy()
    rows = meta.tolist()
    for idx in _groups(meta, 3):
        group = [header(1 << rows[i][4], order, rows[i][3]) +
                 host[rows[i][0]:rows[i][0] + rows[i][1]].tobytes()
                 for i in idx]
        for i, (sym, st) in zip(idx, _decode_group(group, dev)):
            status[i] = st
            o, n = rows[i][2], rows[i][3]
            if st > 0:
                out[o:o + n] = sym
    return out, status


# --- the kernels' pieces in plain torch (csrc/arith_model.cuh) -------------
# The CPU tests hold each against its definition; nothing on a CUDA path
# calls them. Values are int64 tensors holding u16 and u32 quantities.

GROUP = 16               # symbols a group sum covers
MAX_EVENTS = 3           # renorm events a lane a step (proof in csrc/arith.cu)


def pack_halves(x: torch.Tensor) -> torch.Tensor:
    """(..., 2k) u16 values -> (..., k) u32 words, value 2i in the low half
    of word i (the kernels' frequency and group-sum words)."""
    return x[..., 0::2] | (x[..., 1::2] << 16)


def group_sums(freq: torch.Tensor) -> torch.Tensor:
    """(..., 256) frequencies -> (..., 16) sums of each group of 16."""
    return freq.reshape(*freq.shape[:-1], 256 // GROUP, GROUP).sum(-1)


def prefix16(words: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The kernels' prefix16: the sum of the first k (0..16) halves of 8
    packed words (..., 8), by adding whole words (and the low half of word
    k >> 1 when k is odd) and then the two halves of the u32 sum."""
    i = torch.arange(8, device=words.device)
    kw = (k >> 1)[..., None]
    part = torch.where(i < kw, words, torch.where(
        (i == kw) & ((k & 1)[..., None] == 1), words & 0xFFFF,
        torch.zeros_like(words)))
    acc = part.sum(-1) & MASK
    return (acc & 0xFFFF) + (acc >> 16)


def find16(words: torch.Tensor, v: torch.Tensor):
    """The kernels' find16 on 8 packed words (..., 8): (the number of
    inclusive prefix sums of the 16 halves that are <= v, the largest of
    them or 0, the smallest of the others), from the running u32 sum of
    the words."""
    p = words.cumsum(-1) & MASK
    hi_before = torch.cat([torch.zeros_like(p[..., :1]), p[..., :-1] >> 16],
                          -1)
    i0, i1 = (p & 0xFFFF) + hi_before, (p & 0xFFFF) + (p >> 16)
    incl = torch.stack([i0, i1], -1).flatten(-2)          # (..., 16)
    le = incl <= v[..., None]
    below = torch.where(le, incl, torch.zeros_like(incl)).amax(-1)
    above = torch.where(le, torch.full_like(incl, MASK), incl).amin(-1)
    return le.sum(-1), below, above


def lookup_grouped(freq: torch.Tensor, sym: torch.Tensor):
    """The encoder's lookup on rows of frequencies (..., 256): (f, exclusive
    cum) of `sym` (...), as the kernel takes them from the packed group
    sums and the packed frequencies of the symbol's group."""
    g, k = sym >> 4, sym & 15
    gw = pack_halves(group_sums(freq))
    grp = freq.reshape(*freq.shape[:-1], 16, GROUP).gather(
        -2, g[..., None, None].expand(*g.shape, 1, GROUP))[..., 0, :]
    fw = pack_halves(grp)
    before = prefix16(fw, k)
    return prefix16(fw, k + 1) - before, prefix16(gw, g) + before


def search_grouped(freq: torch.Tensor, v: torch.Tensor):
    """The decoder's search on rows (..., 256) for values v < the rows'
    totals: (symbol, f, exclusive cum), the group from the packed group
    sums, then the symbol from the group's packed frequencies."""
    grp_i, base, _ = find16(pack_halves(group_sums(freq)), v)
    grp = freq.reshape(*freq.shape[:-1], 16, GROUP).gather(
        -2, grp_i[..., None, None].expand(*grp_i.shape, 1, GROUP))[..., 0, :]
    k, within, incl = find16(pack_halves(grp), v - base)
    return grp_i * GROUP + k, incl - within, base + within


def event_slots(e: torch.Tensor):
    """The slots of a step's renorm events from the lanes' counts e (N,),
    each 0..MAX_EVENTS: (slots (N, MAX_EVENTS), the step's events). Lane
    l's i-th event goes after the events of iterations before i and after
    the lanes before l with more than i events (the format's order:
    iteration, then lane); slots of events a lane does not have are -1."""
    i = torch.arange(MAX_EVENTS, device=e.device)
    go = e[:, None] > i[None, :]                          # (N, 3)
    totals = go.sum(0)
    before = torch.cumsum(totals, 0) - totals             # iterations < i
    rank = torch.cumsum(go, 0) - go.long()                # lanes < l
    return torch.where(go, before[None, :] + rank, -1), int(totals.sum())


def update_step(freq, gsum, total, ctx, sym, active, order=0, perm=None):
    """The kernels' step update (model_update) on one model, (nctx, 256)
    frequencies, (nctx, 16) group sums and (nctx,) totals, in place; ctx,
    sym and active are the N lanes'. Order 1: each active lane adds INC to
    its frequency, its group sum and its context's total, the total adds in
    the order `perm` (a permutation of the active lanes; default: lane
    order), and the add that takes a context's total over MAX_TOTAL lists
    the context. Order 0 (one context): each active lane adds INC to its
    frequency and its group sum; the total takes INC x the active lanes at
    once, and the context is listed when that crosses MAX_TOTAL. The listed
    contexts are halved once. Returns them in list order."""
    one = torch.full_like(ctx[active], INC)
    freq.index_put_((ctx[active], sym[active]), one, accumulate=True)
    gsum.index_put_((ctx[active], sym[active] >> 4), one, accumulate=True)
    listed = []
    if order == 0:
        old = int(total[0])
        total[0] = old + INC * int(active.sum())
        if old <= MAX_TOTAL < int(total[0]):
            listed.append(0)
    else:
        lanes = active.nonzero()[:, 0].tolist()
        for j in (perm if perm is not None else range(len(lanes))):
            c = int(ctx[lanes[j]])
            old = int(total[c])
            total[c] = old + INC
            if old <= MAX_TOTAL < old + INC:
                listed.append(c)
    if listed:
        rows = torch.tensor(listed, device=freq.device)
        freq[rows] = (freq[rows] + 1) >> 1
        gsum[rows] = group_sums(freq[rows])
        total[rows] = freq[rows].sum(-1)
    return listed
