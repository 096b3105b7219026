"""BWT block codec: a Burrows-Wheeler transform, then the adaptive order-1
coder (ARITH1) over the transformed block.

Counterpart of genozip_tpu/codecs/bwt.py, with its framing and bytes.
Forward: the suffix array by prefix doubling (np.lexsort, O(n log^2 n)),
the BWT from the suffix array of the sentinel-terminated block. Inverse:
the LF mapping by counting, then the walk of its one cycle from the
sentinel's row. genozip_tpu walks it one step at a time in Python (or in
its native runtime); here the walk is vectorized (`_walk`): walkers start
together from sampled rows, each follows the cycle to the next sampled
row, and the segments are then put in cycle order. The text is unique, so
the bytes are genozip_tpu's.

Reference parity: the role of src/bsc/ (block-sorting for large text-ish
sections).
"""

import numpy as np

# the prefix-doubling SA is O(n log^2 n) lexsorts: big payloads split into
# independent blocks. Multi-block blobs carry a sentinel first word;
# single-block blobs keep the one-block framing.
BWT_BLOCK = 4 << 20
_MULTI = (1 << 64) - 1
# one walker starts at every WALK_STRIDE-th row of the LF cycle
WALK_STRIDE = 256


def suffix_array(data: np.ndarray) -> np.ndarray:
    """SA of data + virtual sentinel (lexicographically smallest). Returns
    positions 0..n (n = sentinel position)."""
    n = data.shape[0]
    # rank 0 = sentinel; bytes shifted +1
    rank = np.zeros(n + 1, np.int64)
    rank[:n] = data.astype(np.int64) + 1
    k = 1
    tmp = np.empty(n + 1, np.int64)
    while True:
        key2 = np.full(n + 1, -1, np.int64)
        key2[: n + 1 - k] = rank[k:]
        order = np.lexsort((key2, rank))
        # new ranks: increment where (rank, key2) differs from predecessor
        r_o = rank[order]
        k_o = key2[order]
        diff = np.ones(n + 1, bool)
        diff[1:] = (r_o[1:] != r_o[:-1]) | (k_o[1:] != k_o[:-1])
        tmp[order] = np.cumsum(diff) - 1
        rank, tmp = tmp.copy(), rank
        if rank.max() == n:
            return order
        k *= 2


def bwt_forward(data: np.ndarray):
    """Returns (last column WITHOUT the sentinel row's char, primary index
    = row of the sentinel in the sorted rotation matrix)."""
    sa = suffix_array(data)
    # BWT[i] = data[sa[i]-1]; the sa[i] == 0 row emits the sentinel
    # (skipped, its row recorded)
    prim = int(np.nonzero(sa == 0)[0][0])
    keep = sa != 0
    return data[sa[keep] - 1], prim


def _walk(lf: np.ndarray, start: int) -> np.ndarray:
    """The position of every row on the cycle of `lf` (one cycle through
    all its rows): row lf^(k+1)[start] gets k, so `start` gets len(lf)-1."""
    N = lf.shape[0]
    is_split = np.zeros(N, bool)
    is_split[::WALK_STRIDE] = True
    is_split[start] = True
    splits = np.nonzero(is_split)[0]
    S = splits.shape[0]
    split_i = np.full(N, -1, np.int64)
    split_i[splits] = np.arange(S)
    # walker s covers the rows after splits[s] up to the next sampled row,
    # that row included: each row is covered once
    seg = np.empty(N, np.int64)      # the walker that covers the row
    step = np.empty(N, np.int64)     # its step there, from 0
    nxt = np.empty(S, np.int64)      # the sampled row walker s ends on
    seg_len = np.empty(S, np.int64)
    cur, who, k = lf[splits], np.arange(S), 0
    while cur.shape[0]:
        seg[cur] = who
        step[cur] = k
        done = is_split[cur]
        nxt[who[done]] = cur[done]
        seg_len[who[done]] = k + 1
        cur, who = lf[cur[~done]], who[~done]
        k += 1
    # the segments in cycle order from start: a chain over S walkers
    order = np.empty(S, np.int64)
    s = split_i[start]
    for i in range(S):
        order[i] = s
        s = split_i[nxt[s]]
    first = np.empty(S, np.int64)
    first[order] = np.concatenate([[0], np.cumsum(seg_len[order])[:-1]])
    return first[seg] + step


def _lf(last: np.ndarray, prim: int):
    """(LF mapping, L column with the sentinel as 0 and bytes as 1..256) of
    the rows 0..n, the sentinel's row at `prim`."""
    n = last.shape[0]
    # F column = sorted([sentinel] + last); LF mapping via counting
    occ = np.zeros(257, np.int64)
    sym = last.astype(np.int64) + 1
    np.add.at(occ, sym, 1)
    occ[0] = 1                               # the sentinel
    starts = np.concatenate([[0], np.cumsum(occ)[:-1]])
    # rows: 0..n (with the sentinel row at prim). L[i] for i != prim.
    rows = np.arange(n + 1)
    li = np.concatenate([sym[:prim], [0], sym[prim:]])
    # rank of each symbol occurrence within its symbol class (stable)
    order = np.argsort(li, kind="stable")
    rank_in_class = np.empty(n + 1, np.int64)
    rank_in_class[order] = rows - starts[li[order]]
    return starts[li] + rank_in_class, li


def bwt_inverse(last: np.ndarray, prim: int) -> np.ndarray:
    """Invert: reinsert the virtual sentinel at row `prim` and walk the LF
    mapping backwards from it."""
    n = last.shape[0]
    if n == 0:
        return np.empty(0, np.uint8)
    lf, li = _lf(last, prim)
    rows = np.arange(n + 1)
    # the walk i_{k+1} = lf[i_k] from i_0 = prim emits out[n-1-k] =
    # L[i_{k+1}]; it ends back on prim after n+1 steps
    pos = _walk(lf, prim)
    out = np.empty(n, np.uint8)
    keep = rows != prim
    out[n - 1 - pos[keep]] = (li[keep] - 1).astype(np.uint8)
    return out


def _compress_block(a: np.ndarray, sub_codec: int) -> bytes:
    from . import compress as ccompress
    last, prim = bwt_forward(a)
    sub = ccompress(last.tobytes(), sub_codec)
    return a.shape[0].to_bytes(8, "little") + prim.to_bytes(8, "little") + \
        bytes([sub_codec]) + sub


def compress(data: bytes, sub_codec: int) -> bytes:
    a = np.frombuffer(data, np.uint8)
    if a.shape[0] == 0:
        return (0).to_bytes(8, "little")
    if a.shape[0] <= BWT_BLOCK:
        return _compress_block(a, sub_codec)
    parts = []
    for off in range(0, a.shape[0], BWT_BLOCK):
        blk = _compress_block(a[off:off + BWT_BLOCK], sub_codec)
        parts.append(len(blk).to_bytes(8, "little") + blk)
    return _MULTI.to_bytes(8, "little") + \
        len(parts).to_bytes(8, "little") + b"".join(parts)


def _decompress_block(blob) -> bytes:
    from . import decompress as cdecompress
    n = int.from_bytes(blob[0:8], "little")
    prim = int.from_bytes(blob[8:16], "little")
    sub_codec = blob[16]
    last = np.frombuffer(cdecompress(blob[17:], sub_codec, n), np.uint8)
    return bwt_inverse(last, prim).tobytes()


def decompress(blob) -> bytes:
    blob = memoryview(blob)
    n = int.from_bytes(blob[0:8], "little")
    if n == 0:
        return b""
    if n != _MULTI:
        return _decompress_block(blob)
    nblk = int.from_bytes(blob[8:16], "little")
    out = []
    off = 16
    for _ in range(nblk):
        bl = int.from_bytes(blob[off:off + 8], "little")
        out.append(_decompress_block(blob[off + 8:off + 8 + bl]))
        off += 8 + bl
    return b"".join(out)


def _step_loop(last: np.ndarray, prim: int) -> np.ndarray:
    """The inverse as genozip_tpu walks it without its native runtime: one
    Python step a byte. For timing against `bwt_inverse` only."""
    lf, li = _lf(last, prim)
    out = np.empty(last.shape[0], np.uint8)
    i = prim
    for k in range(last.shape[0] - 1, -1, -1):
        i = lf[i]
        out[k] = li[i] - 1
    return out


if __name__ == "__main__":
    # python -m genozip_tpu_torch.codecs.bwt [MiB]: host seconds of the
    # forward transform, the vectorized inverse and the step loop on one
    # block of cfg3-shaped FASTQ
    import os
    import sys
    import tempfile
    import time

    from .. import synth
    nbytes = int(float(sys.argv[1]) * (1 << 20)) if len(sys.argv) > 1 \
        else BWT_BLOCK
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "r.fastq")
        synth.write_fastq(path, nbytes, seed=3)
        with open(path, "rb") as f:
            block = np.frombuffer(f.read(nbytes), np.uint8)
    t = time.time()
    last, prim = bwt_forward(block)
    times = {"forward": time.time() - t}
    for name, fn in (("walk", bwt_inverse), ("step loop", _step_loop)):
        t = time.time()
        if fn(last, prim).tobytes() != block.tobytes():
            raise SystemExit(f"{name}: not the input")
        times[name] = time.time() - t
    print(f"{block.shape[0]} bytes: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in times.items()))
