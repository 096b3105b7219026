"""Per-field contexts: ZIP-side segmentation state and PIZ-side recon state.

Counterpart of genozip_tpu/contexts.py, unchanged in behaviour.
Reference parity: src/context.c (ctx_clone :469 / ctx_merge_in_vb_ctx :1082),
src/b250.c (word-index streams), src/dict_io.c (global dict output). The
redesign: a VB segs *whole columns* at once (ragged numpy ops — no
per-line loop), dictionaries are deduped vectorized (pad + np.unique) and
merged into the global dict deterministically in VB order (the reference's
per-context merge mutex with vb1-first becomes an ordered reduction), and
b250 becomes a fixed-width word-index array entropy-coded by the wide rANS
instead of base-250 varints.
"""

import numpy as np

from . import native
from .codecs import assign as codec_assign
from .utils import ragged
from .utils.ragged import Col

# ctx reconstruction modes (stored per-VB in the VB header)
MODE_DICT = "dict"          # b250 word indices into the global dict
MODE_NUM = "num"            # numeric local, rendered by datatype/container
MODE_TXT = "txt"            # ragged text local; lens from `len_from` ctx


class VBCtx:
    """One context's payload for one VB (ZIP output / PIZ input)."""
    __slots__ = ("name", "mode", "b250", "vb_words", "local", "ltype",
                 "cat", "special", "param", "flags")

    def __init__(self, name, mode, *, b250=None, vb_words=None, local=None,
                 cat="text", special=None, param=0):
        self.name = name
        self.mode = mode
        self.b250 = b250            # np.int64 VB-local word indices
        self.vb_words = vb_words    # Col of VB-local unique words
        self.local = local          # np.ndarray (typed) or None
        self.cat = cat              # codec-assignment category
        self.special = special      # special id (MODE_SPECIAL)
        self.param = param

    def meta(self):
        m = {"mode": self.mode}
        if self.special is not None:
            m["special"] = self.special
        if self.param:
            m["param"] = self.param
        return m


def dedup_col(col: Col):
    """Vectorized ragged dedup: returns (unique Col in first-seen order,
    inverse int64[n]): the host runtime's 64-bit row hashes, np.unique and
    a check of every row against its representative; on a collision,
    `dedup_col_np` (the exact path)."""
    h = native.row_hash(col.data, col.offsets)
    _, first_idx, inverse = np.unique(h, return_index=True,
                                      return_inverse=True)
    inverse = inverse.reshape(-1)
    if not native.rows_equal_rep(col.data, col.offsets, first_idx[inverse]):
        return dedup_col_np(col)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return ragged.take(col, first_idx[order]), \
        rank[inverse].astype(np.int64)


def dedup_col_np(col: Col):
    """dedup_col in numpy: a pad+hash-fold matrix for rows up to 96 bytes,
    a python dict for wider rows."""
    n = len(col)
    if n == 0:
        return Col.from_list([]), np.zeros(0, np.int64)
    maxw = int(col.lens.max()) if n else 0
    if maxw <= 96:
        w = max(maxw, 1)
        mat = np.zeros((n, w + 1), dtype=np.uint8)  # +1 col for length
        lens = col.lens
        total = int(lens.sum())
        if total:
            pos = np.arange(total, dtype=np.int64) - np.repeat(col.offsets[:-1], lens)
            rows = np.repeat(np.arange(n, dtype=np.int64), lens)
            mat[rows, pos] = col.data
        mat[:, w] = lens  # disambiguate "a\0" vs "a" (only valid for len<256)
        # hash-first dedup: np.unique over void rows is pathologically slow
        # (generic comparisons); numeric unique over a 64-bit row-fold is
        # ~100x faster. Collisions are verified and fall back to exact.
        w8 = (mat.shape[1] + 7) // 8 * 8
        if w8 != mat.shape[1]:
            m8 = np.zeros((n, w8), dtype=np.uint8)
            m8[:, :mat.shape[1]] = mat
        else:
            m8 = mat
        cols64 = m8.view("<u8")
        mult = (np.arange(1, cols64.shape[1] + 1, dtype=np.uint64)
                * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
        h = (cols64 * mult[None, :]).sum(axis=1, dtype=np.uint64)
        h = (h ^ (h >> np.uint64(31))) * np.uint64(0xBF58476D1CE4E5B9)
        uniq_h, first_idx, inverse = np.unique(h, return_index=True,
                                               return_inverse=True)
        # verify no collisions: every row must equal its group representative
        if not (m8 == m8[first_idx[inverse]]).all():
            v = mat.view([("", np.uint8)] * mat.shape[1]).reshape(n)
            uniq, first_idx, inverse = np.unique(v, return_index=True,
                                                 return_inverse=True)
        # unique sorts; remap to first-seen order for determinism
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.shape[0])
        inverse = rank[inverse]
        uniq_col = ragged.take(col, first_idx[order])
        return uniq_col, inverse.astype(np.int64)
    # wide rows: python dict fallback
    seen = {}
    inv = np.empty(n, dtype=np.int64)
    uw = []
    for i in range(n):
        r = col.row(i)
        j = seen.get(r)
        if j is None:
            j = len(uw)
            seen[r] = j
            uw.append(r)
        inv[i] = j
    return Col.from_list(uw), inv


def _col_hashes(col: Col) -> np.ndarray:
    """64-bit row hashes, for dict membership only (any fixed hash serves):
    the host runtime's."""
    return native.row_hash(col.data, col.offsets)


class ZCtxGlobal:
    """ZIP-side global (z_file) context: global dict + committed codecs.
    Merge is deterministic because VBs merge in VB order (cf. the reference's
    vb1-first merge mutexes, src/context.c:938). The merge itself is
    vectorized: sorted-hash membership (searchsorted) + batched append —
    the same ordered-reduction shape as the multi-chip collective merge
    (parallel/zip_sharded.py)."""

    def __init__(self, name):
        self.name = name
        self.words_data = np.zeros(0, np.uint8)   # concatenated word bytes
        self.words_off = np.zeros(1, np.int64)
        self.counts = np.zeros(0, np.int64)
        self._hash_sorted = np.zeros(0, np.uint64)  # sorted global hashes
        self._hash_idx = np.zeros(0, np.int64)      # global idx per sorted hash
        self.b250_codec = None
        self.local_codec = None
        self.codec_nvb = {}       # stream kind -> VBs seen
        self.codec_hist = {}      # stream kind -> recent winners (--best)

    def pick_codec(self, kind: str, payload, cat: str) -> int:
        """Codec for this VB's `kind` ('b250'/'local') stream. Reference
        parity (src/codec.c:196-277): commit the VB-1 winner, RE-TEST at
        VB 10 (an unrepresentative first VB must not lock a bad codec in
        for the whole file — each section carries its own codec id, so
        switching mid-file is safe); under --best, lock in only after 5
        consecutive VBs agree."""
        attr = kind + "_codec"
        n = self.codec_nvb.get(kind, 0) + 1
        self.codec_nvb[kind] = n
        committed = getattr(self, attr)
        if codec_assign._mode == "best" and committed is None:
            c = codec_assign.assign_best(payload, cat)
            hist = self.codec_hist.setdefault(kind, [])
            hist.append(c)
            if len(hist) >= 5 and len(set(hist[-5:])) == 1:
                setattr(self, attr, c)
            return c
        if committed is None:
            c = codec_assign.assign_best(payload, cat)
            # a near-empty payload can't rank codecs — committing NONE from
            # it would lock later, full VBs to raw storage (e.g. NONREF is
            # empty in every MAIN VB of a gencomp run but megabytes in the
            # DEPN component). Defer the commit to the first VB with
            # rankable content; until then each VB decides for itself
            # (deterministic: depends only on payload bytes in VB order).
            if len(payload) >= 4096:
                setattr(self, attr, c)
            return c
        if n == 10 and codec_assign._mode != "fast":
            if len(payload) >= 4096:
                c = codec_assign.assign_best(payload, cat)
                if c != committed:
                    setattr(self, attr, c)
                return c
        return committed

    def __len__(self):
        return self.words_off.shape[0] - 1

    @property
    def words(self) -> Col:
        return Col(self.words_data, self.words_off)

    def word(self, i: int) -> bytes:
        return bytes(self.words_data[self.words_off[i]:self.words_off[i + 1]])

    def merge_words(self, vb_words: Col, vb_counts=None):
        """Map VB-local unique words to global indices, appending new ones
        in VB-local first-seen order. Returns int64 lut. Vectorized:
        hash membership against the sorted global hash set, byte-verify
        the hits, batch-append the misses. (64-bit hash collisions between
        DIFFERENT words would mis-share an index; the byte verification
        catches the global-vs-local case, and within a VB dedup_col already
        guarantees distinct rows, whose hashes collide with probability
        ~2^-64 — detected there and exact-fallback'd.)"""
        k = len(vb_words)
        lut = np.empty(k, dtype=np.int64)
        if k == 0:
            return lut
        h = _col_hashes(vb_words)
        pos = np.searchsorted(self._hash_sorted, h)
        inb = pos < self._hash_sorted.shape[0]
        hit = np.zeros(k, bool)
        hit[inb] = self._hash_sorted[pos[inb]] == h[inb]
        if hit.any():
            gidx = self._hash_idx[pos[hit]]
            # byte-verify hits (hash collision -> treat as new word)
            gl = self.words_off[gidx + 1] - self.words_off[gidx]
            vl = vb_words.lens[hit]
            ok = gl == vl
            if ok.any():
                hi = np.nonzero(hit)[0]
                sub = ragged.take(vb_words, hi[ok])
                starts = self.words_off[gidx[ok]]
                gbytes = ragged.gather_ranges(self.words_data, starts,
                                              gl[ok])
                same = np.ones(int(ok.sum()), bool)
                neq = np.nonzero(sub.data != gbytes.data)[0]
                if neq.shape[0]:
                    rows = np.unique(np.searchsorted(sub.offsets[1:], neq,
                                                     side="right"))
                    same[rows] = False
                ok[np.nonzero(ok)[0]] = same
            hi = np.nonzero(hit)[0]
            hit[hi[~ok]] = False
            lut[hit] = self._hash_idx[pos[hit]]
        new = np.nonzero(~hit)[0]
        if new.shape[0]:
            base = len(self)
            lut[new] = base + np.arange(new.shape[0])
            nw = ragged.take(vb_words, new)
            self.words_data = np.concatenate([self.words_data, nw.data])
            self.words_off = np.concatenate(
                [self.words_off, self.words_off[-1] + np.cumsum(nw.lens)])
            self.counts = np.concatenate(
                [self.counts, np.zeros(new.shape[0], np.int64)])
            order = np.argsort(np.concatenate([self._hash_sorted, h[new]]),
                               kind="stable")
            allh = np.concatenate([self._hash_sorted, h[new]])
            alli = np.concatenate([self._hash_idx, lut[new]])
            self._hash_sorted = allh[order]
            self._hash_idx = alli[order]
        if vb_counts is not None:
            np.add.at(self.counts, lut, np.asarray(vb_counts, np.int64))
        return lut

    def dict_payload(self) -> bytes:
        lens = np.diff(self.words_off)
        head = len(self).to_bytes(4, "little") + lens.astype("<u4").tobytes()
        return head + self.words_data.tobytes()


def parse_dict_payload(payload: bytes) -> Col:
    n = int.from_bytes(payload[0:4], "little")
    lens = np.frombuffer(payload[4:4 + 4 * n], "<u4").astype(np.int64)
    data = np.frombuffer(payload[4 + 4 * n:], np.uint8)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    if offsets[-1] != data.shape[0]:
        raise ValueError("dict payload length mismatch")
    return Col(data.copy(), offsets)


class PCtx:
    """PIZ-side per-VB context: decoded b250/local + shared global dict."""
    __slots__ = ("name", "mode", "b250", "dict_col", "local", "ltype",
                 "param", "special")

    def __init__(self, name, mode, *, b250=None, dict_col=None, local=None,
                 ltype=None, param=0, special=None):
        self.name, self.mode = name, mode
        self.b250, self.dict_col, self.local = b250, dict_col, local
        self.ltype, self.param, self.special = ltype, param, special

    def dict_take(self) -> Col:
        """Per-line words via ragged gather from the global dict."""
        return ragged.take(self.dict_col, self.b250)

    def nums(self) -> np.ndarray:
        v = self.local.astype(np.int64)
        if self.param == 1:  # delta-coded
            v = np.cumsum(v)
        return v

    def txt_col(self, lens: np.ndarray) -> Col:
        offsets = np.concatenate([[0], np.cumsum(lens.astype(np.int64))])
        if offsets[-1] != self.local.shape[0]:
            raise ValueError(f"{self.name}: txt local length mismatch")
        return Col(self.local, offsets)


def narrow_int(vals: np.ndarray):
    """Choose the narrowest dtype representing vals (reference src/dyn_int.c)."""
    if vals.shape[0] == 0:
        return vals.astype(np.uint8)
    lo, hi = int(vals.min()), int(vals.max())
    if lo >= 0:
        for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
            if hi <= np.iinfo(dt).max:
                return vals.astype(dt)
    for dt in (np.int8, np.int16, np.int32, np.int64):
        ii = np.iinfo(dt)
        if ii.min <= lo and hi <= ii.max:
            return vals.astype(dt)
    return vals.astype(np.int64)


def est_ctxs_size(ctxs: dict) -> int:
    """Compressed-size estimate of a candidate VBCtx set, for the trial-both
    seg choices (VCF ID, CSQ and int-list layouts): payloads are compressed
    for real with the codec the category would get (a strided sample above
    4 MB), so the comparison tracks what the write path will do."""
    from .codecs import compress
    tot = 0
    for c in ctxs.values():
        parts = []
        if c.b250 is not None:
            parts.append((narrow_int(c.b250).tobytes(), "b250"))
        if c.vb_words is not None:
            # dict words merge into the global dict, whose similar words
            # carry LZ redundancy: estimate with the "text" assignment
            parts.append((c.vb_words.data.tobytes(), "text"))
        if c.local is not None:
            arr = narrow_int(c.local) if c.mode == MODE_NUM else c.local
            parts.append((arr.tobytes(),
                          "int" if c.mode == MODE_NUM else c.cat))
        for p, cat in parts:
            n = len(p)
            if n < 64:
                tot += n + 8
                continue
            if n > (4 << 20):
                p = codec_assign._strided_sample(np.frombuffer(p, np.uint8),
                                                 1 << 20)
            codec = codec_assign.assign_best(p, cat)
            tot += int(len(compress(p, codec)) * (n / len(p))) + 8
    return tot
