"""SAG (supplementary-alignment-group) store: DEPN alignments compress
against their primary.

Reference parity: src/sam_sag_ingest.c:105-310 sam_zip_prim_ingest_vb (PRIM
SEQ/QUAL/QNAME ingested into z-file-wide buffers), src/sam_sag_load.c (PIZ
loads SAGs before reconstruction), src/gencomp_zip.c (PRIM/DEPN generated
components). Counterpart of genozip_tpu/sag.py on its numpy host path.
Design: primaries-with-dependents are deported to
their own PRIM component (identified by a vectorized qname-hash prescan);
the store is built from that component's text identically at ZIP and PIZ, so
DEPN rows need only a store index + match flags — SEQ/QUAL reconstruct by
orientation + hard-clip slicing of the primary's bytes.
"""

import numpy as np

from .utils import ragged
from .utils.ragged import Col

FLAG_REV = 0x10
MATE_BITS = 0xC0
DEPN_MASK = 0x900  # secondary | supplementary


def qname_hash(col: Col) -> np.ndarray:
    """Vectorized 64-bit hash per row. Width-INDEPENDENT: zero-padded tail
    words multiply to 0 and the row length folds into the final mix, so the
    same qname hashes identically whatever the batch's max row width (the
    prescan batches and the split batches differ). Used only as a prescan
    *filter* — collisions deport extra primaries, never corrupt data."""
    n = len(col)
    if n == 0:
        return np.zeros(0, np.uint64)
    w = max(int(col.lens.max()), 1)
    mat = np.zeros((n, w), dtype=np.uint8)
    lens = np.minimum(col.lens, w)
    total = int(lens.sum())
    if total:
        pos = ragged.arange(total) - np.repeat(col.offsets[:-1], lens)
        rows = np.repeat(ragged.arange(n), lens)
        mat[rows, pos] = col.data[np.repeat(col.offsets[:-1], lens) + pos]
    w8 = (w + 7) // 8 * 8
    m8 = np.zeros((n, w8), dtype=np.uint8)
    m8[:, :w] = mat
    cols64 = m8.view("<u8")
    mult = (np.arange(1, cols64.shape[1] + 1, dtype=np.uint64)
            * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    h = (cols64 * mult[None, :]).sum(axis=1, dtype=np.uint64)
    h ^= lens.astype(np.uint64) * np.uint64(0xFF51AFD7ED558CCD)
    return (h ^ (h >> np.uint64(31))) * np.uint64(0xBF58476D1CE4E5B9)


def tag_int(aux: Col, tag: bytes) -> np.ndarray:
    """Per-row int value of an aux tag (e.g. b'NM:i:'), -1 where absent.
    Vectorized pattern scan over the whole aux text — no per-row python."""
    n = len(aux)
    out = np.full(n, -1, np.int64)
    d = aux.data
    tl = len(tag)
    if d.shape[0] < tl or n == 0:
        return out
    m = np.ones(d.shape[0] - tl + 1, bool)
    for j, b in enumerate(tag):
        m &= d[j:d.shape[0] - tl + 1 + j] == b
    hits = np.nonzero(m)[0]
    if hits.shape[0] == 0:
        return out
    row = np.searchsorted(aux.offsets, hits, "right") - 1
    # a match must start at a tag boundary AND lie fully inside its row:
    # a row whose aux text ends with the tag prefix followed by a next row
    # starting with the remainder would otherwise yield vstart past the
    # row end and a negative gather length.
    keep = ((hits == aux.offsets[row]) |
            (d[np.maximum(hits - 1, 0)] == ord("\t"))) & \
        (hits + tl <= aux.offsets[row + 1])
    hits, row = hits[keep], row[keep]
    # keep first occurrence per row
    first = np.ones(hits.shape[0], bool)
    first[1:] = row[1:] != row[:-1]
    hits, row = hits[first], row[first]
    vstart = hits + tl
    vend = np.minimum(aux.offsets[row + 1], vstart + 19)
    vals_col = ragged.gather_ranges(d, vstart, vend - vstart)
    # trim at the first tab inside the gathered window
    mat, lens = ragged.to_matrix(vals_col, fill=ord("\t"))
    istab = mat == ord("\t")
    wlen = np.where(istab.any(axis=1), istab.argmax(axis=1), lens)
    vals_col = ragged.gather_ranges(d, vstart, wlen)
    v, ok = ragged.atoi(vals_col)
    out[row[ok]] = v[ok]
    return out


def tag_str(aux: Col, tag: bytes) -> Col:
    """Per-row text value of a Z-type aux tag (e.g. b'SA:Z:'), empty rows
    where absent. Vectorized: one pattern scan + one ranged gather."""
    n = len(aux)
    d = aux.data
    tl = len(tag)
    empty = Col(np.zeros(0, np.uint8),
                np.zeros(n + 1, np.int64))
    if d.shape[0] < tl or n == 0:
        return empty
    m = np.ones(d.shape[0] - tl + 1, bool)
    for j, b in enumerate(tag):
        m &= d[j:d.shape[0] - tl + 1 + j] == b
    hits = np.nonzero(m)[0]
    if hits.shape[0] == 0:
        return empty
    row = np.searchsorted(aux.offsets, hits, "right") - 1
    keep = ((hits == aux.offsets[row]) |
            (d[np.maximum(hits - 1, 0)] == ord("\t"))) & \
        (hits + tl <= aux.offsets[row + 1])
    hits, row = hits[keep], row[keep]
    first = np.ones(hits.shape[0], bool)
    first[1:] = row[1:] != row[:-1]
    hits, row = hits[first], row[first]
    vstart = hits + tl
    vend = aux.offsets[row + 1]
    vals = ragged.gather_ranges(d, vstart, vend - vstart)
    # trim at the first tab
    tabs = np.nonzero(vals.data == ord("\t"))[0]
    if tabs.shape[0]:
        trow = np.searchsorted(vals.offsets[1:], tabs, side="right")
        tfirst = np.ones(tabs.shape[0], bool)
        tfirst[1:] = trow[1:] != trow[:-1]
        tabs, trow = tabs[tfirst], trow[tfirst]
        newlens = vals.lens.copy()
        newlens[trow] = tabs - vals.offsets[:-1][trow]
        vals = ragged.gather_ranges(vals.data, vals.offsets[:-1], newlens)
    lens = np.zeros(n, np.int64)
    lens[row] = vals.lens
    out_off = np.concatenate([[0], np.cumsum(lens)])
    return Col(vals.data, out_off)


def hash_join(haystack: Col, needles: Col) -> np.ndarray:
    """Index of each needle row in haystack (-1 if absent): sorted-hash
    join + byte verification, so a collision degrades to a miss. Ties keep
    the lowest haystack row — deterministic at ZIP and PIZ."""
    from .utils.ragged import cols_equal_rows
    n = len(needles)
    if n == 0 or len(haystack) == 0:
        return np.full(n, -1, np.int64)
    hk = qname_hash(haystack)
    order = np.lexsort((np.arange(len(haystack)), hk))
    skeys = hk[order]
    key = qname_hash(needles)
    at = np.searchsorted(skeys, key, side="left")
    ok = at < skeys.shape[0]
    cand = order[np.minimum(at, skeys.shape[0] - 1)]
    ok &= skeys[np.minimum(at, skeys.shape[0] - 1)] == key
    ok &= cols_equal_rows(needles, ragged.take(haystack, cand))
    return np.where(ok, cand, -1).astype(np.int64)


_BAUX_INT_TYPES = {ord("c"): np.int8, ord("C"): np.uint8,
                   ord("s"): np.int16, ord("S"): np.uint16,
                   ord("i"): np.int32, ord("I"): np.uint32}


SOLO_TAGS = (b"CB", b"CR", b"UB", b"UR", b"BX", b"RX")


def _bam_aux_tags(bd, aux: Col):
    """NM:i / NH:i ints (-1 where absent) + SA:Z text + SOLO barcode tag
    columns from binary BAM aux data (one vectorized field walk —
    datatypes/bam.py's)."""
    n = len(aux)
    nm = np.full(n, -1, np.int64)
    nh = np.full(n, -1, np.int64)
    sa = Col(np.zeros(0, np.uint8), np.zeros(n + 1, np.int64))
    solo = {}
    fr, fs, fv, _bad = bd._walk_aux(aux)
    if fr.shape[0] == 0:
        return nm, nh, sa, solo
    data = aux.data
    tag2 = (data[fs].astype(np.uint32) << 8) | data[fs + 1].astype(np.uint32)
    ty = data[fs + 2]
    for tgt, out in ((ord("N") << 8 | ord("M"), nm),
                     (ord("N") << 8 | ord("H"), nh)):
        for tch, dt_ in _BAUX_INT_TYPES.items():
            sel = np.nonzero((tag2 == tgt) & (ty == tch))[0]
            if sel.shape[0] == 0:
                continue
            w = np.dtype(dt_).itemsize
            v = np.zeros(sel.shape[0], np.int64)
            for b in range(w):
                v |= data[fs[sel] + 3 + b].astype(np.int64) << (8 * b)
            out[fr[sel]] = v.astype(np.int64) if dt_().dtype.kind == "u" \
                else v.astype(dt_).astype(np.int64)
    def _ztag(t2):
        s = np.nonzero((tag2 == t2) & (ty == ord("Z")))[0]
        if s.shape[0] == 0:
            return None
        v = ragged.gather_ranges(data, fs[s] + 3,
                                 np.maximum(fv[s] - 1, 0))  # sans NUL
        lens = np.zeros(n, np.int64)
        lens[fr[s]] = v.lens
        return Col(v.data, np.concatenate([[0], np.cumsum(lens)]))

    c = _ztag(ord("S") << 8 | ord("A"))
    if c is not None:
        sa = c
    for tag in SOLO_TAGS:
        c = _ztag(tag[0] << 8 | tag[1])
        if c is not None:
            solo[tag] = c
    return nm, nh, sa, solo


def _sam_lines(data: np.ndarray):
    nl = np.nonzero(data == ord("\n"))[0]
    if data.shape[0] and (nl.shape[0] == 0 or nl[-1] != data.shape[0] - 1):
        nl = np.concatenate([nl, [data.shape[0]]])
    starts = np.concatenate([[0], nl[:-1] + 1])
    return ragged.gather_ranges(data, starts, nl - starts)


class SagStore:
    """Primary alignments parsed from the PRIM component text. Built with
    the same code at ZIP and PIZ, so store row indices are symmetric.

    In-memory compaction (the reference's huffman.c role for the SAG
    store, src/sam_sag_ingest.c:105-310: SEQ 2-bit + huffman'd QUAL):
    SEQ is held 2-bit-packed with a non-ACGT exception channel and QUAL
    palette-bit-packed (typical binned QUAL has <=16 symbols -> 2-4 bits),
    both materialized per requested row only — a fixed-width bit-pack is
    random-access, which is exactly why this build uses it where the
    byte-serial reference uses canonical huffman. The qname->row index is
    a sorted-hash join (vectorized), with byte verification so a hash
    collision degrades to a miss (ratio), never a wrong match."""

    def __init__(self, qname: Col, flag: np.ndarray, seq: Col, qual: Col,
                 rname: Col | None = None, pos: np.ndarray | None = None,
                 mapq: np.ndarray | None = None, cigar: Col | None = None,
                 nm: np.ndarray | None = None):
        from .ops import pack as packops
        self.qname, self.flag = qname, flag
        # SAG_BY_SA flavor columns (reference src/sam_sag.c SA-type groups):
        # the primary's coordinates compose its SA entry
        # "rname,pos,strand,cigar,mapq,nm" so a DEPN row's SA:Z prefix is
        # predictable from the store alone (PIZ rebuilds the same store)
        self.rname, self.pos, self.mapq = rname, pos, mapq
        self.cigar, self.nm = cigar, nm
        self.seq_offsets = seq.offsets
        self.seq_packed, self.seq_exc_pos, self.seq_exc_bytes = \
            packops.seq_pack_2bit(seq.data)
        self.qual_offsets = qual.offsets
        pal = np.unique(qual.data) if qual.data.shape[0] else \
            np.zeros(0, np.uint8)
        width = next((w for w in (1, 2, 4) if pal.shape[0] <= (1 << w)),
                     None)
        if width is not None and pal.shape[0]:
            lut = np.zeros(256, np.uint8)
            lut[pal] = np.arange(pal.shape[0], dtype=np.uint8)
            self.qual_packed = packops.pack_np(lut[qual.data], width)
            self.qual_pal, self.qual_width = pal, width
        else:
            self.qual_packed, self.qual_pal, self.qual_width = \
                qual.data, None, 8
        # SAG_BY_SOLO (sections.h:32, sam_sag_zip.c:877 solo_data):
        # barcode-family tag values of each primary, so DEPN rows elide
        # them by store copy. Filled by from_text/from_bam.
        self.solo = {}
        # SA-first-entry prediction columns (filled by _parse_sa_first)
        n0 = len(qname)
        self.sa1_valid = np.zeros(n0, bool)
        self.sa1_rname = self.sa1_cigar = None
        self.sa1_pos = self.sa1_mapq = None
        self.sa1_rev = None
        # sorted (hash ^ mate-bits) join index; ties keep the lowest row
        n = len(qname)
        key = qname_hash(qname) + (flag.astype(np.uint64) & MATE_BITS)
        order = np.lexsort((np.arange(n), key))
        self._skeys = key[order]
        self._sorder = order

    @classmethod
    def from_text(cls, data: np.ndarray):
        lines = _sam_lines(data)
        cols, aux, good, bad = ragged.split_first_fields(lines, ord("\t"), 11)
        assert bad.shape[0] == 0, "PRIM component has malformed lines"
        flags, _ = ragged.atoi(cols[1])
        pos, _ = ragged.atoi(cols[3])
        mapq, _ = ragged.atoi(cols[4])
        nm = tag_int(aux, b"NM:i:")
        store = cls(cols[0], flags, cols[9], cols[10], rname=cols[2],
                    pos=pos, mapq=mapq, cigar=cols[5], nm=nm)
        # SAG_BY_NH flavor (reference sections.h:32-38): multimapper groups
        # share the primary's NH:i — keep it for DEPN prediction
        store.nh = tag_int(aux, b"NH:i:")
        store._parse_sa_first(tag_str(aux, b"SA:Z:"))
        for tag in SOLO_TAGS:
            c = tag_str(aux, tag + b":Z:")
            if c.data.shape[0]:
                store.solo[tag] = c
        return store

    @classmethod
    def from_bam(cls, data: np.ndarray, refs=None):
        """Build the store from binary PRIM records (the BAM side of
        src/sam_sag_ingest.c). Columns are normalized to the domain the
        predictors compare against: SEQ as ASCII letters (nibble-expanded),
        POS 1-based, RNAME/CIGAR as text; QUAL stays raw phred — the DEPN
        rows it predicts are raw phred too. Built identically at ZIP and
        PIZ from the PRIM component bytes."""
        from .datatypes.bam import BamDT, _u16, _u32, _i32, bam_scan
        bd = BamDT(segconf={"bam_refs": list(refs or [])})
        off, consumed = bam_scan(data, data.shape[0] // 36 + 1)
        assert consumed == data.shape[0], "PRIM component has partial records"
        refid = _i32(data, off + 4)
        pos0 = _i32(data, off + 8)
        l_rn = data[off + 12].astype(np.int64)
        mapq = data[off + 13].astype(np.int64)
        n_cig = _u16(data, off + 16).astype(np.int64)
        flag = _u16(data, off + 18).astype(np.int64)
        l_seq = _u32(data, off + 20).astype(np.int64)
        block_size = _u32(data, off).astype(np.int64)
        name_start = off + 36
        cig_start = name_start + l_rn
        seq_start = cig_start + 4 * n_cig
        seq_bytes = (l_seq + 1) // 2
        qual_start = seq_start + seq_bytes
        aux_start = qual_start + l_seq
        rec_end = off + 4 + block_size
        name = ragged.gather_ranges(data, name_start, l_rn - 1)
        cigar_bin = ragged.gather_ranges(data, cig_start, 4 * n_cig)
        seq_nib = ragged.gather_ranges(data, seq_start, seq_bytes)
        qual = ragged.gather_ranges(data, qual_start, l_seq)
        aux = ragged.gather_ranges(data, aux_start, rec_end - aux_start)
        seq_ascii, _nibok = bd._seq_ascii(seq_nib, l_seq)
        nm, nh, sa, solo = _bam_aux_tags(bd, aux)
        store = cls(name, flag, seq_ascii, qual,
                    rname=bd._rname_text(refid), pos=pos0 + 1, mapq=mapq,
                    cigar=bd._cigar_text(cigar_bin, n_cig), nm=nm)
        store.nh = nh
        store._parse_sa_first(sa)
        store.solo = solo
        return store

    def _parse_sa_first(self, sa: Col):
        """First SA:Z entry of each primary, split into columns — it
        describes the primary's (first) supplementary, so a DEPN row's
        RNAME/POS/MAPQ/CIGAR are predictable from its primary's store row
        (reference src/sam_sag_zip.c SA-group loading, sections.h:32)."""
        n = len(sa)
        self.sa1_valid = np.zeros(n, bool)
        if sa.data.shape[0] == 0:
            return
        # first entry = text up to the first ';'
        semis = np.nonzero(sa.data == ord(";"))[0]
        ent_len = sa.lens.copy()
        if semis.shape[0]:
            srow = np.searchsorted(sa.offsets[1:], semis, side="right")
            sfirst = np.ones(semis.shape[0], bool)
            sfirst[1:] = srow[1:] != srow[:-1]
            semis, srow = semis[sfirst], srow[sfirst]
            ent_len[srow] = semis - sa.offsets[:-1][srow]
        ent = ragged.gather_ranges(sa.data, sa.offsets[:-1], ent_len)
        ncom = ragged.count_sep_per_row(ent, ord(","))
        ok = (ncom == 5) & (ent.lens > 0)
        rows = np.nonzero(ok)[0]
        if rows.shape[0] == 0:
            return
        sub = ragged.take(ent, rows)
        f, _rest, good, _bad = ragged.split_first_fields(sub, ord(","), 6)
        if good.shape[0] != len(sub):
            ok2 = np.zeros(len(sub), bool)
            ok2[good] = True
            rows = rows[ok2]
            sub = ragged.take(sub, np.nonzero(ok2)[0])
            f, _rest, good, _bad = ragged.split_first_fields(sub, ord(","), 6)
        p_, pok = ragged.atoi(f[1])
        m_, mok = ragged.atoi(f[4])
        fok = pok & mok & (f[2].lens == 1)
        frows = np.nonzero(fok)[0]
        rows = rows[frows]
        self.sa1_valid[rows] = True
        zc = Col(np.zeros(0, np.uint8), np.zeros(n + 1, np.int64))
        self.sa1_rname = ragged.merge_rows(
            n, [(rows, ragged.take(f[0], frows))]) if rows.shape[0] else zc
        self.sa1_cigar = ragged.merge_rows(
            n, [(rows, ragged.take(f[3], frows))]) if rows.shape[0] else zc
        self.sa1_pos = np.zeros(n, np.int64)
        self.sa1_pos[rows] = p_[frows]
        self.sa1_mapq = np.zeros(n, np.int64)
        self.sa1_mapq[rows] = m_[frows]
        self.sa1_rev = np.zeros(n, bool)
        st = f[2]
        self.sa1_rev[rows] = (st.data[st.offsets[:-1]] == ord("-"))[frows]

    def sa_entries(self, idx: np.ndarray) -> Col:
        """Composed SA entry 'rname,pos,strand,cigar,mapq,nm;' of the
        primaries at store rows idx (reference sam_sag.c: a DEPN's SA:Z
        leads with its primary's entry)."""
        strand = np.where(self.flag[idx] & FLAG_REV, ord("-"),
                          ord("+")).astype(np.uint8)
        strand_col = Col(strand, np.arange(idx.shape[0] + 1, dtype=np.int64))
        return ragged.interleave(
            [ragged.take(self.rname, idx), ragged.itoa(self.pos[idx]),
             strand_col, ragged.take(self.cigar, idx),
             ragged.itoa(self.mapq[idx]), ragged.itoa(self.nm[idx])],
            sep_after=[b",", b",", b",", b",", b",", b";"])

    def _seq_flat(self) -> np.ndarray:
        """Whole-store SEQ as ASCII, unpacked ONCE and cached — per-batch
        random access then rides one ranged gather instead of per-byte
        index math. The
        2-bit + exception layout stays the at-rest representation."""
        c = getattr(self, "_seq_flat_c", None)
        if c is None:
            from .ops import pack as packops
            total = int(self.seq_offsets[-1])
            c = packops.seq_unpack_2bit(self.seq_packed, total,
                                        self.seq_exc_pos,
                                        self.seq_exc_bytes)
            self._seq_flat_c = c
        return c

    def _qual_flat(self) -> np.ndarray:
        c = getattr(self, "_qual_flat_c", None)
        if c is None:
            if self.qual_pal is None:
                c = self.qual_packed
            else:
                from .ops import pack as packops
                total = int(self.qual_offsets[-1])
                c = self.qual_pal[packops.unpack_np(self.qual_packed,
                                                    self.qual_width, total)]
            self._qual_flat_c = c
        return c

    def seq_rows(self, idx: np.ndarray) -> Col:
        """Materialize SEQ for the requested rows (a ranged gather over
        the lazily-unpacked flat store)."""
        off = self.seq_offsets
        return ragged.gather_ranges(self._seq_flat(), off[:-1][idx],
                                    off[1:][idx] - off[:-1][idx])

    def qual_rows(self, idx: np.ndarray) -> Col:
        off = self.qual_offsets
        return ragged.gather_ranges(self._qual_flat(), off[:-1][idx],
                                    off[1:][idx] - off[:-1][idx])

    def lookup(self, qname: Col, flag: np.ndarray) -> np.ndarray:
        from .utils.ragged import cols_equal_rows
        n = len(qname)
        if n == 0 or self._skeys.shape[0] == 0:
            return np.full(n, -1, np.int64)
        key = qname_hash(qname) + (flag.astype(np.uint64) & MATE_BITS)
        at = np.searchsorted(self._skeys, key, side="left")
        ok = at < self._skeys.shape[0]
        cand = self._sorder[np.minimum(at, self._skeys.shape[0] - 1)]
        ok &= self._skeys[np.minimum(at, self._skeys.shape[0] - 1)] == key
        # verify bytes + mate bits (collision -> miss, never a wrong match)
        ok &= cols_equal_rows(qname, ragged.take(self.qname, cand))
        ok &= (self.flag[cand] & MATE_BITS) == (flag & MATE_BITS)
        return np.where(ok, cand, -1).astype(np.int64)


def leading_hardclip(cigar: Col) -> np.ndarray:
    """Per-row leading hard-clip length (e.g. '75H25M' -> 75), 0 if none."""
    n = len(cigar)
    mat, lens = ragged.to_matrix(cigar)
    w = mat.shape[1]
    isd = (mat >= ord("0")) & (mat <= ord("9"))
    # first non-digit column per row
    nd = ~isd & (np.arange(w)[None, :] < lens[:, None])
    first_nd = np.where(nd.any(axis=1), nd.argmax(axis=1), 0)
    is_h = mat[ragged.arange(n), first_nd] == ord("H")
    v = np.zeros(n, np.int64)
    for j in range(w):
        active = (j < first_nd) & is_h
        v = np.where(active, v * 10 + (mat[:, j].astype(np.int64) - ord("0")),
                     v)
    return np.where(is_h, v, 0)


_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTNacgtn", b"TGCANtgcan"):
    _COMP[_a] = _b
for _c in range(256):
    if _COMP[_c] == 0:
        _COMP[_c] = _c


def predict_depn(store: SagStore, sag_idx: np.ndarray, depn_flag: np.ndarray,
                 cigar: Col, lens: np.ndarray):
    """Predicted (seq Col, qual Col, valid mask) per DEPN row with
    sag_idx >= 0: slice the primary's SEQ/QUAL by orientation + the DEPN's
    leading hard-clip. Rows where the slice doesn't fit get valid=False."""
    hit = sag_idx >= 0
    rows = np.nonzero(hit)[0]
    n = lens.shape[0]
    valid = np.zeros(n, bool)
    if rows.shape[0] == 0:
        empty = Col(np.zeros(0, np.uint8), np.zeros(n + 1, np.int64))
        return empty, empty, valid
    idx = sag_idx[rows]
    p_seq = store.seq_rows(idx)
    p_qual = store.qual_rows(idx)
    differ = ((store.flag[idx] & FLAG_REV) !=
              (depn_flag[rows] & FLAG_REV))
    h1 = leading_hardclip(cigar)[rows]
    ld = lens[rows]
    fits = (h1 >= 0) & (h1 + ld <= p_seq.lens) & (p_seq.lens == p_qual.lens)
    valid[rows] = fits

    pm, plens = ragged.to_matrix(p_seq)
    qm, _ = ragged.to_matrix(p_qual)
    W = max(pm.shape[1], 1)
    # orient: revcomp seq / reverse qual where flags differ
    rev_idx = np.clip(plens[:, None] - 1 - np.arange(W)[None, :], 0, W - 1)
    pm = np.where(differ[:, None], _COMP[np.take_along_axis(pm, rev_idx, axis=1)], pm)
    qm = np.where(differ[:, None], np.take_along_axis(qm, rev_idx, axis=1), qm)
    # slice [h1 : h1+ld]
    out_lens = np.where(fits, ld, 0)
    Wout = max(int(out_lens.max()), 1)
    sidx = np.clip(h1[:, None] + np.arange(Wout)[None, :], 0, W - 1)
    sm = np.take_along_axis(pm, sidx, axis=1)
    sq = np.take_along_axis(qm, sidx, axis=1)
    seq_sub = ragged.from_matrix(sm, out_lens)
    qual_sub = ragged.from_matrix(sq, out_lens)
    # expand to n rows (uncovered rows are zero-length)
    seq_full = ragged.merge_rows(n, [(rows, seq_sub)])
    qual_full = ragged.merge_rows(n, [(rows, qual_sub)])
    return seq_full, qual_full, valid
