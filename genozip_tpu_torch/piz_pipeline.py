"""PIZ pipeline: reconstruct the file(s) of a GXZ archive, of any datatype.

Counterpart of genozip_tpu/piz_pipeline.py: read the global area (dicts)
once, then per VB read and uncompress the context sections, reconstruct with
the datatype plugin and verify the VB digest; each component's digest is
checked at the end. A VB's RANS0 and RANS1 sections of the device size decode
in one launch per order, whatever their number. Archives made with
--reference take the genome from --reference or, when the archive stores the
ranges it used (--REFERENCE), from the archive; SAM/BAM archives made
without one carry their denovo genome (REF_INTERNAL). Paired (R2)
components resolve "pair-identical" sections from the R1 component and add
R1 GPOS back to delta-coded R2 GPOS (reference src/piz.c:450-544). SAM/BAM
gencomp archives reconstruct their PRIM and DEPN components first and
re-interleave their lines into the MAIN VBs, in VB order
(src/gencomp_piz.c). A .bam/.gz output is BGZF, byte-exact where the
archive recorded the input's blocks and zlib level (src/mgzip.c). A --deep
archive (a BAM and the FASTQs it came from) reconstructs its BAM component
first, feeding the deep index in VB order; its FASTQ components take the
SEQ and QUAL of their matching reads from that index (src/fastq_deep.c).

Reference parity: src/piz.c:880 piz_one_txt_file / :381 piz_reconstruct_one_vb.
"""

import contextlib
import hashlib
import os
import threading
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import codecs, crypt, native
from .contexts import PCtx, parse_dict_payload
from .datatypes import get
from .deep import DeepIndex
from .format import sections as fmt
from .ops import pack as packops
from .ref.refstore import RefGenome, load_ref_file
from .utils import profiler, ragged
from .utils.bgzf import ExactBgzfWriter, MgzipExactWriter, open_bgzf
from .utils.ragged import Col


def _not_ported(what):
    return NotImplementedError(f"{what}: not yet ported to genozip_tpu_torch")


def _stored_ref(payload: bytes) -> RefGenome:
    """The genome an archive stores (REF_EXT_STORE under --REFERENCE, or
    REF_INTERNAL's denovo genome): contigs json, (start, len) ranges, 2-bit
    codes per range; bases outside them are 0. REF_INTERNAL archives of
    the round-4 format hold the whole genome instead of ranges."""
    ml = int.from_bytes(payload[0:4], "little")
    meta = fmt.json_parse(payload[4:4 + ml])
    off = 4 + ml
    if "ranges" in meta:
        codes = np.zeros(meta["length"], np.uint8)
        for s, l in meta["ranges"]:
            nb = (l + 3) // 4
            codes[s:s + l] = packops.unpack_np(
                np.frombuffer(payload[off:off + nb], np.uint8), 2, l)
            off += nb
    else:   # legacy whole-genome layout
        pl = int.from_bytes(payload[off:off + 8], "little")
        off += 8
        codes = packops.unpack_np(
            np.frombuffer(payload[off:off + pl], np.uint8), 2, meta["length"])
    return RefGenome(codes, meta["contigs"])


class PizReader:
    """An open archive. `reference` is the .ref.gxz to reconstruct against;
    it is needed only when the archive was made with --reference and stores
    no genome ranges, and only once a VB is reconstructed. `password` opens
    an encrypted archive: its sections decrypt as they are read."""

    def __init__(self, z_path: str, reference: str | None = None,
                 password: str | None = None):
        self.f = open(z_path, "rb")
        try:
            self._open(reference, password)
        except BaseException:
            self.f.close()
            raise

    def _open(self, reference, password):
        self.zr = fmt.ZReader(self.f)
        payload, _ = self.zr.read_one(fmt.SEC_FILE_HEADER)
        if payload is None:
            raise ValueError("missing file header")
        self.file_hdr = h = fmt.json_parse(payload)
        enc = h.get("enc")
        if enc:
            if not password:
                raise ValueError("archive is encrypted — --password required")
            salt = bytes.fromhex(enc["salt"])
            key = crypt.derive_key(password, salt)
            if crypt.key_tag(key) != enc["tag"]:
                raise ValueError("wrong password")
            self.zr.set_encryption(key, salt)
        if h.get("components") and not (h.get("pair") or h.get("deep")):
            raise _not_ported("multi-component archive")
        ref = None
        if h.get("ref_internal"):
            ref = _stored_ref(self.zr.read_one(fmt.SEC_REFERENCE)[0])
        if h.get("ref_stored") and not reference:
            ref = _stored_ref(self.zr.read_one(fmt.SEC_REFERENCE)[0])
        elif reference:
            with profiler.timer("ref:load"):
                ref = load_ref_file(reference)
        segconf = h.get("segconf") or {}
        self.dts = []
        for comp in self.components():
            cdt = get(comp.get("dt", h["dt"]))(comp.get("segconf") or segconf)
            cdt.ref = ref
            cdt.missing_ref = h.get("reference") if ref is None else None
            self.dts.append(cdt)
        self.dt = self.dts[0]
        # deep: the BAM component (0) feeds the index the FASTQ components
        # look their reads up in
        self.deep_index = None
        if h.get("deep"):
            self.deep_index = DeepIndex()
            for d in self.dts[1:]:
                d.deep_index = self.deep_index
        # the PRIM and DEPN components reconstruct on an instance of their
        # own, which holds the SAG store (reference src/sam_sag_load.c)
        self.gc_dt = None
        if h.get("gencomp"):
            self.gc_dt = get(h["dt"])(segconf)
            self.gc_dt.ref = ref
            self.gc_dt.missing_ref = self.dt.missing_ref
        self._gc_loaded = False
        self._gc_prim = self._gc_depn = None
        self.io_lock = threading.Lock()
        self._dec_lock = threading.Lock()
        self._decoding = 0      # VB decodes running (`_uncompressing`)
        self.dicts = {}
        for ent in self.zr.sections(fmt.SEC_DICT):
            payload, meta = self.zr.read_section(ent)
            name = ent.dict_id.rstrip(b"\0").decode()
            self.dicts[name] = parse_dict_payload(payload)

    def _dict(self, name):
        d = self.dicts.get(name)
        if d is None:
            d = self.dicts[name] = Col.from_list([])  # ctx with zero words
        return d

    def txt_header(self, comp_i: int = 0) -> bytes:
        payload, _ = self.zr.read_one(fmt.SEC_TXT_HEADER, comp_i=comp_i)
        if payload is None:
            payload, _ = self.zr.read_one(fmt.SEC_TXT_HEADER)
        return payload or b""

    def num_vbs(self) -> int:
        return self.file_hdr["num_vbs"]

    def components(self):
        """One entry per component (two for a paired archive): name,
        txt_len, adler, num_lines."""
        h = self.file_hdr
        return h.get("components") or [
            {"name": h.get("txt_name"), "txt_len": h["txt_len"],
             "adler": h["adler"], "num_lines": h["num_lines"]}]

    def comp_num_vbs(self, comp_i: int) -> int:
        comps = self.components()
        if comp_i < len(comps):
            return comps[comp_i].get("num_vbs", self.num_vbs())
        return self.num_vbs()

    def _read_ctx_raws(self, vb_i, comp_i=0, names=None):
        """The stored bytes of a VB's B250/LOCAL sections (only `names`,
        when given): [(ent, name, (header fields, payload))]. The caller
        holds io_lock."""
        raws = []
        for ent in self.zr.sections(vb_i=vb_i, comp_i=comp_i):
            if ent.sec_type not in (fmt.SEC_B250, fmt.SEC_LOCAL):
                continue
            name = ent.dict_id.rstrip(b"\0").decode()
            if names is not None and name not in names:
                continue
            raws.append((ent, name, self.zr.read_section_bytes(ent)))
        return raws

    def _uncompress_ctx_sections(self, raws):
        """Check, decrypt and uncompress what `_read_ctx_raws` read, with
        no lock held. Returns {name: {'b250': arr, 'local': (arr, ltype)}}.
        RANS0/RANS1 sections of the device size decode in one launch per
        order."""
        raws = [(ent, name, *self.zr.check_section(ent, *stored))
                for ent, name, stored in raws]
        payloads = {}
        bmin = codecs.device_batch_min()
        if bmin:
            groups = {}
            for i, (ent, name, comp, meta) in enumerate(raws):
                if meta["codec"] in (codecs.RANS0, codecs.RANS1) and \
                        meta["uncomp_len"] >= bmin and len(comp) > 6 and \
                        comp[1] in (0, 1):
                    groups.setdefault(comp[1], []).append(i)
            for idxs in groups.values():
                outs = codecs.decompress_many_rans([raws[i][2] for i in idxs])
                for i, o in zip(idxs, outs):
                    payloads[i] = o[: raws[i][3]["uncomp_len"]]
        out = {}
        for i, (ent, name, comp, meta) in enumerate(raws):
            payload = payloads.get(i)
            if payload is None:
                payload = codecs.decompress(comp, meta["codec"],
                                            meta["uncomp_len"])
            d = out.setdefault(name, {})
            if ent.sec_type == fmt.SEC_B250:
                d["b250"] = np.frombuffer(
                    payload, fmt.lt_dtype(meta["ltype"])).astype(np.int64)
            else:
                d["local"] = (np.frombuffer(payload, fmt.lt_dtype(meta["ltype"])),
                              meta["ltype"])
        return out

    def _load_ctx_sections(self, vb_i, comp_i=0, names=None):
        """Read and uncompress a VB's B250/LOCAL sections; the caller holds
        io_lock."""
        return self._uncompress_ctx_sections(
            self._read_ctx_raws(vb_i, comp_i, names))

    @contextlib.contextmanager
    def _io(self):
        """self.io_lock held for the block; the wait for it is span
        `piz:io-wait`."""
        with profiler.timer("piz:io-wait"):
            self.io_lock.acquire()
        try:
            yield
        finally:
            self.io_lock.release()

    @contextlib.contextmanager
    def _uncompressing(self):
        """One VB's decode: counts `piz:uncompress.vbs`, and
        `piz:uncompress.overlapped` when another VB's decode is running."""
        with self._dec_lock:
            overlapped = self._decoding > 0
            self._decoding += 1
        profiler.count("piz:uncompress.vbs")
        if overlapped:
            profiler.count("piz:uncompress.overlapped")
        try:
            yield
        finally:
            with self._dec_lock:
                self._decoding -= 1

    def _vb_header_ent(self, vb_i: int, comp_i: int):
        ents = self.zr.sections(fmt.SEC_VB_HEADER, vb_i, comp_i)
        if not ents and comp_i == 0:
            ents = self.zr.sections(fmt.SEC_VB_HEADER, vb_i)
        if not ents:
            raise ValueError(f"VB {vb_i} of component {comp_i} missing")
        return ents[0]

    def load_vb(self, vb_i: int, comp_i: int = 0):
        """Read and uncompress VB `vb_i`, thread-safe. io_lock guards the
        file position, the one state that threads share: it is held only
        while the archive's bytes are read (span `piz:read`), and the
        digest checks, decryption and decoding run after it, concurrently
        across threads. An R2 VB also loads the R1 sections it copies, read
        in a second hold once its header is decoded."""
        hent = self._vb_header_ent(vb_i, comp_i)
        with contextlib.ExitStack() as held:
            held.enter_context(self._io())
            with profiler.timer("piz:read+uncompress"):
                with profiler.timer("piz:read"):
                    hdr_stored = self.zr.read_section_bytes(hent)
                    raws = self._read_ctx_raws(vb_i, comp_i)
                held.close()        # io_lock released
                with self._uncompressing():
                    comp, meta = self.zr.check_section(hent, *hdr_stored)
                    vb_hdr = fmt.vbhdr_parse(codecs.decompress(
                        comp, meta["codec"], meta["uncomp_len"]))
                    pair_names = [n for n, cm in vb_hdr["ctxs"].items()
                                  if "pair" in cm]
                    pair_raws = []
                    if pair_names:
                        with self._io(), profiler.timer("piz:read"):
                            pair_raws = self._read_ctx_raws(vb_i, 0,
                                                            pair_names)
                    sec = self._uncompress_ctx_sections(raws)
                    pair_sec = self._uncompress_ctx_sections(pair_raws)
        return vb_hdr, sec, pair_sec

    def read_vb(self, vb_i: int, comp_i: int = 0) -> bytes:
        """VB `vb_i` of component `comp_i`; a MAIN VB of a gencomp archive
        comes back with its deported lines re-interleaved, so MAIN VBs must
        be read (or drained) in order."""
        return next(self.vbs_in_order([vb_i], comp_i))

    def vbs_in_order(self, vb_ids, comp_i: int = 0, workers: int = 1,
                     window: int | None = None, with_adler: bool = False):
        """The VBs `vb_ids` of component `comp_i`, one at a time, in order;
        with `with_adler`, (bytes, their adler32) pairs. `workers` threads
        load and reconstruct up to `window` (default: `workers`) VBs ahead;
        a MAIN VB of a gencomp archive gets its deported lines back on the
        consuming thread, when it is taken, so a caller may drain skipped
        VBs (drain_vb_gencomp) between two takes. Each VB loads and
        reconstructs under its VB's context (`utils/profiler.vb`)."""
        gc = comp_i == 0 and self.ensure_gencomp()

        def work(vb_i):
            with profiler.vb(comp_i, vb_i):
                loaded = self.load_vb(vb_i, comp_i)
                out, pctxs = self.recon_loaded_vb(loaded, vb_i, comp_i,
                                                  want_pctxs=True)
            # recon_loaded_vb checked that the header's adler32 is out's
            return out, pctxs, loaded[0]["adler"]

        def merged(vb_i, res):
            out, pctxs, adler = res
            if gc:
                with profiler.vb(comp_i, vb_i), profiler.timer("piz:drain"):
                    out = self.merge_vb_gencomp(out, pctxs)
                    adler = zlib.adler32(out) if with_adler else None
            return (out, adler) if with_adler else out

        if workers <= 1:
            for vb_i in vb_ids:
                yield merged(vb_i, work(vb_i))
            return
        window = window or workers
        with ThreadPoolExecutor(max_workers=workers) as pool:
            inflight = deque()
            for vb_i in vb_ids:
                inflight.append((vb_i, pool.submit(profiler.bind(work),
                                                   vb_i)))
                if len(inflight) > window:
                    vb_j, fut = inflight.popleft()
                    yield merged(vb_j, fut.result())
            while inflight:
                vb_j, fut = inflight.popleft()
                yield merged(vb_j, fut.result())

    def ensure_gencomp(self) -> bool:
        """Load the PRIM/DEPN record queues and the SAG store, once, if the
        archive has gencomp components. Every MAIN-component consumer
        calls it before reconstructing MAIN VBs."""
        if self._gc_loaded:
            return self._gc_depn is not None
        self._gc_loaded = True
        gc = self.file_hdr.get("gencomp")
        if not gc:
            return False
        with profiler.timer("piz:gencomp-load"):
            prim = self._read_component(1, gc.get("prim_vbs", 0))
            self._gc_prim = _GcQueue(prim, self.gc_dt)
            if prim.shape[0]:
                # SAG store before DEPN recon (reference sam_sag_load.c)
                self.gc_dt.sag_store = self.gc_dt.build_sag_store(prim)
            self._gc_depn = _GcQueue(
                self._read_component(2, gc.get("depn_vbs", 0)), self.gc_dt)
        return True

    def _read_component(self, comp_i: int, nvbs: int) -> np.ndarray:
        txt = b"".join(
            self.recon_loaded_vb(self.load_vb(vb_i, comp_i), vb_i, comp_i)
            for vb_i in range(1, nvbs + 1))
        return np.frombuffer(txt, np.uint8)

    def merge_vb_gencomp(self, out: bytes, pctxs: dict) -> bytes:
        """Re-interleave a reconstructed MAIN VB's deported lines, at the
        positions its GPPOS/GCPOS contexts hold (vectorized ragged merge).
        Call in MAIN-VB order: the queues are consumed front to back."""
        e = np.zeros(0, np.int64)
        pp = pctxs.get("GPPOS")
        dp = pctxs.get("GCPOS")
        if pp is None and dp is None:
            return out
        prim_pos = pp.nums() if pp is not None else e
        depn_pos = dp.nums() if dp is not None else e
        main_col = self.dt.split_records(np.frombuffer(out, np.uint8))
        n_main = len(main_col)
        total = n_main + prim_pos.shape[0] + depn_pos.shape[0]
        deported = np.zeros(total, bool)
        deported[prim_pos] = True
        deported[depn_pos] = True
        main_idx = np.nonzero(~deported)[0]
        if main_idx.shape[0] != n_main:
            raise ValueError("gencomp plan mismatch")
        parts = [(main_idx, main_col)]
        if prim_pos.shape[0]:
            parts.append((prim_pos, self._gc_prim.take(prim_pos.shape[0])))
        if depn_pos.shape[0]:
            parts.append((depn_pos, self._gc_depn.take(depn_pos.shape[0])))
        return ragged.merge_rows(total, parts).data.tobytes()

    def gencomp_counts(self, vb_i: int):
        """(deported PRIM lines, deported DEPN lines) of MAIN VB `vb_i`."""
        with self._io():
            sec = self._load_ctx_sections(vb_i, 0, ["GPPOS", "GCPOS"])
        return tuple(
            0 if sec.get(nm, {}).get("local") is None
            else sec[nm]["local"][0].shape[0] for nm in ("GPPOS", "GCPOS"))

    def drain_vb_gencomp(self, vb_i: int):
        """Consume a skipped MAIN VB's share of the PRIM/DEPN queues without
        reconstructing it."""
        k_prim, k_depn = self.gencomp_counts(vb_i)
        self._gc_prim.skip(k_prim)
        self._gc_depn.skip(k_depn)

    def recon_loaded_vb(self, loaded, vb_i: int, comp_i: int = 0,
                        want_pctxs: bool = False):
        """Reconstruct one loaded VB: its bytes, and with `want_pctxs` also
        its contexts."""
        vb_hdr, sec, pair_sec = loaded
        pctxs = {}
        for name, cm in vb_hdr["ctxs"].items():
            pc = PCtx(name, cm["mode"], param=cm.get("param", 0),
                      special=cm.get("special"))
            src = sec.get(name, {})
            pair = cm.get("pair")
            if pair == "copy_b250":
                src = {**src, "b250": pair_sec.get(name, {}).get("b250")}
            elif pair == "copy_local":
                src = {**src, "local": pair_sec.get(name, {}).get("local")}
            if cm.get("same") is not None:
                val, cnt = cm["same"]
                pc.b250 = np.full(cnt, val, dtype=np.int64)
                pc.dict_col = self._dict(name)
            elif src.get("b250") is not None:
                pc.b250 = src["b250"]
                pc.dict_col = self._dict(name)
            if src.get("local") is not None:
                pc.local, pc.ltype = src["local"]
            pctxs[name] = pc
        meta = dict(vb_hdr["meta"])
        meta["num_lines"] = vb_hdr["n"]
        if meta.get("gpos_pair_delta") and comp_i == 1:
            self._apply_gpos_pair_delta(pctxs, vb_i)
        dt = self.dts[comp_i] if comp_i < len(self.dts) else self.gc_dt
        with profiler.timer("piz:recon"):
            out = dt.recon_vb(pctxs, meta)
        if len(out) != vb_hdr["len"]:
            raise ValueError(f"VB {vb_i}: length {len(out)} != {vb_hdr['len']}")
        # archives written by genozip_tpu with its C++ host runtime also
        # carry an xxh64 digest ("x64"), checked too; the adler32 one is
        # always there
        if zlib.adler32(out) != vb_hdr["adler"]:
            raise ValueError(f"VB {vb_i}: digest mismatch")
        if vb_hdr.get("x64") is not None and \
                native.xxh64(out) != vb_hdr["x64"]:
            raise ValueError(f"VB {vb_i}: xxh64 digest mismatch")
        return (out, pctxs) if want_pctxs else out

    def _apply_gpos_pair_delta(self, pctxs, vb_i):
        """R2 GPOS was stored as a delta against R1's GPOS for reads aligned
        in both (reference fastq_seg_gpos_R2, fastq_seq.c:187)."""
        with self._io():
            r1 = self._load_ctx_sections(vb_i, 0, ["SQBITMAP", "GPOS"])
        a1 = r1["SQBITMAP"]["local"][0].astype(bool)
        g1 = np.zeros(a1.shape[0], np.int64)
        g1[a1] = r1["GPOS"]["local"][0].astype(np.int64)
        a2 = pctxs["SQBITMAP"].nums().astype(bool)
        both = a2 & a1
        g2 = pctxs["GPOS"].local.astype(np.int64)
        pctxs["GPOS"].local = np.where(both[a2], g2 + g1[a2], g2)
        pctxs["GPOS"].param = 0

    def close(self):
        self.f.close()


class _GcQueue:
    """Sequential record queue over a gencomp component's bytes (one
    record-boundary scan through the datatype's framing: newlines for SAM,
    the block_size chain for BAM)."""

    def __init__(self, data: np.ndarray, dt):
        self.col = dt.split_records(data)
        self.cursor = 0

    def take(self, k: int) -> Col:
        sub = ragged.take(self.col, np.arange(self.cursor, self.cursor + k))
        self.cursor += k
        return sub

    def skip(self, k: int):
        self.cursor += k


def piz_file(z_path: str, out_path: str | None = None,
             reference: str | None = None, password: str | None = None) -> int:
    """Reconstruct the archive's file into `out_path` (None: verify only);
    the components of a paired or deep archive go to `out_path`.1,
    `out_path`.2, ...; `password` opens an encrypted archive. Returns the
    bytes reconstructed. The call is span `piz:file`, the root of the
    file's spans (its own file id, `utils/profiler.file`)."""
    with profiler.file(), profiler.timer("piz:file"):
        with profiler.timer("piz:open"):
            pr = PizReader(z_path, reference, password)
        return _piz_all(pr, out_path)


def _piz_all(pr, out_path):
    try:
        comps = pr.components()
        total = 0
        for comp_i in range(len(comps)):
            path = out_path
            if out_path and len(comps) > 1:
                path = f"{out_path}.{comp_i + 1}"
            total += _piz(pr, comp_i, path)
        return total
    finally:
        pr.close()


def _open_sink(pr, out_path):
    """The output file: BGZF (or another gz dialect) for .gz/.bgz/.bam,
    re-emitted byte-exactly where the archive recorded how (SEC_GZ_ISIZES,
    a zlib level), else plain."""
    if not out_path:
        return None
    if not out_path.endswith((".gz", ".bgz", ".bam")):
        return open(out_path, "wb")
    mg = pr.file_hdr.get("mgzip")
    isz_payload, _ = pr.zr.read_one(fmt.SEC_GZ_ISIZES)
    if not (mg and mg.get("exact") and isz_payload is not None
            and mg.get("lib", "zlib") == "zlib"):
        return open_bgzf(out_path)
    isizes = np.frombuffer(isz_payload, "<u4")
    header = bytes.fromhex(mg["header"])
    if mg.get("kind", "bgzf") == "bgzf":
        return ExactBgzfWriter(open(out_path, "wb"), isizes, mg["level"],
                               header)
    return MgzipExactWriter(open(out_path, "wb"), isizes, mg["level"], header)


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """The adler32 of A + B from adler1 = adler32(A), adler2 = adler32(B)
    and len2 = len(B) (zlib's adler32_combine)."""
    base = 65521
    rem = len2 % base
    s1 = adler1 & 0xFFFF
    s2 = rem * s1 % base
    s1 = (s1 + (adler2 & 0xFFFF) + base - 1) % base
    s2 = (s2 + (adler1 >> 16) + (adler2 >> 16) + base - rem) % base
    return s1 | (s2 << 16)


def workers() -> int:
    """Threads that reconstruct VBs ahead of an ordered consumer."""
    return min(os.cpu_count() or 2, 8)


def _piz(pr, comp_i, out_path, n_workers=None, window=None, sink=None):
    """Reconstruct component `comp_i` into `out_path`, or into `sink` (an
    open file that the caller closes) when given, with `n_workers` threads
    (default `workers()`) up to `window` VBs ahead; check its length and
    digests. Returns its bytes reconstructed."""
    h = pr.file_hdr
    comp = pr.components()[comp_i]
    deep = pr.deep_index if comp_i == 0 else None
    own = sink is None
    if own:
        sink = _open_sink(pr, out_path)
    try:
        md5 = hashlib.md5() if comp_i == 0 and h.get("md5") else None
        adler = zlib.adler32(b"")
        total = 0
        hdr = pr.txt_header(comp_i) if comp_i == 0 else b""
        if hdr:
            adler = zlib.adler32(hdr, adler)
            total += len(hdr)
            if sink:
                sink.write(hdr)
            if md5:
                md5.update(hdr)
        # workers read (one at a time), decompress and reconstruct whole
        # VBs concurrently; this thread drains them in order (the running
        # digest, from each VB's own, and the output write; a deep
        # archive's BAM records go into the index in VB order)
        vb_ids = range(1, pr.comp_num_vbs(comp_i) + 1)
        for (out, vb_adler), vb_i in zip(pr.vbs_in_order(
                vb_ids, comp_i, n_workers or workers(), window,
                with_adler=True), vb_ids):
            with profiler.vb(comp_i, vb_i):
                if deep is not None:
                    with profiler.timer("piz:deep-index"):
                        deep.add_bam_records(out)
                with profiler.timer("piz:drain"):
                    adler = adler32_combine(adler, vb_adler, len(out))
                    if md5:
                        md5.update(out)
                    total += len(out)
                    if sink:
                        sink.write(out)
    finally:
        if own and sink:
            sink.close()
    if total != comp["txt_len"]:
        raise ValueError(f"component {comp_i}: length mismatch")
    if comp.get("adler") is not None and adler != comp["adler"]:
        raise ValueError(f"component {comp_i}: digest mismatch")
    if md5 is not None and md5.hexdigest() != h["md5"]:
        raise ValueError("MD5 mismatch")
    return total
