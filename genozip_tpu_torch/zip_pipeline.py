"""ZIP pipeline: compress a file of any datatype (FASTQ, SAM, BAM, VCF,
FASTA, GFF, BED, 23andMe, LOCS or generic), or a pair of FASTQ files, into a
GXZ archive.

Counterpart of genozip_tpu/zip_pipeline.py `zip_file` and `zip_pair`:
per-VB seg on a thread pool, deterministic in-order dict merge, per-context
codec assignment committed on first sight, section write, then the global
area (dicts, counts, stats, a stored reference, file header). With
--reference, FASTQ SEQ is aligned against the genome on the host, and a
SAM's SEQ and a VCF's REF are predicted from it; with
--REFERENCE the genome ranges the file used are stored in the archive. A VB's
whole-section RANS0 and RANS1 payloads of the device size go to the card in
one launch per order. The archive bytes equal genozip_tpu's with its device
path off. With --dp N, N built VBs at a time have those payloads encoded
over N devices (parallel/zip_sharded.py), the same bytes; with --mesh N,
the seed aligner kernel places FASTQ reads (parallel/mesh_aligner.py).

SAM/BAM without a reference build their genome from the alignments
(REF_INTERNAL, src/reference.c): VBs seg in order on one worker, since each
VB populates what the next diffs against, and the genome is stored after
the last VB. Primaries with dependents and the secondary/supplementary
alignments deport to the PRIM and DEPN components (src/gencomp_zip.c),
written after the MAIN VBs; DEPN compresses against the SAG store built
from PRIM (src/sam_sag_ingest.c). A BGZF input's block sizes are stored
(SEC_GZ_ISIZES) so that unzip can re-emit it byte for byte.

`zip_deep` (--deep) puts a BAM and the FASTQ files it was aligned from into
one archive: the BAM first (component 0), then each FASTQ, whose reads that
equal their BAM alignment keep only a hit flag (src/fastq_deep.c). With
--bamass, a BAM's placements stand in for the aligner's seed search of a
FASTQ zipped against a reference (src/fastq_bamass.c).

`zip_pair` co-compresses R1/R2 FASTQ (reference src/fastq.c:224-245): R2 VBs
are built 1:1 with R1 VBs by read count, byte-identical R2 sections are
dropped ("pair-identical", zip.c:223-234) and R2 GPOS is delta-coded against
R1's ("pair-assisted").

Reference parity: src/zip.c:721 zip_one_file / :510 zip_compress_one_vb.
"""

import contextlib
import copy
import hashlib
import itertools
import os
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import codecs, crypt
from .bamass import build_index as build_bamass_index
from .codecs import assign as codec_assign
from .contexts import MODE_NUM, VBCtx, ZCtxGlobal, narrow_int
from .datatypes import detect, get
from .deep import DeepIndex
from .format import sections as fmt
from .ops import pack as packops
from .parallel.mesh_aligner import MeshAligner
from .parallel.zip_sharded import ShardedZipEncoder
from .ref.refstore import load_ref_file
from .regions import ra_entries
from .txtfile import TxtReader, DEFAULT_VB_SIZE
from .utils import profiler
from .utils.bgzf import BgzfBlockReader, MgzipBlockReader
from .utils.progress import Progress

FLAG_DELTA = 1


class ZipStats:
    def __init__(self):
        self.txt_len = 0
        self.z_len = 0
        self.num_vbs = 0
        self.num_lines = 0
        self.start = time.time()
        self.per_ctx = {}  # name -> [txt-ish bytes, z bytes]

    def add_section(self, name, uncomp, comp):
        e = self.per_ctx.setdefault(name, [0, 0])
        e[0] += uncomp
        e[1] += comp


class ZipJob:
    """Shared state for writing one archive (one or two components).

    Built VBs are flushed in batches (`flush_batch`): their whole-section
    RANS0/RANS1 payloads go through one ShardedZipEncoder. Under `dp`
    (zip --dp) a batch is D VBs and the encoder spans D devices; otherwise
    a batch is one VB and the encoder is the kernels' device
    (`codecs.enable_device_rans`) with its size threshold, or none at all
    (host coders)."""

    def __init__(self, out_path: str, dp: int | None = None):
        self.out = open(out_path, "wb")
        self.zw = fmt.ZWriter(self.out)
        self.gctxs: dict[str, ZCtxGlobal] = {}
        self.stats = ZipStats()
        self.ra_index = {}
        self.dp = dp
        if dp:
            self.encoder = ShardedZipEncoder(n_devices=dp)
        elif codecs.device() is not None:
            self.encoder = ShardedZipEncoder(
                devices=[codecs.device()], min_size=codecs.device_batch_min())
        else:
            self.encoder = None
        self.batch_vbs = self.encoder.D if dp else 1

    def precommit_codecs(self, res):
        """Segconf codec pre-commitment (reference segconf.c:459 +
        codec.c:210): assign each calibration-VB context's codec once before
        the fan-out. The VB counter is reset so the VB-10 retest still lands
        on the real 10th VB."""
        for name, c in res.ctxs.items():
            g = self.gctxs.get(name)
            if g is None:
                g = self.gctxs[name] = ZCtxGlobal(name)
            try:
                if c.b250 is not None:
                    g.pick_codec("b250", narrow_int(c.b250).tobytes(),
                                 "b250")
                if c.local is not None:
                    arr = narrow_int(c.local) if c.mode == "num" else c.local
                    g.pick_codec("local", arr.tobytes(), c.cat)
            except codecs.DeviceKernelError:
                raise
            except Exception:
                pass        # calibration must never break the pipeline
            g.codec_nvb = {}

    def precompress_locals(self, res):
        """Worker-side compression of local sections whose codec is already
        committed (reference zip.c:566). Returns {name: (codec, arr,
        payload, blob)}; build_vb uses a blob when the ordered drain picks
        the same codec."""
        pre = {}
        for name, c in res.ctxs.items():
            if c.local is None:
                continue
            g = self.gctxs.get(name)
            if g is None or g.local_codec is None:
                continue
            if g.codec_nvb.get("local", 0) == 9 and \
                    codec_assign._mode != "fast":
                continue        # next pick_codec call is the VB-10 retest
            codec = g.local_codec
            arr = narrow_int(c.local) if c.mode == "num" else c.local
            payload = arr.tobytes()
            try:
                blob = codecs.compress(payload, codec)
            except codecs.DeviceKernelError:
                raise
            except Exception:
                continue
            pre[name] = (codec, arr, payload, blob)
        return pre

    def write_vb(self, res, data, vb_i, comp_i=0, pre_locals=None,
                 pair_payloads=None, collect=False):
        """Write one VB's sections. `pair_payloads`: R1's payload map, for
        dropping R2 sections equal to R1's; `collect` returns this VB's
        {(name, sec_type): payload} map."""
        built = self.build_vb(res, data, vb_i, comp_i, pre_locals,
                              pair_payloads, collect)
        self.flush_batch([built])
        return built["out_payloads"]

    def build_vb(self, res, data, vb_i, comp_i=0, pre_locals=None,
                 pair_payloads=None, collect=False):
        """Dict merge (VB order = determinism) + section planning."""
        out_payloads = {} if collect else None
        ctx_meta = {}
        # random-access index (reference src/random_access.c)
        cctx = res.ctxs.get("CHROM") or res.ctxs.get("RNAME")
        pctx = res.ctxs.get("POS")
        if cctx is not None and pctx is not None and \
                cctx.b250 is not None and pctx.local is not None:
            pv = pctx.local
            if pctx.param == 1:
                pv = np.cumsum(pv)
            ents = ra_entries(cctx.vb_words, cctx.b250, pv)
            if ents:
                self.ra_index[f"{comp_i}:{vb_i}"] = ents
        # (sec_type, name, payload, codec, ltype, flags, units, blob|None)
        pending = []
        for name, c in res.ctxs.items():
            g = self.gctxs.get(name)
            if g is None:
                g = self.gctxs[name] = ZCtxGlobal(name)
            ctx_meta[name] = c.meta()
            if c.b250 is not None:
                counts = np.bincount(c.b250, minlength=len(c.vb_words))
                lut = g.merge_words(c.vb_words, counts)
                b250_g = lut[c.b250]
                payload_arr = narrow_int(b250_g)
                payload = payload_arr.tobytes()
                key = (name, fmt.SEC_B250)
                all_same = b250_g.shape[0] and (b250_g == b250_g[0]).all()
                if collect:
                    # elided sections cannot serve as pair-copy sources
                    out_payloads[key] = None if all_same else payload
                if all_same:
                    # all-the-same: no section, value+count ride in the VB
                    # header (reference ctx_drop_all_the_same, context.c)
                    ctx_meta[name]["same"] = [int(b250_g[0]),
                                              int(b250_g.shape[0])]
                elif pair_payloads is not None and \
                        pair_payloads.get(key) == payload:
                    ctx_meta[name]["pair"] = "copy_b250"
                else:
                    codec = g.pick_codec("b250", payload, "b250")
                    pending.append((fmt.SEC_B250, name, payload, codec,
                                    fmt.lt_for_dtype(payload_arr.dtype), 0,
                                    int(c.b250.shape[0]), None))
            if c.local is not None:
                pc = (pre_locals or {}).get(name)
                if pc is not None:
                    local, payload = pc[1], pc[2]
                else:
                    local = c.local
                    if c.mode == "num":
                        local = narrow_int(local)
                    payload = local.tobytes()
                key = (name, fmt.SEC_LOCAL)
                if collect:
                    out_payloads[key] = payload
                if pair_payloads is not None and \
                        pair_payloads.get(key) == payload:
                    ctx_meta[name]["pair"] = "copy_local"
                    continue
                codec = g.pick_codec("local", payload, c.cat)
                blob = pc[3] if pc is not None and pc[0] == codec else None
                pending.append((fmt.SEC_LOCAL, name, payload,
                                codec, fmt.lt_for_dtype(local.dtype),
                                FLAG_DELTA if c.param == 1 else 0,
                                len(payload), blob))

        vb_hdr = {"n": res.num_lines, "len": int(data.shape[0]),
                  "adler": zlib.adler32(data), "ctxs": ctx_meta,
                  "meta": res.meta}
        return {"pending": pending, "vb_hdr": vb_hdr, "vb_i": vb_i,
                "comp_i": comp_i, "data_len": int(data.shape[0]),
                "num_lines": res.num_lines, "out_payloads": out_payloads}

    def flush_batch(self, batch):
        """Compress and write built VBs, in order. Their whole-section
        RANS0/RANS1 payloads that the encoder takes and no worker
        compressed already are encoded in one `encode_sections`: one
        launch for each (device, order)."""
        pre = [{} for _ in batch]
        enc = self.encoder
        items, keys = [], []
        for bi, b in enumerate(batch if enc is not None else ()):
            for i, e in enumerate(b["pending"]):
                if e[3] in (codecs.RANS0, codecs.RANS1) and e[7] is None \
                        and enc.eligible(len(e[2])):
                    items.append((e[2], 0 if e[3] == codecs.RANS0 else 1))
                    keys.append((bi, i))
        if items:
            with profiler.timer("zip:dp-encode") if self.dp else \
                    contextlib.nullcontext():
                blobs = enc.encode_sections(items)
            for (bi, i), blob in zip(keys, blobs):
                pre[bi][i] = blob
        for b, p in zip(batch, pre):
            self.flush_vb(b, p)

    def flush_vb(self, built, precomp):
        """Write the VB's sections + header; `precomp` maps section indices
        to streams encoded already."""
        zw, stats = self.zw, self.stats
        pending = built["pending"]
        vb_i, comp_i = built["vb_i"], built["comp_i"]
        for i, (sec, name, payload, codec, ltype, flags, units, blob) in \
                enumerate(pending):
            pc = precomp.get(i, blob)
            ent = zw.write_section(
                sec, payload, codec=codec, vb_i=vb_i, comp_i=comp_i,
                dict_id=name, ltype=ltype, flags=flags, precompressed=pc,
                uncomp_len=len(payload) if pc is not None else None)
            stats.add_section(name, units, zw.offset - ent.offset)
        zw.write_section(fmt.SEC_VB_HEADER, fmt.vbhdr_pack(built["vb_hdr"]),
                         codec=codecs.ZLIB, vb_i=vb_i, comp_i=comp_i)
        stats.txt_len += built["data_len"]
        stats.num_vbs += 1
        stats.num_lines += built["num_lines"]

    def write_global_area(self, file_hdr):
        zw = self.zw
        for name, g in self.gctxs.items():
            if len(g):
                payload = g.dict_payload()
                codec = codec_assign.assign_best(payload, "text")
                at = zw.offset
                zw.write_section(fmt.SEC_DICT, payload, codec=codec, dict_id=name)
                self.stats.add_section(name, len(payload), zw.offset - at)
                cnt = np.asarray(g.counts, dtype="<u8").tobytes()
                zw.write_section(fmt.SEC_COUNTS, cnt,
                                 codec=codec_assign.assign_best(cnt, "int"),
                                 dict_id=name, ltype=fmt.LT_U64)
        zw.write_section(fmt.SEC_STATS, fmt.json_payload(self.stats.per_ctx),
                         codec=codecs.ZLIB)
        if self.ra_index:
            zw.write_section(fmt.SEC_RANDOM_ACCESS,
                             fmt.json_payload(self.ra_index), codec=codecs.ZLIB)
        zw.write_section(fmt.SEC_FILE_HEADER, fmt.json_payload(file_hdr),
                         codec=codecs.ZLIB)
        zw.finalize()
        self.out.close()
        self.stats.z_len = zw.offset


def _open_component(in_path, reference=None, dt_name=None, ref=None,
                    truncate=False):
    """Open one input: (reader, datatype instance, datatype name). The
    reference genome is `ref` when given, else loaded from `reference`;
    `truncate` accepts an input cut mid-record (its cut tail is dropped)."""
    reader = TxtReader(in_path, truncate=truncate)
    try:
        head = reader.peek(64 * 1024)
        dt_name = dt_name or detect(in_path, head)
        dt = get(dt_name)()
        if reference:
            if ref is None:
                with profiler.timer("ref:load"):
                    ref = load_ref_file(reference)
            dt.ref = ref
        dt.segconf_scan(np.frombuffer(head, dtype=np.uint8))
        # plaintext size estimate for vb_size auto-tuning (segconf.c:101):
        # compressed inputs assume the typical ~3x gz ratio of genomic text
        if reader.disk_size:
            est = reader.disk_size * (3 if reader.is_compressed else 1)
            dt.segconf["txt_size_est"] = int(est)
    except BaseException:
        reader.close()
        raise
    return reader, dt, dt_name


def zip_file(in_path: str, out_path: str, vb_size: int | None = None,
             show_stats: bool = False, threads: int | None = None,
             reference: str | None = None, store_ref: bool = False,
             optimize: bool = False, bamass: str | None = None,
             dt_name: str | None = None, password: str | None = None,
             use_md5: bool = False, truncate: bool = False,
             dp: int | None = None, mesh: int | None = None):
    """Compress one file of any datatype, detected from its name and first
    bytes unless `dt_name` (--input-type) names it, against `reference` (a
    .ref.gxz) if given; `store_ref` also stores the genome ranges used
    (--REFERENCE); `bamass` names a BAM whose alignments place the FASTQ's
    reads. `password` encrypts every section but the file header
    (AES-256-CTR); `use_md5` adds the input's MD5 to the file header;
    `truncate` accepts an input cut mid-record. The device of the rANS and
    AES kernels is whatever `codecs.enable_device_rans` set (host coders
    and the CPU if nothing).

    `dp` (--dp N): D built VBs at a time have their RANS0/RANS1 sections
    encoded over D devices (parallel/zip_sharded.py); the archive is the
    same bytes. `mesh` (--mesh N, with a reference): FASTQ reads are placed
    by the seed aligner kernel on N devices (parallel/mesh_aligner.py),
    whose placements are genozip_tpu's mesh aligner's, not the host
    aligner's. Their devices are `parallel.devices_for`'s.

    The call is span `zip:file`, the root of the file's spans (its own
    file id, `utils/profiler.file`)."""
    with profiler.file(), profiler.timer("zip:file"):
        return _zip_file(in_path, out_path, vb_size, show_stats, threads,
                         reference, store_ref, optimize, bamass, dt_name,
                         password, use_md5, truncate, dp, mesh)


def _zip_file(in_path, out_path, vb_size, show_stats, threads, reference,
              store_ref, optimize, bamass, dt_name, password, use_md5,
              truncate, dp, mesh):
    if bamass and not reference:
        raise ValueError("--bamass needs --reference")
    with profiler.timer("zip:open"):
        reader, dt, dt_name = _open_component(in_path, reference, dt_name,
                                              truncate=truncate)
    try:
        dt.optimize_enabled = optimize
        if store_ref and getattr(dt, "ref", None) is not None:
            dt.ref.start_tracking()
        if mesh and reference:
            with profiler.timer("zip:mesh-setup"):
                dt.mesh_aligner = MeshAligner(dt.ref, n_devices=mesh)
        if bamass:
            with profiler.timer("zip:bamass-index"):
                dt.bamass_index = build_bamass_index(bamass, dt.ref)
        if vb_size is None:
            vb_size = dt.suggested_vb_size() or DEFAULT_VB_SIZE
        with profiler.timer("zip:open"):
            job, enc = _open_job(out_path, dp, password)
        try:
            _zip_into(job, reader, dt, dt_name, in_path, vb_size, threads,
                      reference, store_ref, enc,
                      hashlib.md5() if use_md5 else None, truncate)
        finally:
            job.out.close()
    finally:
        reader.close()
    if show_stats:
        print_stats(job.stats)
    return job.stats


def _open_job(out_path, dp, password):
    """(the ZipJob writing `out_path`, its encryption entry)."""
    job = ZipJob(out_path, dp)
    try:
        return job, _setup_encryption(job, password)
    except BaseException:
        job.out.close()
        raise


def _setup_encryption(job, password):
    """--password: a new salt and the key derived from it; returns the file
    header's `enc` entry (the salt and the key's tag), or None."""
    if not password:
        return None
    salt = crypt.new_salt()
    key = crypt.derive_key(password, salt)
    job.zw.set_encryption(key, salt)
    return {"salt": salt.hex(), "tag": crypt.key_tag(key)}


def calibrate(job, reader, dt, iref=None) -> bytes:
    """Segconf calibration seg (reference segconf.c:459): seg a ~1MB sample
    to commit the per-file lazy seg choices (QUAL demux class, aux layouts)
    and pre-commit every sampled context's codec, then freeze the choices:
    from here on seg may run concurrently, and bytes match across thread
    counts. Under REF_INTERNAL (`iref`) the denovo genome must not be
    populated out of VB order, so calibration runs with it detached (SEQ
    goes verbatim). Returns the sample peeked, which is part of the VB
    boundary layout (`TxtReader.vblocks` takes the buffered prefix first)."""
    with profiler.timer("zip:read"):
        cal = reader.peek(1 << 20)
    if cal:
        cdata = np.frombuffer(cal, np.uint8)
        cut = dt.vb_boundary(cdata, False)
        if 0 < cut:
            if iref is not None:
                dt.ref = None
            try:
                with profiler.timer("zip:segconf-cal"):
                    cres = dt.seg_vb(cdata[:cut].copy())
                with profiler.timer("zip:codec-commit"):
                    job.precommit_codecs(cres)
            except codecs.DeviceKernelError:
                raise   # ...but a failing card must not go unnoticed
            except Exception:
                pass    # calibration must never break the real path
            finally:
                if iref is not None:
                    dt.ref = iref
    dt.freeze_lazy_choices()
    return cal


def _zip_into(job, reader, dt, dt_name, in_path, vb_size, threads,
              reference, store_ref, enc, md5, truncate):
    with profiler.timer("zip:read"):
        txt_header = dt.read_txt_header(reader)
    file_adler = zlib.adler32(b"")
    if txt_header:
        file_adler = zlib.adler32(txt_header, file_adler)
        if md5:
            md5.update(txt_header)
        codec = codec_assign.assign_best(txt_header, "text")
        job.zw.write_section(fmt.SEC_TXT_HEADER, txt_header, codec=codec, comp_i=0)
        job.stats.txt_len += len(txt_header)
    iref = getattr(dt, "ref", None)
    if not getattr(iref, "internal", False):
        iref = None
    calibrate(job, reader, dt, iref)
    prog = Progress(f"zip {in_path.rsplit('/', 1)[-1]}", None)

    # up to `workers` VBs seg concurrently while the main thread merges,
    # codes and writes completed VBs strictly in VB order (dict merge order
    # = determinism). REF_INTERNAL: VB n's seg populates the genome VB n+1
    # diffs against, and PIZ replays that order, so seg stays sequential.
    workers = 1 if iref is not None else (threads or os.cpu_count() or 2)
    gencomp = _Gencomp(dt, dt_name, in_path, vb_size, truncate)
    vb_i = 0
    batch = []      # built VBs waiting for their batch's encode

    with ThreadPoolExecutor(max_workers=workers) as pool:
        def seg_one(data):
            with profiler.timer("zip:seg"):
                res = dt.seg_vb(data)
            with profiler.timer("zip:compress-local"):
                pre = job.precompress_locals(res)
            return res, pre

        inflight = deque()

        def drain():
            nonlocal vb_i
            pdata, pfut, gcpos = inflight.popleft()
            vb_i += 1
            with profiler.vb(0, vb_i):
                with profiler.timer("zip:seg-wait"):
                    pres, pre_locals = pfut.result()
                gencomp.add_positions(pres, gcpos)
                with profiler.timer("zip:merge+write"):
                    batch.append(job.build_vb(pres, pdata, vb_i,
                                              pre_locals=pre_locals))
                    if len(batch) >= job.batch_vbs:
                        job.flush_batch(batch)
                        batch.clear()
            prog.update(int(pdata.shape[0]))

        # VBs are numbered in the order they are read; drain takes them in
        # that order
        vblocks = reader.vblocks(dt, vb_size)
        for n_read in itertools.count(1):
            with profiler.vb(0, n_read):
                with profiler.timer("zip:read"):
                    data = next(vblocks, None)
                    if data is not None:
                        # the digests cover the original stream, before
                        # deportation
                        file_adler = zlib.adler32(data, file_adler)
                        if md5:
                            md5.update(data)
                if data is None:
                    break
                with profiler.timer("zip:gencomp-split"):
                    data, gcpos = gencomp.split(data)
                inflight.append((data, pool.submit(profiler.bind(seg_one),
                                                   data), gcpos))
            # VB 1 segs alone: its first-sight codec commits are visible to
            # every later VB
            if vb_i == 0 or len(inflight) > workers:
                drain()
        while inflight:
            drain()
        if batch:
            with profiler.timer("zip:merge+write"):
                job.flush_batch(batch)
    prog.finish()
    with profiler.timer("zip:gencomp-write"):
        gencomp_hdr = gencomp.write_components(job, vb_size)

    mgzip = None
    if isinstance(reader.f, (BgzfBlockReader, MgzipBlockReader)):
        mgzip = reader.f.mgzip_info()
        if mgzip.get("exact"):
            isz = np.asarray(reader.f.isizes, dtype="<u4").tobytes()
            job.zw.write_section(fmt.SEC_GZ_ISIZES, isz, codec=codecs.RANS0
                                 if len(isz) >= 64 else codecs.NONE)

    ref_internal = reference is None and iref is not None and \
        _write_internal_ref(job, iref, dt._POP_BLK)
    ref_stored = store_ref and reference is not None and \
        _write_stored_ref(job, dt.ref)
    file_hdr = {
        "version": 2, "dt": dt_name, "num_vbs": vb_i,
        "num_lines": job.stats.num_lines, "txt_len": job.stats.txt_len,
        "adler": file_adler, "segconf": dt.segconf,
        "txt_name": in_path.rsplit("/", 1)[-1],
        "reference": reference.rsplit("/", 1)[-1] if reference else None,
        "ref_internal": ref_internal,
        "ref_stored": ref_stored,
        "enc": enc,
        "md5": md5.hexdigest() if md5 else None,
        "mgzip": mgzip,
        "gencomp": gencomp_hdr,
    }
    with profiler.timer("zip:global-area"):
        job.write_global_area(file_hdr)


class _Gencomp:
    """SAM/BAM generated components (reference src/gencomp_zip.c): each
    MAIN VB deports its primaries-with-dependents to PRIM and its
    secondary/supplementary alignments to DEPN, keeping their line
    positions (GPPOS/GCPOS) in the MAIN VB. After the MAIN VBs, PRIM is
    written as component 1 and DEPN, compressed against the SAG store
    built from PRIM, as component 2."""

    def __init__(self, dt, dt_name, in_path, vb_size, truncate=False):
        self.dt = dt
        self.truncate = truncate
        self.prim_parts = []
        self.depn_parts = []
        self.depn_qnames = None
        # segconf gates the prescan: a sample with no secondary or
        # supplementary flags skips it; DEPN appearing later still deports
        # per VB (DEPN-only mode)
        self.on = dt_name in ("sam", "bam") and \
            dt.segconf.get("has_depn", True)
        if self.on and dt.segconf.get("depn_prim_pairs", True):
            # prescan (reference sam_sag_scan.c): a second streaming pass
            # finds the qnames with dependents; their primaries deport to
            # PRIM so DEPN can compress against them
            with profiler.timer("zip:gencomp-prescan"):
                self.depn_qnames = self._prescan(in_path, vb_size)

    def _prescan(self, in_path, vb_size):
        try:
            r2 = TxtReader(in_path, truncate=self.truncate)
            try:
                self.dt.read_txt_header(r2)
                hs = [h for data in r2.vblocks(self.dt, vb_size)
                      for h in [self.dt.depn_qname_hashes(data)]
                      if h.shape[0]]
            finally:
                r2.close()
        except (OSError, ValueError):
            return None    # unseekable input: DEPN-only deportation
        return np.unique(np.concatenate(hs)) if hs else None

    def split(self, data):
        """(MAIN VB bytes, (prim positions, depn positions) or None)."""
        if not self.on:
            return data, None
        gc = self.dt.gencomp_split(data, self.depn_qnames)
        if gc is None:
            return data, None
        data, pri, dep, ppos, dpos = gc
        self.prim_parts.append(pri)
        self.depn_parts.append(dep)
        return data, (ppos, dpos)

    @staticmethod
    def add_positions(res, gcpos):
        if gcpos is None:
            return
        for nm, pos in zip(("GPPOS", "GCPOS"), gcpos):
            if pos.shape[0]:
                res.ctxs[nm] = VBCtx(nm, MODE_NUM,
                                     local=np.diff(pos, prepend=np.int64(0)),
                                     cat="int", param=1)

    def write_components(self, job, vb_size):
        """Write PRIM (component 1) and DEPN (component 2); returns the
        file header's `gencomp` entry, None when nothing was deported."""
        if not (self.prim_parts or self.depn_parts):
            return None
        dt = self.dt
        e = np.zeros(0, np.uint8)
        prim = np.concatenate(self.prim_parts) if self.prim_parts else e
        self.prim_parts = None
        gp = self._write_chunks(job, prim, 1, vb_size)
        if prim.shape[0]:
            # SAG store: DEPN compresses against its primary
            # (reference sam_sag_ingest.c)
            dt.sag_store = dt.build_sag_store(prim)
        del prim
        depn = np.concatenate(self.depn_parts) if self.depn_parts else e
        self.depn_parts = None
        gd = self._write_chunks(job, depn, 2, vb_size)
        dt.sag_store = None
        return {"prim_vbs": gp, "depn_vbs": gd}

    def _write_chunks(self, job, txt, comp_i, vb_size):
        dt = self.dt
        gvb = 0
        off = 0
        while off < txt.shape[0]:
            end = min(off + vb_size, txt.shape[0])
            if end < txt.shape[0]:
                chunk = txt[off:off + int(dt.vb_boundary(txt[off:end], False))]
            else:
                chunk = txt[off:end]
            if chunk.shape[0] == 0:
                chunk = txt[off:end]
            gvb += 1
            with profiler.vb(comp_i, gvb):
                job.write_vb(dt.seg_vb(chunk), chunk, gvb, comp_i)
            off += chunk.shape[0]
        return gvb


def _write_internal_ref(job, iref, blk) -> bool:
    """REF_INTERNAL (src/reference.c): store the denovo genome built from
    the alignments, so PIZ reconstructs SEQ without an external reference.
    Only populated `blk`-byte blocks are stored, as (start, len) ranges
    (reference src/sections.h:437-450 range compaction); the payload has
    the layout of `_write_stored_ref`'s. False when nothing was populated."""
    if not iref.is_set.any():
        return False
    if getattr(iref, "blk_set", None) is not None:
        pop = iref.blk_set > 0
    else:
        nblk = -(-iref.length // blk)
        pad = nblk * blk - iref.length
        is_set = np.concatenate([iref.is_set[:iref.length],
                                 np.zeros(pad, bool)])
        pop = is_set.reshape(-1, blk).any(axis=1)
    d = np.diff(np.concatenate([[0], pop.view(np.int8), [0]]).astype(np.int8))
    rs = np.nonzero(d == 1)[0] * blk
    re_ = np.nonzero(d == -1)[0] * blk
    ranges = [(int(s), int(min(e, iref.length) - s)) for s, e in zip(rs, re_)]
    with profiler.timer("zip:internal-ref"):
        _write_ref_section(job, iref, ranges)
    return True


def _write_stored_ref(job, ref) -> bool:
    """REF_EXT_STORE (src/reference.c, flags.h:16-21 --REFERENCE): store
    the genome ranges the file used, so unzip needs no .ref file. Payload:
    contigs json + (start, len) ranges + the 2-bit codes of each range.
    False when no range was used."""
    ranges = ref.used_ranges()
    if not ranges:
        return False
    _write_ref_section(job, ref, [[int(s), int(l)] for s, l in ranges])
    return True


def _write_ref_section(job, ref, ranges):
    meta = fmt.json_payload({"contigs": ref.contigs,
                             "length": int(ref.length),
                             "ranges": ranges})
    packed = b"".join(packops.pack_np(ref.codes[s:s + l], 2).tobytes()
                      for s, l in ranges)
    payload = len(meta).to_bytes(4, "little") + meta + packed
    job.zw.write_section(fmt.SEC_REFERENCE, payload,
                         codec=codec_assign.assign_best(payload, "text"))


def zip_pair(in1: str, in2: str, out_path: str, vb_size: int | None = None,
             show_stats: bool = False, reference: str | None = None,
             threads: int | None = None, optimize: bool = False):
    """R1/R2 paired FASTQ into one two-component archive. Two-stage
    dispatcher: workers seg R1 VBs; the ordered drain reads the matching R2
    reads (R1's read count) and hands them to a second worker stage (seg R2
    with R1's GPOS as a hint, pair-GPOS delta, local compression); the final
    ordered drain writes both components. VB 1 runs alone through both
    stages, so its first-sight commits (codecs, R2's per-file seg state) are
    made once, before anything runs concurrently."""
    r1, dt1, _ = _open_component(in1, reference, "fastq")
    try:
        r2, dt2, _ = _open_component(in2, reference, "fastq", ref=dt1.ref)
    except BaseException:
        r1.close()
        raise
    try:
        job = ZipJob(out_path)
        try:
            file_hdr = _zip_pair_into(job, r1, dt1, r2, dt2, in1, in2,
                                      vb_size, reference, threads, optimize)
            job.write_global_area(file_hdr)
        finally:
            job.out.close()
    finally:
        r1.close()
        r2.close()
    if show_stats:
        print_stats(job.stats)
    return job.stats


def _zip_pair_into(job, r1, dt1, r2, dt2, in1, in2, vb_size, reference,
                   threads, optimize):
    if vb_size is None:
        vb_size = dt1.suggested_vb_size() or DEFAULT_VB_SIZE
    dt1.optimize_enabled = dt2.optimize_enabled = optimize
    adler = [zlib.adler32(b""), zlib.adler32(b"")]
    lines = [0, 0]
    tlens = [0, 0]
    nvbs = 0
    workers = threads or min(max(os.cpu_count() or 2, 1), 8)

    def seg1(data1):
        with profiler.timer("zip:seg"):
            res1 = dt1.seg_vb(data1)
        with profiler.timer("zip:compress-local"):
            pre1 = job.precompress_locals(res1)
        return res1, pre1

    def seg2(data2, hint, first):
        # later VBs run on a shallow copy, so the shared dt2's per-file lazy
        # state (the qual class) is read, never raced; VB 1 runs on the
        # original, alone, and commits that state
        d2 = dt2 if first else copy.copy(dt2)
        d2.pair_gpos_hint = hint
        with profiler.timer("zip:seg"):
            res2 = d2.seg_vb(data2)
        # pair-assisted GPOS: R2 gpos as delta vs R1's (same read index,
        # reference fastq_seq.c:187); hint carries R1's per-read gpos
        if hint is not None and "GPOS" in res2.ctxs:
            a1 = hint >= 0
            a2 = res2.ctxs["SQBITMAP"].local.astype(bool)
            g1 = np.where(a1, hint, 0)
            both = a2 & a1
            g2 = res2.ctxs["GPOS"].local.copy()
            res2.ctxs["GPOS"].local = np.where(both[a2], g2 - g1[a2], g2)
            res2.ctxs["GPOS"].param = 0
            res2.meta["gpos_pair_delta"] = True
        with profiler.timer("zip:compress-local"):
            pre2 = job.precompress_locals(res2)
        return res2, pre2

    with ThreadPoolExecutor(max_workers=workers) as pool:
        stage1 = deque()   # (data1, future(res1, pre1))
        stage2 = deque()   # (vb_i, data1, res1, pre1, data2, future2)

        def advance1():
            """Drain one R1 seg in order -> read R2 -> submit stage 2."""
            nonlocal nvbs
            data1, fut1 = stage1.popleft()
            with profiler.timer("zip:seg-wait"):
                res1, pre1 = fut1.result()
            nvbs += 1
            data2 = r2.read_fastq_records(res1.num_lines)
            if optimize:
                data2 = dt2.optimize_vb(data2)
            hint = None
            if "SQBITMAP" in res1.ctxs:
                hint = np.full(res1.num_lines, -1, np.int64)
                hint[res1.ctxs["SQBITMAP"].local.astype(bool)] = \
                    res1.ctxs["GPOS"].local
            fut2 = pool.submit(seg2, data2, hint, nvbs == 1)
            stage2.append((nvbs, data1, res1, pre1, data2, fut2))

        def advance2():
            vb_i, data1, res1, pre1, data2, fut2 = stage2.popleft()
            with profiler.timer("zip:seg-wait"):
                res2, pre2 = fut2.result()
            if res2.num_lines != res1.num_lines:
                raise ValueError(f"R2 out of step with R1 in VB {vb_i}: "
                                 f"{res2.num_lines} reads vs "
                                 f"{res1.num_lines}")
            with profiler.timer("zip:merge+write"):
                p1 = job.write_vb(res1, data1, vb_i, 0, pre_locals=pre1,
                                  collect=True)
                job.write_vb(res2, data2, vb_i, 1, pre_locals=pre2,
                             pair_payloads=p1)
            for c, data, res in ((0, data1, res1), (1, data2, res2)):
                adler[c] = zlib.adler32(data, adler[c])
                tlens[c] += data.shape[0]
                lines[c] += res.num_lines

        for data1 in r1.vblocks(dt1, vb_size):
            stage1.append((data1, pool.submit(seg1, data1)))
            if nvbs == 0:
                # VB 1 wholly alone: codec commits + per-file lazy seg state
                advance1()
                advance2()
                continue
            while len(stage1) > workers:
                advance1()
            while len(stage2) > workers:
                advance2()
        while stage1:
            advance1()
        while stage2:
            advance2()
    if r2.read_fastq_records(1).shape[0]:
        raise ValueError("R2 has more reads than R1")

    return {
        "version": 2, "dt": "fastq", "num_vbs": nvbs,
        "num_lines": sum(lines), "txt_len": sum(tlens),
        "adler": None, "segconf": dt1.segconf,
        "txt_name": in1.rsplit("/", 1)[-1],
        "reference": reference.rsplit("/", 1)[-1] if reference else None,
        "pair": True,
        "components": [
            {"name": in1.rsplit("/", 1)[-1], "txt_len": tlens[0],
             "adler": adler[0], "num_lines": lines[0]},
            {"name": in2.rsplit("/", 1)[-1], "txt_len": tlens[1],
             "adler": adler[1], "num_lines": lines[1]},
        ],
    }


def _fanout_component(job, reader, dt, vb_size, comp_i, workers,
                      on_data=None, adler=None):
    """Seg one archive component's VBs on `workers` threads and write them
    in VB order (zip_file's fan-out without calibration or frozen lazy
    choices, as genozip_tpu's zip_deep runs it). VB 1 segs alone, so its
    first-sight commits are made once. `on_data` sees each VB's bytes in VB
    order, before it is written. Returns (txt_len, num_lines, adler,
    num_vbs); the adler chains from `adler` (e.g. the txt header's)."""
    adler = zlib.adler32(b"") if adler is None else adler
    vb_i = tlen = nlines = 0

    def seg_one(data):
        with profiler.timer("zip:seg"):
            res = dt.seg_vb(data)
        with profiler.timer("zip:compress-local"):
            return res, job.precompress_locals(res)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        inflight = deque()

        def drain():
            nonlocal vb_i, adler, tlen, nlines
            data, fut = inflight.popleft()
            with profiler.timer("zip:seg-wait"):
                res, pre = fut.result()
            vb_i += 1
            adler = zlib.adler32(data, adler)
            if on_data is not None:
                on_data(data)
            with profiler.timer("zip:merge+write"):
                job.write_vb(res, data, vb_i, comp_i, pre_locals=pre)
            tlen += data.shape[0]
            nlines += res.num_lines

        for data in reader.vblocks(dt, vb_size):
            inflight.append((data, pool.submit(seg_one, data)))
            if vb_i == 0 or len(inflight) > workers:
                drain()
        while inflight:
            drain()
    return tlen, nlines, adler, vb_i


def zip_deep(bam_path: str, fastq_paths: list, out_path: str,
             vb_size: int | None = None, show_stats: bool = False,
             reference: str | None = None, threads: int | None = None):
    """--deep: a BAM and the FASTQ file(s) it was aligned from into one
    archive (reference src/fastq_deep.c, src/sam_deep.c). The BAM is
    component 0, REF_INTERNAL and without gencomp; its VBs seg on one
    worker, in VB order, since each populates the genome the next diffs
    against (genozip_tpu segs them on up to 8 threads, so its bytes may
    depend on timing: fault F9). Its records feed the deep index in VB
    order. Each FASTQ is a component after it, segged on `threads` workers
    against the index. `reference` serves the FASTQ components only."""
    job = ZipJob(out_path)
    try:
        stats = _zip_deep_into(job, bam_path, fastq_paths, vb_size,
                               reference, threads)
    finally:
        job.out.close()
    if show_stats:
        print_stats(stats)
    return stats


def _zip_deep_into(job, bam_path, fastq_paths, vb_size, reference, threads):
    index = DeepIndex()
    comps = []
    reader, dt, _ = _open_component(bam_path, dt_name="bam")
    try:
        if vb_size is None:
            vb_size = dt.suggested_vb_size() or DEFAULT_VB_SIZE
        bam_dt = dt
        hdr = dt.read_txt_header(reader)
        hadler = zlib.adler32(b"")
        if hdr:
            hadler = zlib.adler32(hdr, hadler)
            job.zw.write_section(fmt.SEC_TXT_HEADER, hdr,
                                 codec=codec_assign.assign_best(hdr, "text"),
                                 comp_i=0)

        def ingest(data):
            with profiler.timer("zip:deep-index"):
                index.add_bam_records(data.tobytes())
        tlen, nlines, adler, nvb = _fanout_component(
            job, reader, dt, vb_size, 0, 1, on_data=ingest, adler=hadler)
    finally:
        reader.close()
    comps.append({"name": bam_path.rsplit("/", 1)[-1], "dt": "bam",
                  "txt_len": tlen + len(hdr), "adler": adler,
                  "num_lines": nlines, "num_vbs": nvb,
                  "segconf": dt.segconf})
    workers = threads or min(max(os.cpu_count() or 2, 1), 8)
    ref = None
    for ci, fq in enumerate(fastq_paths, start=1):
        reader, dt, _ = _open_component(fq, reference, "fastq", ref=ref)
        try:
            ref = dt.ref
            dt.deep_index = index
            tlen, nlines, adler, nvb = _fanout_component(
                job, reader, dt, vb_size, ci, workers)
        finally:
            reader.close()
        comps.append({"name": fq.rsplit("/", 1)[-1], "dt": "fastq",
                      "txt_len": tlen, "adler": adler, "num_lines": nlines,
                      "num_vbs": nvb})
    iref = bam_dt.ref if getattr(bam_dt.ref, "internal", False) else None
    ref_internal = iref is not None and \
        _write_internal_ref(job, iref, bam_dt._POP_BLK)
    job.write_global_area({
        "version": 2, "dt": "bam",
        "num_vbs": max(c["num_vbs"] for c in comps),
        "num_lines": sum(c["num_lines"] for c in comps),
        "txt_len": sum(c["txt_len"] for c in comps),
        "adler": None, "segconf": {}, "deep": True,
        "ref_internal": ref_internal,
        "txt_name": bam_path.rsplit("/", 1)[-1],
        "reference": reference.rsplit("/", 1)[-1] if reference else None,
        "components": comps,
    })
    return job.stats


def print_stats(stats: ZipStats):
    dt_sec = time.time() - stats.start
    ratio = stats.txt_len / max(stats.z_len, 1)
    print(f"txt {stats.txt_len:,} -> z {stats.z_len:,}  ratio {ratio:.2f}x  "
          f"{stats.txt_len / 1e6 / max(dt_sec, 1e-9):.1f} MB/s  "
          f"vbs {stats.num_vbs} lines {stats.num_lines:,}")
    rows = sorted(stats.per_ctx.items(), key=lambda kv: -kv[1][1])
    for name, (u, z) in rows:
        print(f"  {name:12s} z {z:>12,}  ({100.0 * z / max(stats.z_len, 1):5.1f}%)")
