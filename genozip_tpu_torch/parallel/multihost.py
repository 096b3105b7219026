"""Multi-host (multi-process) ZIP: SPMD workers over torch.distributed.

Counterpart of genozip_tpu/parallel/multihost.py, which runs its workers
over jax.distributed. Design:

- N worker processes (`python -m genozip_tpu_torch.parallel.multihost`) join
  one gloo process group (tcp://127.0.0.1:<port> on one box; the
  coordinator's address across hosts). Each uses the `device` it is given
  for its kernels; two workers may share one card.
- Every rank reads the input and splits VBs identically (the same
  calibration and frozen choices as zip_file), then segs only its stripe
  (vb_i round robin) and compresses its locals: the compute-heavy phases
  run in parallel across processes. Seg results go to a scratch directory.
- Collectives over the group: an all_gather of each rank's (txt bytes,
  lines), and the dict-merge collective (zip_sharded.collective_merge with
  the group) over each rank's novel-word hashes, checked against the
  sequential host twin on every rank.
- Rank 0 then drains in global VB order (dict merge order = archive
  determinism, reference src/context.c:938), reading the other ranks' seg
  results from the scratch directory, and writes the archive: the bytes of
  zip_file's.

Not copied (fault F5): genozip_tpu leaves its scratch directory behind,
which is removed here whatever happens; and it writes SAM/BAM archives
without gencomp (`"gencomp": None`), whose bytes are not zip_file's. SAM and
BAM are refused here, since gencomp and REF_INTERNAL need their VBs segged
in one order by one process.
"""

import datetime
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

W = 256    # novel-word hashes a rank contributes to the merge collective


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def zip_file_multihost(src: str, out: str, n_procs: int = 2,
                       vb_size: int | None = None, device: str = "cuda",
                       timeout: int = 600, show_stats: bool = False) -> None:
    """Compress `src` with `n_procs` torch.distributed worker processes
    whose kernels run on `device`; the archive at `out` is byte-identical to
    zip_file's. Raises ValueError for a compressed input or a SAM/BAM one
    (F5), and RuntimeError when a worker fails or `timeout` seconds pass:
    every worker is then killed and the partial archive removed."""
    from ..datatypes import detect
    from ..txtfile import TxtReader
    reader = TxtReader(src)
    try:
        compressed = reader.is_compressed
        dt_name = detect(src, reader.peek(64 * 1024))
    finally:
        reader.close()
    if compressed:
        raise ValueError("--hosts takes plain (uncompressed) inputs")
    if dt_name in ("sam", "bam"):
        raise ValueError(
            f"--hosts does not take {dt_name.upper()}: gencomp and "
            "REF_INTERNAL need one seg order (genozip_tpu writes such an "
            "archive without gencomp, unlike zip_file: fault F5)")
    port = _free_port()
    scratch = tempfile.mkdtemp(prefix="gxz_mh_")
    env = os.environ.copy()
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    env["GXZ_QUIET"] = "1"     # N progress lines would interleave
    procs = []
    try:
        for rank in range(n_procs):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "genozip_tpu_torch.parallel.multihost",
                 str(rank), str(n_procs), str(port), src, out, scratch,
                 str(vb_size or 0), device, str(int(show_stats)),
                 str(timeout)], env=env))
        deadline = time.time() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            failed = [(r, rc) for r, rc in enumerate(rcs)
                      if rc not in (None, 0)]
            if failed:
                raise RuntimeError(f"multihost workers failed: {failed}")
            if all(rc == 0 for rc in rcs):
                return
            if time.time() > deadline:
                raise RuntimeError(f"multihost workers still running after "
                                   f"{timeout} s")
            time.sleep(0.05)
    except BaseException:
        if os.path.exists(out):
            os.unlink(out)      # never leave a partial archive
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(scratch, ignore_errors=True)


def _worker(rank: int, nprocs: int, port: int, src: str, out: str,
            scratch: str, vb_size: int, device: str, show_stats: bool,
            timeout: int) -> None:
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=nprocs, timeout=datetime.timedelta(seconds=timeout))
    try:
        _zip_rank(rank, nprocs, src, out, scratch, vb_size, device,
                  show_stats)
        # the store lives in rank 0: it stays up until every rank is done
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _zip_rank(rank, nprocs, src, out, scratch, vb_size, device, show_stats):
    import torch.distributed as dist
    from .. import codecs
    from ..codecs import assign as codec_assign
    from ..format import sections as fmt
    from ..sag import qname_hash
    from ..txtfile import DEFAULT_VB_SIZE
    from ..utils import profiler
    from ..zip_pipeline import ZipJob, _open_component, calibrate, print_stats
    from . import all_gather_rows
    from .zip_sharded import collective_merge, collective_merge_host_twin

    codecs.enable_device_rans(device)
    reader, dt, dt_name = _open_component(src)
    # only rank 0 writes an archive; the others keep codec state only
    job = ZipJob(out if rank == 0 else os.devnull)
    try:
        if not vb_size:
            vb_size = dt.suggested_vb_size() or DEFAULT_VB_SIZE
        # identical on every rank: header, calibration commits, freeze
        txt_header = dt.read_txt_header(reader)
        file_adler = zlib.adler32(b"")
        if txt_header:
            file_adler = zlib.adler32(txt_header, file_adler)
            if rank == 0:
                job.zw.write_section(
                    fmt.SEC_TXT_HEADER, txt_header, comp_i=0,
                    codec=codec_assign.assign_best(txt_header, "text"))
                job.stats.txt_len += len(txt_header)
        cal = calibrate(job, reader, dt)

        # seg this rank's stripe; keep the novel-word hashes of each VB's
        # largest dict context for the merge collective
        vb_i = my_txt = my_lines = 0
        dict_hashes = []
        for data in reader.vblocks(dt, vb_size):
            vb_i += 1
            file_adler = zlib.adler32(data, file_adler)
            if (vb_i - 1) % nprocs != rank:
                continue
            with profiler.timer("mh:seg"):
                res = dt.seg_vb(data)
            pre = job.precompress_locals(res)
            tmp = os.path.join(scratch, f"vb{vb_i}.pkl.tmp")
            with open(tmp, "wb") as f:
                pickle.dump((res, pre), f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, os.path.join(scratch, f"vb{vb_i}.pkl"))
            my_txt += int(data.shape[0])
            my_lines += res.num_lines
            big = max((c for c in res.ctxs.values() if c.vb_words is not None),
                      key=lambda c: len(c.vb_words), default=None)
            if big is not None:
                dict_hashes.append(qname_hash(big.vb_words))
        n_vbs = vb_i

        # the collectives: totals, and the dict merge over every rank's
        # hashes, equal to the sequential host twin on every rank
        totals = all_gather_rows(torch.tensor([[my_txt, my_lines]])) \
            .sum(0).tolist()
        mine = np.concatenate(dict_hashes)[:W] if dict_hashes else \
            np.zeros(0, np.uint64)
        padded = np.zeros(W, np.uint64)
        padded[:mine.shape[0]] = mine
        hi = (padded >> np.uint64(32)).astype(np.int64)
        lo = (padded & np.uint64(0xFFFFFFFF)).astype(np.int64)
        valid = np.arange(W) < mine.shape[0]
        lut, nuniq = collective_merge(hi[None], lo[None], valid[None],
                                      group=dist.group.WORLD)
        g_hi, g_lo, g_va = (all_gather_rows(torch.from_numpy(a[None]))
                            .numpy() for a in (hi, lo, valid.astype(np.uint8)))
        want, n_want = collective_merge_host_twin(
            (g_hi.astype(np.uint64) << np.uint64(32)) | g_lo.astype(np.uint64),
            g_va > 0)
        if not (np.array_equal(lut.numpy(), want) and nuniq == n_want):
            raise RuntimeError("cross-host collective dict merge != host twin")
        if rank == 0:
            _drain(job, src, dt, dt_name, vb_size, cal, scratch, n_vbs,
                   file_adler, len(txt_header or b""), totals)
            if show_stats:
                print_stats(job.stats)
    finally:
        job.out.close()
        reader.close()


def _drain(job, src, dt, dt_name, vb_size, cal, scratch, n_vbs, file_adler,
           header_len, totals):
    """Rank 0: write every rank's VBs in global VB order, then the global
    area."""
    from ..utils import profiler
    from ..zip_pipeline import _open_component
    r2, dt2, _ = _open_component(src, dt_name=dt_name)
    try:
        dt2.read_txt_header(r2)
        if cal:
            # replicate the calibration peek: vblocks takes the buffered
            # prefix first, so the peeks are part of the VB boundary layout
            r2.peek(1 << 20)
        vb_j = 0
        for data in r2.vblocks(dt, vb_size):
            vb_j += 1
            with open(os.path.join(scratch, f"vb{vb_j}.pkl"), "rb") as f:
                res, pre = pickle.load(f)
            with profiler.timer("mh:merge+write"):
                job.write_vb(res, data, vb_j, 0, pre_locals=pre)
    finally:
        r2.close()
    if vb_j != n_vbs or [job.stats.txt_len - header_len,
                         job.stats.num_lines] != totals:
        raise RuntimeError("multihost: rank 0's drain disagrees with the "
                           "ranks' totals")
    job.write_global_area({
        "version": 2, "dt": dt_name, "num_vbs": vb_j,
        "num_lines": job.stats.num_lines, "txt_len": job.stats.txt_len,
        "adler": file_adler, "segconf": dt.segconf,
        "txt_name": src.rsplit("/", 1)[-1],
        "reference": None,
        "ref_internal": False,
        "ref_stored": False,
        "enc": None,
        "md5": None,
        "mgzip": None,
        "gencomp": None,
    })


if __name__ == "__main__":
    _a = sys.argv[1:]
    _worker(int(_a[0]), int(_a[1]), int(_a[2]), _a[3], _a[4], _a[5],
            int(_a[6]), _a[7], _a[8] == "1", int(_a[9]))
