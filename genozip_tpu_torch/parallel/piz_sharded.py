"""dp-sharded PIZ: batches of rANS streams decoded over D devices, and
data-parallel reconstruction with plan-ordered assembly.

Counterpart of genozip_tpu/parallel/piz_sharded.py (reference
src/writer.c:866 writer_create_plan, :1203 writer_main_loop): VBs load,
decode and reconstruct on `dp` threads, up to 2·dp ahead, and the calling
thread drains them strictly in plan order (gencomp re-interleave on the
MAIN component, running digest, output write), so peak memory is a few
VBs, not the file. The output equals piz_file's byte for byte.
"""

import io
import os

from ..ops import rans_cuda, rans_np
from . import devices_for, map_devices, split_blocks


class ShardedPizDecoder:
    """Decodes batches of framed rANS streams over D devices
    (`devices_for`); outputs equal the host decoder's (rans_np)."""

    def __init__(self, n_devices: int | None = None, min_size: int = 4096,
                 devices=None):
        self.devices = devices_for(n_devices, devices)
        self.D = len(self.devices)
        self.min_size = min_size

    def decode_sections(self, items) -> list:
        """items: framed rANS streams. Streams of `min_size` symbols or more
        are split by order into D contiguous blocks, one `decode_many`
        launch a block and device; order 1 goes to the devices as well
        (genozip_tpu decodes it on the host: the bytes are the same).
        Smaller streams go to the host decoder. Returns each payload,
        equal to rans_np.decode."""
        out = [None] * len(items)
        groups = {0: [], 1: []}
        for i, buf in enumerate(items):
            n = int.from_bytes(bytes(buf[2:6]), "little")
            order = buf[1]
            if n < self.min_size or order not in groups:
                out[i] = rans_np.decode(buf)
            else:
                groups[order].append(i)
        jobs = [(dev, idxs[a:b]) for idxs in groups.values()
                for dev, (a, b) in zip(self.devices,
                                       split_blocks(len(idxs), self.D))
                if b > a]

        def run(job):
            dev, idxs = job
            return rans_cuda.decode_many([items[i] for i in idxs], dev)

        for (_, idxs), outs in zip(jobs, map_devices(run, jobs)):
            for i, o in zip(idxs, outs):
                out[i] = o
        return out


def piz_file_dp(z_path: str, out_path: str | None = None, dp: int = 1,
                reference: str | None = None) -> bytes | None:
    """Data-parallel PIZ: `dp` threads reconstruct VBs with an in-flight
    window of 2·dp, drained in plan order; each component's running adler
    is checked against its digest. Components of a paired or deep archive
    go to `out_path`.1, .2, ... as piz_file writes them; with no
    `out_path`, returns all components' bytes. A partial output is unlinked
    on any error."""
    from ..piz_pipeline import PizReader, _piz
    pr = PizReader(z_path, reference)
    written = []
    try:
        comps = pr.components()
        sink = io.BytesIO() if out_path is None else None
        for comp_i in range(len(comps)):
            path = out_path
            if out_path and len(comps) > 1:
                path = f"{out_path}.{comp_i + 1}"
            if path:
                written.append(path)
            _piz(pr, comp_i, path, n_workers=dp, window=2 * dp, sink=sink)
    except BaseException:
        for path in written:
            if os.path.exists(path):
                os.unlink(path)   # never leave a wrong partial output
        raise
    finally:
        pr.close()
    return None if sink is None else sink.getvalue()
