"""MeshAligner: the seed aligner on the cards, a drop-in for
ref/aligner.align_batch behind `zip --mesh N`.

Counterpart of genozip_tpu/parallel/mesh_aligner.py. The genome's codes and
layer 0 of the refhash are copied to each device once and stay there (the
reference's shared-memory genome cache, src/ref_cache.c, as device state);
a batch of reads is split over the devices in contiguous blocks, one
`seed_align` launch a block. The genome is replicated, not split over an
'mp' axis as genozip_tpu splits it, so the result equals genozip_tpu's
MeshAligner(n_devices=1) whatever the device count (fault F16 is not
copied). Like genozip_tpu's, it reads refhash layer 0 only and takes no
pair hint and no splice pass, so its placements, and the archive bytes,
differ from the host aligner's. The mismatch channels are computed on the
host from whatever placement it returns, so a placement can cost ratio,
never data.
"""

import numpy as np
import torch

from ..ops import align_cuda, rans_cuda
from ..ref.refstore import KMER
from . import devices_for, map_devices, split_blocks

NO_GPOS = 0xFFFFFFFF


def _bucket(n: int, step: int) -> int:
    return max(((n + step - 1) // step) * step, step)


class MeshAligner:
    def __init__(self, ref, n_devices: int | None = None, devices=None,
                 max_read_len: int = 1024):
        self.devices = devices_for(n_devices, devices)
        self.D = len(self.devices)
        self.max_read_len = max_read_len
        self.hash_bits = ref.hash_bits
        genome = torch.from_numpy(np.array(ref.codes, dtype=np.uint8))
        rh = torch.from_numpy(np.array(ref.refhash[:1 << ref.hash_bits],
                                       dtype=np.uint32).view(np.int32))
        # one resident copy a distinct device
        self._resident = {dev: (genome.to(dev), rh.to(dev))
                          for dev in dict.fromkeys(self.devices)}

    def align_batch(self, ref, codes_mat: np.ndarray, lens: np.ndarray):
        """Same contract as ref/aligner.align_batch without its pair hint
        and splice pass (host in, host out): aligned, gpos (int64, -1 for
        none), is_fwd, nmm."""
        R, L = codes_mat.shape
        if R == 0 or ref.length < KMER:
            z = np.zeros(R, dtype=bool)
            return {"aligned": z, "gpos": np.zeros(R, np.int64),
                    "is_fwd": np.ones(R, bool), "nmm": np.zeros(R, np.int32)}
        Lb = _bucket(L, 128)
        if Lb > self.max_read_len:
            raise ValueError(
                f"reads longer than mesh halo ({L} > {self.max_read_len})")
        cm = np.zeros((R, Lb), np.uint8)
        cm[:, :L] = codes_mat
        codes = torch.from_numpy(cm)
        lv = torch.from_numpy(np.asarray(lens, dtype=np.int32).copy())

        def run(job):
            dev, (a, b) = job
            genome, rh = self._resident[dev]
            with rans_cuda._device_errors(dev, "seed_align"):
                out = align_cuda.seed_align(codes[a:b].to(dev),
                                            lv[a:b].to(dev), genome, rh,
                                            self.hash_bits)
                return [t.cpu() for t in out]

        jobs = [(dev, ab) for dev, ab in zip(self.devices,
                                             split_blocks(R, self.D))
                if ab[1] > ab[0]]
        gpos_u, fwd, nmm, aligned = (torch.cat(c).numpy() for c in
                                     zip(*map_devices(run, jobs)))
        gpos = np.where(gpos_u == NO_GPOS, -1, gpos_u).astype(np.int64)
        # defensive bounds (ratio-only decisions; recon derives from channels)
        bad = aligned & ((gpos < 0) | (gpos + lens > ref.length))
        aligned = aligned & ~bad
        return {"aligned": aligned, "gpos": gpos, "is_fwd": fwd.astype(bool),
                "nmm": nmm.astype(np.int32)}
