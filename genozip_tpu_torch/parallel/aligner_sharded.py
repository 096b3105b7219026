"""The seed aligner step on one device, and the genome's slab layout.

Counterpart of genozip_tpu/parallel/aligner_sharded.py. There, `local`
(:65-140) runs under shard_map on a ('dp', 'mp') mesh: the genome and
refhash are split over 'mp' slabs, each rank scores the candidates whose
start lies in its slab's base region, and a psum over 'mp' adds the counts.
Its base region is `slab + max_read_len - L` bases long, so it overlaps the
next slab's first `max_read_len - L` bases; a candidate there is scored by
two ranks and its mismatches counted twice (fault F16). The port keeps the
whole genome and layer 0 of the refhash on each card, as an 80 GB card
holds a human genome, and `local` at mp = 1 is the kernel `seed_align`
(csrc/seed_align.cu, bound in ops/align_cuda.py) on the reads of one
device, which `mesh_aligner.MeshAligner` launches. Its result equals
genozip_tpu's MeshAligner(n_devices=1) whatever the device count.

`shard_genome` is genozip_tpu's numpy slab layout: the parity tests lay
the port's genome out with it to run genozip_tpu's `make_sharded_aligner`
against the kernel's plain version.
"""

import numpy as np

from ..ref.refstore import KMER, NO_GPOS


def shard_genome(ref, mp: int, max_read_len: int):
    """Split genome codes into mp contiguous slabs with halo; pad refhash to
    a multiple of mp. Returns (slabs (mp, slab+halo) u8, slab_starts (mp,),
    refhash_mat (mp, slots/mp) u32)."""
    G = ref.length
    slab = -(-G // mp)
    halo = max_read_len + KMER
    slabs = np.zeros((mp, slab + halo), dtype=np.uint8)
    starts = np.zeros(mp, dtype=np.int64)
    for j in range(mp):
        s = j * slab
        e = min(s + slab + halo, G)
        slabs[j, : e - s] = ref.codes[s:e]
        starts[j] = s
    # layer 0 only on the mesh path (the layered table is [l0 | l1] flat;
    # owner-rank routing assumes slot space == 2^hash_bits)
    nslots = 1 << ref.hash_bits
    per = -(-nslots // mp)
    rh = np.full(mp * per, NO_GPOS, dtype=np.uint32)
    rh[:nslots] = ref.refhash[:nslots]
    return slabs, starts, rh.reshape(mp, per)

