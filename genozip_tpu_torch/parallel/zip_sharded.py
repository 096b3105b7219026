"""dp-sharded ZIP: a batch of VBs' section payloads encoded over D devices,
and the dictionary merge as a collective.

Counterpart of genozip_tpu/parallel/zip_sharded.py.

- ShardedZipEncoder: the rANS payloads of D built VBs, split by order into
  D contiguous blocks, one block a device, each block one
  `rans_cuda.encode_many` launch (the rANS kernels on a card, their plain
  versions on the CPU). Streams equal `rans_np.encode(payload, order)` byte
  for byte, so a dp-N archive equals the single-device one. (The JAX
  version pads every stream to a common lane block and vmaps one jitted
  encoder over a 'dp' mesh axis; the kernels take ragged batches, so
  nothing is padded here.)

- collective_merge: the dict merge (reference src/context.c:938) as a
  collective. Each VB contributes its novel-word hashes, laid out in VB
  order; every rank gathers all rows (torch.distributed all_gather over a
  process group, where XLA inserts an all-gather for the replicated output)
  and computes the same first-seen global indices with a stable sort,
  group starts and dense ranks, in torch ops.
"""

import numpy as np
import torch

from ..ops import rans_cuda
from . import all_gather_rows, devices_for, map_devices, split_blocks


class ShardedZipEncoder:
    """Encodes batches of (payload, order) sections over D devices
    (`devices_for`); streams are byte-identical to rans_np.encode."""

    def __init__(self, n_devices: int | None = None, min_size: int = 4096,
                 devices=None):
        self.devices = devices_for(n_devices, devices)
        self.D = len(self.devices)
        self.min_size = min_size

    def eligible(self, payload_len: int) -> bool:
        return payload_len >= self.min_size

    def encode_sections(self, items) -> list:
        """items: list of (payload bytes, order). Returns the framed rANS
        streams, each equal to rans_np.encode(payload, order); one
        encode_many call for each (device, order) that has rows, a
        device's orders one after the other."""
        if any(it[1] not in (0, 1) for it in items):
            raise ValueError("rANS order must be 0 or 1")
        blocks = {}         # device index -> [(order, item indices)]
        for order in (0, 1):
            idxs = [i for i, it in enumerate(items) if it[1] == order]
            for d, (a, b) in enumerate(split_blocks(len(idxs), self.D)):
                if b > a:
                    blocks.setdefault(d, []).append((order, idxs[a:b]))

        def run(d):
            return [rans_cuda.encode_many([items[i][0] for i in idxs], order,
                                          self.devices[d])
                    for order, idxs in blocks[d]]

        out = [None] * len(items)
        for d, res in zip(blocks, map_devices(run, list(blocks))):
            for (_, idxs), blobs in zip(blocks[d], res):
                for i, blob in zip(idxs, blobs):
                    out[i] = blob
        return out


def _as_i64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _as_bool(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.bool)
    return torch.from_numpy(np.asarray(x).astype(bool))


def collective_merge(hi, lo, valid, group=None):
    """First-seen global word indices of (D, W) 64-bit word hashes given as
    u32 halves `hi`/`lo` (numpy or torch) and a `valid` mask, in genozip_tpu's
    layout (`make_collective_merge`): (indices int64 (D, W), -1 where
    invalid; the number of unique words). Assignment order is (row, column),
    the VB-order merge. With a torch.distributed `group`, each rank passes
    its own rows (the same shape on every rank), all ranks' rows are
    gathered in rank order, and every rank returns the whole result."""
    hi, lo, va = _as_i64(hi), _as_i64(lo), _as_bool(valid)
    if group is not None:
        hi, lo = all_gather_rows(hi, group), all_gather_rows(lo, group)
        va = all_gather_rows(va.to(torch.uint8), group).to(torch.bool)
    shape = hi.shape
    fhi, flo, fva = hi.reshape(-1), lo.reshape(-1), va.reshape(-1)
    n = fhi.shape[0]
    if n == 0:
        return torch.empty(shape, dtype=torch.int64), 0
    # invalid entries sort last and never define a group of their own
    shi = torch.where(fva, fhi, 0xFFFFFFFF)
    slo = torch.where(fva, flo, 0xFFFFFFFF)
    # lexicographic (hi, lo, position): two stable sorts from position order
    order = torch.argsort(slo, stable=True)
    order = order[torch.argsort(shi[order], stable=True)]
    ghi, glo, gva = shi[order], slo[order], fva[order]
    newgrp = torch.ones(n, dtype=torch.bool)
    newgrp[1:] = (ghi[1:] != ghi[:-1]) | (glo[1:] != glo[:-1])
    gid = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    ngrp = int(gid[-1]) + 1
    first_pos = order[newgrp]         # within a group, positions ascend
    grp_valid = torch.zeros(ngrp, dtype=torch.int64).scatter_reduce(
        0, gid, gva.to(torch.int64), "amax") > 0
    fp = torch.where(grp_valid, first_pos, n)
    rank = torch.empty(ngrp, dtype=torch.int64)
    rank[torch.argsort(fp, stable=True)] = torch.arange(ngrp)
    out = torch.empty(n, dtype=torch.int64)
    out[order] = rank[gid]
    out = torch.where(fva, out, -1)
    return out.reshape(shape), int((newgrp & gva).sum())


def collective_merge_host_twin(hash_rows: np.ndarray, valid: np.ndarray):
    """Numpy twin of the collective merge (same first-seen semantics) for
    equivalence tests vs ZCtxGlobal.merge_words."""
    flat = hash_rows.reshape(-1)
    fva = valid.reshape(-1)
    out = np.full(flat.shape[0], -1, np.int64)
    seen = {}
    for i in np.nonzero(fva)[0]:
        h = int(flat[i])
        j = seen.get(h)
        if j is None:
            j = len(seen)
            seen[h] = j
        out[i] = j
    return out.reshape(hash_rows.shape), len(seen)
