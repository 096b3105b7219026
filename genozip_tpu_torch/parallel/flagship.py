"""Flagship device compute: the FASTQ VB-encode step, on one device and
sharded over several.

Counterpart of genozip_tpu/parallel/flagship.py, the step that
genozip_tpu's `__graft_entry__.entry()` and `dryrun_multichip` run: 2-bit
SEQ packing (reference src/codec_acgt.c) and wide-interleaved rANS of QUAL,
with the global frequency reconciliation as a sum over devices (the
reference's mutex-guarded context merge, src/context.c:938). The rANS
lanes go through the port's `rans_encode_o0` kernel with the step's own
table; the lane layout is the stream format's (contiguous chunks,
ops/rans_np.py), so the words are the decoder's.

The device mesh becomes a device list of dp x sp shards: reads over 'dp',
read positions over 'sp'. Each shard's histogram is summed on the first
device, normalized there, and each shard encodes its own lanes.

    python -m genozip_tpu_torch.parallel.flagship [--device cpu]

prints scaling_bench.py's JSON lines (devices, encode_MBps,
weak_scaling_eff) for 1, 2, 4, 8 devices up to the cards present.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..ops import rans_cuda
from ..ops.rans_np import SCALE, normalize_freqs as normalize_freqs_np
from . import devices_for, map_devices


def normalize_freqs(hist: torch.Tensor):
    """The histogram -> 2^12 normalization of genozip_tpu's
    `normalize_freqs_jnp` (two rounds of +-1 over the largest bins), in
    int64: genozip_tpu computes `hist * SCALE` in int32, which overflows
    once a bin holds more than 524,287 counts; the two agree below that.
    Returns (freq, cum) int64 (256,)."""
    hist = hist.to(torch.int64)
    total = torch.clamp(hist.sum(), min=1)
    f = hist * SCALE // total
    f = torch.where((hist > 0) & (f == 0), 1, f)
    order = torch.argsort(-hist, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(256, device=hist.device)
    for _ in range(2):
        diff = SCALE - f.sum()
        sign = torch.sign(diff)
        eligible = torch.where(sign >= 0, hist > 0, f > 1)
        take = rank < diff.abs()
        f = f + torch.where(take & eligible, sign, 0)
    if int(hist.sum()) == 0:
        f = torch.zeros_like(f)
        f[0] = SCALE
    cum = torch.cumsum(f, 0) - f
    return f, cum


def pack_seq_2bit(codes: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 2-bit codes -> packed bytes (n/4,), the first code in the
    low bits."""
    v = codes.reshape(-1, 4).to(torch.int32)
    shifts = torch.arange(4, dtype=torch.int32, device=codes.device) * 2
    return (v << shifts).sum(1).to(torch.uint8)


def rans_encode_block(syms: torch.Tensor, freq: torch.Tensor,
                      cum: torch.Tensor):
    """Encode a flat uint8 symbol block as N lanes of K contiguous symbols,
    all lanes full, with the table (freq, cum), through `rans_encode_o0` on
    the block's device. N = max(32, min(8192, 2^ceil(log2(n // 64)))).
    Returns (final states int64 (N,) of u32 values, the renorm words
    int64 of u16 values in the decoder's read order (step, then lane),
    nbytes = 2 * (2N + words))."""
    n = syms.numel()
    N = max(32, min(8192, 1 << int(np.ceil(np.log2(max(n // 64, 1))))))
    K = n // N
    if K * N != n:
        raise ValueError(f"the flagship block needs N | n (n {n}, N {N})")
    dev = syms.device
    out_len = n + 2 * N + 8
    meta = torch.tensor([[0, n, N, K, 0, 0, out_len, 0]], dtype=torch.int64,
                        device=dev)
    tab = torch.stack([freq, cum]).to(torch.int32).reshape(1, 2, 256).to(dev)
    words, p, states = rans_cuda.rans_encode_o0(
        syms.contiguous(), meta, tab.contiguous(), out_len, N)
    body = words[int(p[0]):].to(torch.int64) & 0xFFFF
    return states.to(torch.int64) & 0xFFFFFFFF, body, 2 * (2 * N + body.numel())


def fastq_encode_step(seq_codes: torch.Tensor, qual: torch.Tensor,
                      freq: torch.Tensor, cum: torch.Tensor):
    """Single-device VB encode: (packed SEQ, QUAL lane states, QUAL words,
    compressed bytes)."""
    packed = pack_seq_2bit(seq_codes.reshape(-1))
    x, w, nb = rans_encode_block(qual.reshape(-1), freq, cum)
    return packed, x, w, nb


class Mesh:
    """dp x sp shards over a device list (row-major: shard i * sp + j)."""

    def __init__(self, devices):
        self.devices = list(devices)
        n = len(self.devices)
        self.sp = 2 if n % 2 == 0 and n >= 2 else 1
        self.dp = n // self.sp


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    return Mesh(devices_for(n_devices, devices))


def make_sharded_step(mesh: Mesh):
    """The multi-device VB encode step: per-shard histograms summed on the
    first device (the one cross-device sync), the table normalized there,
    then each shard's SEQ packed and QUAL lanes encoded on its device.
    step(seq_codes, qual), both (reads, read_len) uint8 with reads a
    multiple of dp and read_len of sp, returns (packed SEQ of every shard
    in shard order, the states in shard order, [words of each shard],
    [nbytes of each shard])."""
    devs, dp, sp = mesh.devices, mesh.dp, mesh.sp

    def blocks(x):
        x = torch.as_tensor(x)
        rb, cb = x.shape[0] // dp, x.shape[1] // sp
        return [x[i * rb:(i + 1) * rb, j * cb:(j + 1) * cb].reshape(-1)
                .to(devs[i * sp + j]) for i in range(dp) for j in range(sp)]

    def step(seq_codes, qual):
        seqs, quals = blocks(seq_codes), blocks(qual)
        hist = sum(torch.bincount(q.to(torch.int64), minlength=256)
                   .to(devs[0]) for q in quals)
        freq, cum = normalize_freqs(hist)

        def shard(d):
            return fastq_encode_step(seqs[d], quals[d], freq.to(devs[d]),
                                     cum.to(devs[d]))

        outs = map_devices(shard, range(len(devs)))
        return (torch.cat([o[0].cpu() for o in outs]),
                torch.cat([o[1].cpu() for o in outs]),
                [o[2] for o in outs], [o[3] for o in outs])

    return step


def example_batch(reads=4096, read_len=128, seed=0):
    rng = np.random.default_rng(seed)
    seq_codes = rng.integers(0, 4, (reads, read_len)).astype(np.uint8)
    qual = rng.choice(np.frombuffer(b"FFFFF:F,#", np.uint8),
                      (reads, read_len)).astype(np.uint8)
    hist = np.bincount(qual.reshape(-1), minlength=256)
    freq = normalize_freqs_np(hist)
    cum = np.concatenate([[0], np.cumsum(freq)[:-1]]).astype(np.uint32)
    return seq_codes, qual, freq.astype(np.uint32), cum


def bench_encode(devices, reads, read_len, iters):
    """MB/s (SEQ + QUAL bytes) of the sharded step, best of `iters` after a
    warm-up, each call ending with its results on the host."""
    mesh = Mesh(devices)
    step = make_sharded_step(mesh)
    reads = reads // mesh.dp * mesh.dp
    read_len = read_len // mesh.sp * mesh.sp
    seq, qual, _, _ = example_batch(reads=reads, read_len=read_len)
    step(seq, qual)
    best = None
    for _ in range(iters):
        t0 = time.perf_counter()
        step(seq, qual)
        d = time.perf_counter() - t0
        best = d if best is None else min(best, d)
    return reads * read_len * 2 / 1e6 / best


def main(argv=None):
    ap = argparse.ArgumentParser(description="the flagship step's weak "
                                 "scaling over the devices present")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        avail = [torch.device("cpu")] * 8
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA GPU is available (--device cpu runs "
                             "the plain versions)")
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    base = None
    for n in (k for k in (1, 2, 4, 8) if k <= len(avail)):
        mbps = bench_encode(avail[:n], reads=4096 * n, read_len=128, iters=3)
        base = base or mbps
        print(json.dumps({"devices": n, "encode_MBps": round(mbps, 1),
                          "weak_scaling_eff": round(mbps / (base * n), 3)}))


if __name__ == "__main__":
    main()
