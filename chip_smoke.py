#!/usr/bin/env python3
"""Smoke run of genozip_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --phases kernels,micro     # a subset, no result
    python3 chip_smoke.py --ab PARENT CHANGE         # kernels of two trees
    python3 chip_smoke.py --ab-host PARENT CHANGE    # cells end to end

Phases, each printed on its own lines; any failure exits non-zero:

1. setup: the card (nvidia-smi name and power limit), torch/CUDA versions,
   and the nvcc builds of the kernels (csrc/rans.cu, csrc/aes.cu,
   csrc/seed_align.cu, csrc/arith.cu, csrc/pbwt.cu) and of the
   rANS microbenchmarks (csrc/rans_micro.cu), side by side, with ptxas'
   register and spill report; then the g++ build of the host runtime.
2. kernels: each of the four rANS kernels against its plain PyTorch version
   on the same inputs, byte for byte (tolerance: exact), at main-path shapes
   (R = 8 streams of 1-4 MiB of packed SEQ and packed QUAL, which has 256
   symbols, and of raw QUAL, which has few) and at edge cases (R = 8 at
   mixed lane counts and at N = 16, 64, 1024 and 8192: empty streams, short
   last lanes, one and 256 symbols); times of kernel and plain
   version from CUDA events (an encoder's through its C entry point on
   buffers allocated once, since its wrapper's host work takes longer than
   its card time), also at R = 1 on one 16 MiB VB's packed stream,
   the shape the full runs' nested SEQ and QUAL streams launch with, and
   rans_decode_o0 on a 134 MB refhash-shaped stream (N = 8192, R = 1), the
   shape of the reference load.
2b. micro: the decode step's chain floor (block_rank alone), the decoder
   before the shared-memory redesign with its stores and loads switched off
   in turn, the redesigned decoder on the same streams, barrier.cluster
   over 1-8 blocks, and the encoders: the new pass 1's chain floor (its
   arithmetic alone), then on one VB stream of each order the encoder
   before the lane-parallel redesign, the new pass 1 with and without its
   word stores, and the whole new encoder through its C entry point and
   through its wrapper, in us per step.
3. device equals host: `zip` of a 32 MiB FASTQ (64 before phase 8 joined
   the smoke) with --device cuda and with
   --device cpu must write the same archive bytes.
4. cfg3 full run: `zip`, then `unzip`, of a 128 MiB cfg3-shaped FASTQ (512
   before phase 8 joined the smoke),
   compared byte for byte; `cat --head 1000` and `ls`. Every kernel's launch
   count over this run must be > 0.
5. entry points: the single-stream `encode`, `decode`, `encode_order1`,
   `decode_order1` and the fixed-lane `encode_many` of `ops.rans_cuda` on the
   card, each byte-equal to its plain version on the card and (decoders) to
   the input (tolerance: exact), at n in {100, 517, 33000, 131072,
   200000} and N in {128, 256, 1024}; kernel and plain times on one 1.84 MB
   VB stream at N = 1024.
6. cfg4 full run: a 64 Mbp genome (the length of GRCh38 chr20), `zip
   --make-reference`, 2 x 64 MiB of paired FASTQ off it (2 x 256 before
   phase 8 joined the smoke), `zip --pair
   --reference --vblock 16`, `unzip` of both components compared byte for
   byte, `cat --r1 --head 1000`, `cat --interleave --head 1000` and `ls`;
   every kernel's launch count over this run must be > 0. At 2 x 16 MiB the
   --device cuda archive must equal the --device cpu one, and a --REFERENCE
   archive must unzip without --reference.
7. cfg5 full run: a 32 MiB (on disk; 64 before phase 10 joined the smoke)
   coordinate-sorted BAM of 150 bp reads
   over 32 Mbp contigs with ~8% multi-mappers (primary + secondary) and ~4%
   split reads (primary + supplementary), BGZF at zlib level 6
   (`synth.write_bam`); `zip --vblock 16` (REF_INTERNAL, gencomp and the SAG
   store), `unzip` compared byte for byte with the input (the BGZF
   re-emission is exact), `ls`; every kernel's launch count over zip plus
   unzip must be > 0. Then the same records as 16 MiB of SAM text: the
   --device cuda archive must equal the --device cpu one, `unzip` is byte
   exact, `cat --head 1000` is the header and the first 1000 records, and
   `cat --one-vb k` over every VB gives the records back in their order.
8. cfg5x, on phase 7's files (the BAM is written with its SAM text and the
   R1/R2 FASTQ of its primaries, `synth.write_deep_fastq`; the SAM with its
   records as a BAM stream): `cat --sam` of the BAM archive equals the
   generator's SAM text (MB/s printed); `cat --idxstats` of the SAM
   archive counts the generator's reads per contig; `cat --bam --index -o` of the
   SAM archive is the same .bam and .bai from cuda and cpu, and its BAM
   stream the generator's; `cat --regions <contig>:1-1000000 --count` and
   `cat --lines 1000-2000` equal the selection made in Python; `zip --deep
   BAM R1 R2 --vblock 32` and `unzip` of every component byte for byte,
   with MB/s, ratio and each kernel's launches over zip plus unzip (each
   must be > 0); a 16 MiB BAM off a 4 Mbp cfg5 genome with its R1/R2: the
   deep archive equal from cuda and cpu, `cat --coverage` of it counting
   the generator's reads per contig, and `zip --bamass` of the R1
   against a reference of that genome (under the BAM's contig names), equal
   from cuda and cpu and unzipped with the reference only; a 16 MiB (64
   before phase 10 joined the smoke) long-read SAM
   (`synth.write_longread_sam`) zipped and unzipped byte for byte.
9. cfg1, cfg2 and the other datatypes: a 64 MiB VCF of a 200-sample
   cohort (`synth.write_vcf`, bench.py's `gen_vcf` shapes) through `zip
   --vblock 16`, `unzip` (byte for byte), `ls`, `cat --head 1000` and `cat
   -r chr1:a-b --count` (against the selection made in Python), with MB/s,
   ratio, the --show-time regions and each kernel's launches over the run
   (each must be > 0); 16 MiB of it: the --device cuda archive equals the
   --device cpu one, and the launches at the default VB size are printed;
   16 MiB against an 8 Mbp genome named chr1 (the VCF's CHROM is 1): a
   --reference archive unzipped with it and a --REFERENCE one without it;
   cfg2, phase 6's 64 Mbp FASTA zipped as a file at --vblock 16 (written
   here when phase 6 did not run), cuda == cpu, unzip byte exact, MB/s and
   launches; 16 MiB each of GFF3, BED, 23andMe, LOCS and a log zipped with
   `--input-type generic`, each cuda == cpu and unzipped byte for byte,
   with MB/s; and `cat --vcf` of the 23andMe archive against the chr1
   reference, equal to `translate.me23_vb_to_vcf` of the generator's text.
10. tools: the aes256_ctr kernel against its plain version on the card,
   byte for byte, at n in {0, 1, 15, 16, 17, 4095, 4097, 1 MiB, 64 MiB} and
   counters whose low bytes carry, timed at 1 and 64 MiB through its
   wrapper and alone (a CUDA graph of its C entry point); phase 4's 128
   MiB FASTQ through `zip --password --md5 --test`, `unzip --password`
   (byte for byte) and `cat --password --head 1000`, with MB/s beside phase
   4's unencrypted ones and every kernel's launches (each must be > 0, the
   AES kernel's too); a wrong and a missing password refused; 16 MiB
   encrypted from cuda and cpu the same bytes with the salt fixed; phase
   7's BAM encrypted (REF_INTERNAL, gencomp) and unzipped byte for byte;
   `zip --best` of 16 MiB of cfg3 FASTQ and of the first 4 MiB of phase
   7's SAM (at 16 MiB no SAM section takes BWT), cuda and cpu in four child
   processes side by side (codec trials are host work), the archives
   equal, unzipped byte for byte, with sections per codec (the SAM's must
   hold a BWT section), MB/s and --show-time regions; then `--tar` of two inputs (each member that input's own
   archive), `--replace`, `--truncate` of a FASTQ cut mid-record,
   `--biopsy 2` against VB 2, and a .cram input read through a samtools
   shim.
11. parallel, on phase 6's reference and R1 and phase 4's FASTQ and
   archive: the seed_align kernel against its plain version on the card,
   output for output, at edge reads (lengths 1, 15, 16, 17, Lb - 1 and Lb,
   both strands, codes above 3; the genome's last bases and position 0;
   a tie that the first candidate must win; tests/torch_seed_reads.py)
   spread over 8192 rows, at Lb = 256, at Lb = 130 and with the codes one
   byte past an aligned address, and at one cfg4 VB (49k reads of 150 bp,
   Lb = 256), timed through its wrapper and alone against its bound;
   `zip --reference --vblock 16` of the
   64 MiB R1 with the host aligner, then with `--mesh 1`, each unzipped byte
   for byte, with MB/s, ratio, `zip:align` seconds, the aligned share
   (SQBITMAP; the mesh run's must be > 0.5) and seed_align's launches (> 0
   with --mesh, 0 without); 16 MiB of it with --mesh the same bytes from
   cuda and cpu; `zip --dp 2` of phase 4's FASTQ equal to phase 4's
   archive; ShardedZipEncoder and ShardedPizDecoder on 4 x cuda:0 against
   4 CPU devices; `piz_file_dp(dp=4)` of phase 4's archive byte for byte,
   with MB/s; `zip --hosts 2` of 32 MiB of it (two worker processes on the
   card) equal to zip_file's; the flagship step on the card equal to its
   CPU run, and scaling_bench.py's line for one card. Every rANS kernel's
   launches over the phase must be > 0.
12. host: the port's C++ host runtime (genozip_tpu_torch/native, built by
   g++ in setup): g++'s version, the build's seconds, the host CPU and
   whether its AVX-512 rANS cores run; each function held to its numpy
   version (exact) with the host ms per call both ways: `bam_scan`, the
   SEQ nibble expansion and its inverse and the tokenizer over phase 7's
   BAM; the sample-cell split, the AD/PL int lists, the cell join and
   the PBWT on one 16 MiB VB of phase 9's VCF; rANS (also its scalar
   coder), ARITH, PACK, ACGT and the byte histogram on 300 payloads of
   64 B-256 KiB drawn from a cfg3 FASTQ's names, SEQ and QUAL; and the
   row counts at which dedup and a range copy gain from the runtime.

13. devfns: the device functions genozip_tpu leaves to XLA and no CLI
   command of either package calls (arith_jax, X6; pbwt_*_jnp, X5). The
   slice's main path, with the launch counts set to 0 before it: the ARITH
   entry points (`arith_cuda.encode_many`/`decode_many`, both orders) on
   R = 8 streams of 256 KiB from cfg3 (4 raw QUAL, 4 packed SEQ: the
   streams ARITH1 competes for) and the PBWT ones
   (`pbwt.pbwt_encode_torch`/`decode_torch`) on one cfg1 VB's GT matrix
   (H = 400); each of the four kernels must launch. Then ARITH at n in
   {0, 1, 100, 4095, 4096, 262143, 262144, 1 MiB}, both orders, with the
   chosen lanes and N = 16, 64, 256, 1024 (one launch a case each way):
   every stream decodes on the card and equals native.arith_encode's
   (chosen lanes), arith_np's (K <= 1024) and the plain version's on the
   card (K <= 128); drifting streams whose model halves every 3rd step
   (N = 256) and every step (N = 1024); the main batch against the plain
   version on the card (exact) and timed through the wrappers, through
   the C entry points alone and against each step's chain floor
   (`arith_step_floor`); the PBWT kernels against their plain version and
   the host runtime on the cfg1 VB, on 512 x 5008 haplotypes (the 2,504
   diploid samples of 1000 Genomes phase 3; perm in global memory), at
   H = 1 and n = 0, timed with the row's chain floor (`pbwt_row_floor`).
   After the run, the ARITH and PBWT launches of every CLI phase must be 0.
   Phase 4 also prints the host runtime's ARITH calls (calls, bytes,
   seconds) during its zip and unzip beside `zip:compress-local` and
   `zip:merge+write`, and phase 10's --best children print theirs.

They run in the order 2, 2b, 5, 12, 13, 3-4, 6, 11, 7-10, so every phase
after phase 12 runs with the host runtime on its path. The inputs of phases 7-9 are
written in a child process (`InputWriter`, numpy on the host) while phases
2, 2b and 5 keep the card busy; phase 3 starts when it is done. Each
phase's seconds and the total are printed.

Neither jax, nor any module of the JAX package genozip_tpu, nor
cryptography may have been imported. The last two lines are a JSON object
with the numbers of all sixteen TPU kernels' counterparts, of the AES
kernel, of the seed aligner kernel and of the four ARITH and PBWT kernels
(phase 13's main path gives their launches; `launches_cli` is 0) (time,
plain time, the bound: bytes
at 3.35 TB/s or 32-bit integer operations at 16.7 T/s, whichever is
larger; launches on the cfg4, cfg3, cfg5, deep, cfg1, cfg2, phase 10 and
phase 11 paths; seed_align's on phase 11's --mesh run; `ms` through the
wrapper for every kernel, and for the AES and seed aligner kernels also
`ms_alone`, the kernel alone) and
{"ok": true,
"device": {...}}. Needs no network; writes under a temporary directory
that it removes.
"""

import argparse
import contextlib
import ctypes
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MIB = 1 << 20
R = 8
# a 16 MiB VB of cfg3 holds 16 MiB / 342 B ~ 49k records of 150 bases, so its
# packed SEQ and its packed 4-bin QUAL are each ~1.84 MB; ACGT and PACK1 hand
# each of them to the kernel alone (R = 1)
VB_STREAM = 16 * MIB // 342 * 150 // 4
KERNEL_ROWS = [  # name, order, encode?
    ("rans_encode_o0", 0, True), ("rans_decode_o0", 0, False),
    ("rans_encode_o1", 1, True), ("rans_decode_o1", 1, False),
]
PALLAS = "genozip_tpu/ops/rans_pallas.py:"
# the sixteen TPU kernels: (device fn line, port kernel, entry point, the
# measurement of phase 2 or 5 that times it)
TPU_ROWS = [
    (1764, "rans_encode_o0", "encode_many", "main"),
    (1391, "rans_decode_o0", "decode_many", "main"),
    (1925, "rans_encode_o1", "encode_many", "palette"),
    (1603, "rans_decode_o1", "decode_many", "palette"),
    (3108, "rans_encode_o1", "encode_many", "main"),
    (2908, "rans_decode_o1", "decode_many", "main"),
    (1231, "rans_decode_o0", "decode_many", "vb"),
    (2466, "rans_encode_o0", "encode_many(n_lanes=1024)", "entry_many"),
    (2677, "rans_encode_o0", "encode", "entry"),
    (377, "rans_decode_o0", "decode", "entry"),
    (350, "rans_decode_o0", "decode", "entry"),
    (769, "rans_decode_o0", "decode", "entry"),
    (743, "rans_decode_o0", "decode", "entry"),
    (717, "rans_decode_o0", "decode", "entry"),
    (883, "rans_decode_o1", "decode_order1", "entry"),
    (1008, "rans_encode_o1", "encode_order1", "entry"),
]
ENTRY_N = (100, 517, 33000, 131072, 200000)
CHR20_BP = 64_444_167     # GRCh38 chr20, the cfg4 genome's length
# input sizes of phases 7-9 in MiB, shared by the phases and `InputWriter`
# (cfg5 and the long reads were 64 MiB until phase 10 joined the smoke)
CFG5_MIB, SAM_MIB, SMALL_MIB, LONGREAD_MIB, CFG1_MIB = 32, 16, 16, 16, 64
BAMASS_GENOME, CFG1_REF_BP = 4 << 20, 8 << 20
ENTRY_LANES = (128, 256, 1024)
QUALS = np.frombuffer(b"FFFFF:F,#AB!x", np.uint8)
HBM_BPS = 3.35e12         # H100 SXM device memory, bytes/s
# H100 SXM 32-bit integer operations a second: 64 INT32 lanes an SM a clock
# x 132 SMs x 1.98 GHz (the kernels' shifts, xors, adds, compares, lookups)
INT_OPS = 16.7e12
OPS_PER_SYMBOL = 10       # table lookup, multiply-add, compare, rank, store


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warm=True):
    """Mean ms per call of fn() on the current stream, after one warm-up
    call (unless `warm` is False: fn has just run)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, launches=20, reps=5):
    """Mean ms per call of fn() replayed from a CUDA graph of `launches`
    calls (after one warm-up call outside it): the card's time alone, with
    no host work between launches. fn launches on the current stream."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    return cuda_ms(g.replay, reps) / launches


def main_path_streams(rng, sizes, raw_qual=False):
    """Streams of the given sizes of 2-bit packed SEQ (order 0) and 2-bit
    packed 4-bin QUAL (order 1), as ACGT and PACK1 hand them to rANS; with
    `raw_qual` the QUAL streams are the quality text itself (4 symbols)."""
    from genozip_tpu_torch import synth
    from genozip_tpu_torch.ops import pack
    g = synth.genome(rng, 16 * MIB)
    seqs, quals = [], []
    for nbytes in sizes:
        reads = nbytes * 4 // 150 + 1
        starts = rng.integers(0, g.shape[0] - 150, reads)
        s = g[starts[:, None] + np.arange(150)[None, :]].reshape(-1)
        seqs.append(pack.pack_np(pack.BASE2BIT[s], 2)[:nbytes].tobytes())
        q = synth.qual_rows(rng, reads, 150).reshape(-1)
        if raw_qual:
            quals.append(q[:nbytes].tobytes())
            continue
        codes = np.searchsorted(np.array([35, 45, 56, 70]), q).astype(np.uint8)
        quals.append(pack.pack_np(codes, 2)[:nbytes].tobytes())
    return seqs, quals


def edge_streams(rng):
    """n = 0, n < N, n not a multiple of N, one symbol, 256 symbols."""
    q = np.frombuffer(b"FFFF:F,#ABx", np.uint8)
    out = [rng.choice(q, s).tobytes() for s in (0, 1, 15, 17, 1000, 70001)]
    return out + [b"\x07" * 5000, rng.integers(0, 256, 300000, np.uint8).tobytes()]


def stream_bytes(datas, bufs, tab_bytes):
    """Bytes a coder must move: the symbols, the coded streams and the
    tables, each once."""
    return sum(map(len, datas)) + sum(map(len, bufs)) + tab_bytes


def bound_ms(nbytes, ops):
    """Least time on the card: bytes over 3.35 TB/s against 32-bit integer
    operations over 16.7 T/s (INT_OPS); returns (ms, "bytes" |
    "operations")."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / INT_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_kernel(name, order, is_enc, datas, lanes, time_plain=True, reps=5):
    """Run kernel `name` and its plain version on the card on the same
    inputs; fail unless they agree byte for byte (and a decode gives back
    `datas`). Returns (max_abs_err, kernel ms, plain ms, bytes moved,
    symbols); an encoder's ms is its C entry point's on buffers allocated
    once, a decoder's its wrapper's."""
    from genozip_tpu_torch.ops import rans_cuda, rans_torch as rt
    kfn = getattr(rans_cuda, name)
    if is_enc:
        b = rt.prepare_encode(datas, order, lanes)
        dev = [t.cuda() for t in (b.data, b.meta, b.tab)]

        def kern():
            return kfn(*dev, b.n_words, b.n_states)

        def plain():
            return rt.encode_plain(order, *dev, b.n_words, b.n_states)
        kw, kp, ks = kern()
        pw, pp, ps = plain()
        torch.cuda.synchronize()
        got = rt.finish_encode(b, kw, kp, ks)
        want = rt.finish_encode(b, pw, pp, ps)
        err = max(int((kp - pp).abs().max()) if kp.numel() else 0,
                  int((ks.long() - ps.long()).abs().max()) if ks.numel() else 0)
        nbytes = stream_bytes(datas, got, b.tab.numel() * 4)
        # the encoders take tens of microseconds on the card, less than the
        # wrapper's host work (allocations, checks, six launch calls), so
        # they are timed through their C entry point on buffers allocated
        # once; the result is checked against the wrapper's
        n = len(b.data)
        work = torch.empty(rans_cuda.encode_work_bytes(order, len(datas), n),
                           dtype=torch.uint8, device="cuda")
        outs = (torch.empty_like(kw), torch.empty_like(kp),
                torch.empty_like(ks))
        args = [t.data_ptr() for t in dev] + [work.data_ptr()] + \
            [t.data_ptr() for t in outs]
        stream = torch.cuda.current_stream().cuda_stream

        def timed():
            rc = getattr(rans_cuda.lib(), name)(*args, len(datas), n, stream)
            if rc:
                raise SystemExit(f"{name}: CUDA error {rc}")
        timed()
        torch.cuda.synchronize()
        if rt.finish_encode(b, *outs) != got:
            raise SystemExit(f"{name}: C entry point differs from the wrapper")
    else:
        bufs = rans_cuda.encode_many(datas, order, "cuda", lanes)
        d = rt.prepare_decode(bufs)
        ddev = [t.cuda() for t in (d.words, d.meta, d.tab)]

        def kern():
            return kfn(*ddev, d.n_out)

        def plain():
            return rt.decode_plain(order, *ddev, d.n_out)
        ko, po = kern(), plain()
        timed = kern
        torch.cuda.synchronize()
        got, want = rt.finish_decode(d, ko), rt.finish_decode(d, po)
        err = int((ko.long() - po.long()).abs().max()) if ko.numel() else 0
        if got != datas:
            raise SystemExit(f"{name}: decode differs from input")
        nbytes = stream_bytes(datas, bufs, d.tab.numel() * 4)
    if got != want or err:
        raise SystemExit(f"{name}: kernel differs from plain "
                         f"(max_abs_err {err})")
    ms = cuda_ms(timed, reps) if reps else None
    # plain() ran above for the comparison: that was its warm-up
    pms = cuda_ms(plain, 1, warm=False) if time_plain and reps else None
    return err, ms, pms, nbytes, sum(map(len, datas))


def phase_kernels(rng):
    """Phase 2. Returns {(kernel name, label): (max_abs_err, ms, plain ms)}
    for the timed labels."""
    seqs, quals = main_path_streams(
        rng, [int(rng.integers(1 * MIB, 4 * MIB + 1)) for _ in range(R)])
    _, raw = main_path_streams(
        rng, [int(rng.integers(1 * MIB, 4 * MIB + 1)) for _ in range(R)],
        raw_qual=True)
    one_seq, one_qual = main_path_streams(rng, [VB_STREAM])
    edges = edge_streams(rng)
    meas = {}
    for name, order, is_enc in KERNEL_ROWS:
        main = seqs if order == 0 else quals
        one = one_seq if order == 0 else one_qual
        cases = [("main", main, None), ("vb", one, None)]
        if order == 1:
            cases.append(("palette", raw, None))
        cases += [("edge", edges, None)] + [
            (f"edge{N}", edges, N) for N in (16, 64, 1024, 8192)]
        for label, datas, lanes in cases:
            timed = label in ("main", "vb", "palette")
            m = check_kernel(name, order, is_enc, datas, lanes,
                             reps=5 if timed else 0)
            err, ms, pms = m[:3]
            log(f"kernel {name} {label}: R={len(datas)} equal to plain, "
                f"max_abs_err {err}")
            if not timed:
                continue
            meas[(name, label)] = m
            mb = sum(map(len, datas)) / 1e6
            if label == "vb":
                bms, by = bound_ms(m[3], m[4] * OPS_PER_SYMBOL)
                log(f"kernel {name}: {ms:.3f} ms ({mb / ms:.2f} GB/s of "
                    f"symbols) at R=1, one {mb:.2f} MB VB stream (main path), "
                    f"plain {pms:.3f} ms, bound {bms:.6f} ms ({by}, "
                    f"{m[3]} bytes)")
            else:
                log(f"kernel {name} {label}: {ms:.3f} ms ({mb / ms:.1f} GB/s "
                    f"of symbols), plain {pms:.3f} ms, R={R}, {mb:.1f} MB")
    # a refhash-sized stream, as the reference load decodes: the 2^24-slot,
    # two-layer u32 seed table of a cfg4 genome (134 MB, N = 8192, R = 1)
    rh = refhash_like(rng)
    m = check_kernel("rans_decode_o0", 0, False, [rh], None, time_plain=False,
                     reps=2)
    log(f"kernel rans_decode_o0 refhash: R=1 {len(rh) / 1e6:.1f} MB at "
        f"N=8192 equal to plain; {m[1]:.3f} ms")
    return meas


def refhash_like(rng):
    """134,217,728 bytes shaped like a refhash: u32 genome positions below
    2^26, a third of the slots empty (0xFFFFFFFF)."""
    g = rng.integers(0, 1 << 26, 1 << 25, dtype=np.uint32)
    g[rng.random(1 << 25) < 1 / 3] = 0xFFFFFFFF
    return g.astype("<u4").tobytes()


def phase_entry(rng):
    """Phase 5: the single-stream entry points and the fixed-lane
    encode_many on the card, each against its plain version on the card and
    the input; then kernel and plain times at one VB stream at N = 1024.
    Returns {(kernel name, label): (max_abs_err, ms, plain ms)}."""
    from genozip_tpu_torch.ops import rans_cuda, rans_torch as rt

    def plain_encode(data, order, lanes):
        b = rt.prepare_encode([data], order, lanes)
        out = rt.encode_plain(order, *(t.cuda() for t in (b.data, b.meta,
                                                           b.tab)),
                              b.n_words, b.n_states)
        return rt.finish_encode(b, *out)[0]

    def plain_decode(buf):
        d = rt.prepare_decode([buf])
        out = rt.decode_plain(d.order, *(t.cuda() for t in (
            d.words, d.meta, d.tab)), d.n_out)
        return rt.finish_decode(d, out)[0]

    fns = ((0, rans_cuda.encode, rans_cuda.decode),
           (1, rans_cuda.encode_order1, rans_cuda.decode_order1))
    n_checked = 0
    for n in ENTRY_N:
        data = rng.choice(QUALS, n).tobytes()
        for lanes in ENTRY_LANES:
            for order, enc, dec in fns:
                buf = enc(data, n_lanes=lanes, device="cuda")
                if buf != plain_encode(data, order, lanes):
                    raise SystemExit(f"entry order-{order} encode n={n} "
                                     f"N={lanes}: differs from plain")
                out = dec(buf, device="cuda")
                if out != data or plain_decode(buf) != data:
                    raise SystemExit(f"entry order-{order} decode n={n} "
                                     f"N={lanes}: differs from the input")
                n_checked += 1
    seqs, _ = main_path_streams(rng, [int(rng.integers(1 * MIB, 4 * MIB + 1))
                                      for _ in range(R)])
    many = rans_cuda.encode_many(seqs, 0, "cuda", n_lanes=1024)
    if many != [plain_encode(d, 0, 1024) for d in seqs]:
        raise SystemExit("entry encode_many(n_lanes=1024): differs from plain")
    log(f"entry: encode/decode/encode_order1/decode_order1 equal to plain "
        f"and the input at {n_checked} (n, N, order) cases; "
        f"encode_many(n_lanes=1024) equal to plain at R={R}")
    meas = {("rans_encode_o0", "entry_many"): check_kernel(
        "rans_encode_o0", 0, True, seqs, 1024)}
    one_seq, one_qual = main_path_streams(rng, [VB_STREAM])
    for name, order, is_enc in KERNEL_ROWS:
        datas = one_seq if order == 0 else one_qual
        meas[(name, "entry")] = m = check_kernel(name, order, is_enc, datas,
                                                 1024)
        log(f"entry {name}: {m[1]:.3f} ms, plain {m[2]:.3f} ms, one "
            f"{len(datas[0]) / 1e6:.2f} MB VB stream at N=1024")
    return meas


def run_cli(args, capture=False):
    """Run the port's CLI in this process; returns its stdout bytes when
    `capture`."""
    from genozip_tpu_torch.cli import main
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, write_through=True)
    with contextlib.redirect_stdout(out) if capture else contextlib.nullcontext():
        rc = main(args)
    out.flush()
    val = buf.getvalue()
    out.detach()
    if rc != 0:
        raise SystemExit(f"cli {args[0]} exited {rc}")
    return val


def same_file(a, b):
    return subprocess.run(["cmp", "-s", a, b]).returncode == 0


def zip_cuda_cpu(srcs, stem, extra, what):
    """`zip` of `srcs` with --device cuda, then with --device cpu, into
    `stem`.cuda.gxz and `stem`.cpu.gxz; fail unless the two archives are the
    same bytes. Returns ({device: archive}, {device: zip seconds})."""
    zs, ts = {}, {}
    for dev in ("cuda", "cpu"):
        zs[dev] = f"{stem}.{dev}.gxz"
        t = time.time()
        run_cli(["zip", *srcs, "-o", zs[dev], "--device", dev, "-q", *extra])
        ts[dev] = time.time() - t
    if not same_file(zs["cuda"], zs["cpu"]):
        raise SystemExit(f"{what}: CUDA and CPU archives differ")
    return zs, ts


def head_records(path, k):
    with open(path, "rb") as f:
        return b"".join(f.readline() for _ in range(4 * k))


def write_input(path, write, *a, **kw):
    """Write the input file `path` of a phase with `write(path, *a, **kw)`,
    unless it is there already (`InputWriter` wrote it); returns its
    bytes."""
    if not os.path.exists(path):
        t = time.time()
        write(path, *a, **kw)
        log(f"input {os.path.basename(path)}: written in "
            f"{time.time() - t:.1f} s")
    return os.path.getsize(path)


def chr1_genome(ref_bp):
    """Phase 9's genome, whose one contig is named chr1."""
    from genozip_tpu_torch import synth
    return synth.genome(np.random.default_rng(91), ref_bp)


def _write_ref_vcf(path, nbytes, ref_bp):
    from genozip_tpu_torch import synth
    synth.write_vcf(path, nbytes, seed=17, chrom=b"1",
                    genome=chr1_genome(ref_bp))


OTHER_DATATYPES = [  # phase 9: datatype, file name, synth writer, zip options
    ("gff", "genes.gff3", "write_gff", []),
    ("bed", "peaks.bed", "write_bed", []),
    ("me23", "genome_23andme.txt", "write_me23", []),
    ("locs", "s_1_1101.locs", "write_locs", []),
    ("generic", "server.log", "write_generic", ["--input-type", "generic"])]


def phase_inputs(phase, tmp, bam_mib=CFG5_MIB, sam_mib=SAM_MIB,
                 small_mib=SMALL_MIB, longread_mib=LONGREAD_MIB,
                 bamass_genome=BAMASS_GENOME, vcf_mib=CFG1_MIB,
                 ref_bp=CFG1_REF_BP):
    """The input files of phase 7 (cfg5), 8 (cfg5x) or 9 (cfg1) as
    `write_input` arguments: (path, writer, *args, {keywords})."""
    from genozip_tpu_torch import synth
    j = os.path.join
    if phase == "cfg5":
        bam, sam = j(tmp, "cfg5.bam"), j(tmp, "cfg5.sam")
        return [(bam, synth.write_deep_fastq, bam + ".R1.fastq",
                 bam + ".R2.fastq", bam_mib * MIB,
                 dict(seed=5, sam_path=bam + ".sam")),
                (sam, synth.write_sam, sam_mib * MIB,
                 dict(seed=5, bam_path=sam + ".bamstream"))]
    if phase == "cfg5x":
        b16 = j(tmp, "d16.bam")
        return [(b16, synth.write_deep_fastq, j(tmp, "d16.R1.fastq"),
                 j(tmp, "d16.R2.fastq"), small_mib * MIB,
                 dict(seed=7, genome_len=bamass_genome,
                      sam_path=b16 + ".sam")),
                (j(tmp, "longread.sam"), synth.write_longread_sam,
                 longread_mib * MIB, dict(seed=9, genome_len=8 << 20))]
    assert phase == "cfg1", phase
    return [(j(tmp, "cfg1.vcf"), synth.write_vcf, vcf_mib * MIB,
             dict(seed=9)),
            (j(tmp, "cfg1_16.vcf"), synth.write_vcf, small_mib * MIB,
             dict(seed=16)),
            (j(tmp, "cfg1_ref.vcf"), _write_ref_vcf, small_mib * MIB, ref_bp,
             {})] + [(j(tmp, name), getattr(synth, writer), small_mib * MIB,
                      dict(seed=19))
                     for _, name, writer, _ in OTHER_DATATYPES]


def write_inputs(phase, tmp, **sizes):
    """`write_input` of each of `phase_inputs(phase, tmp, **sizes)`."""
    for path, write, *a, kw in phase_inputs(phase, tmp, **sizes):
        write_input(path, write, *a, **kw)


def _write_inputs(tmp, phases, threads):
    from genozip_tpu_torch import synth
    synth._GEN_THREADS = threads
    for phase in phases:
        write_inputs(phase, tmp)


class InputWriter:
    """Writes the inputs of phases 7-9 (numpy on the host, nothing on the
    card) in a child process, started before phase 2 so that it runs beside
    the card-bound phases 2, 2b and 5 on all but two of the host's cores;
    `wait` before a phase reads them."""

    def __init__(self, tmp, phases):
        import multiprocessing
        todo = [p for p in ("cfg5", "cfg5x", "cfg1") if p in phases]
        self.proc = None
        if todo:
            ctx = multiprocessing.get_context("spawn")
            self.proc = ctx.Process(target=_write_inputs, args=(
                tmp, todo, max(1, (os.cpu_count() or 4) - 2)))
            self.proc.start()

    def wait(self):
        if self.proc is None:
            return
        self.proc.join()
        rc, self.proc = self.proc.exitcode, None
        if rc != 0:
            raise SystemExit(f"the input writer exited {rc}")

    def stop(self):
        if self.proc is not None and self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()


HOST_PAYLOADS = 300           # codec payloads drawn from cfg3's streams
HOST_MAX_PAYLOAD = 256 * 1024  # the device threshold: larger go to kernels
HOST_ARITH_MAX = 64 * 1024     # the numpy arith coder is slow beyond this
# ARITH has no device route: a few payloads past HOST_ARITH_MAX, up to 1 MiB
HOST_ARITH_LARGE = (96 * 1024, 256 * 1024, 512 * 1024, 1024 * 1024)


class HostTimes:
    """Calls and seconds of each host function through the C++ runtime
    and through its numpy version, for the per-call lines."""

    def __init__(self):
        self.t = {}

    def both(self, name, native_fn, numpy_fn, same=None):
        """Run both routes; fail unless their results are equal (`same`
        compares them, default ==). Returns the runtime's result."""
        t = time.perf_counter()
        got = native_fn()
        tn = time.perf_counter() - t
        t = time.perf_counter()
        ref = numpy_fn()
        tp = time.perf_counter() - t
        ok = same(got, ref) if same else got == ref
        if not ok:
            raise SystemExit(f"host {name}: the C++ runtime and numpy differ")
        c = self.t.setdefault(name, [0, 0.0, 0.0])
        c[0] += 1
        c[1] += tn
        c[2] += tp
        return got

    def scalar(self, name, fn, want):
        """The rANS scalar coder's run (a NO_AVX512 build), held to the
        runtime's bytes `want`."""
        t = time.perf_counter()
        if fn() != want:
            raise SystemExit(f"host {name}: the scalar coder and the runtime "
                             f"differ")
        c = self.t.setdefault(name, [0, 0.0, None])
        c[0] += 1
        c[1] += time.perf_counter() - t

    def report(self, smi):
        for name, (n, tn, tp) in self.t.items():
            ref = f"{1e3 * tp / n:.4f} ms/call numpy, " \
                f"{tp / max(tn, 1e-9):.1f}x" if tp is not None else \
                "the runtime's bytes"
            log(f"host {name}: {n} calls, {1e3 * tn / n:.4f} ms/call C++, "
                f"{ref} (host CPU, beside {smi})")


def _arrays_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x, y) for x, y in zip(a, b))


def _cols_equal(a, b):
    return a.data.tobytes() == b.data.tobytes() and \
        np.array_equal(a.offsets, b.offsets)


def _fastq_streams(path):
    """A cfg3 FASTQ's names, SEQ and QUAL, each as one stream."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return [b"\n".join(lines[k::4]) for k in (0, 1, 3)]


def _host_codecs(ht, rng, streams, scalar):
    """The codecs' host functions on HOST_PAYLOADS payloads under the
    device threshold drawn from cfg3's streams: names (RANS1, ARITH1), SEQ
    (ACGT, RANS0) and QUAL (RANS0/1, PACK, ARITH0/1); rANS also through the
    scalar coder (`scalar`, a NO_AVX512 build); then ARITH0/1 of names and
    QUAL at HOST_ARITH_LARGE."""
    from genozip_tpu_torch import native
    from genozip_tpu_torch.ops import arith_np, pack, rans_np
    for i, n in enumerate(HOST_ARITH_LARGE):
        src = streams[0 if i % 2 else 2]
        at = int(rng.integers(0, max(1, len(src) - n)))
        d = src[at:at + n]
        for o in (0, 1):
            ab = ht.both(f"arith_encode o{o} (64 KiB-1 MiB)",
                         lambda: native.arith_encode(d, o),
                         lambda: arith_np.encode(d, order=o))
            ht.both(f"arith_decode o{o} (64 KiB-1 MiB)",
                    lambda: native.arith_decode(ab),
                    lambda: arith_np.decode(ab))
    for i in range(HOST_PAYLOADS):
        kind = i % 3
        src = streams[kind]
        n = int(np.exp(rng.uniform(np.log(64), np.log(HOST_MAX_PAYLOAD))))
        at = int(rng.integers(0, max(1, len(src) - n)))
        d = src[at:at + n]
        a = np.frombuffer(d, np.uint8)
        orders = (1,) if kind == 0 else ((0,) if kind == 1 else (0, 1))
        for o in orders:
            blob = ht.both(f"rans_encode o{o}",
                           lambda: native.rans_encode(d, o),
                           lambda: rans_np.encode(d, order=o))
            ht.scalar(f"rans_encode o{o} scalar",
                      lambda: native.rans_encode(d, o, so=scalar), blob)
            ht.both(f"rans_decode o{o}", lambda: native.rans_decode(blob),
                    lambda: rans_np.decode(blob))
            ht.scalar(f"rans_decode o{o} scalar",
                      lambda: native.rans_decode(blob, so=scalar), d)
            if n <= HOST_ARITH_MAX and (kind != 1) and i % 2 == 0:
                ab = ht.both(f"arith_encode o{o}",
                             lambda: native.arith_encode(d, o),
                             lambda: arith_np.encode(d, order=o))
                ht.both(f"arith_decode o{o}", lambda: native.arith_decode(ab),
                        lambda: arith_np.decode(ab))
        hist = ht.both("byte_hist", lambda: native.byte_hist(a),
                       lambda: np.bincount(a, minlength=256),
                       np.array_equal)
        if kind == 1:
            pk = ht.both("acgt_pack", lambda: native.acgt_pack(a),
                         lambda: pack.seq_pack_2bit(a), _arrays_equal)
            ht.both("acgt_unpack",
                    lambda: native.acgt_unpack(pk[0], n, pk[1], pk[2]),
                    lambda: pack.seq_unpack_2bit(pk[0], n, pk[1], pk[2]),
                    np.array_equal)
        syms = np.nonzero(hist)[0].astype(np.uint8)
        if kind == 2 and syms.shape[0] <= 16:
            width = 1 if syms.shape[0] <= 2 else (
                2 if syms.shape[0] <= 4 else 4)
            lut = np.zeros(256, np.uint8)
            lut[syms] = np.arange(syms.shape[0])
            packed = ht.both("pack_lut",
                             lambda: native.pack_lut(a, lut, width),
                             lambda: pack.pack_np(lut[a], width),
                             np.array_equal)
            ht.both("unpack_lut",
                    lambda: native.unpack_lut(packed, n, width, syms),
                    lambda: syms[pack.unpack_np(packed, width, n)],
                    np.array_equal)


def _bam_records(bam):
    """The alignment records of a BGZF BAM, decompressed, after its header
    and reference list."""
    import gzip
    with open(bam, "rb") as f:
        raw = gzip.decompress(f.read())
    l_text = int.from_bytes(raw[4:8], "little")
    off = 12 + l_text
    for _ in range(int.from_bytes(raw[8 + l_text:12 + l_text], "little")):
        off += 8 + int.from_bytes(raw[off:off + 4], "little")
    return np.frombuffer(raw, np.uint8)[off:]


def _host_bam(ht, bam):
    """bam_scan over a cfg5 BAM's records, then the SEQ nibble expansion
    and its inverse and the tokenizer on its read names."""
    from genozip_tpu_torch.datatypes.bam import BamDT, bam_scan, bam_scan_np
    from genozip_tpu_torch.seg import MAX_TOKENS, _tokenize_np, tokenize_col
    from genozip_tpu_torch.utils import ragged
    from genozip_tpu_torch.utils.ragged import Col
    recs = _bam_records(bam)
    off, consumed = ht.both("bam_scan", lambda: bam_scan(recs, 1 << 24),
                            lambda: bam_scan_np(recs, 1 << 24),
                            lambda a, b: np.array_equal(a[0], b[0])
                            and a[1] == b[1])
    if consumed != recs.shape[0]:
        raise SystemExit("host bam_scan: the chain does not end at the end")
    u8 = lambda k: recs[off + k].astype(np.int64)
    l_rn = u8(12)
    n_cig = u8(16) | (u8(17) << 8)
    l_seq = u8(20) | (u8(21) << 8) | (u8(22) << 16) | (u8(23) << 24)
    seq_at = off + 36 + l_rn + 4 * n_cig
    nb = (l_seq + 1) // 2
    seq = ragged.gather_ranges(recs, seq_at, nb)
    ascii_, _ok = ht.both("nib_expand", lambda: BamDT()._seq_ascii(seq, l_seq),
                          lambda: BamDT._seq_ascii_np(seq, l_seq),
                          lambda a, b: _cols_equal(a[0], b[0])
                          and np.array_equal(a[1], b[1]))
    ht.both("renibble", lambda: BamDT._renibble(ascii_),
            lambda: BamDT._renibble_np(ascii_), _cols_equal)
    names = ragged.gather_ranges(recs, off + 36, l_rn - 1)
    ht.both("tokenize", lambda: tokenize_col(names.data, names.offsets,
                                             MAX_TOKENS),
            lambda: _tokenize_np(names.data, names.offsets, MAX_TOKENS),
            _arrays_equal)
    return recs.shape[0], off.shape[0]


def _host_vcf(ht, vcf, vb_bytes):
    """The VCF helpers on the first `vb_bytes` of a cfg1 VCF (one VB): the
    per-tag split of the sample cells, the int lists of AD and PL (values,
    sums, GQ from PL), the cell join and the PBWT of the GT matrix."""
    from genozip_tpu_torch import native
    from genozip_tpu_torch.datatypes.vcf import VcfDT
    from genozip_tpu_torch.ops import pbwt
    from genozip_tpu_torch.utils import ragged
    from genozip_tpu_torch.utils.ragged import Col
    with open(vcf, "rb") as f:
        text = f.read(vb_bytes)
    lines = [ln for ln in text[:text.rindex(b"\n")].split(b"\n")
             if ln and not ln.startswith(b"#")]
    rows = [ln.split(b"\t") for ln in lines]
    S = len(rows[0]) - 9
    tags = rows[0][8].split(b":")
    cells = Col.from_list([c for r in rows for c in r[9:]])
    T = len(tags)
    ncnt, bad, sel_by_t, vals_by_t = ht.both(
        "split_fields", lambda: VcfDT._cell_fields(cells, T),
        lambda: VcfDT._cell_fields_np(cells, T),
        lambda a, b: np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        and all(np.array_equal(a[2][t], b[2][t]) and _cols_equal(a[3][t],
                                                                b[3][t])
                for t in b[2]) and sorted(a[2]) == sorted(b[2]))
    for tag in (b"AD", b"PL"):
        col = vals_by_t[tags.index(tag)]
        ht.both("int_list_parse", lambda: VcfDT._comma_ints(col),
                lambda: VcfDT._comma_ints_np(col),
                lambda a, b: np.array_equal(a[3], b[3]) and
                np.array_equal(a[0], b[0][b[3][b[1]]]))
        for name, fn, ref in (("int_list_stats (sums)", VcfDT._ad_sums,
                               VcfDT._ad_sums_np),
                              ("int_list_stats (GQ)", VcfDT._pl_gq,
                               VcfDT._pl_gq_np)):
            ht.both(name, lambda: fn(col), lambda: ref(col), _arrays_equal)
    total = int(ncnt.sum())
    sub_off = np.concatenate([[0], np.cumsum(ncnt)])
    subs = ragged.merge_rows(total, [(sub_off[:-1][sel_by_t[t]] + t,
                                      vals_by_t[t]) for t in sel_by_t])
    joined = ht.both("join_cells",
                     lambda: Col(*native.join_cells(subs.data, subs.offsets,
                                                    ncnt, ord(":"))),
                     lambda: VcfDT._join_cells_np(subs, sub_off, ncnt,
                                                  len(cells)), _cols_equal)
    if joined.data.tobytes() != cells.data.tobytes():
        raise SystemExit("host join_cells: the cells do not come back")
    gt = vals_by_t[tags.index(b"GT")]
    if not (gt.lens == 3).all():
        raise SystemExit("host pbwt: cfg1's GT cells are not diploid")
    g = gt.data.reshape(-1, 3)
    A = np.stack([g[:, 0], g[:, 2]], 1).reshape(len(rows), 2 * S) - ord("0")
    A = A.astype(np.uint8)
    Y = ht.both("pbwt_encode", lambda: pbwt.pbwt_encode(A),
                lambda: pbwt.pbwt_encode_np(A), np.array_equal)
    ht.both("pbwt_decode", lambda: pbwt.pbwt_decode(Y),
            lambda: pbwt.pbwt_decode_np(Y), np.array_equal)
    return len(rows), S


def _per_call_us(fn, reps):
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e6 * (time.perf_counter() - t) / reps


def _host_thresholds(rng, smi):
    """Where a ragged call is worth the runtime, through it and in numpy:
    the whole dedup_col of n short words, the VCF cell join of n subfields
    into n / 2 cells, and a range copy (a gather) of n rows of 1-16 bytes
    (VCF cells, SAM fields) and of 150 (SEQ). The port takes the runtime for
    dedup and the join at every size, and for a copy from
    ragged.NATIVE_MIN_BYTES bytes."""
    from genozip_tpu_torch import contexts, native
    from genozip_tpu_torch.datatypes.vcf import VcfDT
    from genozip_tpu_torch.utils import ragged
    from genozip_tpu_torch.utils.ragged import Col
    for n in (8, 64, 256, 1024, 4096):
        words = Col.from_list([b"%dM" % int(rng.integers(1, 151))
                               for _ in range(n)])
        nsub = np.full(n // 2, 2, np.int64)
        sub_off = np.concatenate([[0], np.cumsum(nsub)])
        reps = max(20, 20000 // n)
        us = lambda fn: f"{_per_call_us(fn, reps):.1f}"
        join = lambda: Col(*native.join_cells(words.data, words.offsets,
                                              nsub, ord(":")))
        join_np = lambda: VcfDT._join_cells_np(words, sub_off, nsub, n // 2)
        res = [f"dedup_col C++ {us(lambda: contexts.dedup_col(words))} "
               f"numpy {us(lambda: contexts.dedup_col_np(words))}",
               f"join of {n // 2} cells C++ {us(join)} numpy {us(join_np)}"]
        for lo, hi in ((1, 17), (150, 151)):
            lens = rng.integers(lo, hi, n)
            data = rng.integers(0, 256, int(lens.sum()) + 64 * n,
                                dtype=np.uint8)
            starts = rng.integers(0, 64 * n, n)
            res.append(
                f"gather of {int(lens.sum())} bytes C++ "
                f"{us(lambda: _gather_native(data, starts, lens))} numpy "
                f"{us(lambda: _gather_np(data, starts, lens))}")
        log(f"host threshold n={n}: " + ", ".join(res) + f" us/call "
            f"(NATIVE_MIN_BYTES {ragged.NATIVE_MIN_BYTES}; host CPU, beside "
            f"{smi})")


def _gather_native(data, starts, lens):
    from genozip_tpu_torch import native
    off = np.concatenate([[0], np.cumsum(lens)])
    out = np.empty(int(off[-1]), np.uint8)
    native.copy_ranges(data, starts, out, off[:-1], lens, packed=True)
    return out


def _gather_np(data, starts, lens):
    from genozip_tpu_torch.utils import ragged
    off = np.concatenate([[0], np.cumsum(lens)])
    total = int(off[-1])
    src = np.repeat(starts - off[:-1], lens) + ragged.arange(total)
    return data[src]


def phase_host(tmp, smi, bam, vcf, vb_mib=16):
    """Phase host: the port's C++ host runtime (genozip_tpu_torch/native)
    on this machine: g++'s version, the build's seconds, the host CPU and
    whether the AVX-512 rANS cores run; then each function against its
    numpy version (exact) at a cell's size, with its host ms per call both
    ways: bam_scan over cfg5's BAM records (and the SEQ nibbles, the read
    names' tokenizer), the VCF helpers on one cfg1 VB (`vb_mib`) and the
    PBWT of its GT matrix, the codecs on HOST_PAYLOADS payloads of cfg3's
    streams under the device threshold (rANS also through a build without
    the AVX-512 cores) and ARITH up to 1 MiB; the crossover of the ragged
    calls against numpy. `bam` and `vcf` are written here when no earlier
    step wrote them."""
    from genozip_tpu_torch import native, synth
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    with open("/proc/cpuinfo") as f:
        cpu = next((ln.split(":", 1)[1].strip() for ln in f
                    if ln.startswith("model name")), "unknown")
    L = native.lib()
    log(f"host: {gxx}; built in {native.build_seconds:.2f} s this process "
        f"(0.00: up to date); CPU {cpu}, {os.cpu_count()} cores; AVX-512 "
        f"cores compiled {bool(L.gxz_host_avx512_compiled())}, used "
        f"{native.avx512()}")
    scalar_so = os.path.join(native.BUILD_DIR, "libgxz_host_noavx512.so")
    t = native.build(scalar_so, native.CXXFLAGS + native.NO_AVX512)
    scalar = native.load(scalar_so)
    log(f"host: the build without the AVX-512 cores in {t:.2f} s")
    if native.xxh64(b"") != 0xEF46DB3751D8E999:
        raise SystemExit("host xxh64: not the XXH64 of the empty input")
    write_input(bam, synth.write_bam, 8 * MIB, seed=5)
    write_input(vcf, synth.write_vcf, vb_mib * MIB, seed=9)
    rng = np.random.default_rng(11)
    ht = HostTimes()
    nbytes, nrec = _host_bam(ht, bam)
    log(f"host bam: {nrec} records, {nbytes} bytes of BAM records")
    nrows, S = _host_vcf(ht, vcf, vb_mib * MIB)
    log(f"host vcf: one VB of {nrows} rows x {S} samples")
    fq = os.path.join(tmp, "host_streams.fastq")
    synth.write_fastq(fq, 16 * MIB, seed=3)
    _host_codecs(ht, rng, _fastq_streams(fq), scalar)
    os.remove(fq)
    ht.report(smi)
    _host_thresholds(rng, smi)


def phase_cfg3(tmp, smi, full_mib=128, host_mib=32, keep=False,
               keep_archive=False):
    """Phases 3 and 4. Returns the launch counts of the full run, its zip
    and unzip MB/s, and (with `keep`: phase 10 reuses it) the FASTQ; with
    `keep_archive` its archive stays at FASTQ.gxz (phase 11 reuses it)."""
    from genozip_tpu_torch import synth
    from genozip_tpu_torch.ops import rans_cuda
    from genozip_tpu_torch.utils import profiler
    # 3. device equals host
    fq = os.path.join(tmp, "reads_host.fastq")
    synth.write_fastq(fq, host_mib * MIB, seed=64)
    zs, ts = zip_cuda_cpu([fq], fq, [], "device equals host")
    log(f"device equals host: {host_mib} MiB archives equal "
        f"({os.path.getsize(zs['cuda'])} bytes; zip cuda {ts['cuda']:.1f} s, "
        f"cpu {ts['cpu']:.1f} s)")
    for p in (fq, *zs.values()):
        os.remove(p)

    # 4. full run
    fq = os.path.join(tmp, "reads.fastq")
    t = time.time()
    size = synth.write_fastq(fq, full_mib * MIB, seed=512)
    log(f"full run: generated {size} bytes in {time.time() - t:.1f} s")
    z, out = fq + ".gxz", fq + ".out"
    torch.cuda.synchronize()
    rans_cuda.reset_launches()
    profiler.reset()
    t = time.time()
    with arith_host_calls() as zcalls:
        run_cli(["zip", fq, "-o", z, "--device", "cuda", "-q"])
    tz = time.time() - t
    zreg = dict(profiler._totals)
    profiler.reset()
    t = time.time()
    with arith_host_calls() as ucalls:
        run_cli(["unzip", z, "-o", out, "--device", "cuda"])
    tu = time.time() - t
    ureg = dict(profiler._totals)
    head = run_cli(["cat", z, "--head", "1000", "--device", "cuda"], True)
    ls = run_cli(["ls", z], True).decode()
    torch.cuda.synchronize()
    counts = dict(rans_cuda.launches)
    if not same_file(fq, out):
        raise SystemExit("full run: unzip output differs from the input")
    if head != head_records(fq, 1000):
        raise SystemExit("full run: cat --head 1000 differs from the input")
    if str(size) not in ls.replace(",", ""):
        raise SystemExit(f"full run: ls does not show {size} bytes:\n{ls}")
    zsize = os.path.getsize(z)
    log(f"full run: zip {size / 1e6 / tz:.2f} MB/s ({tz:.1f} s), unzip "
        f"{size / 1e6 / tu:.2f} MB/s ({tu:.1f} s), ratio {size / zsize:.3f}, "
        f"on {smi}")
    log("full run: ls", ls.strip().splitlines()[-1])
    log(f"full run: launches {counts}")
    log(f"full run: zip {arith_host_line(zcalls)}; beside zip:compress-local"
        f" {zreg.get('zip:compress-local', 0.0):.3f} s and zip:merge+write "
        f"{zreg.get('zip:merge+write', 0.0):.3f} s (summed over threads), "
        f"wall {tz:.2f} s")
    log(f"full run: unzip {arith_host_line(ucalls)}; beside "
        f"piz:read+uncompress {ureg.get('piz:read+uncompress', 0.0):.3f} s, "
        f"wall {tu:.2f} s")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise SystemExit(f"full run: kernels never launched: {missing}")
    for p in [out] + ([] if keep else [fq]) + ([] if keep_archive else [z]):
        os.remove(p)
    return counts, (size / 1e6 / tz, size / 1e6 / tu), fq if keep else None


CFG4_REF, CFG4_R1 = "chr20like.ref.gxz", "cfg4_R1.fastq"   # under tmp


def phase_cfg4(tmp, smi, genome_bp=CHR20_BP, pair_mib=64, keep_r1=False):
    """Phase 6. Returns the launch counts of the paired run; with `keep_r1`
    the R1 FASTQ stays (phase 11 reuses it, and the reference, which always
    stays)."""
    from genozip_tpu_torch import synth
    from genozip_tpu_torch.ops import rans_cuda
    from genozip_tpu_torch.zip_pipeline import profiler
    rng = np.random.default_rng(20)
    t = time.time()
    g = synth.genome(rng, genome_bp)
    fa = os.path.join(tmp, "chr20like.fa")
    synth.write_fasta(fa, g)
    log(f"cfg4: {genome_bp} bp genome generated in {time.time() - t:.1f} s")
    ref = os.path.join(tmp, CFG4_REF)
    t = time.time()
    run_cli(["zip", "--make-reference", fa, "-o", ref, "--device", "cuda"],
            True)
    tref = time.time() - t
    log(f"cfg4: make-reference {tref:.1f} s -> {os.path.getsize(ref)} bytes")
    # the FASTA stays for phase 9, which zips it as a file (cfg2)

    r1, r2 = os.path.join(tmp, CFG4_R1), os.path.join(tmp, "cfg4_R2.fastq")
    t = time.time()
    size = synth.write_paired_fastq(r1, r2, g, pair_mib * MIB, seed=4)
    log(f"cfg4: generated 2 x {pair_mib} MiB ({size} bytes) in "
        f"{time.time() - t:.1f} s")
    z, out = os.path.join(tmp, "cfg4.gxz"), os.path.join(tmp, "cfg4.out")
    torch.cuda.synchronize()
    profiler.reset()
    rans_cuda.reset_launches()
    t = time.time()
    run_cli(["zip", r1, r2, "--pair", "--reference", ref, "-o", z,
             "--device", "cuda", "--vblock", "16", "-q"])
    tz = time.time() - t
    zip_regions = profiler.report()
    profiler.reset()
    t = time.time()
    run_cli(["unzip", z, "-o", out, "--reference", ref, "--device", "cuda"])
    tu = time.time() - t
    unzip_regions = profiler.report()
    head1 = run_cli(["cat", z, "--r1", "--head", "1000", "--reference", ref,
                     "--device", "cuda"], True)
    ilv = run_cli(["cat", z, "--interleave", "--head", "1000", "--reference",
                   ref, "--device", "cuda"], True)
    ls = run_cli(["ls", z], True).decode()
    torch.cuda.synchronize()
    counts = dict(rans_cuda.launches)
    for i, src in enumerate((r1, r2), start=1):
        if not same_file(src, f"{out}.{i}"):
            raise SystemExit(f"cfg4: unzip of component {i} differs")
    if head1 != head_records(r1, 1000):
        raise SystemExit("cfg4: cat --r1 --head 1000 differs from R1")
    a, b = head_records(r1, 500), head_records(r2, 500)
    la, lb = a.splitlines(keepends=True), b.splitlines(keepends=True)
    want = b"".join(b"".join(la[i:i + 4] + lb[i:i + 4])
                    for i in range(0, len(la), 4))
    if ilv != want:
        raise SystemExit("cfg4: cat --interleave --head 1000 differs")
    if str(size) not in ls.replace(",", ""):
        raise SystemExit(f"cfg4: ls does not show {size} bytes:\n{ls}")
    zsize = os.path.getsize(z)
    log(f"cfg4: make-reference {tref:.1f} s, zip --pair --reference "
        f"{size / 1e6 / tz:.2f} MB/s ({tz:.1f} s), unzip "
        f"{size / 1e6 / tu:.2f} MB/s ({tu:.1f} s), ratio {size / zsize:.3f}, "
        f"on {smi}")
    log("cfg4: zip --show-time regions:\n" + zip_regions)
    log("cfg4: unzip --show-time regions:\n" + unzip_regions)
    log("cfg4: ls", ls.strip().splitlines()[-1])
    log(f"cfg4: launches {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise SystemExit(f"cfg4: kernels never launched: {missing}")
    for p in ([] if keep_r1 else [r1]) + [r2, z, out + ".1", out + ".2"]:
        os.remove(p)

    # 2 x 16 MiB: device equals host, and --REFERENCE without --reference
    s1, s2 = os.path.join(tmp, "s_R1.fastq"), os.path.join(tmp, "s_R2.fastq")
    synth.write_paired_fastq(s1, s2, g, 16 * MIB, seed=16)
    zs, ts = zip_cuda_cpu([s1, s2], os.path.join(tmp, "s"), [
        "--pair", "--reference", ref, "--vblock", "16"], "cfg4: paired")
    for dev in zs:
        log(f"cfg4: 2 x 16 MiB zip --device {dev} {ts[dev]:.1f} s")
    zst = os.path.join(tmp, "s.stored.gxz")
    run_cli(["zip", s1, "--reference", ref, "--REFERENCE", "-o", zst,
             "--device", "cuda", "-q"])
    run_cli(["unzip", zst, "-o", zst + ".out", "--device", "cuda"])
    if not same_file(s1, zst + ".out"):
        raise SystemExit("cfg4: --REFERENCE archive did not unzip without "
                         "--reference")
    log(f"cfg4: 2 x 16 MiB archives equal from cuda and cpu "
        f"({os.path.getsize(zs['cuda'])} bytes); --REFERENCE archive "
        f"({os.path.getsize(zst)} bytes) unzipped without --reference")
    return counts


def _bam_txt_len(path):
    """Bytes of a BGZF file's uncompressed stream."""
    import gzip
    n = 0
    with gzip.open(path, "rb") as f:
        for chunk in iter(lambda: f.read(16 * MIB), b""):
            n += len(chunk)
    return n


def phase_cfg5(tmp, smi, bam_mib=CFG5_MIB, sam_mib=SAM_MIB):
    """Phase 7. Returns the launch counts of the BAM run (zip + unzip), and
    the files phase 8 reuses: the BAM, its archive, its records as SAM text
    and the R1/R2 FASTQ of its primaries; the SAM, its archive and its
    records as an uncompressed BAM stream."""
    from genozip_tpu_torch.ops import rans_cuda
    from genozip_tpu_torch.piz_pipeline import PizReader
    from genozip_tpu_torch.zip_pipeline import profiler
    bam = os.path.join(tmp, "cfg5.bam")
    files = {"bam": bam, "bam_sam": bam + ".sam", "r1": bam + ".R1.fastq",
             "r2": bam + ".R2.fastq"}
    write_inputs("cfg5", tmp, bam_mib=bam_mib, sam_mib=sam_mib)
    disk, txt = os.path.getsize(bam), _bam_txt_len(bam)
    log(f"cfg5: a {disk} byte BAM ({txt} bytes of BAM stream), its SAM text "
        f"({os.path.getsize(files['bam_sam'])} bytes) and the R1/R2 FASTQ of "
        f"its primaries ({os.path.getsize(files['r1'])} + "
        f"{os.path.getsize(files['r2'])} bytes)")
    z, out = bam + ".gxz", os.path.join(tmp, "cfg5.out.bam")
    torch.cuda.synchronize()
    profiler.reset()
    rans_cuda.reset_launches()
    t = time.time()
    run_cli(["zip", bam, "-o", z, "--device", "cuda", "--vblock", "16",
             "-q"])
    tz = time.time() - t
    zip_regions = profiler.report()
    profiler.reset()
    t = time.time()
    run_cli(["unzip", z, "-o", out, "--device", "cuda"])
    tu = time.time() - t
    unzip_regions = profiler.report()
    torch.cuda.synchronize()
    counts = dict(rans_cuda.launches)
    ls = run_cli(["ls", z], True).decode()
    if not same_file(bam, out):
        raise SystemExit("cfg5: unzip output differs from the input BAM")
    if str(txt) not in ls.replace(",", ""):
        raise SystemExit(f"cfg5: ls does not show {txt} bytes:\n{ls}")
    pr = PizReader(z)
    h = pr.file_hdr
    pr.close()
    if not (h["ref_internal"] and h["gencomp"] and h["mgzip"]["exact"]):
        raise SystemExit(f"cfg5: expected REF_INTERNAL, gencomp and exact "
                         f"BGZF, got {h['ref_internal']}, {h['gencomp']}, "
                         f"{h['mgzip']}")
    zsize = os.path.getsize(z)
    log(f"cfg5: zip {disk / 1e6 / tz:.2f} MB/s on disk, {txt / 1e6 / tz:.2f} "
        f"MB/s of BAM stream ({tz:.1f} s); unzip {disk / 1e6 / tu:.2f} / "
        f"{txt / 1e6 / tu:.2f} MB/s ({tu:.1f} s); ratio {disk / zsize:.3f} "
        f"on disk, {txt / zsize:.3f} of BAM stream ({zsize} bytes); "
        f"{h['num_vbs']} MAIN VBs, gencomp {h['gencomp']}; on {smi}")
    log("cfg5: zip --show-time regions:\n" + zip_regions)
    log("cfg5: unzip --show-time regions:\n" + unzip_regions)
    log("cfg5: ls", ls.strip().splitlines()[-1])
    log(f"cfg5: launches over zip + unzip {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise SystemExit(f"cfg5: kernels never launched: {missing}")
    os.remove(out)
    files.update(z=z, txt=txt)

    # the same records as SAM text: device equals host, unzip, cat
    sam = os.path.join(tmp, "cfg5.sam")
    files.update(sam=sam, sam_bam=sam + ".bamstream")
    size = os.path.getsize(sam)
    zs, ts = zip_cuda_cpu([sam], sam, ["--vblock",
                                       str(max(1, sam_mib // 4))], "cfg5: SAM")
    za = zs["cuda"]
    for dev in zs:
        log(f"cfg5: {size} bytes of SAM zip --device {dev} {ts[dev]:.1f} s")
    run_cli(["unzip", za, "-o", sam + ".out", "--device", "cuda"])
    if not same_file(sam, sam + ".out"):
        raise SystemExit("cfg5: SAM unzip output differs from the input")
    with open(sam, "rb") as f:
        orig = f.read()
    hdr_len = 0
    while orig.startswith(b"@", hdr_len):
        hdr_len = orig.index(b"\n", hdr_len) + 1
    lines = orig[hdr_len:].splitlines(keepends=True)
    head = run_cli(["cat", za, "--head", "1000", "--device", "cuda"], True)
    if head != orig[:hdr_len] + b"".join(lines[:1000]):
        raise SystemExit("cfg5: cat --head 1000 differs from the input")
    pr = PizReader(za)
    nvb, gc = pr.num_vbs(), pr.file_hdr["gencomp"]
    pr.close()
    if nvb < 3 or not gc:
        raise SystemExit(f"cfg5: SAM archive has {nvb} VBs, gencomp {gc}")
    pieces = [run_cli(["cat", za, "--one-vb", str(k), "--no-header",
                       "--device", "cuda"], True) for k in range(1, nvb + 1)]
    if b"".join(pieces) != orig[hdr_len:] or not all(pieces):
        raise SystemExit("cfg5: cat --one-vb k over the VBs does not give "
                         "the records back in their order")
    log(f"cfg5: SAM archives equal from cuda and cpu "
        f"({os.path.getsize(za)} bytes, {nvb} VBs, gencomp {gc}); unzip "
        f"exact; cat --head 1000 and cat --one-vb 1..{nvb} "
        f"({[len(p) for p in pieces]} bytes) equal the input")
    for p in (zs["cpu"], sam + ".out"):
        os.remove(p)
    files["za"] = za
    return counts, files


def _same_stream(gz_path, plain_path):
    """A gzip file's uncompressed bytes equal a plain file's."""
    import gzip
    with gzip.open(gz_path, "rb") as a, open(plain_path, "rb") as b:
        while True:
            x, y = a.read(16 * MIB), b.read(16 * MIB)
            if x != y:
                return False
            if not x:
                return True


def _mapped_per_contig(sam_path):
    """({RNAME: mapped records}, unmapped records) of a SAM file."""
    reads, unmapped = {}, 0
    with open(sam_path, "rb") as f:
        for line in f:
            if line.startswith(b"@"):
                continue
            _, flag, rname, _ = line.split(b"\t", 3)
            if int(flag) & 4:
                unmapped += 1
            else:
                reads[rname.decode()] = reads.get(rname.decode(), 0) + 1
    return reads, unmapped


def phase_cfg5x(tmp, smi, files, small_mib=SMALL_MIB,
                longread_mib=LONGREAD_MIB, bamass_genome=BAMASS_GENOME):
    """Phase 8: cfg5 translations, deep and bamass, on phase 7's files.
    Returns the launch counts of the deep run (zip + unzip)."""
    from genozip_tpu_torch import synth
    from genozip_tpu_torch.ops import rans_cuda
    from genozip_tpu_torch.zip_pipeline import profiler
    bam, z, za, txt = files["bam"], files["z"], files["za"], files["txt"]
    write_inputs("cfg5x", tmp, small_mib=small_mib, longread_mib=longread_mib,
                 bamass_genome=bamass_genome)

    # cat --sam of the BAM archive: the generator's SAM text
    out = os.path.join(tmp, "cfg5.cat.sam")
    profiler.reset()
    t = time.time()
    run_cli(["cat", z, "--sam", "-o", out, "--device", "cuda"])
    tsam = time.time() - t
    sam_bytes = os.path.getsize(out)
    if not same_file(out, files["bam_sam"]):
        with open(out, "rb") as a, open(files["bam_sam"], "rb") as b:
            ha, hb = a.read(4096), b.read(4096)
        raise SystemExit("cfg5x: cat --sam differs from the generator's SAM "
                         f"text; headers {'equal' if ha == hb else 'differ'}"
                         f": {ha[:300]!r} / {hb[:300]!r}")
    log(f"cfg5x: cat --sam {sam_bytes / 1e6 / tsam:.2f} MB/s of SAM text, "
        f"{txt / 1e6 / tsam:.2f} MB/s of BAM stream ({tsam:.1f} s, "
        f"{sam_bytes} bytes) equal to the generator's text, on {smi}")
    log("cfg5x: cat --sam regions:\n" + profiler.report())
    os.remove(out)

    # --idxstats of the SAM archive: the generator's reads per contig
    t = time.time()
    idx = run_cli(["cat", za, "--idxstats", "--device", "cuda"], True).decode()
    tidx = time.time() - t
    got = {r.split("\t")[0]: int(r.split("\t")[2])
           for r in idx.splitlines()[:-1]}
    got_un = int(idx.splitlines()[-1].split("\t")[3])
    want = _mapped_per_contig(files["sam"])
    if (got, got_un) != want:
        raise SystemExit(f"cfg5x: --idxstats {got}/{got_un}, generator "
                         f"{want}")
    log(f"cfg5x: --idxstats of the SAM archive ({tidx:.1f} s): reads per "
        f"contig and unmapped {want}, the generator's")

    # cat --bam --index -o of the SAM archive, on the card and on the host
    outs = {}
    for dev in ("cuda", "cpu"):
        ob = os.path.join(tmp, f"cfg5.{dev}.bam")
        profiler.reset()
        t = time.time()
        run_cli(["cat", za, "--bam", "--index", "-o", ob, "--device", dev])
        outs[dev] = (ob, time.time() - t, profiler.report())
    ob = outs["cuda"][0]
    if not (same_file(ob, outs["cpu"][0]) and
            same_file(ob + ".bai", outs["cpu"][0] + ".bai")):
        raise SystemExit("cfg5x: cat --bam --index differs between cuda and "
                         "cpu")
    if not _same_stream(ob, files["sam_bam"]):
        raise SystemExit("cfg5x: cat --bam's BAM stream differs from the "
                         "generator's records")
    log(f"cfg5x: cat --bam --index of {os.path.getsize(files['sam'])} bytes "
        f"of SAM: {os.path.getsize(ob)} byte BAM, "
        f"{os.path.getsize(ob + '.bai')} byte BAI, equal from cuda and cpu, "
        f"BAM stream equal to the generator's; {outs['cuda'][1]:.1f} s on "
        f"cuda, {outs['cpu'][1]:.1f} s on cpu")
    log("cfg5x: cat --bam --index regions:\n" + outs["cuda"][2])
    for dev in outs:
        os.remove(outs[dev][0])
        os.remove(outs[dev][0] + ".bai")

    # --regions with --count, and --lines: the same selection in Python
    with open(files["sam"], "rb") as f:
        text = f.read()
    hdr_len = 0
    while text.startswith(b"@", hdr_len):
        hdr_len = text.index(b"\n", hdr_len) + 1
    recs = text[hdr_len:].splitlines(keepends=True)
    chrom = synth.cfg5_contigs(small_mib * MIB)[0]
    in_reg = sum(1 for r in recs if r.split(b"\t", 4)[2] == chrom and
                 1 <= int(r.split(b"\t", 4)[3]) <= 1_000_000)
    cnt = run_cli(["cat", za, "--regions", f"{chrom.decode()}:1-1000000",
                   "--count", "--device", "cuda"], True)
    lines = run_cli(["cat", za, "--lines", "1000-2000", "--device", "cuda"],
                    True)
    if cnt != b"%d\n" % in_reg:
        raise SystemExit(f"cfg5x: --regions --count gave {cnt!r}, want "
                         f"{in_reg}")
    if lines != text[:hdr_len] + b"".join(recs[999:2000]):
        raise SystemExit("cfg5x: --lines 1000-2000 differs")
    log(f"cfg5x: --regions {chrom.decode()}:1-1000000 --count = {in_reg} and "
        f"--lines 1000-2000 equal the selection made from the text")
    del text, recs

    # deep at full width: the BAM with the FASTQ of its primaries
    r1, r2 = files["r1"], files["r2"]
    inputs = txt + os.path.getsize(r1) + os.path.getsize(r2)
    zd, od = os.path.join(tmp, "deep.gxz"), os.path.join(tmp, "deep.out")
    torch.cuda.synchronize()
    profiler.reset()
    rans_cuda.reset_launches()
    t = time.time()
    # 32 MiB VBs: at 16 the packed SEQ of a FASTQ VB's misses (a tenth of
    # its reads) is about 190 KB, under the 256 KiB at which a stream goes
    # to the card, and no order-0 stream of the archive is decoded there
    run_cli(["zip", bam, r1, r2, "--deep", "-o", zd, "--vblock", "32",
             "--device", "cuda", "-q"])
    tz = time.time() - t
    zip_regions = profiler.report()
    profiler.reset()
    t = time.time()
    run_cli(["unzip", zd, "-o", od, "--device", "cuda"])
    tu = time.time() - t
    unzip_regions = profiler.report()
    torch.cuda.synchronize()
    counts = dict(rans_cuda.launches)
    if not (_same_stream(bam, od + ".1") and same_file(r1, od + ".2")
            and same_file(r2, od + ".3")):
        raise SystemExit("cfg5x: deep unzip differs from the inputs")
    zsize = os.path.getsize(zd)
    log(f"cfg5x: deep zip {inputs / 1e6 / tz:.2f} MB/s ({tz:.1f} s), unzip "
        f"{inputs / 1e6 / tu:.2f} MB/s ({tu:.1f} s) of {inputs} input bytes "
        f"(BAM stream {txt} + R1/R2 FASTQ), ratio {inputs / zsize:.3f} "
        f"({zsize} bytes); every component unzips byte for byte; on {smi}")
    log("cfg5x: deep zip --show-time regions:\n" + zip_regions)
    log("cfg5x: deep unzip --show-time regions:\n" + unzip_regions)
    log(f"cfg5x: deep launches over zip + unzip {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise SystemExit(f"cfg5x: kernels never launched: {missing}")
    for p in (zd, od + ".1", od + ".2", od + ".3"):
        os.remove(p)

    # a smaller BAM with the FASTQ of its primaries, off a 4 Mbp genome:
    # deep on the card equals deep on the host, then bamass
    nb = small_mib * MIB
    b16, q1, q2 = (os.path.join(tmp, n) for n in
                   ("d16.bam", "d16.R1.fastq", "d16.R2.fastq"))
    zs, ts = zip_cuda_cpu([b16, q1, q2], os.path.join(tmp, "d16"),
                          ["--deep", "--vblock", "16"], "cfg5x: deep")
    for dev in zs:
        log(f"cfg5x: {small_mib} MiB deep zip --device {dev} "
            f"{ts[dev]:.1f} s")
    log(f"cfg5x: {small_mib} MiB deep archives equal from cuda and cpu "
        f"({os.path.getsize(zs['cuda'])} bytes)")

    # --coverage of the deep archive's BAM: the generator's reads per contig
    t = time.time()
    cov = run_cli(["cat", zs["cuda"], "--coverage", "--device", "cuda"],
                  True).decode()
    tcov = time.time() - t
    got = {r.split()[0]: int(r.split()[1].replace(",", ""))
           for r in cov.splitlines()[1:-1]}
    got_un = int(cov.splitlines()[-1].split()[1].replace(",", ""))
    want = _mapped_per_contig(b16 + ".sam")
    if (got, got_un) != want:
        raise SystemExit(f"cfg5x: --coverage {got}/{got_un}, generator "
                         f"{want}")
    log(f"cfg5x: --coverage of the {small_mib} MiB deep archive "
        f"({tcov:.1f} s): reads per contig and unmapped {want}, the "
        f"generator's")
    for p in (zs["cuda"], zs["cpu"], b16 + ".sam"):
        os.remove(p)

    # bamass: the R1 placed by its BAM against a reference of the genome
    fa, ref = os.path.join(tmp, "ba.fa"), os.path.join(tmp, "ba.ref.gxz")
    synth.write_fasta(fa, synth.cfg5_genome(bamass_genome, 7),
                      synth.cfg5_contigs(nb, bamass_genome))
    t = time.time()
    run_cli(["zip", "--make-reference", fa, "-o", ref, "--device", "cuda"],
            True)
    tref = time.time() - t
    bb, b1 = b16, q1
    zs, ts = zip_cuda_cpu([b1], os.path.join(tmp, "ba"), [
        "--reference", ref, "--bamass", bb], "cfg5x: bamass")
    for dev in zs:
        log(f"cfg5x: bamass zip of {os.path.getsize(b1)} bytes --device "
            f"{dev} {ts[dev]:.1f} s")
    run_cli(["unzip", zs["cuda"], "--reference", ref, "-o", b1 + ".out",
             "--device", "cuda"])
    if not same_file(b1, b1 + ".out"):
        raise SystemExit("cfg5x: bamass unzip differs from the input")
    log(f"cfg5x: bamass: make-reference of {os.path.getsize(fa)} bytes "
        f"{tref:.1f} s; archives equal from cuda and cpu "
        f"({os.path.getsize(zs['cuda'])} bytes, ratio "
        f"{os.path.getsize(b1) / os.path.getsize(zs['cuda']):.3f}); unzip "
        f"with --reference only is byte exact")
    for p in (fa, ref, b16, q1, q2, b1 + ".out", zs["cuda"], zs["cpu"]):
        os.remove(p)

    # long-read SAM
    lr = os.path.join(tmp, "longread.sam")
    size = os.path.getsize(lr)
    zl = lr + ".gxz"
    t = time.time()
    run_cli(["zip", lr, "-o", zl, "--device", "cuda", "-q"])
    tz = time.time() - t
    t = time.time()
    run_cli(["unzip", zl, "-o", lr + ".out", "--device", "cuda"])
    tu = time.time() - t
    if not same_file(lr, lr + ".out"):
        raise SystemExit("cfg5x: long-read unzip differs from the input")
    log(f"cfg5x: long-read SAM ({size} bytes) zip {size / 1e6 / tz:.2f} MB/s "
        f"({tz:.1f} s), unzip {size / 1e6 / tu:.2f} MB/s ({tu:.1f} s), ratio "
        f"{size / os.path.getsize(zl):.3f}, byte exact; on {smi}")
    for p in (lr, zl, lr + ".out"):
        os.remove(p)
    return counts


def _zip_unzip(src, z, out, dev="cuda", extra=()):
    """`zip` then `unzip` on the card; returns (zip s, unzip s, zip
    --show-time regions, unzip regions)."""
    from genozip_tpu_torch.zip_pipeline import profiler
    profiler.reset()
    t = time.time()
    run_cli(["zip", src, "-o", z, "--device", dev, "-q"] + list(extra))
    tz = time.time() - t
    zr = profiler.report()
    profiler.reset()
    t = time.time()
    run_cli(["unzip", z, "-o", out, "--device", dev])
    tu = time.time() - t
    if not same_file(src, out):
        raise SystemExit(f"unzip of {os.path.basename(src)} differs from "
                         "the input")
    return tz, tu, zr, profiler.report()


def _cuda_equals_cpu(src, extra=()):
    """`zip_cuda_cpu` of `src`, then `unzip` of the cuda archive, which must
    give `src` back; launches counted from zero over the cuda zip and the
    unzip. Returns (zip s, unzip s, archive bytes, launches); the cuda
    archive stays at `src`.cuda.gxz."""
    from genozip_tpu_torch.ops import rans_cuda
    torch.cuda.synchronize()
    rans_cuda.reset_launches()
    zs, ts = zip_cuda_cpu([src], src, extra, os.path.basename(src))
    t = time.time()
    run_cli(["unzip", zs["cuda"], "-o", src + ".out", "--device", "cuda"])
    tu = time.time() - t
    torch.cuda.synchronize()
    counts = dict(rans_cuda.launches)
    if not same_file(src, src + ".out"):
        raise SystemExit(f"unzip of {os.path.basename(src)} differs from "
                         "the input")
    for p in (zs["cpu"], src + ".out"):
        os.remove(p)
    return ts["cuda"], tu, os.path.getsize(zs["cuda"]), counts


def _vcf_rows(path):
    """(header bytes, data lines) of a VCF file."""
    with open(path, "rb") as f:
        text = f.read()
    hdr_len = text.index(b"\n#CHROM") + 1
    hdr_len = text.index(b"\n", hdr_len) + 1
    return text[:hdr_len], text[hdr_len:].splitlines(keepends=True)


def phase_cfg1(tmp, smi, vcf_mib=CFG1_MIB, small_mib=SMALL_MIB,
               genome_bp=CHR20_BP, ref_bp=CFG1_REF_BP):
    """Phase 9: cfg1 (a cohort's VCF) at full width, then FASTA (cfg2),
    GFF3, BED, 23andMe, LOCS and generic files, and `cat --vcf`. Returns the
    launch counts of the cfg1 run (zip + unzip + cat) and of the FASTA run
    (zip + unzip)."""
    from genozip_tpu_torch import synth
    from genozip_tpu_torch.ops import rans_cuda
    from genozip_tpu_torch.piz_pipeline import PizReader
    from genozip_tpu_torch.ref.refstore import load_ref_file, make_reference
    from genozip_tpu_torch.translate import VCF_ME23_HEADER, me23_vb_to_vcf

    # the cfg1 full run, at --vblock 16: at the datatype's default VB size
    # (6 MiB for 64 samples and more) no rANS payload reaches the 256 KiB at
    # which a stream goes to the card
    write_inputs("cfg1", tmp, vcf_mib=vcf_mib, small_mib=small_mib,
                 ref_bp=ref_bp)
    vcf = os.path.join(tmp, "cfg1.vcf")
    size = os.path.getsize(vcf)
    hdr, rows = _vcf_rows(vcf)
    samples = hdr.rsplit(b"\n#CHROM", 1)[1].count(b"\t") - 8
    log(f"cfg1: a {size} byte VCF ({len(rows)} rows of {samples} samples)")
    z, out = vcf + ".gxz", vcf + ".out"
    torch.cuda.synchronize()
    rans_cuda.reset_launches()
    tz, tu, zip_regions, unzip_regions = _zip_unzip(
        vcf, z, out, extra=["--vblock", "16"])
    os.remove(out)
    ls = run_cli(["ls", z], True).decode()
    head = run_cli(["cat", z, "--head", "1000", "--device", "cuda"], True)
    pos = [int(r.split(b"\t", 2)[1]) for r in rows]
    a, b = pos[len(pos) // 3], pos[len(pos) // 3 + 2000]
    cnt = run_cli(["cat", z, "-r", f"chr1:{a}-{b}", "--count", "--device",
                   "cuda"], True)
    torch.cuda.synchronize()
    counts = dict(rans_cuda.launches)
    want = sum(1 for p in pos if a <= p <= b)
    if head != hdr + b"".join(rows[:1000]):
        raise SystemExit("cfg1: cat --head 1000 differs from the input")
    if cnt != b"%d\n" % want:
        raise SystemExit(f"cfg1: -r chr1:{a}-{b} --count gave {cnt!r}, want "
                         f"{want}")
    if str(size) not in ls.replace(",", ""):
        raise SystemExit(f"cfg1: ls does not show {size} bytes:\n{ls}")
    zsize = os.path.getsize(z)
    log(f"cfg1: zip --vblock 16 {size / 1e6 / tz:.2f} MB/s ({tz:.1f} s), "
        f"unzip {size / 1e6 / tu:.2f} MB/s ({tu:.1f} s), ratio "
        f"{size / zsize:.3f} ({zsize} bytes), byte exact; cat --head 1000 "
        f"and -r chr1:{a}-{b} --count = {want} equal the input; on {smi}")
    log("cfg1: zip --show-time regions:\n" + zip_regions)
    log("cfg1: unzip --show-time regions:\n" + unzip_regions)
    log("cfg1: ls", ls.strip().splitlines()[-1])
    log(f"cfg1: launches over zip + unzip + cat {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise SystemExit(f"cfg1: kernels never launched: {missing}")
    del rows, pos
    for p in (vcf, z):
        os.remove(p)

    # 16 MiB of cfg1: cuda == cpu at --vblock 16, then the default VB size
    v16 = os.path.join(tmp, "cfg1_16.vcf")
    tz, tu, zsize, c16 = _cuda_equals_cpu(v16, ["--vblock", "16"])
    log(f"cfg1: {os.path.getsize(v16)} bytes at --vblock 16: archives equal "
        f"from cuda and cpu ({zsize} bytes), zip {tz:.1f} s, unzip "
        f"{tu:.1f} s; launches {c16}")
    rans_cuda.reset_launches()
    tz, tu, _, _ = _zip_unzip(v16, v16 + ".d.gxz", v16 + ".out")
    torch.cuda.synchronize()
    log(f"cfg1: at the default VB size: zip {tz:.1f} s, unzip {tu:.1f} s, "
        f"launches {dict(rans_cuda.launches)}")
    for p in (v16, v16 + ".cuda.gxz", v16 + ".d.gxz", v16 + ".out"):
        os.remove(p)

    # REF against a genome whose contig is chr1 (the VCF says 1)
    g = chr1_genome(ref_bp)
    fa, ref = os.path.join(tmp, "chr1.fa"), os.path.join(tmp, "chr1.ref.gxz")
    synth.write_fasta(fa, g, names=[b"chr1"])
    # VCF REF and cat --vcf read the genome only, not the refhash: a 2^16
    # slot one keeps the reference's build and load short
    make_reference(fa, ref, hash_bits=16)
    os.remove(fa)
    vr = os.path.join(tmp, "cfg1_ref.vcf")
    for opt in ("--reference", "--REFERENCE"):
        zr = vr + ".gxz"
        t = time.time()
        extra = ["--reference", ref] + (["--REFERENCE"] if opt ==
                                        "--REFERENCE" else [])
        run_cli(["zip", vr, "-o", zr, "--vblock", "16", "--device", "cuda",
                 "-q"] + extra)
        tz = time.time() - t
        un = ["--reference", ref] if opt == "--reference" else []
        run_cli(["unzip", zr, "-o", vr + ".out", "--device", "cuda"] + un)
        if not same_file(vr, vr + ".out"):
            raise SystemExit(f"cfg1: {opt} archive does not unzip to the "
                             "input")
        log(f"cfg1: zip {opt} {tz:.1f} s, {os.path.getsize(zr)} bytes; unzip"
            f" {'with' if un else 'without'} the reference byte exact")
    for p in (vr, vr + ".gxz", vr + ".out"):
        os.remove(p)

    # cfg2: phase 6's 64 Mbp FASTA as a file to compress
    fa64 = os.path.join(tmp, "chr20like.fa")
    if not os.path.exists(fa64):
        synth.write_fasta(fa64, synth.genome(np.random.default_rng(20),
                                             genome_bp))
    size = os.path.getsize(fa64)
    tz, tu, zsize, counts2 = _cuda_equals_cpu(fa64, ["--vblock", "16"])
    log(f"cfg2: FASTA of {size} bytes at --vblock 16: zip "
        f"{size / 1e6 / tz:.2f} MB/s ({tz:.1f} s), unzip "
        f"{size / 1e6 / tu:.2f} MB/s ({tu:.1f} s), ratio {size / zsize:.3f}; "
        f"archives equal from cuda and cpu; unzip byte exact; on {smi}")
    log(f"cfg2: launches over zip + unzip {counts2}")
    if not (counts2["rans_encode_o0"] and counts2["rans_decode_o0"]):
        raise SystemExit("cfg2: the packed SEQ never went to the card")
    for p in (fa64, fa64 + ".cuda.gxz"):
        os.remove(p)

    # GFF3, BED, 23andMe, LOCS and generic, 16 MiB each
    for dt, name, _, extra in OTHER_DATATYPES:
        src = os.path.join(tmp, name)
        size = os.path.getsize(src)
        tz, tu, zsize, c = _cuda_equals_cpu(src, extra)
        pr = PizReader(src + ".cuda.gxz")
        got = pr.file_hdr["dt"]
        pr.close()
        if got != dt:
            raise SystemExit(f"{name}: zipped as {got}, not {dt}")
        log(f"{dt}: {size} bytes, zip {size / 1e6 / tz:.2f} MB/s, unzip "
            f"{size / 1e6 / tu:.2f} MB/s, ratio {size / zsize:.3f}; archives "
            f"equal from cuda and cpu; unzip byte exact; launches {c}")
        if dt != "me23":
            os.remove(src)
            os.remove(src + ".cuda.gxz")

    # cat --vcf of the 23andMe archive against the chr1 reference
    m = os.path.join(tmp, "genome_23andme.txt")
    t = time.time()
    got = run_cli(["cat", m + ".cuda.gxz", "--vcf", "--reference", ref,
                   "--device", "cuda"], True)
    tcat = time.time() - t
    with open(m, "rb") as f:
        want = VCF_ME23_HEADER + me23_vb_to_vcf(f.read(), load_ref_file(ref))
    if got != want:
        raise SystemExit("cat --vcf differs from me23_vb_to_vcf of the "
                         "generator's text")
    nrec = want.count(b"\n") - VCF_ME23_HEADER.count(b"\n")
    log(f"cat --vcf: {nrec} VCF records, {len(want)} bytes in {tcat:.1f} s, "
        f"equal to me23_vb_to_vcf of the input")
    for p in (m, m + ".cuda.gxz", ref):
        os.remove(p)
    return counts, counts2


AES_SIZES = (0, 1, 15, 16, 17, 4095, 4097, MIB, 64 * MIB)
# counter0 = salt[:8] || offset (little-endian): a plain one, the offset's
# top byte 0xFF (the first increment carries), the low 8 bytes all 0xFF
# (the carry reaches the salt half), and the 128-bit wrap
AES_COUNTERS = (bytes(range(16)), b"\x11" * 8 + b"\x00" * 7 + b"\xff",
                b"\x22" * 8 + b"\xff" * 8, b"\xff" * 16)
AES_OPS_PER_BLOCK = 448   # 14 rounds x 16 bytes x (one lookup, one XOR)
PW = "smoke-password"


def aes_launch(rk, hi, lo, buf):
    """One launch of the aes256_ctr kernel on `buf` through its C entry
    point, on the current stream (for graph_ms)."""
    from genozip_tpu_torch.ops import aes_cuda
    words = (ctypes.c_uint32 * 60)(*rk)

    def launch():
        rc = aes_cuda.lib().aes256_ctr(
            words, hi, lo, buf.data_ptr(), buf.numel(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"aes256_ctr: CUDA error {rc}")
    return launch


def check_aes(rng):
    """The aes256_ctr kernel against its plain version on the card, at
    AES_SIZES x AES_COUNTERS, byte for byte; then timed at 1 MiB and 64 MiB:
    through its wrapper and the plain version (CUDA events, mean of 5 after
    a warm-up), and the kernel alone (graph_ms of its C entry point).
    Returns {n: (max_abs_err, ms, plain ms, bytes, bound ms, bound by,
    ms alone)} for the timed sizes."""
    from genozip_tpu_torch.ops import aes_cuda, aes_torch
    key = rng.integers(0, 256, 32, np.uint8).tobytes()
    rk = aes_torch.round_keys(key)
    meas, checked = {}, 0
    for n in AES_SIZES:
        data = torch.from_numpy(rng.integers(0, 256, n, np.uint8)).cuda()
        for c0 in AES_COUNTERS:
            hi, lo = aes_torch.split_counter(c0)
            k = aes_cuda.aes256_ctr_xor_(data.clone(), rk, hi, lo)
            p = aes_torch.aes256_ctr_plain(rk, hi, lo, data.clone())
            torch.cuda.synchronize()
            err = int((k.int() - p.int()).abs().max()) if n else 0
            if err or not torch.equal(k, p):
                raise SystemExit(f"aes256_ctr n={n} counter0={c0.hex()}: "
                                 f"kernel differs from plain (max_abs_err "
                                 f"{err})")
            checked += 1
        if n in (MIB, 64 * MIB):
            buf = data.clone()
            ms = cuda_ms(lambda: aes_cuda.aes256_ctr_xor_(buf, rk, hi, lo),
                         5)
            ams = graph_ms(aes_launch(rk, hi, lo, buf))
            pms = cuda_ms(lambda: aes_torch.aes256_ctr_plain(rk, hi, lo, buf),
                          5)
            nbytes = 2 * n
            bms, by = bound_ms(nbytes, (n + 15) // 16 * AES_OPS_PER_BLOCK)
            meas[n] = (0, ms, pms, nbytes, bms, by, ams)
            log(f"kernel aes256_ctr: {ms:.4f} ms at {n} bytes through the "
                f"wrapper ({n / 1e6 / ms:.2f} GB/s; {ams:.4f} ms alone), "
                f"plain {pms:.3f} ms, bound {bms:.6f} ms ({by}), share "
                f"{100 * bms / ms:.2f}% ({100 * bms / ams:.2f}% alone)")
    log(f"kernel aes256_ctr: equal to plain at {checked} (n, counter0) "
        f"cases, n in {AES_SIZES}")
    return meas


def section_codecs(path):
    """{codec name: sections} of an archive (the headers are not
    encrypted)."""
    from collections import Counter
    from genozip_tpu_torch import codecs
    from genozip_tpu_torch.format import sections as fmt
    out = Counter()
    with open(path, "rb") as f:
        for ent in fmt.ZReader(f).index:
            f.seek(ent.offset)
            out[codecs.NAMES[fmt._HDR.unpack(f.read(fmt.HDR_SIZE))[2]]] += 1
    return dict(out)


@contextlib.contextmanager
def call_times(module, name, sink, nbytes=None):
    """Append the seconds of every call of module.name to `sink`, and with
    `nbytes` (a list) the length of its first argument there."""
    orig = getattr(module, name)

    def wrapped(*a, **k):
        t = time.time()
        try:
            return orig(*a, **k)
        finally:
            sink.append(time.time() - t)
            if nbytes is not None:
                nbytes.append(len(a[0]))
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def arith_host_calls():
    """{function: (seconds, bytes in)} of every call of the host runtime's
    ARITH coder (native.arith_encode, native.arith_decode) meanwhile."""
    from genozip_tpu_torch import native
    calls = {name: ([], []) for name in ("arith_encode", "arith_decode")}
    with contextlib.ExitStack() as stack:
        for name, (secs, nb) in calls.items():
            stack.enter_context(call_times(native, name, secs, nb))
        yield calls


def arith_host_line(calls) -> str:
    """The calls, bytes and host seconds of `arith_host_calls`."""
    return "host ARITH: " + ", ".join(
        f"{name} {len(secs)} calls, {sum(nb)} bytes, {sum(secs):.4f} s"
        for name, (secs, nb) in calls.items())


@contextlib.contextmanager
def fixed_salt():
    """The salt of every archive made meanwhile is one value, as the tests
    fix it, so two archives of the same input can be compared."""
    from genozip_tpu_torch import crypt
    orig = crypt.new_salt
    crypt.new_salt = lambda: bytes(range(16))
    try:
        yield
    finally:
        crypt.new_salt = orig


def fails(args, msg):
    """run_cli(args) must raise an error that says `msg`."""
    try:
        run_cli(args, True)
    except Exception as e:      # noqa: BLE001 (any error, checked below)
        if msg not in str(e):
            raise SystemExit(f"{args}: failed with {e!r}, not {msg!r}")
        return
    raise SystemExit(f"{args}: did not fail")


def cut_records(src, dst, nbytes, lines_per_record=1):
    """The first whole records of `src` within `nbytes` into `dst` (a SAM's
    header lines count as records)."""
    with open(src, "rb") as f:
        data = f.read(nbytes)
    ends = np.flatnonzero(np.frombuffer(data, np.uint8) == ord("\n"))
    k = len(ends) // lines_per_record * lines_per_record
    with open(dst, "wb") as f:
        f.write(data[:ends[k - 1] + 1])


def phase_tools(tmp, smi, fq=None, rates3=None, full_mib=128,
                bam_mib=CFG5_MIB, best_mib=SAM_MIB, best_sam_mib=4,
                small_mib=4):
    """Phase 10: encrypted archives with the aes256_ctr kernel, `--best`
    with the BWT codec, and the small tools. Returns the AES kernel's
    measurements and the launch counts of the encrypted cfg3 run."""
    from genozip_tpu_torch import piz_pipeline, synth, zip_pipeline
    from genozip_tpu_torch.ops import aes_cuda, rans_cuda
    from genozip_tpu_torch.zip_pipeline import profiler
    aes = check_aes(np.random.default_rng(10))

    # the cfg3 FASTQ of phase 4 (128 MiB), encrypted, on the card
    if fq is None:
        fq = os.path.join(tmp, "reads.fastq")
        synth.write_fastq(fq, full_mib * MIB, seed=512)
    size = os.path.getsize(fq)
    z, out = fq + ".enc.gxz", fq + ".out"
    torch.cuda.synchronize()
    rans_cuda.reset_launches()
    aes_cuda.reset_launches()
    tz, tt = [], []
    t = time.time()
    with call_times(zip_pipeline, "zip_file", tz), \
            call_times(piz_pipeline, "piz_file", tt):
        run_cli(["zip", fq, "-o", z, "--password", PW, "--md5", "--test",
                 "--device", "cuda", "-q"], True)
    tzt = time.time() - t
    t = time.time()
    run_cli(["unzip", z, "-o", out, "--password", PW, "--device", "cuda"])
    tu = time.time() - t
    head = run_cli(["cat", z, "--head", "1000", "--password", PW, "--device",
                    "cuda"], True)
    torch.cuda.synchronize()
    counts = {**rans_cuda.launches, **aes_cuda.launches}
    if not same_file(fq, out):
        raise SystemExit("tools: unzip --password differs from the input")
    if head != head_records(fq, 1000):
        raise SystemExit("tools: cat --password --head 1000 differs")
    fails(["cat", z, "--head", "10", "--password", "not-it", "--device",
           "cuda"], "wrong password")
    fails(["cat", z, "--head", "10", "--device", "cuda"],
          "--password required")
    pr = piz_pipeline.PizReader(z, password=PW)
    h = pr.file_hdr
    pr.close()
    if not (h["enc"] and h["md5"]):
        raise SystemExit(f"tools: header enc {h['enc']}, md5 {h['md5']}")
    base = (f"; unencrypted (phase 4) zip {rates3[0]:.2f}, unzip "
            f"{rates3[1]:.2f} MB/s") if rates3 else ""
    log(f"tools: cfg3 {size} bytes zip --password --md5 --test {tzt:.1f} s "
        f"(zip {size / 1e6 / tz[0]:.2f} MB/s, {tz[0]:.1f} s; --test "
        f"{tt[0]:.1f} s); unzip --password {size / 1e6 / tu:.2f} MB/s "
        f"({tu:.1f} s){base}; ratio {size / os.path.getsize(z):.3f}; unzip "
        f"and cat --head 1000 exact, wrong and missing password refused; "
        f"on {smi}")
    log(f"tools: launches over zip --test + unzip + cat {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise SystemExit(f"tools: kernels never launched: {missing}")
    # the same file unencrypted again, so that encrypted and plain runs
    # alternate in this call (plain in phase 4, encrypted, plain)
    tp, tpu, _, _ = _zip_unzip(fq, fq + ".gxz", out)
    log(f"tools: cfg3 unencrypted again: zip {size / 1e6 / tp:.2f} MB/s "
        f"({tp:.1f} s), unzip {size / 1e6 / tpu:.2f} MB/s ({tpu:.1f} s)")
    for p in (z, out, fq + ".gxz"):
        os.remove(p)

    # device equals host, encrypted, with the salt fixed; then the --best
    # inputs: 16 MiB of cfg3 FASTQ and phase 7's 16 MiB of cfg5 SAM
    fq16 = os.path.join(tmp, "best.fastq")
    synth.write_fastq(fq16, best_mib * MIB, seed=16, block=5000)
    with fixed_salt():
        zs, ts = zip_cuda_cpu([fq16], fq16 + ".enc", ["--password", PW],
                              "tools: encrypted")
    log(f"tools: {os.path.getsize(fq16)} bytes zip --password: archives "
        f"equal from cuda and cpu with the salt fixed; cuda {ts['cuda']:.1f}"
        f" s, cpu {ts['cpu']:.1f} s")
    for p in zs.values():
        os.remove(p)
    sam16 = os.path.join(tmp, "cfg5.sam")
    write_inputs("cfg5", tmp, bam_mib=bam_mib, sam_mib=best_mib)
    # --best of the SAM text on its first 4 MiB: there its POS and SAGIDX
    # sections take BWT; at 16 MiB no section does
    sam4 = os.path.join(tmp, "best.sam")
    cut_records(sam16, sam4, best_sam_mib * MIB)
    # --best: its codec trials are host work, mostly on one core, so the
    # four zips (two inputs, cuda and cpu) run in child processes beside
    # the encrypted BAM and the small tools
    kids = {(src, dev): ChildCli(
        ["zip", src, "-o", f"{src}.best.{dev}.gxz", "--best", "--device",
         dev, "-q", "--show-time"], f"{src}.best.{dev}.log")
        for src in (fq16, sam4) for dev in ("cuda", "cpu")}
    try:
        # the cfg5 BAM of phase 7, encrypted (REF_INTERNAL, gencomp)
        bam = os.path.join(tmp, "cfg5.bam")
        zb, ob = bam + ".enc.gxz", os.path.join(tmp, "cfg5.enc.out.bam")
        t = time.time()
        run_cli(["zip", bam, "-o", zb, "--password", PW, "--vblock", "16",
                 "--device", "cuda", "-q"])
        tzb = time.time() - t
        t = time.time()
        run_cli(["unzip", zb, "-o", ob, "--password", PW, "--device",
                 "cuda"])
        tub = time.time() - t
        if not same_file(bam, ob):
            raise SystemExit("tools: the encrypted BAM archive does not "
                             "unzip to the input")
        pr = piz_pipeline.PizReader(zb, password=PW)
        h = pr.file_hdr
        pr.close()
        if not (h["enc"] and h["ref_internal"] and h["gencomp"]):
            raise SystemExit(f"tools: encrypted BAM: enc {h['enc']}, "
                             f"REF_INTERNAL {h['ref_internal']}, gencomp "
                             f"{h['gencomp']}")
        disk = os.path.getsize(bam)
        log(f"tools: cfg5 BAM ({disk} bytes) zip --password "
            f"{disk / 1e6 / tzb:.2f} MB/s on disk ({tzb:.1f} s), unzip "
            f"{disk / 1e6 / tub:.2f} MB/s ({tub:.1f} s), byte exact, "
            f"REF_INTERNAL and gencomp encrypted (beside the --best runs)")
        for p in (zb, ob):
            os.remove(p)

        small_tools(tmp, fq16, sam16, small_mib)

        t = time.time()
        done = {key: kid.wait() for key, kid in kids.items()}
        log(f"tools: waited {time.time() - t:.1f} s for the --best runs")
    finally:
        for kid in kids.values():
            kid.stop()
    for src in (fq16, sam4):
        name, n = os.path.basename(src), os.path.getsize(src)
        zc = f"{src}.best.cuda.gxz"
        if not same_file(zc, f"{src}.best.cpu.gxz"):
            raise SystemExit(f"tools: --best archives of {name} differ "
                             "between cuda and cpu")
        t = time.time()
        run_cli(["unzip", zc, "-o", src + ".best.out", "--device", "cuda"])
        tuc = time.time() - t
        if not same_file(src, src + ".best.out"):
            raise SystemExit(f"tools: --best unzip of {name} differs")
        cod = section_codecs(zc)
        for dev in ("cuda", "cpu"):
            secs, text = done[(src, dev)]
            log(f"tools: --best {name} ({n} bytes) zip --device {dev} "
                f"{n / 1e6 / secs:.3f} MB/s ({secs:.1f} s in its process, "
                f"beside the other runs of this phase)")
        log(f"tools: --best {name}: archives equal from cuda and cpu, ratio "
            f"{n / os.path.getsize(zc):.3f}; unzip {n / 1e6 / tuc:.2f} MB/s "
            f"({tuc:.1f} s), byte exact; sections per codec {cod}")
        log(f"tools: --best {name} --device cuda zip --show-time and "
            f"launches:\n" + done[(src, "cuda")][1])
        if src == sam4 and not cod.get("BWT"):
            raise SystemExit("tools: the --best SAM archive holds no BWT "
                             "section")
        for p in (zc, f"{src}.best.cpu.gxz", src + ".best.out"):
            os.remove(p)
    for p in (fq, fq16, sam4):
        os.remove(p)
    return aes, counts


class ChildCli:
    """The port's CLI in a child process (`python -c CHILD_CLI args`), its
    output into `log_path`; `wait` returns (seconds that its main() took,
    its output) and fails unless it exited 0."""

    def __init__(self, args, log_path):
        root = os.path.dirname(os.path.abspath(__file__))
        self.log_path = log_path
        self.log = open(log_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", CHILD_CLI, *args], cwd=root,
            env={**os.environ, "PYTHONPATH": root}, stdout=self.log,
            stderr=subprocess.STDOUT)

    def wait(self):
        rc = self.proc.wait()
        self.log.close()
        with open(self.log_path) as f:
            text = f.read()
        os.remove(self.log_path)
        if rc != 0:
            raise SystemExit(f"child {self.proc.args[3:]} exited {rc}:\n"
                             f"{text[-3000:]}")
        secs = float(text.rsplit("elapsed ", 1)[1].split()[0])
        return secs, text.rsplit("elapsed ", 1)[0].strip()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


CHILD_CLI = """
import sys, time
from chip_smoke import arith_host_calls, arith_host_line
from genozip_tpu_torch.cli import main
from genozip_tpu_torch.ops import (aes_cuda, arith_cuda, pbwt_cuda,
                                   rans_cuda)
t = time.time()
with arith_host_calls() as calls:
    rc = main(sys.argv[1:])
print("launches", {**rans_cuda.launches, **aes_cuda.launches,
                   **arith_cuda.launches, **pbwt_cuda.launches})
print(arith_host_line(calls))
if any(arith_cuda.launches.values()) or any(pbwt_cuda.launches.values()):
    print("a CLI command launched an ARITH or PBWT kernel")
    rc = 3
print(f"elapsed {time.time() - t:.3f}")
sys.exit(rc)
"""


def small_tools(tmp, fq16, sam16, small_mib):
    """--tar, --replace, --truncate, --biopsy and a .cram input read through
    a samtools shim, on the card."""
    import tarfile
    j = os.path.join
    a, b = j(tmp, "t1.fastq"), j(tmp, "t2.sam")
    cut_records(fq16, a, small_mib * MIB, 4)
    cut_records(sam16, b, small_mib * MIB)
    tar = j(tmp, "two.tar")
    run_cli(["zip", a, b, "--tar", tar, "--device", "cuda"], True)
    with tarfile.open(tar) as tf:
        members = {m.name: tf.extractfile(m).read() for m in tf.getmembers()}
    for src in (a, b):
        run_cli(["zip", src, "-o", src + ".own.gxz", "--device", "cuda",
                 "-q"])
        with open(src + ".own.gxz", "rb") as f:
            if members.get(os.path.basename(src) + ".gxz") != f.read():
                raise SystemExit(f"tools: --tar member of {src} differs from "
                                 "its own archive")
        os.remove(src + ".own.gxz")
    log(f"tools: --tar of two inputs: members {sorted(members)} equal each "
        f"input's own archive")

    keep = a + ".orig"
    os.link(a, keep)
    run_cli(["zip", a, "-o", a + ".gxz", "--replace", "--device", "cuda",
             "-q"], True)
    if os.path.exists(a):
        raise SystemExit("tools: --replace left its input")
    run_cli(["unzip", a + ".gxz", "-o", a, "--device", "cuda"])
    if not same_file(a, keep):
        raise SystemExit("tools: the --replace archive does not unzip")
    log("tools: --replace removed its input after the digest verified; the "
        "archive unzips byte exact")

    cut = j(tmp, "cut.fastq")
    with open(keep, "rb") as f, open(cut, "wb") as g:
        data = f.read()
        g.write(data[:len(data) * 2 // 3 + 7])
    run_cli(["zip", cut, "-o", cut + ".gxz", "--truncate", "--device",
             "cuda", "-q"])
    run_cli(["unzip", cut + ".gxz", "-o", cut + ".out", "--device", "cuda"])
    with open(cut + ".out", "rb") as f:
        got = f.read()
    if not (got.endswith(b"\n") and data.startswith(got) and
            0 < len(data) * 2 // 3 + 7 - len(got) < 1000):
        raise SystemExit("tools: --truncate did not keep the whole records "
                         "before the cut")
    log(f"tools: --truncate of a FASTQ cut mid-record: {len(got)} of "
        f"{len(data) * 2 // 3 + 7} bytes kept, whole records, byte exact")

    vblock = str(max(1, os.path.getsize(fq16) // (4 * MIB)))
    run_cli(["zip", fq16, "--biopsy", "2", "--vblock", vblock, "--device",
             "cuda"], True)
    run_cli(["zip", fq16, "-o", fq16 + ".vb.gxz", "--vblock", vblock,
             "--device", "cuda", "-q"])
    vb2 = run_cli(["cat", fq16 + ".vb.gxz", "--one-vb", "2", "--device",
                   "cuda"], True)
    with open(fq16 + ".vb2", "rb") as f:
        if f.read() != vb2 or not vb2:
            raise SystemExit("tools: --biopsy 2 differs from VB 2")
    log(f"tools: --biopsy 2 at --vblock {vblock} equals VB 2 ({len(vb2)} "
        f"bytes)")

    shims = j(tmp, "bin")
    os.makedirs(shims, exist_ok=True)
    with open(j(shims, "samtools"), "w") as f:
        f.write(f"#!/bin/sh\nexec /bin/cat {b}\n")
    os.chmod(j(shims, "samtools"), 0o755)
    cram = j(tmp, "in.cram")
    with open(cram, "wb") as f:
        f.write(b"opaque")
    path = os.environ["PATH"]
    os.environ["PATH"] = shims + os.pathsep + path
    try:
        run_cli(["zip", cram, "-o", cram + ".gxz", "--device", "cuda", "-q"])
    finally:
        os.environ["PATH"] = path
    run_cli(["unzip", cram + ".gxz", "-o", cram + ".sam", "--device",
             "cuda"])
    if not same_file(b, cram + ".sam"):
        raise SystemExit("tools: the .cram input's archive does not unzip "
                         "to the SAM text samtools printed")
    log("tools: a .cram input read through a samtools shim: its archive "
        "unzips to the SAM text")
    for p in (a, a + ".gxz", keep, b, tar, cut, cut + ".gxz", cut + ".out",
              fq16 + ".vb2", fq16 + ".vb.gxz", cram, cram + ".gxz",
              cram + ".sam"):
        os.remove(p)


# --- phase 11: parallel ------------------------------------------------------

CARD = "cuda:0"       # the card of phase 11's device lists
SEED_CAND_OPS = 34   # a candidate's k-mer, hash, lookup and checks
# rows of the spread edge batches: over twice the warps resident on an H100
# (3,168 at Lb <= 1024), so each warp's stride crosses reads of other lengths
SEED_SPREAD_ROWS = 8192
MESH_VB_READS = 16 * MIB // 342   # one 16 MiB VB of 150 bp reads


def seed_align_traffic(codes, lens, rh, G, hash_bits):
    """(bytes, operations) that the seed aligner needs on these reads: of
    each read's codes the 32-byte sectors it reads (its bases, at least
    the first k-mer's 16), lens and the outputs once; for each of a read's
    8 candidates one 32-byte refhash sector and SEED_CAND_OPS operations;
    the genome window of each distinct (read, start) among the usable
    candidates once, in 32-byte sectors (a repeated start is read again
    from L2, not from memory); two operations a base of every usable
    candidate's compare."""
    from genozip_tpu_torch.ops import align_torch
    starts, oks, _ = align_torch.candidates(codes, lens, rh, G, hash_bits)
    R, Lb = codes.shape
    span = lens.long().clamp(max=Lb)[:, None]
    extent = span.clamp(min=min(16, Lb))
    code_bytes = 32 * int(((extent + 31) // 32).sum())
    s = torch.where(oks, starts, -1).sort(1).values
    first = torch.ones_like(oks)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    sectors = torch.where(first & (s >= 0),
                          (s + span - 1) // 32 - s // 32 + 1, 0)
    nbytes = code_bytes + 4 * R + 14 * R + 8 * 32 * R + 32 * int(sectors.sum())
    ops = 8 * R * SEED_CAND_OPS + 2 * int(torch.where(oks, span, 0).sum())
    return nbytes, ops


def seed_align_batches(ref, fq, rng):
    """The edge batches, as (label, codes, lens, src, tie row, tie start):
    tests/torch_seed_reads.edge_batch at Lb = 256 and at Lb = 130 (rows
    not a multiple of 4 bytes), each spread over SEED_SPREAD_ROWS rows (row
    i is the batch's row src[i]); the 256 one also with its codes one byte
    past an aligned address (label "offset"). Then one cfg4 VB of reads
    (the first MESH_VB_READS reads of `fq`, 150 bp, Lb = 256) as padded
    (codes, lens) numpy arrays."""
    from genozip_tpu_torch.ops import pack
    from tests.torch_seed_reads import edge_batch, spread
    edges = []
    for Lb in (256, 130):
        codes, lens, tie, p1 = edge_batch(ref, rng, Lb)
        codes, lens, src = spread(codes, lens, rng, SEED_SPREAD_ROWS)
        edges.append((f"edge Lb={Lb}", codes, lens, src, tie, p1))
    edges.append(("offset",) + edges[0][1:])
    Lb = 256
    lines = head_records(fq, MESH_VB_READS).split(b"\n")[1::4]
    seq = np.frombuffer(b"".join(lines), np.uint8).reshape(len(lines), -1)
    codes = np.zeros((seq.shape[0], Lb), np.uint8)
    codes[:, :seq.shape[1]] = pack.BASE2BIT[seq]
    return edges, (codes, np.full(seq.shape[0], seq.shape[1], np.int32))


def seed_launch(c, ln, genome, rh, hb):
    """One launch of the seed_align kernel through its C entry point on
    outputs allocated once, on the current stream (for graph_ms)."""
    from genozip_tpu_torch.ops import align_cuda
    R, Lb = c.shape
    outs = [torch.empty(R, dtype=dt, device=c.device) for dt in
            (torch.int64, torch.bool, torch.int32, torch.bool)]

    def launch():
        rc = align_cuda.lib().seed_align(
            c.data_ptr(), ln.data_ptr(), R, Lb, genome.data_ptr(),
            rh.data_ptr(), genome.numel(), hb, *(t.data_ptr() for t in outs),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"seed_align: CUDA error {rc}")
    return launch


def check_seed_align(ref, fq):
    """The seed_align kernel against its plain version on the card, output
    for output, at the edge batches (seed_align_batches; the tie read's
    first candidate must win in each) and at one cfg4 VB; then timed at the
    VB: through its wrapper and the plain version (CUDA events), and the
    kernel alone (graph_ms of its C entry point). Returns (max_abs_err, ms,
    plain ms, bytes, bound ms, bound by, ms alone)."""
    from genozip_tpu_torch.ops import align_cuda, align_torch
    hb = ref.hash_bits
    genome = torch.from_numpy(np.array(ref.codes, np.uint8)).cuda()
    rh = torch.from_numpy(np.array(ref.refhash[:1 << hb], np.uint32)
                          .view(np.int32)).cuda()
    edges, vb = seed_align_batches(ref, fq, np.random.default_rng(18))
    err = 0
    for label, codes, lens, src, tie, p1 in edges + [("vb",) + vb + (
            None, None, None)]:
        c, ln = torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda()
        if label == "offset":
            buf = torch.empty(codes.size + 1, dtype=torch.uint8,
                              device="cuda")
            c = buf[1:].view(codes.shape)
            c.copy_(torch.from_numpy(codes))
            assert c.data_ptr() % 4
        k = align_cuda.seed_align(c, ln, genome, rh, hb)
        p = align_torch.seed_align_plain(c, ln, genome, rh, hb)
        torch.cuda.synchronize()
        e = max(int((a.long() - b.long()).abs().max()) for a, b in zip(k, p))
        if e or not all(torch.equal(a, b) for a, b in zip(k, p)):
            raise SystemExit(f"seed_align {label}: kernel differs from plain "
                             f"(max_abs_err {e})")
        err = max(err, e)
        log(f"kernel seed_align {label}: R={codes.shape[0]} Lb="
            f"{codes.shape[1]} equal to plain, max_abs_err {e}, aligned "
            f"{k[3].float().mean().item():.4f}")
        if src is not None:
            ties = torch.from_numpy(np.nonzero(src == tie)[0]).cuda()
            if not ((k[0][ties] == p1).all() and k[1][ties].all()):
                raise SystemExit(f"seed_align {label}: the tie read's first "
                                 "candidate did not win")
    ms = cuda_ms(lambda: align_cuda.seed_align(c, ln, genome, rh, hb), 5)
    ams = graph_ms(seed_launch(c, ln, genome, rh, hb))
    pms = cuda_ms(lambda: align_torch.seed_align_plain(c, ln, genome, rh, hb),
                  1)
    nbytes, ops = seed_align_traffic(c, ln, rh, ref.length, hb)
    bms, by = bound_ms(nbytes, ops)
    log(f"kernel seed_align: {ms:.4f} ms through the wrapper at one cfg4 VB "
        f"({codes.shape[0]} reads, Lb={codes.shape[1]}; {ams:.4f} ms "
        f"alone), plain {pms:.3f} ms, bound {bms:.6f} ms ({by}: {nbytes} "
        f"bytes, {ops} operations), share {100 * bms / ms:.2f}% "
        f"({100 * bms / ams:.2f}% alone), on {torch.cuda.get_device_name(0)}")
    return err, ms, pms, nbytes, bms, by, ams


def aligned_share(z, ref):
    """Share of reads the archive's FASTQ VBs hold as aligned (SQBITMAP)."""
    from genozip_tpu_torch import piz_pipeline
    pr = piz_pipeline.PizReader(z, ref)
    try:
        bms = [pr.load_vb(i, 0)[1]["SQBITMAP"]["local"][0]
               for i in range(1, pr.num_vbs() + 1)]
    finally:
        pr.close()
    return float(np.concatenate(bms).astype(bool).mean())


def check_sharded_codecs(rng):
    """ShardedZipEncoder and ShardedPizDecoder on ["cuda:0"] * 4 against
    the same classes on four CPU devices (the kernels' plain versions),
    byte for byte, and the payloads back."""
    from genozip_tpu_torch.parallel import piz_sharded, zip_sharded
    seqs, quals = main_path_streams(
        rng, [int(rng.integers(256 << 10, MIB)) for _ in range(R)])
    items = [(d, 0) for d in seqs] + [(d, 1) for d in quals] + \
        [(d, i % 2) for i, d in enumerate(edge_streams(rng))]
    datas = [d for d, _ in items]
    blobs = {dev: zip_sharded.ShardedZipEncoder(
        devices=[dev] * 4).encode_sections(items) for dev in (CARD, "cpu")}
    if blobs[CARD] != blobs["cpu"]:
        raise SystemExit("ShardedZipEncoder: cuda differs from plain")
    for dev in (CARD, "cpu"):
        dec = piz_sharded.ShardedPizDecoder(devices=[dev] * 4, min_size=1024)
        if dec.decode_sections(blobs[CARD]) != datas:
            raise SystemExit(f"ShardedPizDecoder on {dev}: payloads differ")
    log(f"parallel: ShardedZipEncoder/ShardedPizDecoder on 4 x cuda:0 equal "
        f"to 4 x cpu and the payloads, {len(items)} streams of "
        f"{sum(map(len, datas))} bytes")


def check_flagship():
    """The flagship step on the card (2 shards on cuda:0) equals its run on
    two CPU devices; then scaling_bench.py's line for one card."""
    from genozip_tpu_torch.parallel import flagship
    seq, qual, _, _ = flagship.example_batch(reads=4096, read_len=128)
    outs = {dev: flagship.make_sharded_step(flagship.Mesh([dev] * 2))(
        seq, qual) for dev in (CARD, "cpu")}
    a, b = outs[CARD], outs["cpu"]
    same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and \
        all(torch.equal(x.cpu(), y) for x, y in zip(a[2], b[2])) and \
        a[3] == b[3]
    if not same:
        raise SystemExit("flagship: the step on the card differs from the CPU")
    mbps = flagship.bench_encode([torch.device(CARD)], 4096, 128, 3)
    log(f"parallel: flagship step on the card equal to the CPU's (2 shards, "
        f"{sum(b[3])} bytes); scaling_bench line "
        + json.dumps({"devices": 1, "encode_MBps": round(mbps, 1),
                      "weak_scaling_eff": 1.0}))


def phase_parallel(tmp, smi, fq=None, mesh_mib=64, hosts_mib=32,
                   small_mib=16, full_mib=128, genome_bp=CHR20_BP):
    """Phase 11 on phase 6's genome, reference and R1 and phase 4's FASTQ
    and archive (made here at these sizes when those phases did not run).
    Returns (seed_align's measurements, its launches over the mesh run, the
    rANS launches over the phase)."""
    from genozip_tpu_torch import codecs, synth
    from genozip_tpu_torch.ops import align_cuda, rans_cuda
    from genozip_tpu_torch.parallel import piz_sharded
    from genozip_tpu_torch.ref import refstore
    from genozip_tpu_torch.zip_pipeline import profiler
    ref, r1 = os.path.join(tmp, CFG4_REF), os.path.join(tmp, CFG4_R1)
    if not os.path.exists(r1):
        g = synth.genome(np.random.default_rng(20), genome_bp)
        synth.write_fasta(os.path.join(tmp, "p11.fa"), g)
        run_cli(["zip", "--make-reference", os.path.join(tmp, "p11.fa"),
                 "-o", ref, "--device", "cuda"], True)
        synth.write_paired_fastq(r1, r1 + ".r2", g, mesh_mib * MIB, seed=4)
        os.remove(r1 + ".r2")
    if fq is None:
        fq = os.path.join(tmp, "reads.fastq")
        synth.write_fastq(fq, full_mib * MIB, seed=512)
        run_cli(["zip", fq, "-o", fq + ".gxz", "--device", "cuda", "-q"])
    torch.cuda.synchronize()
    rans_cuda.reset_launches()
    seed = check_seed_align(refstore.load_ref_file(ref), r1)

    # the mesh aligner against the host aligner on one file, in turns
    size, res = os.path.getsize(r1), {}
    for label, extra in (("host", []), ("mesh", ["--mesh", "1"])):
        z, out = r1 + f".{label}.gxz", r1 + ".out"
        torch.cuda.synchronize()
        profiler.reset()
        align_cuda.reset_launches()
        t = time.time()
        run_cli(["zip", r1, "--reference", ref, "--vblock", "16", "-o", z,
                 "--device", "cuda", "-q"] + extra)
        tz = time.time() - t
        torch.cuda.synchronize()
        seed_launches = align_cuda.launches["seed_align"]
        align_s = profiler._totals.get("zip:align", 0.0)
        t = time.time()
        run_cli(["unzip", z, "-o", out, "--reference", ref, "--device",
                 "cuda"])
        tu = time.time() - t
        if not same_file(r1, out):
            raise SystemExit(f"parallel: {label} unzip differs from the input")
        share = aligned_share(z, ref)
        res[label] = (seed_launches, share)
        log(f"parallel: zip --reference{' --mesh 1' if extra else ''} "
            f"--vblock 16 of {size} bytes: zip {size / 1e6 / tz:.2f} MB/s "
            f"({tz:.1f} s, zip:align {align_s:.2f} s), unzip "
            f"{size / 1e6 / tu:.2f} MB/s ({tu:.1f} s), ratio "
            f"{size / os.path.getsize(z):.3f}, aligned {share:.4f}, "
            f"seed_align launches {seed_launches}, on {smi}")
        for p in (z, out):
            os.remove(p)
    if res["mesh"][0] <= 0 or res["host"][0] != 0:
        raise SystemExit(f"parallel: seed_align launches {res}")
    # refhash layer 0 holds the smallest position of a slot's k-mers; at
    # cfg4's 64 Mbp over 2^24 slots (four k-mers a slot) a seed's k-mer is
    # there about a quarter of the time, so the mesh aligner places fewer
    # reads than the host aligner, which also reads layer 1
    if res["mesh"][1] <= 0.5:
        raise SystemExit(f"parallel: the mesh aligner aligned "
                         f"{res['mesh'][1]:.4f} of the reads")
    s16 = os.path.join(tmp, "r1_16.fastq")
    cut_records(r1, s16, small_mib * MIB, 4)
    zs, ts = zip_cuda_cpu([s16], s16, ["--reference", ref, "--mesh", "1",
                                       "--vblock", "16"], "parallel: mesh")
    log(f"parallel: {small_mib} MiB --mesh archives equal from cuda "
        f"({ts['cuda']:.1f} s) and cpu ({ts['cpu']:.1f} s)")
    for p in (r1, s16, *zs.values()):
        os.remove(p)

    # --dp 2, the sharded coders, piz_file_dp and --hosts 2 on cfg3
    size, z4 = os.path.getsize(fq), fq + ".gxz"
    enc = []
    with _count_items(enc):
        t = time.time()
        run_cli(["zip", fq, "--dp", "2", "-o", fq + ".dp.gxz", "--device",
                 "cuda", "-q"])
        tz = time.time() - t
    if not same_file(fq + ".dp.gxz", z4):
        raise SystemExit("parallel: the --dp 2 archive differs from phase 4's")
    # --dp N takes min(N, cards present) devices, so on one card D = 1 and
    # a batch is one VB; batches of D > 1 VBs run in the CPU tests, and D > 1
    # devices on the card only in check_sharded_codecs (4 x cuda:0)
    log(f"parallel: zip --dp 2 of {size} bytes {size / 1e6 / tz:.2f} MB/s "
        f"({tz:.1f} s), the archive equal to phase 4's; sections through "
        f"the sharded encoder: {sum(n for n, _ in enc)} in {len(enc)} calls, "
        f"D = {sorted({d for _, d in enc})}")
    check_sharded_codecs(np.random.default_rng(12))
    codecs.enable_device_rans(CARD)
    t = time.time()
    piz_sharded.piz_file_dp(z4, fq + ".out", dp=4)
    tp = time.time() - t
    if not same_file(fq, fq + ".out"):
        raise SystemExit("parallel: piz_file_dp output differs from the input")
    log(f"parallel: piz_file_dp(dp=4) {size / 1e6 / tp:.2f} MB/s ({tp:.1f} "
        f"s), byte exact")
    f32 = os.path.join(tmp, "h32.fastq")
    cut_records(fq, f32, hosts_mib * MIB, 4)
    t = time.time()
    run_cli(["zip", f32, "--hosts", "2", "-o", f32 + ".h.gxz", "--device",
             "cuda", "-q"])
    th = time.time() - t
    run_cli(["zip", f32, "-o", f32 + ".gxz", "--device", "cuda", "-q"])
    if not same_file(f32 + ".h.gxz", f32 + ".gxz"):
        raise SystemExit("parallel: the --hosts 2 archive differs from "
                         "zip_file's")
    log(f"parallel: zip --hosts 2 of {os.path.getsize(f32)} bytes in "
        f"{th:.1f} s (two worker processes on one card), equal to zip_file's")
    check_flagship()
    torch.cuda.synchronize()
    counts = dict(rans_cuda.launches)
    log(f"parallel: rANS launches over the phase {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise SystemExit(f"parallel: kernels never launched: {missing}")
    for p in (fq + ".dp.gxz", fq + ".out", f32, f32 + ".h.gxz", f32 + ".gxz"):
        os.remove(p)
    os.remove(z4)
    return seed, res["mesh"][0], counts


@contextlib.contextmanager
def _count_items(sink):
    """Append (sections, D) of every ShardedZipEncoder call."""
    from genozip_tpu_torch.parallel import zip_sharded
    orig = zip_sharded.ShardedZipEncoder.encode_sections

    def wrapped(self, items):
        sink.append((len(items), self.D))
        return orig(self, items)
    zip_sharded.ShardedZipEncoder.encode_sections = wrapped
    try:
        yield
    finally:
        zip_sharded.ShardedZipEncoder.encode_sections = orig


def slot_to_symbol(freq):
    """Slot->symbol bytes per (freq) row that sums to 4096, 0 elsewhere: the
    table the decoder took before the packed slot entries (its copy in
    csrc/rans_micro.cu still does)."""
    f2 = freq.reshape(-1, 256).astype(np.int64)
    out = np.zeros((f2.shape[0], 4096), np.uint8)
    used = f2.sum(axis=1) == 4096
    syms = np.tile(np.arange(256, dtype=np.uint8), int(used.sum()))
    out[used] = np.repeat(syms, f2[used].reshape(-1)).reshape(-1, 4096)
    return out.reshape(freq.shape[:-1] + (4096,))


def micro_lib():
    from genozip_tpu_torch.ops import rans_cuda
    L = ctypes.CDLL(rans_cuda.lib_path("rans_micro"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    L.micro_chain.argtypes = [ci, ci, ctypes.c_longlong, vp, vp]
    L.micro_decode_v2_o0.argtypes = [ci, vp, vp, vp, vp, vp, ci, vp]
    L.micro_decode_v2_o1.argtypes = [ci, vp, vp, vp, vp, vp, ci, vp]
    L.micro_decode_tile_o0.argtypes = [vp, vp, vp, vp, vp, ci, vp]
    L.micro_decode_tile_o1.argtypes = [vp, vp, vp, vp, vp, ci, vp]
    L.micro_cluster_sync.argtypes = [ci, ci, vp, vp]
    L.micro_encode_v3_o0.argtypes = [vp, vp, vp, vp, vp, vp, ci, vp]
    L.micro_encode_v3_o1.argtypes = [vp, vp, vp, vp, vp, vp, ci, vp]
    L.micro_encode_pass1.argtypes = [ci, ci, vp, vp, vp, vp, ci,
                                     ctypes.c_longlong, vp]
    L.micro_encode_chain.argtypes = [ci, ci, ci, vp, vp, vp]
    for f in (L.micro_chain, L.micro_decode_v2_o0, L.micro_decode_v2_o1,
              L.micro_decode_tile_o0, L.micro_decode_tile_o1,
              L.micro_cluster_sync, L.micro_encode_v3_o0,
              L.micro_encode_v3_o1, L.micro_encode_pass1,
              L.micro_encode_chain):
        f.restype = ci
    return L


def devfns_floor_lib():
    """csrc/devfns_micro.cu: the ARITH step's and the PBWT row's chain
    floors."""
    from genozip_tpu_torch.ops import rans_cuda
    L = ctypes.CDLL(rans_cuda.lib_path("devfns_micro"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    L.arith_step_floor.argtypes = [ci, ctypes.c_longlong, ci, ci, ci, ci, vp,
                                   vp]
    L.pbwt_row_floor.argtypes = [ctypes.c_longlong, ci, ci, ci, vp, vp]
    L.arith_step_floor.restype = L.pbwt_row_floor.restype = ci
    return L


def _ok(what, rc):
    if rc:
        raise SystemExit(f"micro {what}: CUDA error {rc}")


V2_VARIANTS = ((3, "stores+loads"), (2, "loads, no stores"),
               (1, "stores, no loads"), (0, "neither"))


def phase_micro(rng, smi):
    """Phase 2b: (a) the chain floor, the word ranking alone (block_rank of
    the encoders, block_rank_runs of the decoders), at N = 1024 and 8192;
    (b) the decoder before the redesign (csrc/rans_micro.cu) per step at
    N = 1024 and 8192 on one VB stream of each order, with its symbol stores
    and renorm-word loads switched off in turn, beside the design with a
    shared-memory tile (rans_micro.cu) and the shipped decoder on the same
    stream; (c) one barrier.cluster over 1,
    2, 4 and 8 blocks of 1024 threads, beside __syncthreads; (d) the
    encoders (micro_encoders). Prints one `micro {...}` JSON line (us per
    step, ns per barrier)."""
    from genozip_tpu_torch.ops import rans_cuda, rans_torch as rt
    L = micro_lib()
    st = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(1024, dtype=torch.int32, device="cuda")
    res = {"card": smi}
    K = 4096
    for runs, rank in ((0, "block_rank"), (1, "block_rank_runs")):
        for N in (1024, 8192):
            ms = cuda_ms(lambda: _ok("chain", L.micro_chain(
                runs, N, K, sink.data_ptr(), st)), 3)
            res[f"chain_{rank}_N{N}_us_per_step"] = ms * 1e3 / K
            log(f"micro chain floor N={N}: {ms * 1e3 / K:.3f} us per step "
                f"({rank} alone, {K} steps)")
    one_seq, one_qual = main_path_streams(rng, [VB_STREAM])
    for order, data in ((0, one_seq[0]), (1, one_qual[0])):
        for N in (1024, 8192):
            bufs = rans_cuda.encode_many([data], order, "cuda", N)
            d = rt.prepare_decode(bufs)
            steps = int(d.meta[0, 4])
            s2s = torch.from_numpy(slot_to_symbol(d.tab[:, 0].numpy()))
            w, m, tb, ss = (t.cuda() for t in (d.words, d.meta, d.tab, s2s))
            out = torch.empty(d.n_out, dtype=torch.uint8, device="cuda")
            fn = L.micro_decode_v2_o0 if order == 0 else L.micro_decode_v2_o1
            for var, label in V2_VARIANTS:
                def run(var=var):
                    _ok("decode_v2", fn(var, w.data_ptr(), m.data_ptr(),
                                        tb.data_ptr(), ss.data_ptr(),
                                        out.data_ptr(), 1, st))
                ms = cuda_ms(run, 5)
                if var == 3 and out.cpu().numpy().tobytes() != data:
                    raise SystemExit("micro decode_v2: differs from the input")
                key = f"v2_o{order}_N{N}_{label.replace(' ', '_')}"
                res[key] = ms * 1e3 / steps
                log(f"micro decode before redesign o{order} N={N} {label}: "
                    f"{ms:.3f} ms, {ms * 1e3 / steps:.3f} us per step "
                    f"(K={steps})")
            tfn = L.micro_decode_tile_o0 if order == 0 \
                else L.micro_decode_tile_o1
            slots = torch.empty((1, 256, 4096), dtype=torch.int32,
                                device="cuda")

            def tile():
                _ok("decode_tile", tfn(w.data_ptr(), m.data_ptr(),
                                       tb.data_ptr(), slots.data_ptr(),
                                       out.data_ptr(), 1, st))
            ms = cuda_ms(tile, 5)
            if out.cpu().numpy().tobytes() != data:
                raise SystemExit("micro decode_tile: differs from the input")
            res[f"tile_o{order}_N{N}"] = ms * 1e3 / steps
            log(f"micro decode with a shared-memory tile o{order} N={N}: "
                f"{ms:.3f} ms, {ms * 1e3 / steps:.3f} us per step")
            kfn = rans_cuda.rans_decode_o0 if order == 0 \
                else rans_cuda.rans_decode_o1
            ms = cuda_ms(lambda: kfn(w, m, tb, d.n_out), 5)
            res[f"new_o{order}_N{N}"] = ms * 1e3 / steps
            log(f"micro decode as shipped (rows + unstripe) o{order} N={N}: "
                f"{ms:.3f} ms, {ms * 1e3 / steps:.3f} us per step")
    iters = 100000
    for c in (0, 1, 2, 4, 8):
        ms = cuda_ms(lambda: _ok("cluster_sync", L.micro_cluster_sync(
            c, iters, sink.data_ptr(), st)), 3)
        what = "__syncthreads" if c == 0 else f"barrier.cluster x{c}"
        res[f"sync_{c}_ns"] = ms * 1e6 / iters
        log(f"micro {what} (1024 threads a block): "
            f"{ms * 1e6 / iters:.1f} ns per barrier")
    res.update(micro_encoders(L, st, one_seq[0], one_qual[0]))
    log("micro " + json.dumps(res))
    return res


def micro_encoders(L, st, seq, qual):
    """Phase 2b (d): us per step at N = 1024 and 8192 on one VB stream of
    each order (packed SEQ, packed QUAL) for the encoder before the
    lane-parallel redesign (csrc/rans_micro.cu), the new pass 1 alone
    without and with its word stores, and the whole new encoder (entries,
    stripe, pass 1, scan, scatter) through its C entry point on buffers
    allocated once (device time) and through the wrapper (what the main
    path pays, host work included); the old and new encoders' streams must
    equal rans_np.encode."""
    from genozip_tpu_torch.ops import rans_cuda, rans_np, rans_torch as rt
    res = {}
    # the chain floor: 16 entries of varied frequencies, no memory traffic
    f16 = np.array([1, 2, 3, 7, 100, 255, 1000, 1365, 2047, 2049, 3000, 3500,
                    4000, 4095, 4096, 512], np.int32)
    tab = torch.from_numpy(np.stack([f16, (np.arange(16) * 255) % 4096])
                           .astype(np.int32)[None])
    ent16 = rt.enc_entries(tab)[0].numpy().astype(np.uint32).view(np.int32)
    ent16 = torch.from_numpy(ent16.copy()).cuda()
    sink = torch.zeros(1024, dtype=torch.int32, device="cuda")
    K = 4096
    for wide, what in ((1, "64-bit emit compare"), (0, "32-bit emit compare")):
        for N in (1024, 8192):
            ms = cuda_ms(lambda: _ok("chain", L.micro_encode_chain(
                wide, N, K, ent16.data_ptr(), sink.data_ptr(), st)), 3)
            res[f"enc_chain_{'u64' if wide else 'u32'}_N{N}"] = ms * 1e3 / K
            log(f"micro encode chain floor N={N} ({what}): "
                f"{ms * 1e3 / K:.4f} us per step ({K} steps)")
    for order, data in ((0, seq), (1, qual)):
        for N in (1024, 8192):
            b = rt.prepare_encode([data], order, N)
            n, steps = len(data), int(b.meta[0, 3])
            dv, mv, tv = (t.cuda() for t in (b.data, b.meta, b.tab))
            want = rans_np.encode(data, order, n_lanes=N)
            words = torch.empty(b.n_words, dtype=torch.int16, device="cuda")
            p = torch.empty(1, dtype=torch.int64, device="cuda")
            states = torch.empty(b.n_states, dtype=torch.int32, device="cuda")
            ptrs = [t.data_ptr() for t in (dv, mv, tv)]
            outs = [t.data_ptr() for t in (words, p, states)]
            v3 = L.micro_encode_v3_o0 if order == 0 else L.micro_encode_v3_o1
            kfn = rans_cuda.rans_encode_o0 if order == 0 \
                else rans_cuda.rans_encode_o1
            work = torch.empty(rans_cuda.encode_work_bytes(order, 1, n),
                               dtype=torch.uint8, device="cuda")
            _ok("encode", getattr(rans_cuda.lib(), kfn.__name__)(
                *ptrs, work.data_ptr(), *outs, 1, n, st))
            if rt.finish_encode(b, words, p, states)[0] != want:
                raise SystemExit("micro encode: differs from rans_np")
            runs = [
                ("v3", "before the redesign (block_rank a step)",
                 lambda: _ok("encode_v3", v3(*ptrs, *outs, 1, st))),
                ("pass1_nostore", "pass 1 alone, no word stores",
                 lambda: _ok("pass1", L.micro_encode_pass1(
                     order, 0, ptrs[1], ptrs[2], work.data_ptr(), outs[2], 1,
                     n, st))),
                ("pass1", "pass 1 alone",
                 lambda: _ok("pass1", L.micro_encode_pass1(
                     order, 1, ptrs[1], ptrs[2], work.data_ptr(), outs[2], 1,
                     n, st))),
                ("new_device", "as shipped, C entry point, buffers "
                 "allocated once",
                 lambda: _ok("encode", getattr(rans_cuda.lib(), kfn.__name__)(
                     *ptrs, work.data_ptr(), *outs, 1, n, st))),
                ("new", "as shipped through the wrapper (entries, stripe, "
                 "pass 1, scan, scatter)",
                 lambda: kfn(dv, mv, tv, b.n_words, b.n_states)),
            ]
            for key, label, fn in runs:
                ms = cuda_ms(fn, 5)
                if key == "v3" and \
                        rt.finish_encode(b, words, p, states)[0] != want:
                    raise SystemExit("micro encode_v3: differs from rans_np")
                res[f"enc_{key}_o{order}_N{N}"] = ms * 1e3 / steps
                log(f"micro encode o{order} N={N} {label}: {ms:.4f} ms, "
                    f"{ms * 1e3 / steps:.4f} us per step (K={steps})")
    return res


AB_CASES = [  # label, streams, kernel, order, lanes (None: choose_num_lanes)
    ("seq_r8", "seq_r8", "rans_decode_o0", 0, None),
    ("rawqual_r8", "rawqual_r8", "rans_decode_o1", 1, None),
    ("qual_r8", "qual_r8", "rans_decode_o1", 1, None),
    ("vbseq", "vbseq", "rans_decode_o0", 0, None),
    ("vbqual", "vbqual", "rans_decode_o1", 1, None),
    ("vbseq_n1024", "vbseq", "rans_decode_o0", 0, 1024),
    ("vbqual_n1024", "vbqual", "rans_decode_o1", 1, 1024),
    ("refhash", "refhash", "rans_decode_o0", 0, None),
    ("enc_seq_r8", "seq_r8", "rans_encode_o0", 0, None),
    ("enc_rawqual_r8", "rawqual_r8", "rans_encode_o1", 1, None),
    ("enc_qual_r8", "qual_r8", "rans_encode_o1", 1, None),
    ("enc_vbseq", "vbseq", "rans_encode_o0", 0, None),
    ("enc_vbqual", "vbqual", "rans_encode_o1", 1, None),
    ("enc_seq_r8_n1024", "seq_r8", "rans_encode_o0", 0, 1024),
    ("enc_vbseq_n1024", "vbseq", "rans_encode_o0", 0, 1024),
    ("enc_vbqual_n1024", "vbqual", "rans_encode_o1", 1, 1024),
]
AB_CHILD = """
import json, sys
import numpy as np
import chip_smoke
z = np.load(sys.argv[1])
out = {}
for label, streams, name, order, lanes in json.loads(sys.argv[2]):
    keys = sorted((k for k in z.files if k.split("__")[0] == streams),
                  key=lambda k: int(k.split("__")[1]))
    datas = [z[k].tobytes() for k in keys]
    out[label] = chip_smoke.check_kernel(name, order,
                                         name.startswith("rans_encode"),
                                         datas, lanes, time_plain=False)[1]
if "aes__key" in z.files:   # the AES and seed aligner kernels
    import importlib.util
    import torch
    from genozip_tpu_torch.ops import aes_cuda, aes_torch
    from genozip_tpu_torch.ops import align_cuda, align_torch
    # graph_ms, aes_launch and seed_launch of the chip_smoke.py that runs
    # --ab: a parent's may lack them, and they launch through whichever
    # genozip_tpu_torch this process imports
    spec = importlib.util.spec_from_file_location("ab_helpers", sys.argv[3])
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    rk = aes_torch.round_keys(z["aes__key"].tobytes())
    hi, lo = aes_torch.split_counter(z["aes__ctr"].tobytes())
    for label in ("aes_1mib", "aes_64mib"):
        data = torch.from_numpy(z[label]).cuda()
        k = aes_cuda.aes256_ctr_xor_(data.clone(), rk, hi, lo)
        if not torch.equal(k, aes_torch.aes256_ctr_plain(rk, hi, lo,
                                                         data.clone())):
            raise SystemExit(f"{label}: kernel differs from plain")
        out[label] = chip_smoke.cuda_ms(
            lambda: aes_cuda.aes256_ctr_xor_(data, rk, hi, lo), 20)
        out[label + "_device"] = ab.graph_ms(ab.aes_launch(rk, hi, lo, data))
    hb = int(z["sa__hash_bits"])
    args = [torch.from_numpy(z[k]).cuda()
            for k in ("sa__codes", "sa__lens", "sa__genome", "sa__rh")]
    k = align_cuda.seed_align(*args, hb)
    p = align_torch.seed_align_plain(*args, hb)
    if not all(torch.equal(a, b) for a, b in zip(k, p)):
        raise SystemExit("seed_align: kernel differs from plain")
    out["seed_align_vb"] = chip_smoke.cuda_ms(
        lambda: align_cuda.seed_align(*args, hb), 20)
    out["seed_align_vb_device"] = ab.graph_ms(ab.seed_launch(*args, hb))
print("AB " + json.dumps(out))
"""
AB_LABELS = ("aes_1mib", "aes_1mib_device", "aes_64mib", "aes_64mib_device",
             "seed_align_vb", "seed_align_vb_device")


def ab_inputs(rng, genome_bp=CHR20_BP):
    """The inputs of --ab's AES and seed aligner cases: a key, a counter
    whose low 8 bytes carry, 1 MiB and 64 MiB of data; a genome of
    `genome_bp` bases (synth.genome) with its refhash layer 0
    (refstore.build_refhash at 2^24 slots), and one cfg4 VB of 150 bp reads
    off it (MESH_VB_READS, 0.3% substitutions, every other one reverse
    complemented, as the pairs' R2), padded to Lb = 256."""
    from genozip_tpu_torch import synth
    from genozip_tpu_torch.ops import pack
    from genozip_tpu_torch.ref import refstore
    out = {"aes__key": rng.integers(0, 256, 32, np.uint8),
           "aes__ctr": np.frombuffer(AES_COUNTERS[2], np.uint8),
           "aes_1mib": rng.integers(0, 256, MIB, np.uint8),
           "aes_64mib": rng.integers(0, 256, 64 * MIB, np.uint8)}
    codes = pack.BASE2BIT[synth.genome(rng, genome_bp)]
    hb = refstore.HASH_BITS_DEFAULT
    rh = refstore.build_refhash(codes, hb, layers=1)
    starts = rng.integers(0, genome_bp - 150, MESH_VB_READS)
    reads = pack.BASE2BIT[synth._reads(rng, pack.ACGT[codes], starts, 150)]
    reads[1::2] = (reads[1::2] ^ 3)[:, ::-1]
    rows = np.zeros((MESH_VB_READS, 256), np.uint8)
    rows[:, :150] = reads
    out.update({"sa__genome": codes, "sa__rh": rh.view(np.int32),
                "sa__codes": rows,
                "sa__lens": np.full(MESH_VB_READS, 150, np.int32),
                "sa__hash_bits": np.array(hb)})
    return out


def ab_kernels(parent, change):
    """Times the six kernels of two checkouts on the same inputs, each
    checkout in a fresh interpreter, in the order parent, change, change,
    parent; prints each run and the medians. The rANS kernels go through
    each checkout's own chip_smoke.check_kernel (byte-checked against its
    plain version); aes256_ctr (1 and 64 MiB, a counter that carries) and
    seed_align (one cfg4 VB off a 64 Mbp genome, ab_inputs) through their
    wrappers and alone (CUDA graphs of their C entry points), each checked
    against its plain version."""
    rng = np.random.default_rng(2024)
    sizes = lambda: [int(rng.integers(1 * MIB, 4 * MIB + 1)) for _ in range(R)]
    seqs, quals = main_path_streams(rng, sizes())
    _, raw = main_path_streams(rng, sizes(), raw_qual=True)
    one_seq, one_qual = main_path_streams(rng, [VB_STREAM])
    data = {"seq_r8": seqs, "rawqual_r8": raw, "qual_r8": quals,
            "vbseq": one_seq, "vbqual": one_qual,
            "refhash": [refhash_like(rng)]}
    t = time.time()
    extra = ab_inputs(rng)
    log(f"ab: AES and seed_align inputs made in {time.time() - t:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    runs = []
    with tempfile.TemporaryDirectory(prefix="gxz_ab_") as tmp:
        npz = os.path.join(tmp, "streams.npz")
        np.savez(npz, **{f"{k}__{i}": np.frombuffer(b, np.uint8)
                         for k, v in data.items() for i, b in enumerate(v)},
                 **extra)
        del extra
        for who, path in (("parent", parent), ("change", change),
                          ("change", change), ("parent", parent)):
            env = dict(os.environ, PYTHONPATH=os.path.abspath(path))
            res = subprocess.run(
                [sys.executable, "-c", AB_CHILD, npz, json.dumps(AB_CASES),
                 os.path.abspath(__file__)],
                cwd=path, env=env, capture_output=True, text=True)
            if res.returncode != 0:
                raise SystemExit(f"ab {who} ({path}) failed:\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
            line = [x for x in res.stdout.splitlines() if x.startswith("AB ")]
            runs.append((who, json.loads(line[-1][3:])))
            log(f"ab {who}: " + json.dumps(runs[-1][1]))
    for label in [c[0] for c in AB_CASES] + list(AB_LABELS):
        par = sorted(r[label] for w, r in runs if w == "parent")
        chg = sorted(r[label] for w, r in runs if w == "change")
        log(f"ab {label}: parent {par} ms, change {chg} ms, median ratio "
            f"{np.median(par) / np.median(chg):.2f}x on {smi}")
    ab_cfg3(parent, change, smi)
    return 0


# cfg3's turns: parent and change alternate, then alternate the other way
# round, so each holds as many early as late slots and a drift over the
# call (the host warming up, the card's clocks) weighs on both alike
AB_CFG3_ORDER = ("parent", "change", "parent", "change",
                 "change", "parent", "change", "parent")


def ab_cfg3(parent, change, smi):
    """cfg3 end to end for two checkouts: `zip` and `unzip` of one 512 MiB
    cfg3-shaped FASTQ through each one's CLI in a fresh interpreter
    (`--device cuda`; wall time includes start-up), in the turns of
    AB_CFG3_ORDER; each unzip must give back the input, and the log says
    whether each archive equals the parent's first one, and each side's
    median."""
    from genozip_tpu_torch import synth
    with tempfile.TemporaryDirectory(prefix="gxz_ab3_") as tmp:
        fq = os.path.join(tmp, "reads512.fastq")
        size = synth.write_fastq(fq, 512 * MIB, seed=512)
        rates = {"zip": {"parent": [], "change": []},
                 "unzip": {"parent": [], "change": []}}
        same = []
        for i, who in enumerate(AB_CFG3_ORDER):
            path = parent if who == "parent" else change
            env = dict(os.environ, PYTHONPATH=os.path.abspath(path))
            z, out = os.path.join(tmp, f"{i}.gxz"), os.path.join(tmp, "out")
            for cmd, argv in (("zip", ["zip", fq, "-o", z, "-q"]),
                              ("unzip", ["unzip", z, "-o", out])):
                t = time.time()
                subprocess.run([sys.executable, "-m", "genozip_tpu_torch"] +
                               argv + ["--device", "cuda"], cwd=path, env=env,
                               check=True, capture_output=True)
                rates[cmd][who].append(size / 1e6 / (time.time() - t))
            if not same_file(fq, out):
                raise SystemExit(f"ab cfg3 {who}: unzip output differs")
            same.append(same_file(z, os.path.join(tmp, "0.gxz")))
            os.remove(out)
        for cmd, r in rates.items():
            log(f"ab cfg3 {cmd}: parent {r['parent']} MB/s, change "
                f"{r['change']} MB/s in the order {AB_CFG3_ORDER}, medians "
                f"{np.median(r['parent']):.2f} and {np.median(r['change']):.2f}"
                f" ({size} bytes, fresh interpreter each) on {smi}")
        log(f"ab cfg3: archives equal to the first (parent's): {same}")


# --ab-host: the cells profiled per tree, and the turns of each
AB_HOST_CELLS = ("cfg5", "deep", "cfg1")
AB_HOST_ORDER = ("parent", "change", "change", "parent")
AB_HOST_CFG3_MIB = 128


def _tree_env(path):
    return dict(os.environ, PYTHONPATH=os.path.abspath(path))


def ab_host(parent, change):
    """End to end on the host, for two checkouts: scripts/profile_cell.py
    (as it is in each tree) on each cell of AB_HOST_CELLS, then `zip` and
    `unzip --show-time` of a cfg3 FASTQ of AB_HOST_CFG3_MIB through each tree's
    CLI (`--device cuda`, a fresh interpreter each), in the turns of
    AB_HOST_ORDER. A tree's host runtime is built before its first turn
    (where it has one), so no turn times g++. Prints each run's lines and
    the zip and unzip MB/s of each turn."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    for path in (parent, change):
        if os.path.exists(os.path.join(path, "genozip_tpu_torch", "native")):
            subprocess.run([sys.executable, "-c", "from genozip_tpu_torch "
                            "import native; native.lib()"], cwd=path,
                           env=_tree_env(path), check=True)
            log(f"ab-host: {path}'s host runtime built")
    for cell in AB_HOST_CELLS:
        for i, who in enumerate(AB_HOST_ORDER):
            path = parent if who == "parent" else change
            t = time.time()
            res = subprocess.run(
                [sys.executable, "scripts/profile_cell.py", "--cell", cell],
                cwd=path, env=_tree_env(path), capture_output=True, text=True)
            if res.returncode != 0:
                raise SystemExit(f"ab-host {cell} {who} failed:\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
            for line in res.stdout.splitlines():
                log(f"abh {cell} {i} {who}: {line}")
            log(f"abh {cell} {i} {who}: {time.time() - t:.1f} s in all")
    from genozip_tpu_torch import synth
    with tempfile.TemporaryDirectory(prefix="gxz_abh_") as tmp:
        fq = os.path.join(tmp, "cfg3.fastq")
        size = synth.write_fastq(fq, AB_HOST_CFG3_MIB * MIB, seed=3)
        for i, who in enumerate(AB_HOST_ORDER):
            path = parent if who == "parent" else change
            z, out = os.path.join(tmp, f"{i}.gxz"), os.path.join(tmp, "out")
            for cmd, argv in (("zip", ["zip", fq, "-o", z, "-q"]),
                              ("unzip", ["unzip", z, "-o", out])):
                t = time.time()
                res = subprocess.run(
                    [sys.executable, "-m", "genozip_tpu_torch"] + argv +
                    ["--device", "cuda", "--show-time"], cwd=path,
                    env=_tree_env(path), capture_output=True, text=True)
                wall = time.time() - t
                if res.returncode != 0:
                    raise SystemExit(f"ab-host cfg3 {cmd} {who} failed:\n"
                                     f"{res.stderr[-3000:]}")
                log(f"abh cfg3 {i} {who} {cmd}: {wall:.2f} s, "
                    f"{size / 1e6 / wall:.3f} MB/s ({size} bytes, fresh "
                    f"interpreter) on {smi}")
                for line in (res.stdout + res.stderr).splitlines():
                    log(f"abh cfg3 {i} {who} {cmd}: {line}")
            if not same_file(fq, out):
                raise SystemExit(f"ab-host cfg3 {who}: unzip output differs")
            if not same_file(z, os.path.join(tmp, "0.gxz")):
                raise SystemExit(f"ab-host cfg3 {who}: the archive differs "
                                 f"from the parent's")
            os.remove(out)
    return 0


# phase 13 (devfns): the device functions genozip_tpu leaves to XLA, X6
# (arith_jax) and X5 (pbwt_*_jnp), and their kernels
ARITH_SIZES = (0, 1, 100, 4095, 4096, 262143, 262144, MIB)
ARITH_LANES = (16, 64, 256, 1024)
ARITH_MAIN = 256 * 1024   # each stream of the main batch: 4 raw QUAL, 4
#                           packed SEQ, the device threshold's size
ARITH_NP_STEPS = 1024     # arith_np (host numpy) checks streams of <= this K
ARITH_PLAIN_STEPS = 128   # the plain version on the card: streams of <= K
ARITH_HALVING_STEPS = 256
# operations the function needs (arith_np's spec), not this kernel's own:
# a symbol: its load or store, the (f, cum) lookup, the division by the
# shared total (4: a multiply-high by the total's reciprocal, a multiply, a
# compare, a correction), two multiply-adds, the renorm test and the +INC
# of the update: 11; the symbol's cumulative frequency at order 1 (encode:
# a Fenwick prefix) and the decoder's search at either order: log2(256) = 8
# a symbol; a renorm event: a shift and a store, 2; order 0's cumulative
# row: 256 adds a step. The halving, (f + 1) >> 1 of a context when its
# total passes MAX_TOTAL, depends on the data and is not counted.
ARITH_OPS_SYMBOL, ARITH_OPS_SEARCH, ARITH_OPS_EVENT = 11, 8, 2
ARITH_OPS_STEP = {0: 256, 1: 0}
# the PBWT (pbwt_np's spec): a value: the perm load, the gather, the store,
# the bucket's count and the perm scatter, 5; a row: the 256-bucket scan
PBWT_OPS_VALUE, PBWT_OPS_ROW = 5, 256
H_1KG = 5008              # 1000 Genomes phase 3: 2,504 diploid samples
ROWS_1KG = 512            # about 5 MiB of its GT text ('0|0\t' a sample)
DEVFNS_REPS = 5


def cfg1_gt(vcf, vb_bytes=16 * MIB):
    """The GT matrix (rows, 2 S) of the first `vb_bytes` of a cfg1 VCF, one
    VB, as `_host_vcf` builds it: allele codes minus '0' (a missing '.' is
    254)."""
    with open(vcf, "rb") as f:
        text = f.read(vb_bytes)
    rows = [ln.split(b"\t") for ln in text[:text.rindex(b"\n")].split(b"\n")
            if ln and not ln.startswith(b"#")]
    if rows[0][8].split(b":")[0] != b"GT":
        raise SystemExit("devfns: cfg1's FORMAT does not start with GT")
    gts = np.frombuffer(b"".join(c[:3] for r in rows for c in r[9:]),
                        np.uint8).reshape(len(rows), -1, 3)
    if not np.isin(gts[:, :, 1], np.frombuffer(b"|/", np.uint8)).all():
        raise SystemExit("devfns: cfg1's GT cells are not diploid")
    return (gts[:, :, [0, 2]].reshape(len(rows), -1) - ord("0")) \
        .astype(np.uint8)


def haplotypes_1kg(rng, n=ROWS_1KG, H=H_1KG):
    """n rows of H haplotypes sharing ancestry blocks (tests/test_pbwt.py's
    generator at 64 founders), 3% of the alleles 2..10."""
    founders = rng.integers(0, 2, (64, n)).astype(np.uint8)
    A = founders[rng.integers(0, 64, H)].T.copy()
    A[rng.random((n, H)) < 0.01] ^= 1
    multi = rng.random((n, H)) < 0.03
    A[multi] = rng.integers(2, 11, int(multi.sum()))
    return A


def drift_stream(rng, n):
    """A stream whose 4-symbol alphabet moves along it."""
    syms = np.frombuffer(b"ABCDEFGHIJKLMNOP", np.uint8)
    parts = [rng.choice(syms[i:i + 4], -(-n // 12), p=[0.7, 0.2, 0.07, 0.03])
             for i in range(12)]
    return np.concatenate(parts)[:n].tobytes()


def arith_ops(datas, bufs, order, decode):
    """Operations the function needs on these streams (ARITH_OPS_*): the
    encoder's or, with `decode`, the decoder's."""
    ops = 0
    for d, b in zip(datas, bufs):
        n, N = len(d), 1 << b[0]
        K = -(-n // N)
        search = ARITH_OPS_SEARCH if order or decode else 0
        ops += n * (ARITH_OPS_SYMBOL + search) + K * ARITH_OPS_STEP[order] + \
            (len(b) - 6 - 4 * N) * ARITH_OPS_EVENT
    return ops


def pbwt_ops(n, H):
    return n * (H * PBWT_OPS_VALUE + PBWT_OPS_ROW)


def _event_ms(fn):
    """ms of one call of fn() on the card (CUDA events; fn may sync)."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    res = fn()
    b.record()
    torch.cuda.synchronize()
    return res, a.elapsed_time(b)


def _max_err(a, b):
    """max |a - b| of two byte strings of one length, or a failure."""
    if len(a) != len(b):
        raise SystemExit(f"devfns: {len(a)} bytes against {len(b)}")
    if not a:
        return 0
    x, y = np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8)
    return int(np.abs(x.astype(np.int16) - y).max())


def devfns_main_path(batch, gt):
    """The slice's main path, as a user calls it: the ARITH entry points
    (`arith_cuda.encode_many` / `decode_many`, both orders) on the R = 8
    batch and the PBWT ones (`pbwt.pbwt_encode_torch` / `decode_torch`) on
    one cfg1 VB's GT matrix; every kernel must launch. Returns (launch
    counts, {order: streams}, Y)."""
    from genozip_tpu_torch.ops import arith_cuda, pbwt, pbwt_cuda
    torch.cuda.synchronize()
    arith_cuda.reset_launches()
    pbwt_cuda.reset_launches()
    enc = {}
    for order in (0, 1):
        enc[order] = arith_cuda.encode_many(batch, order, device=CARD)
        if arith_cuda.decode_many(enc[order], CARD) != batch:
            raise SystemExit(f"devfns: ARITH{order} does not decode to the "
                             "batch")
    Y = pbwt.pbwt_encode_torch(gt, CARD)
    back = pbwt.pbwt_decode_torch(Y)
    torch.cuda.synchronize()
    counts = {**arith_cuda.launches, **pbwt_cuda.launches}
    if not torch.equal(back.cpu(), torch.from_numpy(gt)):
        raise SystemExit("devfns: the PBWT does not invert")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise SystemExit(f"devfns: kernels never launched: {missing}")
    return counts, enc, Y.cpu().numpy()


def check_arith_sizes(rng):
    """Both orders at every size of ARITH_SIZES and lane count of
    ARITH_LANES (and choose_num_lanes'): one encode and one decode launch a
    (order, lanes); the streams decode to the data on the card and equal
    native.arith_encode's (chosen lanes), arith_np's (K <= ARITH_NP_STEPS)
    and the plain version's on the card (K <= ARITH_PLAIN_STEPS)."""
    from genozip_tpu_torch import native, synth
    from genozip_tpu_torch.ops import arith_cuda, arith_np, arith_torch
    q = synth.qual_rows(rng, MIB // 150 + 1, 150).reshape(-1)
    datas = [q[:n].tobytes() for n in ARITH_SIZES]
    checked = {"native": 0, "arith_np": 0, "plain": 0}
    for order in (0, 1):
        for N in (None,) + ARITH_LANES:
            enc = arith_cuda.encode_many(datas, order, N, CARD)
            if arith_cuda.decode_many(enc, CARD) != datas:
                raise SystemExit(f"devfns: ARITH{order} N={N} round trip")
            for d, e in zip(datas, enc):
                lanes = N or arith_np.choose_num_lanes(len(d))
                K = -(-len(d) // lanes)
                if N is None:
                    if e != native.arith_encode(d, order) or \
                            native.arith_decode(e) != d:
                        raise SystemExit(f"devfns: ARITH{order} n={len(d)}"
                                         " differs from native")
                    checked["native"] += 1
                if K <= ARITH_NP_STEPS:
                    if e != arith_np.encode(np.frombuffer(d, np.uint8),
                                            order=order, n_lanes=N):
                        raise SystemExit(f"devfns: ARITH{order} n={len(d)} "
                                         f"N={N} differs from arith_np")
                    checked["arith_np"] += 1
                if K <= ARITH_PLAIN_STEPS:
                    t = torch.frombuffer(bytearray(d), dtype=torch.uint8) \
                        .to(CARD) if d else torch.zeros(0, dtype=torch.uint8,
                                                        device=CARD)
                    if arith_torch.encode_plain(t, order, N) != e:
                        raise SystemExit(f"devfns: ARITH{order} n={len(d)} "
                                         f"N={N} differs from its plain "
                                         "version")
                    checked["plain"] += 1
    log(f"devfns: ARITH both orders at n in {ARITH_SIZES} and N in "
        f"{('chosen',) + ARITH_LANES}: every stream decodes on the card; "
        f"streams checked equal: {checked}")
    # the model halves: order 0, N lanes all active add N * INC = 24 N a
    # step to a total kept under 2^15: every 3rd step at N = 256, every
    # step at N = 1024
    for N in (256, 1024):
        d = drift_stream(rng, N * ARITH_HALVING_STEPS)
        e = arith_cuda.encode(d, 0, N, CARD)
        t = torch.frombuffer(bytearray(d), dtype=torch.uint8).to(CARD)
        if e != arith_torch.encode_plain(t, 0, N) or \
                arith_cuda.decode(e, CARD) != d or \
                arith_torch.decode_plain(torch.frombuffer(
                    bytearray(e), dtype=torch.uint8).to(CARD)) != d:
            raise SystemExit(f"devfns: the halving stream at N={N}")
    log(f"devfns: ARITH0 on drifting streams of {ARITH_HALVING_STEPS} steps "
        f"at N = 256 (halving every 3rd step) and N = 1024 (every step): "
        f"kernel and plain version equal, both directions")


def time_arith(batch, enc, order, smi):
    """arith_encode and arith_decode on the main batch of one order:
    equal to the plain version on the card, timed through the wrapper (ms)
    and their C entry point (ms_alone), the plain version once, the bound
    and the step's chain floor. Returns {kernel: numbers}."""
    from genozip_tpu_torch.ops import arith_cuda, arith_torch
    L, F = arith_cuda.lib(), devfns_floor_lib()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    b = arith_torch.prepare_encode(batch, order)
    data, meta = b.data.to(CARD), b.meta.to(CARD)
    K = max(-(-len(d) // (1 << int(m[4]))) for d, m in
            zip(batch, b.meta.tolist()))
    thr = arith_cuda.threads_for(b.meta)
    floor = {}
    sink = torch.empty(1, dtype=torch.int64, device=CARD)
    for iters in (0, 1):
        def fl():
            rc = F.arith_step_floor(order, K, iters, 256, thr, 1,
                                    sink.data_ptr(), stream)
            if rc:
                raise SystemExit(f"arith_step_floor: CUDA error {rc}")
        floor[iters] = cuda_ms(fl, DEVFNS_REPS) * 1e3 / K
    [(db, _)] = arith_torch.prepare_decode(enc)
    nbytes = sum(map(len, batch)) + sum(map(len, enc)) + meta.numel() * 8
    cases = (("arith_encode", arith_cuda.arith_encode,
              arith_torch.encode_batch_plain, data, meta, b.out_len,
              lambda o, r: arith_torch.finish_encode(b, o, r), enc),
             ("arith_decode", arith_cuda.arith_decode,
              arith_torch.decode_batch_plain, db.bufs.to(CARD),
              db.meta.to(CARD), db.n_out,
              lambda o, r: arith_torch.finish_decode(db, o, r), batch))
    for name, kfn, pfn, src, m, size, finish, want_io in cases:
        def kern():
            return kfn(src, m, order, size)
        ko, kr = kern()
        (po, pr), pms = _event_ms(lambda: pfn(src, m, order, size))
        got, plain = finish(ko, kr), finish(po, pr)
        if got != want_io:
            raise SystemExit(f"{name} o{order}: the kernel's result is not "
                             "the entry points'")
        err = max(_max_err(x, y) for x, y in zip(got, plain))
        if err or got != plain:
            raise SystemExit(f"{name} o{order}: kernel differs from plain "
                             f"(max_abs_err {err})")
        ms = cuda_ms(kern, DEVFNS_REPS)
        o2 = torch.empty(max(size, 1), dtype=torch.uint8, device=CARD)
        r2 = torch.empty(m.shape[0], dtype=torch.int64, device=CARD)

        def alone():
            rc = getattr(L, name)(order, src.data_ptr(), m.data_ptr(),
                                  m.shape[0], thr, o2.data_ptr(),
                                  r2.data_ptr(), stream)
            if rc:
                raise SystemExit(f"{name}: CUDA error {rc}")
        ams = cuda_ms(alone, DEVFNS_REPS)
        bms, by = bound_ms(nbytes, arith_ops(batch, enc, order,
                                             name == "arith_decode"))
        out[name] = dict(err=err, ms=ms, ms_alone=ams, plain_ms=pms,
                         bound_ms=bms, bound_by=by, bytes=nbytes, steps=K,
                         step_us=ms * 1e3 / K, floor_us=floor[0],
                         floor_event_us=floor[1])
        log(f"devfns: {name} o{order}: R={len(batch)} x {ARITH_MAIN >> 10} "
            f"KiB equal to plain (max_abs_err {err}); {ms:.3f} ms through "
            f"the wrapper, "
            f"{ams:.3f} ms alone, plain {pms:.1f} ms, bound {bms:.6f} ms "
            f"({by}, {nbytes} bytes); {K} steps: {ms * 1e3 / K:.3f} us a "
            f"step against a chain floor of {floor[0]:.3f} us (no event), "
            f"{floor[1]:.3f} us (one event a lane), on {smi}")
    return out


def check_pbwt(name, A, smi, timed):
    """pbwt_encode and pbwt_decode on one matrix: equal to the plain
    version on the card and to the host runtime, and (timed) their times,
    bound and the row's chain floor. Returns {kernel: numbers}."""
    from genozip_tpu_torch import native
    from genozip_tpu_torch.ops import pbwt_cuda, pbwt_torch
    L = pbwt_cuda.lib()
    stream = torch.cuda.current_stream().cuda_stream
    flat, meta, work = pbwt_torch.prepare([torch.from_numpy(A).to(CARD)])
    thr = pbwt_cuda.threads_for(meta)
    n, H = A.shape
    Y = native.pbwt_encode(A)
    out = {}
    for kname, src, want in (("pbwt_encode", flat, Y),
                             ("pbwt_decode",
                              torch.from_numpy(Y.reshape(-1).copy()).to(CARD),
                              A)):
        fn = getattr(pbwt_cuda, kname)

        def kern():
            return fn(src, meta, work)
        got = kern()
        plain, pms = _event_ms(lambda: pbwt_torch.batch_plain(
            src, meta, kname == "pbwt_decode"))
        err = int((got.int() - plain.int()).abs().max()) if got.numel() \
            else 0
        if err or not np.array_equal(got.cpu().numpy().reshape(n, H), want):
            raise SystemExit(f"{kname} {name}: kernel differs from plain or "
                             f"the host runtime (max_abs_err {err})")
        if not timed:
            continue
        ms = cuda_ms(kern, DEVFNS_REPS)
        o2 = torch.empty_like(src)
        w2 = torch.empty(max(work, 1), dtype=torch.int32, device=CARD)

        def alone():
            rc = getattr(L, kname)(src.data_ptr(), o2.data_ptr(),
                                   meta.data_ptr(), 1, thr, w2.data_ptr(),
                                   stream)
            if rc:
                raise SystemExit(f"{kname}: CUDA error {rc}")
        ams = cuda_ms(alone, DEVFNS_REPS)
        sink = torch.empty(1, dtype=torch.int64, device=CARD)

        def fl():
            rc = devfns_floor_lib().pbwt_row_floor(n, H, thr, 1,
                                                   sink.data_ptr(), stream)
            if rc:
                raise SystemExit(f"pbwt_row_floor: CUDA error {rc}")
        floor = cuda_ms(fl, DEVFNS_REPS) * 1e3 / n
        nbytes = 2 * n * H + meta.numel() * 8
        bms, by = bound_ms(nbytes, pbwt_ops(n, H))
        out[kname] = dict(err=err, ms=ms, ms_alone=ams, plain_ms=pms,
                          bound_ms=bms, bound_by=by, bytes=nbytes, rows=n,
                          row_us=ms * 1e3 / n, floor_us=floor)
        log(f"devfns: {kname} {name} ({n} x {H}): equal to plain and the "
            f"host runtime; {ms:.3f} ms through the wrapper, {ams:.3f} ms "
            f"alone, plain {pms:.1f} ms, bound {bms:.6f} ms ({by}, {nbytes}"
            f" bytes); {ms * 1e3 / n:.3f} us a row against a chain floor of "
            f"{floor:.3f} us, on {smi}")
    if not timed:
        log(f"devfns: pbwt_encode and pbwt_decode {name} ({n} x {H}): equal"
            " to plain and the host runtime")
    return out


def phase_devfns(tmp, smi):
    """Phase 13. Returns (the main path's launch counts, {(kernel, shape):
    numbers})."""
    from genozip_tpu_torch import synth
    rng = np.random.default_rng(13)
    seqs, _ = main_path_streams(rng, [ARITH_MAIN] * 4)
    _, quals = main_path_streams(rng, [ARITH_MAIN] * 4, raw_qual=True)
    batch = [x for pair in zip(quals, seqs) for x in pair]
    vcf = os.path.join(tmp, "cfg1.vcf")
    if not os.path.exists(vcf):
        vcf = os.path.join(tmp, "devfns.vcf")
        synth.write_vcf(vcf, 16 * MIB, seed=9)
    gt = cfg1_gt(vcf)
    counts, enc, _ = devfns_main_path(batch, gt)
    log(f"devfns: main path (arith_cuda.encode_many/decode_many of R=8 "
        f"cfg3 QUAL and packed SEQ streams of {ARITH_MAIN >> 10} KiB, both "
        f"orders; "
        f"pbwt_encode_torch/decode_torch of one cfg1 VB's {gt.shape[0]} x "
        f"{gt.shape[1]} GT matrix): launches {counts}")
    meas = {}
    check_arith_sizes(rng)
    for order in (0, 1):
        for k, v in time_arith(batch, enc[order], order, smi).items():
            meas[(k, f"o{order}")] = v
    for k, v in check_pbwt("cfg1 VB", gt, smi, True).items():
        meas[(k, "cfg1")] = v
    for k, v in check_pbwt("1kg", haplotypes_1kg(rng), smi, True).items():
        meas[(k, "1kg")] = v
    check_pbwt("H = 1", rng.integers(0, 3, (64, 1)).astype(np.uint8), smi,
               False)
    check_pbwt("n = 0", np.zeros((0, 400), np.uint8), smi, False)
    return counts, meas


DEVFN_ROWS = [  # kernel, the XLA function it replaces, X-item, shape, label
    ("arith_encode", "arith_jax.py:86", "X6",
     "R = 8 of 256 KiB, 4 raw QUAL + 4 packed SEQ, order 1", "o1"),
    ("arith_decode", "arith_jax.py:124", "X6",
     "R = 8 of 256 KiB, 4 raw QUAL + 4 packed SEQ, order 1", "o1"),
    ("pbwt_encode", "pbwt.py:46", "X5", "one cfg1 VB's GT matrix, H = 400",
     "cfg1"),
    ("pbwt_decode", "pbwt.py:61", "X5", "one cfg1 VB's GT matrix, H = 400",
     "cfg1"),
]
DEVFN_ENTRIES = {
    "arith_encode": "genozip_tpu_torch.ops.arith_cuda.encode_many",
    "arith_decode": "genozip_tpu_torch.ops.arith_cuda.decode_many",
    "pbwt_encode": "genozip_tpu_torch.ops.pbwt.pbwt_encode_torch",
    "pbwt_decode": "genozip_tpu_torch.ops.pbwt.pbwt_decode_torch"}


PHASES = ("kernels", "micro", "host", "devfns", "cfg3", "entry", "cfg4",
          "parallel", "cfg5", "cfg5x", "cfg1", "tools")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ", ".join(PHASES) +
                    " (default: all, and only then the result lines)")
    ap.add_argument("--ab-host", nargs=2, metavar=("PARENT", "CHANGE"),
                    help="scripts/profile_cell.py on cfg5, deep and cfg1, "
                         "then cfg3 zip and unzip --show-time, from two "
                         "checkouts in the turns parent, change, change, "
                         "parent, and stop")
    ap.add_argument("--ab", nargs=2, metavar=("PARENT", "CHANGE"),
                    help="time the kernels of two checkouts in turns "
                         "(parent, change, change, parent), then cfg3 zip "
                         "and unzip (parent and change alternating, eight "
                         "runs), and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
        return 2
    if args.ab:
        return ab_kernels(*args.ab)
    if args.ab_host:
        return ab_host(*args.ab_host)
    phases = [x for x in args.phases.split(",") if x]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    if "cfg5x" in phases and "cfg5" not in phases:
        raise SystemExit("phase cfg5x runs on cfg5's files: add cfg5")
    t_start = time.time()
    phase_s = {}

    def timed(name, fn, *a):
        t = time.time()
        res = fn(*a)
        phase_s[name] = time.time() - t
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return res
    from genozip_tpu_torch.ops import (aes_cuda, align_cuda, arith_cuda,
                                       pbwt_cuda, rans_cuda)

    # 1. setup
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"setup: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} x{torch.cuda.device_count()}")
    t = time.time()
    report = rans_cuda.build(verbose=True, names=tuple(rans_cuda.SOURCES))
    log(f"setup: kernels and microbenchmarks built in {time.time() - t:.1f} s")
    for line in report.splitlines():
        if line.endswith(".cu:") or "registers" in line or "spill" in line \
                or "Compiling entry" in line:
            log("  ptxas:", line.strip())
    rans_cuda.lib()
    aes_cuda.lib()
    align_cuda.lib()
    arith_cuda.lib()
    pbwt_cuda.lib()
    from genozip_tpu_torch import native
    native.lib()
    log(f"setup: host runtime (genozip_tpu_torch/native) built by g++ in "
        f"{native.build_seconds:.2f} s")

    rng = np.random.default_rng(2024)
    meas, counts3, counts4, counts5, counts8 = {}, None, None, None, None
    counts1 = counts2 = rates3 = fq3 = None
    par = "parallel" in phases
    with tempfile.TemporaryDirectory(prefix="gxz_smoke_") as tmp, \
            contextlib.ExitStack() as stack:
        inputs = InputWriter(tmp, phases)
        stack.callback(inputs.stop)
        if "kernels" in phases:                         # 2
            meas.update(timed("kernels", phase_kernels, rng))
        if "micro" in phases:                           # 2b
            timed("micro", phase_micro, np.random.default_rng(7), smi)
        if "entry" in phases:
            meas.update(timed("entry", phase_entry, rng))      # 5
        t = time.time()
        inputs.wait()
        log(f"inputs of phases 7-9 ready; waited {time.time() - t:.1f} s")
        if "host" in phases:
            timed("host", phase_host, tmp, smi,
                  os.path.join(tmp, "cfg5.bam"), os.path.join(tmp, "cfg1.vcf"))

        def devfns_launches():
            return {**arith_cuda.launches, **pbwt_cuda.launches}
        dev_counts, dev_meas, dev_before = None, {}, devfns_launches()
        if "devfns" in phases:                                   # 13
            dev_counts, dev_meas = timed("devfns", phase_devfns, tmp, smi)
            dev_before = devfns_launches()
        if "cfg3" in phases:                            # 3 and 4
            counts3, rates3, fq3 = timed("cfg3", phase_cfg3, tmp, smi, 128,
                                         32, "tools" in phases or par, par)
        if "cfg4" in phases:
            counts4 = timed("cfg4", phase_cfg4, tmp, smi, CHR20_BP, 64,
                            par)                                 # 6
        if par:                                                  # 11
            seed, seed_launches, counts11 = timed(
                "parallel", phase_parallel, tmp, smi, fq3)
        if "cfg5" in phases:
            counts5, files5 = timed("cfg5", phase_cfg5, tmp, smi)  # 7
        if "cfg5x" in phases:
            counts8 = timed("cfg5x", phase_cfg5x, tmp, smi, files5)  # 8
        if "cfg1" in phases:
            counts1, counts2 = timed("cfg1", phase_cfg1, tmp, smi)   # 9
        if "tools" in phases:                                         # 10
            aes, counts10 = timed("tools", phase_tools, tmp, smi, fq3,
                                  rates3)
    log(f"phases {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}"
        f", total {time.time() - t_start:.1f} s since setup")
    # no CLI command routes to the ARITH or PBWT kernels, as in genozip_tpu
    cli_launches = {k: v - dev_before[k]
                    for k, v in devfns_launches().items()}
    log(f"ARITH and PBWT kernel launches over the CLI phases: {cli_launches}")
    if any(cli_launches.values()):
        raise SystemExit("a CLI command launched an ARITH or PBWT kernel")
    if any(k.split(".")[0] in ("jax", "genozip_tpu", "cryptography")
           for k in sys.modules):
        raise SystemExit("jax, the JAX package genozip_tpu or cryptography "
                         "was imported")
    if set(phases) != set(PHASES):
        log(f"partial run of phases {phases}: passed; no result lines")
        return 0
    rows = []
    for line, name, entry, label in TPU_ROWS:
        err, ms, pms, nbytes, nsym = meas[(name, label)]
        bms, by = bound_ms(nbytes, nsym * OPS_PER_SYMBOL)
        rows.append({"name": name, "route": "cuda",
                     "source": "genozip_tpu_torch/csrc/rans.cu",
                     "replaces": f"{PALLAS}{line}", "launches": counts4[name],
                     "max_abs_err": err, "ms": round(ms, 4),
                     "plain_ms": round(pms, 4), "bound_ms": round(bms, 6),
                     "bound_by": by, "library_ms": None,
                     "port_kernel": name,
                     "entry": f"genozip_tpu_torch.ops.rans_cuda.{entry}",
                     "shape": label, "bytes": nbytes,
                     "launches_cfg3": counts3[name],
                     "launches_cfg5": counts5[name],
                     "launches_deep": counts8[name],
                     "launches_cfg1": counts1[name],
                     "launches_cfg2": counts2[name],
                     "launches_tools": counts10[name],
                     "launches_parallel": counts11[name]})
    err, ms, pms, nbytes, bms, by, ams = aes[64 * MIB]
    rows.append({"name": "aes256_ctr", "route": "cuda",
                 "source": "genozip_tpu_torch/csrc/aes.cu",
                 "replaces": "genozip_tpu/native/gxz_native.cpp:1244",
                 "launches": counts10["aes256_ctr"], "max_abs_err": err,
                 "ms": round(ms, 4), "plain_ms": round(pms, 4),
                 "bound_ms": round(bms, 6), "bound_by": by,
                 "library_ms": None, "port_kernel": "aes256_ctr",
                 "entry": "genozip_tpu_torch.ops.aes_cuda.aes256_ctr",
                 "tpu_kernel": None,
                 "note": "no TPU kernel: genozip_tpu runs AES-256-CTR in "
                         "host C++",
                 "shape": "64 MiB", "bytes": nbytes,
                 "ms_alone": round(ams, 4),
                 "ms_1mib": round(aes[MIB][1], 4),
                 "ms_1mib_alone": round(aes[MIB][6], 4),
                 "plain_ms_1mib": round(aes[MIB][2], 4),
                 "bound_ms_1mib": round(aes[MIB][4], 6),
                 "launches_tools": counts10["aes256_ctr"]})
    err, ms, pms, nbytes, bms, by, ams = seed
    rows.append({"name": "seed_align", "route": "cuda",
                 "source": "genozip_tpu_torch/csrc/seed_align.cu",
                 "replaces": "genozip_tpu/parallel/aligner_sharded.py:65",
                 "launches": seed_launches, "max_abs_err": err,
                 "ms": round(ms, 4), "plain_ms": round(pms, 4),
                 "bound_ms": round(bms, 6), "bound_by": by,
                 "library_ms": None, "port_kernel": "seed_align",
                 "entry": "genozip_tpu_torch.ops.align_cuda.seed_align",
                 "tpu_kernel": None,
                 "note": "no Pallas kernel: genozip_tpu's mesh aligner step "
                         "is the XLA device function make_sharded_aligner's "
                         "local (X3)",
                 "ms_alone": round(ams, 4),
                 "shape": f"one cfg4 VB, {MESH_VB_READS} reads, Lb 256",
                 "bytes": nbytes, "launches_parallel": seed_launches})
    for name, line, note, shape, label in DEVFN_ROWS:
        m = dev_meas[(name, label)]
        row = {"name": name, "route": "cuda",
               "source": f"genozip_tpu_torch/csrc/{name.split('_')[0]}.cu",
               "replaces": f"genozip_tpu/ops/{line}",
               "launches": dev_counts[name], "max_abs_err": m["err"],
               "ms": round(m["ms"], 4), "plain_ms": round(m["plain_ms"], 4),
               "bound_ms": round(m["bound_ms"], 6), "bound_by": m["bound_by"],
               "library_ms": None, "port_kernel": name,
               "entry": DEVFN_ENTRIES[name], "tpu_kernel": None,
               "note": f"XLA device function ({note}), not Pallas; "
                       "launches 0 on every CLI command, as in genozip_tpu",
               "shape": shape, "bytes": m["bytes"],
               "ms_alone": round(m["ms_alone"], 4),
               "launches_cli": cli_launches[name]}
        if name.startswith("arith"):
            o0 = dev_meas[(name, "o0")]
            row.update(step_us=round(m["step_us"], 4),
                       chain_floor_us=round(m["floor_us"], 4),
                       chain_floor_event_us=round(m["floor_event_us"], 4),
                       ms_o0=round(o0["ms"], 4),
                       plain_ms_o0=round(o0["plain_ms"], 4),
                       bound_ms_o0=round(o0["bound_ms"], 6),
                       step_us_o0=round(o0["step_us"], 4),
                       chain_floor_us_o0=round(o0["floor_us"], 4))
        else:
            k1 = dev_meas[(name, "1kg")]
            row.update(row_us=round(m["row_us"], 4),
                       chain_floor_us=round(m["floor_us"], 4),
                       ms_1kg=round(k1["ms"], 4),
                       plain_ms_1kg=round(k1["plain_ms"], 4),
                       bound_ms_1kg=round(k1["bound_ms"], 6),
                       row_us_1kg=round(k1["row_us"], 4),
                       chain_floor_us_1kg=round(k1["floor_us"], 4))
        rows.append(row)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
