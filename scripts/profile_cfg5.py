#!/usr/bin/env python3
"""Device busy share of genozip_tpu_torch's cfg5 zip and unzip on the card.

    python3 scripts/profile_cfg5.py [--bam-mib 64] [--seed 5] [--deep]

Generates a cfg5-shaped BAM (`synth.write_bam`), then runs `zip --device
cuda --vblock 16` and `unzip` in this process, each under
`torch.profiler` with CPU and CUDA activity. Prints, for each command, the
wall time, MB/s (on disk and of BAM stream), the device's busy time (the
sum of the CUDA kernels' and copies' device time) and its share of the
wall time, the five busiest device ops, and the `--show-time` regions; then
checks that the unzip output equals the input. With --deep the BAM comes
with the R1/R2 FASTQ of its primaries (`synth.write_deep_fastq`), the
commands are `zip --deep BAM R1 R2 --vblock 32` and `unzip` of its three
components, and the MB/s are of the summed inputs (BAM stream and FASTQ).
Needs a CUDA device and fails without one. Writes under a temporary
directory that it removes.
"""

import argparse
import gzip
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_us(prof):
    """(total device microseconds, [(name, us, count)] busiest first), over
    the device-side events only (kernels and copies), so that no CPU op's
    share of its kernels is counted twice."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, us, e.count))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def run(argv, label, disk, txt):
    from genozip_tpu_torch.cli import main
    from genozip_tpu_torch.utils import profiler as regions
    from torch.profiler import ProfilerActivity, profile
    regions.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        if main(argv) != 0:
            raise SystemExit(f"{label} failed")
        torch.cuda.synchronize()
        wall = time.time() - t
    busy_us, rows = device_us(prof)
    print(f"{label}: {wall:.2f} s, {disk / 1e6 / wall:.3f} MB/s on disk, "
          f"{txt / 1e6 / wall:.3f} MB/s of BAM stream (or of the summed "
          f"inputs with --deep; profiler on); device busy "
          f"{busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / wall:.3f}% of the "
          f"wall time")
    for name, us, n in rows[:5]:
        print(f"  {name[:60]:60s} {us / 1e3:10.2f} ms / {n}")
    print(regions.report())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bam-mib", type=int, default=64)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--deep", action="store_true",
                    help="zip --deep the BAM with the FASTQ of its primaries")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_cfg5: no CUDA device")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    from genozip_tpu_torch import synth
    from genozip_tpu_torch.ops import rans_cuda
    rans_cuda.build(names=("rans",))
    with tempfile.TemporaryDirectory(prefix="gxz_prof_") as tmp:
        bam = os.path.join(tmp, "cfg5.bam")
        fq = [os.path.join(tmp, f"R{i}.fastq") for i in (1, 2)]
        if args.deep:
            disk = synth.write_deep_fastq(bam, *fq, args.bam_mib << 20,
                                          seed=args.seed)
        else:
            disk = synth.write_bam(bam, args.bam_mib << 20, seed=args.seed)
        with gzip.open(bam, "rb") as f:
            bam_txt = f.read()
        txt = len(bam_txt)
        print(f"input: {disk} bytes on disk, {txt} bytes of BAM stream")
        if args.deep:
            disk += sum(os.path.getsize(p) for p in fq)
            txt += sum(os.path.getsize(p) for p in fq)
            print(f"with the FASTQ: {disk} bytes on disk, {txt} of inputs")
        z, out = bam + ".gxz", os.path.join(tmp, "out.bam")
        # warm: build and load the kernels, first CUDA context work
        rans_cuda.encode_many([b"warm" * 100000], 0, "cuda")
        # deep at 32 MiB VBs, as chip_smoke.py's phase 8 runs it
        run(["zip", bam] + (fq + ["--deep"] if args.deep else []) +
            ["-o", z, "--device", "cuda", "--vblock",
             "32" if args.deep else "16", "-q"], "zip", disk, txt)
        run(["unzip", z, "-o", out, "--device", "cuda"], "unzip", disk, txt)
        if args.deep:
            outs = [(out + ".1", None)] + [
                (f"{out}.{i}", p) for i, p in enumerate(fq, start=2)]
        else:
            outs = [(out, bam)]
        for o, src in outs:
            with open(o, "rb") as a:
                if src is None:
                    same = a.read() == bam_txt
                else:
                    with open(src, "rb") as b:
                        same = a.read() == b.read()
            if not same:
                raise SystemExit(f"unzip output {o} differs from the input")
        print(f"ratio {disk / os.path.getsize(z):.3f} on disk, "
              f"{txt / os.path.getsize(z):.3f} of BAM stream (summed inputs "
              f"with --deep); unzip exact; on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
