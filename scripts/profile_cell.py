#!/usr/bin/env python3
"""Device busy share of genozip_tpu_torch's zip and unzip of one cell on the
card.

    python3 scripts/profile_cell.py [--cell cfg5|deep|cfg1] [--mib N]
                                    [--seed S] [--vblock V]

Generates the cell's input, then runs `zip --device cuda` and `unzip` in
this process, each under `torch.profiler` with CPU and CUDA activity:

- cfg5: a cfg5-shaped BAM of `--mib` (64) on disk (`synth.write_bam`),
  `--vblock` 16; MB/s on disk and of BAM stream;
- deep: the same BAM with the R1/R2 FASTQ of its primaries
  (`synth.write_deep_fastq`), `zip --deep BAM R1 R2`, `--vblock` 32, and
  `unzip` of its three components; MB/s of the summed inputs (BAM stream
  and FASTQ);
- cfg1: a cfg1-shaped VCF of `--mib` (128) (`synth.write_vcf`: 200 samples
  of GT:AD:DP:GQ:PL, GATK INFO, VEP CSQ), `--vblock` 16; MB/s of VCF.

Prints, for each command, the wall time, MB/s, the device's busy time (the
sum of the CUDA kernels' and copies' device time) and its share of the wall
time, the five busiest device ops, and the `--show-time` regions; then
checks that the unzip output equals the input. Needs a CUDA device and
fails without one. Writes under a temporary directory that it removes.
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

# cell: (input MiB, seed, --vblock)
DEFAULTS = {"cfg5": (64, 5, "16"), "deep": (64, 5, "32"),
            "cfg1": (128, 9, "16")}


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


def run(argv, label, sizes):
    """Run the CLI with `argv` under the profiler; `sizes` is [(bytes, what
    they are)] for the MB/s."""
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
    rates = ", ".join(f"{n / 1e6 / wall:.3f} MB/s {what}"
                      for n, what in sizes)
    print(f"{label}: {wall:.2f} s, {rates} (profiler on); device busy "
          f"{busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / wall:.3f}% of the "
          f"wall time")
    for name, us, n in rows[:5]:
        print(f"  {name[:60]:60s} {us / 1e3:10.2f} ms / {n}")
    print(regions.report())


def make_input(cell, tmp, nbytes, seed):
    """The cell's input: (zip's input arguments, [(bytes, what)] for the
    MB/s, [(unzip output suffix, the bytes it must hold)])."""
    from genozip_tpu_torch import synth
    if cell == "cfg1":
        vcf = os.path.join(tmp, "cfg1.vcf")
        size = synth.write_vcf(vcf, nbytes, seed=seed)
        print(f"input: {size} bytes of VCF")
        with open(vcf, "rb") as f:
            return [vcf], [(size, "of VCF")], [("", f.read())]
    bam = os.path.join(tmp, "cfg5.bam")
    fq = [os.path.join(tmp, f"R{i}.fastq") for i in (1, 2)]
    if cell == "deep":
        disk = synth.write_deep_fastq(bam, *fq, nbytes, seed=seed)
    else:
        disk = synth.write_bam(bam, nbytes, seed=seed)
    with gzip.open(bam, "rb") as f:
        want = [f.read()]
    txt = len(want[0])
    print(f"input: {disk} bytes on disk, {txt} bytes of BAM stream")
    if cell == "cfg5":
        return [bam], [(disk, "on disk"), (txt, "of BAM stream")], \
            [("", want[0])]
    for p in fq:
        with open(p, "rb") as f:
            want.append(f.read())
    fqb = sum(map(len, want[1:]))
    print(f"with the FASTQ: {disk + fqb} bytes on disk, {txt + fqb} of "
          "inputs")
    return [bam] + fq + ["--deep"], [(txt + fqb, "of the summed inputs")], \
        [(f".{i}", w) for i, w in enumerate(want, start=1)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", choices=sorted(DEFAULTS), default="cfg5")
    ap.add_argument("--mib", type=int, help="input size (default: the "
                    "cell's, 64 for cfg5 and deep, 128 for cfg1)")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--vblock", help="zip --vblock (default: the cell's)")
    args = ap.parse_args(argv)
    mib, seed, vblock = DEFAULTS[args.cell]
    mib = args.mib or mib
    seed = seed if args.seed is None else args.seed
    vblock = args.vblock or vblock
    if not torch.cuda.is_available():
        print("profile_cell: no CUDA device")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    from genozip_tpu_torch.ops import rans_cuda
    rans_cuda.build(names=("rans",))
    with tempfile.TemporaryDirectory(prefix="gxz_prof_") as tmp:
        srcs, sizes, outs = make_input(args.cell, tmp, mib << 20, seed)
        z, out = os.path.join(tmp, "in.gxz"), os.path.join(tmp, "out")
        # warm: build and load the kernels, first CUDA context work
        rans_cuda.encode_many([b"warm" * 100000], 0, "cuda")
        run(["zip"] + srcs + ["-o", z, "--device", "cuda", "--vblock", vblock,
                              "-q"], "zip", sizes)
        run(["unzip", z, "-o", out, "--device", "cuda"], "unzip", sizes)
        for suffix, want in outs:
            with open(out + suffix, "rb") as f:
                if f.read() != want:
                    raise SystemExit(f"unzip output {out + suffix} differs "
                                     "from the input")
        zsize = os.path.getsize(z)
        ratios = ", ".join(f"{n / zsize:.3f} {what}" for n, what in sizes)
        print(f"{args.cell} at --vblock {vblock}: ratio {ratios}; unzip "
              f"exact; on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
