#!/usr/bin/env python3
"""What holds the aes256_ctr and seed_align kernels under their bounds, on
the card.

    python3 scripts/kernel_probe.py [--genome-bp N]

1. The instruction mix of each kernel as compiled (cuobjdump -sass of
   build/libaes.so and build/libalign.so), by the pipe that issues it: the
   ALU pipe (LOP3, PRMT, SHF, LEA, IADD3, ...), the FMA pipe (IMAD), the
   shared-memory and shuffle pipe (LDS, STS, SHFL, REDUX) and global memory
   (LDG, STG). Static counts over the whole kernel, not per launch.
2. seed_align at one cfg4 VB (chip_smoke.ab_inputs: a 64 Mbp genome and
   49,056 reads of 150 bp) as shipped, and two probes built from the same
   source: `no_window_loads` (each window word made from its index instead
   of loaded) and `no_window_compare` (the loaded words folded with one XOR
   instead of compared and counted). Each is timed alone (CUDA graphs of its
   C entry point, chip_smoke.graph_ms), in turns, twice; the shipped one is
   checked against its plain version. The probes give wrong answers: they
   show how much of the time the window bytes and the window arithmetic
   take.

Prints the card's name and power limit first. Needs a CUDA device and
nvcc. Builds into genozip_tpu_torch/build/ (gitignored).
"""

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PIPES = {"fma": {"IMAD", "FFMA", "FMUL", "FADD"},
         "shared/shuffle": {"LDS", "STS", "SHFL", "REDUX", "VOTE"},
         "global": {"LDG", "STG"}}
CONTROL = {"BRA", "BSSY", "BSYNC", "EXIT", "NOP", "WARPSYNC", "BAR", "RET",
           "CALL", "ENDCOLLECTIVE"}


def sass_mix(lib):
    """{pipe: count} of the SASS instructions in `lib` (control flow and
    uniform-datapath instructions apart)."""
    from genozip_tpu_torch.ops import rans_cuda
    cuobjdump = os.path.join(os.path.dirname(rans_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     text, re.M)
    mix = collections.Counter()
    for op in ops:
        pipe = next((p for p, s in PIPES.items() if op in s), None)
        if pipe is None:
            pipe = "control" if op in CONTROL else \
                "uniform" if op.startswith("U") or op in ("S2UR", "R2UR") \
                else "alu"
        mix[pipe] += 1
    return dict(mix)


# the seed_align.cu text each probe replaces: a window word's two loads in
# load_tile, and count_tile's per-candidate compare, from its first shuffle
# up to the line that adds the count
WINDOW_LOADS = (("__ldg(genome_w + w + HALF / 4)", "(w * 40503u)"),
                ("__ldg(genome_w + w)", "(w * 2654435761u)"))
COMPARE = ("    const uint32_t na = __shfl_down_sync",
           "    acc[c >> 1] += (uint32_t)n << (16 * (c & 1));",
           "    const uint32_t n = (t.a[c] ^ t.b[c] ^ fa ^ rb) & 1;\n")


def probe_sources(src):
    """The shipped seed_align.cu and its two probes, as source text. Raises
    SystemExit naming the text when the source no longer holds it."""
    missing = [t for t in [o for o, _ in WINDOW_LOADS] + list(COMPARE[:2])
               if t not in src]
    if missing:
        raise SystemExit(f"kernel_probe: seed_align.cu no longer holds "
                         f"{missing}; update WINDOW_LOADS and COMPARE")
    no_loads = src
    for old, new in WINDOW_LOADS:
        no_loads = no_loads.replace(old, new)
    a, b = src.index(COMPARE[0]), src.index(COMPARE[1])
    return {"shipped": src, "no_window_loads": no_loads,
            "no_window_compare": src[:a] + COMPARE[2] + src[b:]}


def build_probes(src_path, out_dir):
    from genozip_tpu_torch.ops import rans_cuda
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in probe_sources(open(src_path).read()).items():
        cu = os.path.join(out_dir, f"probe_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"libprobe_{name}.so")
        procs[name] = (so, subprocess.Popen(
            rans_cuda.nvcc_cmd(cu, so, verbose=True),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{err}")
        regs = [ln.strip() for ln in err.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"probe {name}: {'; '.join(regs)}")
        L = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.seed_align.argtypes = [vp, vp, ctypes.c_longlong, ci, vp, vp,
                                 ctypes.c_uint, ci, vp, vp, vp, vp, vp]
        L.seed_align.restype = ci
        libs[name] = L
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-bp", type=int, default=None,
                    help="genome length (default: cfg4's 64,444,167)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA device")
    import chip_smoke
    from genozip_tpu_torch.ops import align_torch, rans_cuda
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    rans_cuda.build(names=("aes", "align"))
    for name in ("aes", "align"):
        print(f"sass {name}: {sass_mix(rans_cuda.lib_path(name))}")
    libs = build_probes(os.path.join(rans_cuda._CSRC, "seed_align.cu"),
                        rans_cuda.BUILD_DIR)
    x = chip_smoke.ab_inputs(np.random.default_rng(2024),
                             args.genome_bp or chip_smoke.CHR20_BP)
    hb = int(x["sa__hash_bits"])
    c, ln, genome, rh = (torch.from_numpy(x[k]).cuda() for k in
                         ("sa__codes", "sa__lens", "sa__genome", "sa__rh"))
    want = align_torch.seed_align_plain(c, ln, genome, rh, hb)
    R, Lb = c.shape
    outs = [torch.empty(R, dtype=dt, device="cuda") for dt in
            (torch.int64, torch.bool, torch.int32, torch.bool)]
    times = collections.defaultdict(list)
    for _ in range(2):
        for name, L in libs.items():
            def launch(L=L):
                rc = L.seed_align(
                    c.data_ptr(), ln.data_ptr(), R, Lb, genome.data_ptr(),
                    rh.data_ptr(), genome.numel(), hb,
                    *(t.data_ptr() for t in outs),
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"probe {name}: CUDA error {rc}")
            launch()
            torch.cuda.synchronize()
            if name == "shipped" and not all(
                    torch.equal(a, b) for a, b in zip(outs, want)):
                raise SystemExit("probe shipped: differs from plain")
            times[name].append(chip_smoke.graph_ms(launch))
    for name, ts in times.items():
        print(f"probe seed_align {name}: {ts} ms at one cfg4 VB ({R} reads, "
              f"Lb {Lb})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
