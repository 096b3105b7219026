#!/usr/bin/env python3
"""What holds a row of the PBWT kernels, on the card.

    python3 scripts/pbwt_probe.py [--reps N]

On chip_smoke.py's phase 13 shapes, one cfg1 VB's GT matrix (3,252 x 400,
synth.write_vcf at 16 MiB, seed 9) and the 1000 Genomes width (512 x 5,008,
`chip_smoke.haplotypes_1kg`), both directions:

1. PR 12's pbwt_encode and pbwt_decode (csrc/pbwt_v1.cuh, frozen in
   csrc/devfns_micro.cu), checked equal to the host runtime, and the same
   kernels with one piece taken out at a time (`pbwt_probe_run`):
   `no_global` (the row's bytes from shared memory), `present_only` (the
   column scan over the row's present values), `fewer_barriers` (the
   histogram scan's two barriers merged into pass B's first) and
   `perm_smem` (perm in shared memory up to 8,192 values: the 1000 Genomes
   width only). The outputs of all but `no_global` must equal PR 12's.
2. The row's chain floors (`pbwt_row_floor`): version 1 PR 12's row;
   version 2 the shipped encoder's (its sort, two barriers; no device
   memory); version 3 the decoder's chain, one shared-memory gather a row,
   at one row a barrier and at the shipped chain's group a barrier, at
   each thread count of THREAD_SWEEP that the row takes.
3. The shipped kernels alone (their C entry points on buffers allocated
   once) at each thread count of THREAD_SWEEP, checked equal to the host
   runtime, and the decoder's first phase alone (`pbwt_sigmas`, every row's
   stable sort) beside `torch.argsort(stable=True)` of the same rows.

Each number is the mean of --reps launches after a warm-up (CUDA events),
in ms and us a row. Prints the card's name and power limit first and one
`pbwt_probe {...}` JSON line last. Needs a CUDA device and nvcc; builds
into genozip_tpu_torch/build/ (gitignored).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {"pr12": 0, "no_global": 1, "present_only": 2,
            "fewer_barriers": 4, "perm_smem": 8}
EXACT = ("pr12", "present_only", "fewer_barriers", "perm_smem")
THREAD_SWEEP = (64, 96, 128, 160, 256, 352, 416, 512, 672, 1024)
PR12_SMEM_H = 4096


def probe_lib():
    from genozip_tpu_torch.ops import rans_cuda
    L = ctypes.CDLL(rans_cuda.lib_path("devfns_micro"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    L.pbwt_probe_run.argtypes = [ci, ci, vp, vp, vp, ci, ci, vp, vp]
    L.pbwt_probe_run.restype = ci
    return L


def pr12_threads(H):
    return min(1024, max(256, (H + 31) // 32 * 32))


def shapes(tmp):
    import chip_smoke as cs
    from genozip_tpu_torch import synth
    vcf = os.path.join(tmp, "cfg1.vcf")
    synth.write_vcf(vcf, 16 * cs.MIB, seed=9)
    return {"cfg1": cs.cfg1_gt(vcf),
            "1kg": cs.haplotypes_1kg(np.random.default_rng(13))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sass", metavar="FILE",
                    help="also write the kernels' SASS (cuobjdump) to FILE")
    ap.add_argument("--shapes", default="cfg1,1kg",
                    help="comma-separated subset of cfg1, 1kg")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pbwt_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from genozip_tpu_torch import native
    from genozip_tpu_torch.ops import pbwt_cuda, pbwt_torch, rans_cuda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    report = rans_cuda.build(verbose=True, names=("pbwt", "devfns_micro"))
    for line in report.splitlines():
        if "Compiling entry" in line or "registers" in line or \
                "spill" in line:
            print("ptxas:", line.strip())
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(rans_cuda._nvcc()),
                                 "cuobjdump")
        with open(args.sass, "w") as f:
            for name in ("pbwt", "devfns_micro"):
                subprocess.run([cuobjdump, "-sass", rans_cuda.lib_path(name)],
                               stdout=f, check=True)
    L, P, F = pbwt_cuda.lib(), probe_lib(), cs.devfns_floor_lib()
    st = torch.cuda.current_stream().cuda_stream
    res = {"card": smi}
    with tempfile.TemporaryDirectory(prefix="pbwt_probe_") as tmp:
        mats = shapes(tmp)

    def ms(fn):
        return cs.cuda_ms(fn, args.reps)
    for label, A in mats.items():
        if label not in args.shapes.split(","):
            continue
        n, H = A.shape
        Y = native.pbwt_encode(A)
        o = {"rows": n, "H": H}
        src = {"encode": torch.from_numpy(A.reshape(-1).copy()).cuda(),
               "decode": torch.from_numpy(Y.reshape(-1).copy()).cuda()}
        want = {"encode": Y, "decode": A}
        out = torch.empty(n * H, dtype=torch.uint8, device="cuda")
        # 1. PR 12's kernels and the probes, PR 12's launch table
        meta1 = torch.tensor([[0, n, H, 0]], dtype=torch.int64,
                             device="cuda")
        work1 = torch.empty(max(2 * H if H > PR12_SMEM_H else 0, 1),
                            dtype=torch.int32, device="cuda")
        thr1 = pr12_threads(H)
        for vname, var in VARIANTS.items():
            if vname == "perm_smem" and H <= PR12_SMEM_H:
                continue
            for kind in ("encode", "decode"):
                def run(var=var, kind=kind):
                    rc = P.pbwt_probe_run(var, kind == "decode",
                                          src[kind].data_ptr(),
                                          out.data_ptr(), meta1.data_ptr(),
                                          1, thr1, work1.data_ptr(), st)
                    if rc:
                        raise SystemExit(f"probe {vname}: CUDA error {rc}")
                run()
                torch.cuda.synchronize()
                if vname in EXACT and not np.array_equal(
                        out.cpu().numpy().reshape(n, H), want[kind]):
                    raise SystemExit(f"probe {vname} {kind} {label}: "
                                     "differs from the host runtime")
                t = ms(run)
                o[f"{kind}_{vname}_ms"] = t
                o[f"{kind}_{vname}_us_row"] = t * 1e3 / n
        # 2. the floors: PR 12's row, the encoder's, the decoder's chain at
        # a row a barrier and at its group a barrier
        sink = torch.empty(1, dtype=torch.int64, device="cuda")
        for version, group in ((1, 1), (2, 1), (3, 1),
                               (3, pbwt_torch.group_rows(H))):
            for thr in THREAD_SWEEP:
                if version == 1 and thr != thr1:
                    continue

                def fl(version=version, thr=thr, group=group):
                    return F.pbwt_row_floor(version, group, n, H, thr, 1,
                                            sink.data_ptr(), st)
                if fl():     # a version or thread count it does not take
                    continue
                o[f"floor_v{version}_g{group}_t{thr}_us_row"] = \
                    ms(fl) * 1e3 / n
        # 3. the shipped kernels alone, by thread count
        for kind in ("encode", "decode"):
            _, meta, work_words = pbwt_torch.prepare(
                [torch.from_numpy(A).cuda()], kind == "decode")
            host, meta = meta, meta.cuda()   # the C entry points read it there
            work = torch.empty(max(work_words, 1), dtype=torch.int32,
                               device="cuda")
            fn = getattr(L, f"pbwt_{kind}")
            for thr in THREAD_SWEEP:
                def alone(fn=fn, thr=thr, meta=meta, work=work, kind=kind):
                    return fn(src[kind].data_ptr(), out.data_ptr(),
                              meta.data_ptr(), 1, thr, work.data_ptr(), st)
                if alone():
                    continue
                torch.cuda.synchronize()
                if not np.array_equal(out.cpu().numpy().reshape(n, H),
                                      want[kind]):
                    raise SystemExit(f"shipped {kind} {label} at {thr} "
                                     "threads: differs from the host runtime")
                t = ms(alone)
                o[f"{kind}_shipped_t{thr}_ms"] = t
                o[f"{kind}_shipped_t{thr}_us_row"] = t * 1e3 / n
            if kind == "decode" and hasattr(L, "pbwt_sigmas"):
                sig = torch.empty(max(work_words, 1), dtype=torch.int32,
                                  device="cuda")
                thr = pbwt_cuda.threads_for(host, True)
                o["sigmas_ms"] = ms(lambda: L.pbwt_sigmas(
                    src[kind].data_ptr(), meta.data_ptr(), 1, thr,
                    sig.data_ptr(), st))
                rows = src[kind].view(n, H)
                o["argsort_ms"] = ms(lambda: torch.argsort(rows, dim=1,
                                                           stable=True))
        o["clocks"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        res[label] = o
        for k, v in o.items():
            print(f"{label} {k}: {v:.4f}" if isinstance(v, float)
                  else f"{label} {k}: {v}", flush=True)
    print("pbwt_probe " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
