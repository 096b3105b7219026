#!/usr/bin/env python3
"""What holds a step of the ARITH-W32 kernels, on the card.

    python3 scripts/arith_probe.py [--reps N]

On the main batch of chip_smoke.py's phase 13 (R = 8 streams of 256 KiB,
4 raw QUAL and 4 packed SEQ, N = 256 lanes, K = 1024 steps), both orders:

1. PR 12's arith_encode and arith_decode (csrc/arith_v1.cuh, frozen in
   csrc/devfns_micro.cu), checked equal to the shipped kernels' streams and
   data, and the same kernels with one piece taken out at a time
   (`arith_probe_run`): `no_walk` (c and the decoder's symbol from one
   shared word, no row walk, cumulative row or binary search), `no_global`
   (no symbol load on the chain, no byte read or written), `fixed_renorm`
   (each lane renormalises alone in registers, then one barrier and the
   event slots, in place of a barrier an iteration), and all three. A
   probe's output is not a stream: the probes show what each piece costs.
2. The chain floors of both steps on the batch's own symbols
   (`arith_step_floor`: version 1, PR 12's barriers, ranks and update;
   version 2, the shipped step's two barriers, event slots and update;
   version 3, the same with the warp-aggregated update of __match_any_sync
   leaders; version 4, with no update; version 5, with the commonest keys
   of a warp peeled by __shfl_sync/__ballot_sync leaders), with 0 and 1
   renorm event a lane a step.
3. The shipped kernels, alone (their C entry points on buffers allocated
   once; the encoder also on the batch's 4 QUAL and its 4 SEQ streams
   apart), and builds of their source with one piece taken out
   (SHIPPED_PROBES: the source text each replaces): `no_update` (barrier B
   alone), `no_division` (shifts for the exact u32 divisions), `no_lookup`
   (f and c from the symbol, no group sums or group loads; the decoder's
   second round of loads gone), `no_byte_stores` (the encoder writes no
   event byte) and `one_build` (every block size on the build bounded for
   1024 threads, at most 64 registers a thread). Their output is not a
   stream, but for `one_build`'s. A decoder probe that changes
   the symbols also changes the update's contention: read the encoder's.

Each number is the mean of --reps launches after a warm-up (CUDA events),
in ms and us a step. Prints the card's name and power limit first and one
`arith_probe {...}` JSON line last. Needs a CUDA device and nvcc; builds
into genozip_tpu_torch/build/ (gitignored).
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {"pr12": 0, "no_walk": 1, "no_global": 2, "fixed_renorm": 4,
            "all_three": 7}
# builds of the shipped source with one piece taken out: {name: {file:
# [(text, replacement), ...]}}; each text must be in the file
SHIPPED_PROBES = {
    "no_update": {"arith.cu": [(
        "    model_update(sm, act, ctx, sym, tot0, lanes.at(s));  // barrier B",
        "    __syncthreads_or(false);                             // barrier B")]},
    "no_division": {"arith.cu": [
        ("const uint32_t r = rng / tot;", "const uint32_t r = rng >> 15;"),
        ("uint32_t v = (code - low) / (r ? r : 1);",
         "uint32_t v = (code - low) >> 16;")]},
    "no_lookup": {"arith.cu": [
        ("      lookup(sm, ctx, sym, tot0, f, c, tot);",
         "      f = 1 + (sym & 7); c = sym; tot = ORDER ? sm.total[ctx] : tot0;"),
        ("      sym = search(sm, ctx, gs, v, f, c);",
         "      sym = v & 255; f = 1 + (sym & 7); c = gs[sym & 7] & 255;")]},
    "one_build": {"arith.cu": [("constexpr int SMALL = 256;",
                                "constexpr int SMALL = 0;")]},
    "no_byte_stores": {"arith.cu": [
        ("  if (pos < cap) body[pos] = byte;\n  else overflow = true;",
         "  if (pos >= cap) overflow = true;")]},
}


def build_shipped_probes(tmp):
    """nvcc each SHIPPED_PROBES build of csrc/arith.cu (with its own copy of
    arith_model.cuh) side by side; returns {name: ctypes library}."""
    from genozip_tpu_torch.ops import rans_cuda
    csrc = os.path.join(ROOT, "genozip_tpu_torch", "csrc")
    procs = {}
    for name, edits in SHIPPED_PROBES.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in ("arith.cu", "arith_model.cuh"):
            text = open(os.path.join(csrc, f)).read()
            for old, new in edits.get(f, []):
                if old not in text:
                    raise SystemExit(f"probe {name}: {f} no longer holds "
                                     f"{old!r}")
                text = text.replace(old, new)
            open(os.path.join(d, f), "w").write(text)
        lib = os.path.join(d, "libarith.so")
        procs[name] = (lib, subprocess.Popen(
            rans_cuda.nvcc_cmd(os.path.join(d, "arith.cu"), lib),
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe {name}: nvcc failed\n{err}")
        libs[name] = L = ctypes.CDLL(lib)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (L.arith_encode, L.arith_decode):
            fn.argtypes = [ci, vp, vp, ci, ci, vp, vp, vp]
            fn.restype = ci
    return libs


def probe_lib():
    from genozip_tpu_torch.ops import rans_cuda
    L = ctypes.CDLL(rans_cuda.lib_path("devfns_micro"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    L.arith_probe_run.argtypes = [ci, ci, ci, vp, vp, ci, ci, vp, vp, vp]
    L.arith_probe_run.restype = ci
    return L


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sass", metavar="FILE",
                    help="also write the shipped kernels' SASS (cuobjdump) "
                         "to FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("arith_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from genozip_tpu_torch.ops import arith_cuda, arith_torch, rans_cuda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    report = rans_cuda.build(verbose=True, names=("arith", "devfns_micro"))
    for line in report.splitlines():
        if "arith" in line and ("Compiling entry" in line or "Function" in
                                line) or "registers" in line or \
                "spill" in line:
            print("ptxas:", line.strip())
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(rans_cuda._nvcc()),
                                 "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([cuobjdump, "-sass", rans_cuda.lib_path("arith")],
                           stdout=f, check=True)
    L, P, F = arith_cuda.lib(), probe_lib(), cs.devfns_floor_lib()
    tmp = tempfile.mkdtemp(prefix="arith_probe_")
    shipped = {"shipped": L, **build_shipped_probes(tmp)}
    st = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(13)           # phase 13's batch
    seqs, _ = cs.main_path_streams(rng, [cs.ARITH_MAIN] * 4)
    _, quals = cs.main_path_streams(rng, [cs.ARITH_MAIN] * 4, raw_qual=True)
    batch = [x for pair in zip(quals, seqs) for x in pair]
    res = {"card": smi}

    def ms(fn):
        return cs.cuda_ms(fn, args.reps)
    for order in (0, 1):
        b = arith_torch.prepare_encode(batch, order)
        data, meta = b.data.cuda(), b.meta.cuda()
        R = meta.shape[0]
        thr = arith_cuda.threads_for(b.meta)
        K = max(-(-len(d) // (1 << int(m[4])))
                for d, m in zip(batch, b.meta.tolist()))
        enc = arith_cuda.encode_many(batch, order)
        [(db, _)] = arith_torch.prepare_decode(enc)
        bufs, dmeta = db.bufs.cuda(), db.meta.cuda()
        out = torch.empty(b.out_len, dtype=torch.uint8, device="cuda")
        sym = torch.empty(max(db.n_out, 1), dtype=torch.uint8, device="cuda")
        lens = torch.empty(R, dtype=torch.int64, device="cuda")
        v1_thr = max(256, thr)           # PR 12's blocks: at least 256
        o = {"steps": K}
        for vname, var in VARIANTS.items():
            for kind, src, m, dst in (("encode", data, meta, out),
                                      ("decode", bufs, dmeta, sym)):
                def run(var=var, kind=kind, src=src, m=m, dst=dst):
                    rc = P.arith_probe_run(var, order, kind == "decode",
                                           src.data_ptr(), m.data_ptr(), R,
                                           v1_thr, dst.data_ptr(),
                                           lens.data_ptr(), st)
                    if rc:
                        raise SystemExit(f"probe {vname}: CUDA error {rc}")
                run()
                if var == 0:        # PR 12 as frozen: the shipped bytes
                    torch.cuda.synchronize()
                    got = (arith_torch.finish_encode(b, out, lens)
                           if kind == "encode" else
                           arith_torch.finish_decode(db, sym, lens))
                    if got != (enc if kind == "encode" else batch):
                        raise SystemExit(f"PR 12's arith_{kind} o{order} "
                                         "differs from the shipped kernel")
                t = ms(run)
                o[f"{kind}_{vname}_ms"] = t
                o[f"{kind}_{vname}_us_step"] = t * 1e3 / K
        sink = torch.empty(R, dtype=torch.int64, device="cuda")
        for version, fthr in ((1, v1_thr), (2, thr), (3, thr), (4, thr),
                              (5, thr)):
            for iters in (0, 1):
                def fl(version=version, iters=iters, fthr=fthr):
                    rc = F.arith_step_floor(version, order, data.data_ptr(),
                                            meta.data_ptr(), R, iters, fthr,
                                            sink.data_ptr(), st)
                    if rc:
                        raise SystemExit(f"floor v{version}: CUDA error {rc}")
                o[f"floor_v{version}_e{iters}_us_step"] = ms(fl) * 1e3 / K
        for lname, lib in shipped.items():
            for kind, src, m, dst in (("encode", data, meta, out),
                                      ("decode", bufs, dmeta, sym)):
                fn = getattr(lib, f"arith_{kind}")

                def alone(fn=fn, src=src, m=m, dst=dst):
                    rc = fn(order, src.data_ptr(), m.data_ptr(), R, thr,
                            dst.data_ptr(), lens.data_ptr(), st)
                    if rc:
                        raise SystemExit(f"{lname} arith_{kind}: CUDA error "
                                         f"{rc}")
                t = ms(alone)
                o[f"{kind}_{lname}_ms"] = t
                o[f"{kind}_{lname}_us_step"] = t * 1e3 / K
        for half, idx in (("qual", range(0, R, 2)), ("seq", range(1, R, 2))):
            part = [batch[i] for i in idx]
            pb = arith_torch.prepare_encode(part, order)
            pd, pm = pb.data.cuda(), pb.meta.cuda()
            po = torch.empty(pb.out_len, dtype=torch.uint8, device="cuda")

            def enc_half(pd=pd, pm=pm, po=po):
                rc = L.arith_encode(order, pd.data_ptr(), pm.data_ptr(),
                                    pm.shape[0], thr, po.data_ptr(),
                                    lens.data_ptr(), st)
                if rc:
                    raise SystemExit(f"arith_encode: CUDA error {rc}")
            o[f"encode_shipped_{half}_us_step"] = ms(enc_half) * 1e3 / K
        res[f"o{order}"] = o
        for k, v in o.items():
            print(f"o{order} {k}: {v:.4f}" if isinstance(v, float)
                  else f"o{order} {k}: {v}", flush=True)
    print("arith_probe " + json.dumps(res))
    shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
