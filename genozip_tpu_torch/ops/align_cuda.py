"""The seed aligner kernel (csrc/seed_align.cu) bound to PyTorch.

`seed_align` computes genozip_tpu's mesh aligner step
(`parallel/aligner_sharded.py` `make_sharded_aligner`'s `local`, an XLA
device function; no Pallas kernel) with the whole genome on the card. The
library is built with nvcc for sm_90a at first use, like the rANS kernels
(`rans_cuda.build`), into `genozip_tpu_torch/build/libalign.so`, and loaded
with ctypes. The wrapper checks its tensors; on CUDA tensors it launches the
kernel on the current stream (and adds one to `launches["seed_align"]`) or
raises `DeviceKernelError`, and on CPU tensors it runs the plain version
`align_torch.seed_align_plain`. The kernel reads the genome in aligned
4-byte words and keeps each read's row and its reverse complement in
shared memory, so on the card the genome must be 4-byte aligned and Lb at
most the kernel's MAX_LB (16384); the wrapper raises ValueError otherwise,
the second from the entry point's cudaErrorInvalidValue.
"""

import ctypes
import threading

import torch

from . import align_torch, rans_cuda
from .rans_cuda import DeviceKernelError

launches = {"seed_align": 0}
INVALID_VALUE = 1   # cudaErrorInvalidValue: arguments the kernel refuses

_lock = threading.Lock()
_lib = None


def reset_launches():
    launches["seed_align"] = 0


def lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            rans_cuda.build(names=("align",))
            path = rans_cuda.lib_path("align")
            try:
                L = ctypes.CDLL(path)
            except OSError as e:
                raise DeviceKernelError(f"cannot load {path}: {e}") from e
            vp, ci = ctypes.c_void_p, ctypes.c_int
            L.seed_align.argtypes = [vp, vp, ctypes.c_longlong, ci, vp, vp,
                                     ctypes.c_uint, ci, vp, vp, vp, vp, vp]
            L.seed_align.restype = ci
            _lib = L
    return _lib


def seed_align(codes: torch.Tensor, lens: torch.Tensor, genome: torch.Tensor,
               rh: torch.Tensor, hash_bits: int):
    """codes uint8 (R, Lb), lens int32 (R,), genome uint8 (G,), rh int32
    (2^hash_bits,) holding u32 refhash slots, all on one device ->
    (gpos int64 (R,) of u32 values, 0xFFFFFFFF for none; is_fwd bool;
    nmm int32; aligned bool) on that device. On the card the genome must
    be 4-byte aligned (a tensor of its own is) and Lb at most 16384."""
    for name, t, dt, nd in (("codes", codes, torch.uint8, 2),
                            ("lens", lens, torch.int32, 1),
                            ("genome", genome, torch.uint8, 1),
                            ("rh", rh, torch.int32, 1)):
        if t.dtype != dt or t.dim() != nd:
            raise TypeError(f"{name}: {t.dtype} of {t.dim()} dims, expected "
                            f"{dt} of {nd}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    R, Lb = codes.shape
    if lens.shape[0] != R:
        raise ValueError(f"lens: {lens.shape[0]} rows, codes {R}")
    if not 1 <= hash_bits <= 32 or rh.shape[0] != 1 << hash_bits:
        raise ValueError(f"rh: {rh.shape[0]} slots, hash_bits {hash_bits}")
    G = genome.shape[0]
    if G >= 1 << 32:
        raise ValueError(f"genome of {G} bases: u32 positions hold < 2^32")
    dev = codes.device
    if any(t.device != dev for t in (lens, genome, rh)):
        raise ValueError("tensors on more than one device")
    if dev.type == "cpu":
        return align_torch.seed_align_plain(codes, lens, genome, rh,
                                            hash_bits)
    if dev.type != "cuda":
        raise ValueError(f"device {dev} not supported")
    if genome.data_ptr() % 4:
        raise ValueError("genome: the kernel reads 4-byte words and needs a "
                         "4-byte aligned tensor")
    gpos = torch.empty(R, dtype=torch.int64, device=dev)
    fwd = torch.empty(R, dtype=torch.bool, device=dev)
    nmm = torch.empty(R, dtype=torch.int32, device=dev)
    aligned = torch.empty(R, dtype=torch.bool, device=dev)
    if R:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib().seed_align(
                codes.data_ptr(), lens.data_ptr(), R, Lb, genome.data_ptr(),
                rh.data_ptr(), G, hash_bits, gpos.data_ptr(), fwd.data_ptr(),
                nmm.data_ptr(), aligned.data_ptr(), stream)
        if rc == INVALID_VALUE:
            raise ValueError(f"seed_align: the kernel refuses rows of {Lb} "
                             "columns: it keeps a read's rows in shared "
                             "memory and takes at most MAX_LB "
                             "(csrc/seed_align.cu)")
        if rc != 0:
            raise DeviceKernelError(f"seed_align: CUDA error {rc} at launch")
        with _lock:
            launches["seed_align"] += 1
    return gpos, fwd, nmm, aligned
