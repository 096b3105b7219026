"""The AES-256-CTR kernel (csrc/aes.cu) bound to PyTorch, and `aes256_ctr`,
which the archive encryption (`crypt.crypt_payload`) calls.

The kernel has no TPU counterpart: genozip_tpu computes this function in its
host C++ runtime (`native/gxz_native.cpp` `gxz_aes256_ctr`). It is built
with nvcc for sm_90a at first use, like the rANS kernels
(`rans_cuda.build`), into `genozip_tpu_torch/build/libaes.so`, and loaded
with ctypes. The wrapper `aes256_ctr_xor_` checks its tensor; on a CUDA
tensor it launches the kernel (and adds one to `launches["aes256_ctr"]`) or
raises `DeviceKernelError`, and on a CPU tensor it runs the plain version
`aes_torch.aes256_ctr_plain`. Both XOR the keystream into the tensor in
place.
"""

import ctypes
import threading

import torch

from . import aes_torch, rans_cuda
from .rans_cuda import DeviceKernelError

launches = {"aes256_ctr": 0}

_lock = threading.Lock()
_lib = None


def reset_launches():
    launches["aes256_ctr"] = 0


def lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            rans_cuda.build(names=("aes",))
            path = rans_cuda.lib_path("aes")
            try:
                L = ctypes.CDLL(path)
            except OSError as e:
                raise DeviceKernelError(f"cannot load {path}: {e}") from e
            vp = ctypes.c_void_p
            L.aes256_ctr.argtypes = [vp, ctypes.c_ulonglong,
                                     ctypes.c_ulonglong, vp,
                                     ctypes.c_longlong, vp]
            L.aes256_ctr.restype = ctypes.c_int
            _lib = L
    return _lib


def aes256_ctr_xor_(data: torch.Tensor, rk, ctr_hi: int,
                    ctr_lo: int) -> torch.Tensor:
    """XOR the AES-256-CTR keystream of the key schedule `rk` (60 words,
    `aes_torch.round_keys`) from the counter (ctr_hi, ctr_lo) into `data`
    (uint8, 1-D, contiguous) in place; returns `data`."""
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError(f"data: {data.dtype} of {data.dim()} dims, expected "
                        "1-D uint8")
    if not data.is_contiguous():
        raise ValueError("data: not contiguous")
    if len(rk) != 60:
        raise ValueError(f"rk: {len(rk)} words, expected 60")
    if data.device.type == "cpu":
        return aes_torch.aes256_ctr_plain(rk, ctr_hi, ctr_lo, data)
    if data.device.type != "cuda":
        raise ValueError(f"device {data.device} not supported")
    if data.data_ptr() % 16:
        raise ValueError("data: the kernel XORs 16-byte blocks and needs a "
                         "16-byte aligned tensor")
    n = data.numel()
    if n:
        words = (ctypes.c_uint32 * 60)(*rk)
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            rc = lib().aes256_ctr(words, ctr_hi, ctr_lo, data.data_ptr(), n,
                                  stream)
        if rc != 0:
            raise DeviceKernelError(f"aes256_ctr: CUDA error {rc} at launch")
        with _lock:
            launches["aes256_ctr"] += 1
    return data


def aes256_ctr(key: bytes, counter0: bytes, data, device=None) -> bytes:
    """AES-256-CTR of `data` under `key` from the 16-byte `counter0`, on
    `device` ('cuda', 'cpu' or None for the CPU); equals
    genozip_tpu.crypt's keystream XOR, so it both encrypts and decrypts."""
    rk = aes_torch.round_keys(bytes(key))
    hi, lo = aes_torch.split_counter(bytes(counter0))
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) if len(data) \
        else torch.empty(0, dtype=torch.uint8)
    dev = torch.device(device or "cpu")
    with rans_cuda._device_errors(dev, "aes256_ctr"):
        out = aes256_ctr_xor_(buf.to(dev), rk, hi, lo)
        return out.cpu().numpy().tobytes()
