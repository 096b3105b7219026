"""The PBWT kernels (csrc/pbwt.cu) bound to PyTorch. Counterpart of
genozip_tpu's `pbwt_encode_jnp` and `pbwt_decode_jnp`
(`genozip_tpu/ops/pbwt.py` :46 and :61, XLA device functions), which
`ops.pbwt.pbwt_encode_torch` / `pbwt_decode_torch` call. As in
genozip_tpu, the VCF seg and recon run the PBWT on the host
(`ops.pbwt.pbwt_encode`, the host runtime), not here.

The library is built with nvcc for sm_90a at first use, like the rANS
kernels (`rans_cuda.build`), into `genozip_tpu_torch/build/libpbwt.so`, and
loaded with ctypes. The wrappers `pbwt_encode` and `pbwt_decode` check
their tensors; on CUDA tensors they call the C entry point (and add one to
`launches`) or raise `DeviceKernelError`, and on CPU tensors they run the
plain version `pbwt_torch.batch_plain`. `pbwt_decode` is two launches on
the current stream (every row's sort order, then the chain); the C entry
point `pbwt_sigmas`, the first alone, is for timing.
"""

import ctypes

import torch

from . import pbwt_torch, rans_cuda
from .rans_cuda import _check, _device_errors, _same_device

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_ARGS = [_vp, _vp, _vp, _ci, _ci, _vp, _vp]
_LIB = rans_cuda.KernelLib(
    "pbwt", {"pbwt_encode": (_ARGS, _ci), "pbwt_decode": (_ARGS, _ci),
             "pbwt_sigmas": ([_vp, _vp, _ci, _ci, _vp, _vp], _ci)},
    kernels=("pbwt_encode", "pbwt_decode"))
launches, lib, reset_launches = _LIB.launches, _LIB.lib, _LIB.reset_launches


def threads_for(meta: torch.Tensor, decode: bool = False) -> int:
    """A block's threads for a launch table, from its widest matrix H.
    The sorts take sorting warps and one helper warp: for the encoder
    ceil(H / 64) sorting warps up to H = 1,024 (2 steps of 32 values a
    warp), ceil(H / 256) past it (8 steps), between 1 and 31; the decoder
    a thread a value on its chain, between 128 and 1024. 1024 past SMEM_H,
    so that a warp's counts stay within u16 up to MAX_H."""
    widest = int(meta[:, 2].max()) if meta.shape[0] else 0
    if widest > pbwt_torch.SMEM_H:
        return 1024
    if decode:
        return 32 * min(32, max(4, -(-widest // 32)))
    sorting = -(-widest // (64 if widest <= 1024 else 256))
    return 32 * (min(31, max(1, sorting)) + 1)


def _run(name, flat, meta, work_words):
    decode = name == "pbwt_decode"
    _check("flat", flat, torch.uint8, 1)
    _check("meta", meta, torch.int64, 2)
    if meta.shape[1] != pbwt_torch.META:
        raise ValueError(f"meta: {meta.shape[1]} columns")
    # the table on the host (as `pbwt_torch.prepare` makes it) is read
    # without waiting on the card, and copied to it for the launch
    host = meta.cpu()
    pbwt_torch.check_meta(host, flat.numel(), work_words, decode)
    dev = flat.device if meta.device.type == "cpu" else \
        _same_device(flat, meta)
    if dev.type == "cpu":
        return pbwt_torch.batch_plain(flat, host, decode)
    if dev.type != "cuda":
        raise ValueError(f"device {dev} not supported")
    out = torch.empty_like(flat)
    R = meta.shape[0]
    if R:
        table = meta if meta.device == dev else \
            host.to(dev, non_blocking=True)
        work = torch.empty(max(work_words, 1), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(lib(), name)(flat.data_ptr(), out.data_ptr(),
                                      table.data_ptr(), R,
                                      threads_for(host, decode),
                                      work.data_ptr(), stream)
        _LIB.launched(name, rc)
    return out


def pbwt_encode(flat, meta, work_words: int):
    """R matrices (`pbwt_torch.prepare`'s layout; the table on the flat
    buffer's device or on the host) -> their PBWTs, flat: one launch."""
    return _run("pbwt_encode", flat, meta, work_words)


def pbwt_decode(flat, meta, work_words: int):
    """R PBWTs (`pbwt_torch.prepare(..., decode=True)`'s layout) -> their
    matrices, flat: one entry call, two kernels (every row's sort order,
    then the chain)."""
    return _run("pbwt_decode", flat, meta, work_words)


def _many(fn, mats, device):
    mats = [torch.as_tensor(A).to(device) for A in mats]
    flat, meta, work = pbwt_torch.prepare(mats, fn is pbwt_decode)
    with _device_errors(device, fn.__name__):
        return pbwt_torch.split(fn(flat, meta, work), meta)


def encode_many(mats, device="cuda") -> list:
    """The PBWT of R (n, H) uint8 matrices in one launch on `device`."""
    return _many(pbwt_encode, mats, device)


def decode_many(mats, device="cuda") -> list:
    """The inverse PBWT of R matrices in one launch on `device`."""
    return _many(pbwt_decode, mats, device)
