"""The PBWT kernels (csrc/pbwt.cu) bound to PyTorch. Counterpart of
genozip_tpu's `pbwt_encode_jnp` and `pbwt_decode_jnp`
(`genozip_tpu/ops/pbwt.py` :46 and :61, XLA device functions), which
`ops.pbwt.pbwt_encode_torch` / `pbwt_decode_torch` call. As in
genozip_tpu, the VCF seg and recon run the PBWT on the host
(`ops.pbwt.pbwt_encode`, the host runtime), not here.

The library is built with nvcc for sm_90a at first use, like the rANS
kernels (`rans_cuda.build`), into `genozip_tpu_torch/build/libpbwt.so`, and
loaded with ctypes. The wrappers `pbwt_encode` and `pbwt_decode` check
their tensors; on CUDA tensors they launch the kernel (and add one to
`launches`) or raise `DeviceKernelError`, and on CPU tensors they run the
plain version `pbwt_torch.batch_plain`.
"""

import ctypes

import torch

from . import pbwt_torch, rans_cuda
from .rans_cuda import _check, _device_errors, _same_device

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_ARGS = [_vp, _vp, _vp, _ci, _ci, _vp, _vp]
_LIB = rans_cuda.KernelLib("pbwt", {"pbwt_encode": (_ARGS, _ci),
                                    "pbwt_decode": (_ARGS, _ci)})
launches, lib, reset_launches = _LIB.launches, _LIB.lib, _LIB.reset_launches


def threads_for(meta: torch.Tensor) -> int:
    """A block's threads: the widest matrix's H rounded up to a warp,
    between 256 and 1024."""
    widest = int(meta[:, 2].max()) if meta.shape[0] else 0
    return min(1024, max(256, (widest + 31) // 32 * 32))


def _run(name, flat, meta, work_words):
    _check("flat", flat, torch.uint8, 1)
    _check("meta", meta, torch.int64, 2)
    if meta.shape[1] != pbwt_torch.META:
        raise ValueError(f"meta: {meta.shape[1]} columns")
    pbwt_torch.check_meta(meta, flat.numel(), work_words)
    dev = _same_device(flat, meta)
    if dev.type == "cpu":
        return pbwt_torch.batch_plain(flat, meta, name == "pbwt_decode")
    out = torch.empty_like(flat)
    R = meta.shape[0]
    if R:
        work = torch.empty(max(work_words, 1), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(lib(), name)(flat.data_ptr(), out.data_ptr(),
                                      meta.data_ptr(), R, threads_for(meta),
                                      work.data_ptr(), stream)
        _LIB.launched(name, rc)
    return out


def pbwt_encode(flat, meta, work_words: int):
    """R matrices (`pbwt_torch.prepare`'s layout) -> their PBWTs, flat."""
    return _run("pbwt_encode", flat, meta, work_words)


def pbwt_decode(flat, meta, work_words: int):
    """R PBWTs -> their matrices, flat."""
    return _run("pbwt_decode", flat, meta, work_words)


def _many(fn, mats, device):
    mats = [torch.as_tensor(A).to(device) for A in mats]
    flat, meta, work = pbwt_torch.prepare(mats)
    with _device_errors(device, fn.__name__):
        return pbwt_torch.split(fn(flat, meta, work), meta)


def encode_many(mats, device="cuda") -> list:
    """The PBWT of R (n, H) uint8 matrices in one launch on `device`."""
    return _many(pbwt_encode, mats, device)


def decode_many(mats, device="cuda") -> list:
    """The inverse PBWT of R matrices in one launch on `device`."""
    return _many(pbwt_decode, mats, device)
