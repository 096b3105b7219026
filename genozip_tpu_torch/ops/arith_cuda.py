"""The ARITH-W32 kernels (csrc/arith.cu) bound to PyTorch, and the entry
points that code streams through them. Counterpart of
`genozip_tpu.ops.arith_jax`:

* `encode(data, order, n_lanes, device)` and `encode_many(datas, order,
  n_lanes, device)` -> `arith_encode` (order 0 or 1): `arith_jax.encode`,
  the XLA device function `_encode_device` :86;
* `decode(buf, device)` and `decode_many(bufs, device)` -> `arith_decode`:
  `arith_jax.decode`, `_decode_device` :124.

Each stream equals `arith_np.encode(data, order, n_lanes)`, whatever the
route. As in genozip_tpu, no CLI command calls them: the codecs run ARITH
on the host runtime (`native.arith_encode`).

The library is built with nvcc for sm_90a at first use, like the rANS
kernels (`rans_cuda.build`), into `genozip_tpu_torch/build/libarith.so`,
and loaded with ctypes. The wrappers `arith_encode` and `arith_decode`
check their tensors; on CUDA tensors they launch the kernel (and add one to
`launches`) or raise `DeviceKernelError`, and on CPU tensors they run the
plain versions `arith_torch.encode_batch_plain` and `decode_batch_plain`.
A stream the decoder cannot read raises ValueError on both routes.
"""

import ctypes

import torch

from . import arith_torch, rans_cuda
from .rans_cuda import _check, _device_errors, _same_device

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_ARGS = [_ci, _vp, _vp, _ci, _ci, _vp, _vp, _vp]
_LIB = rans_cuda.KernelLib("arith", {"arith_encode": (_ARGS, _ci),
                                     "arith_decode": (_ARGS, _ci)})
launches, lib, reset_launches = _LIB.launches, _LIB.lib, _LIB.reset_launches


def threads_for(meta: torch.Tensor) -> int:
    """A block's threads: one a lane of the widest stream, at least a
    warp."""
    widest = 1 << int(meta[:, 4].max()) if meta.shape[0] else 1
    return max(32, widest)


def _launch(name, order, src, meta, out, res):
    if order not in (0, 1):
        raise ValueError(f"order {order}")
    R = meta.shape[0]
    if R:
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream(src.device).cuda_stream
            rc = getattr(lib(), name)(order, src.data_ptr(), meta.data_ptr(),
                                      R, threads_for(meta), out.data_ptr(),
                                      res.data_ptr(), stream)
        _LIB.launched(name, rc)
    return out, res


def arith_encode(data: torch.Tensor, meta: torch.Tensor, order: int,
                 out_len: int):
    """R streams of one order (`arith_torch.prepare_encode`'s table) ->
    (out uint8 (out_len,), lens int64 (R,))."""
    _check("data", data, torch.uint8, 1)
    _check("meta", meta, torch.int64, 2)
    if meta.shape[1] != arith_torch.META:
        raise ValueError(f"meta: {meta.shape[1]} columns")
    arith_torch.check_meta(meta, data.numel(), out_len, decode=False)
    dev = _same_device(data, meta)
    if dev.type == "cpu":
        return arith_torch.encode_batch_plain(data, meta, order, out_len)
    out = torch.empty(out_len, dtype=torch.uint8, device=dev)
    lens = torch.empty(meta.shape[0], dtype=torch.int64, device=dev)
    return _launch("arith_encode", order, data, meta, out, lens)


def arith_decode(bufs: torch.Tensor, meta: torch.Tensor, order: int,
                 n_out: int):
    """R streams of one order (`arith_torch.prepare_decode`'s table) ->
    (out uint8 (n_out,), status int64 (R,): n, or -1 where a body ran out
    of bytes)."""
    _check("bufs", bufs, torch.uint8, 1)
    _check("meta", meta, torch.int64, 2)
    if meta.shape[1] != arith_torch.META:
        raise ValueError(f"meta: {meta.shape[1]} columns")
    arith_torch.check_meta(meta, bufs.numel(), n_out, decode=True)
    dev = _same_device(bufs, meta)
    if dev.type == "cpu":
        return arith_torch.decode_batch_plain(bufs, meta, order, n_out)
    out = torch.empty(max(n_out, 1), dtype=torch.uint8, device=dev)
    status = torch.empty(meta.shape[0], dtype=torch.int64, device=dev)
    return _launch("arith_decode", order, bufs, meta, out, status)


def encode_many(datas, order: int = 0, n_lanes: int | None = None,
                device="cuda") -> list:
    """Code R payloads of one order in one launch on `device`; each result
    equals `arith_np.encode(d, order, n_lanes)`."""
    b = arith_torch.prepare_encode(datas, order, n_lanes)
    with _device_errors(device, "arith_encode"):
        out, lens = arith_encode(b.data.to(device), b.meta.to(device), order,
                                 b.out_len)
        return arith_torch.finish_encode(b, out, lens)


def decode_many(bufs, device="cuda") -> list:
    """Decode R streams, one launch an order present, on `device`."""
    res = [None] * len(bufs)
    for b, idx in arith_torch.prepare_decode(bufs):
        with _device_errors(device, "arith_decode"):
            out, status = arith_decode(b.bufs.to(device), b.meta.to(device),
                                       b.order, b.n_out)
            status = status.cpu()
            out = out.cpu()
        for i, d in zip(idx, arith_torch.finish_decode(b, out, status)):
            res[i] = d
    return res


def encode(data, order: int = 0, n_lanes: int | None = None,
           device="cuda") -> bytes:
    """One stream; equals `arith_np.encode(data, order, n_lanes)`."""
    return encode_many([data], order, n_lanes, device)[0]


def decode(buf, device="cuda") -> bytes:
    """One stream of either order and any lane count up to 1024."""
    return decode_many([buf], device)[0]
