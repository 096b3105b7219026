"""The four rANS kernels (csrc/rans.cu) bound to PyTorch, the batched
encode/decode that the codecs call, and the single-stream entry points.
Counterpart of `genozip_tpu.ops.rans_pallas`.

Entry points and the TPU kernels (`rans_pallas.py` device functions) whose
function each one computes:

* `encode_many(datas, order, device, n_lanes)` -> `rans_encode_o0` /
  `rans_encode_o1`: `encode_many_device_v6` :1764, `encode_many_o1_device_v6`
  :1925, `encode_many_o1_device` :3108, and with a fixed `n_lanes` the pre-v6
  `encode_many_device` :2466.
* `decode_many(bufs, device)` -> `rans_decode_o0` / `rans_decode_o1`:
  `decode_many_device_v6` :1391, `decode_many_device` :1231,
  `decode_many_o1_device_v6` :1603, `decode_many_o1_device` :2908.
* `encode(data, n_lanes, device)` -> `rans_encode_o0` at R = 1:
  `encode_order0_device` :2677.
* `decode(buf, device)` -> `rans_decode_o0` at R = 1, any lane count:
  `decode_order0_device` :377 and its variants v2 :350, v3 :769, v4 :743 and
  v5 :717 (tiling and lookup choices of one function; the kernel's 4096-slot
  table in shared memory replaces v4's two-level lookup).
* `encode_order1(data, n_lanes, device)` -> `rans_encode_o1` at R = 1:
  `encode_order1_device` :1008.
* `decode_order1(buf, device)` -> `rans_decode_o1` at R = 1:
  `decode_order1_device` :883.

The Pallas wrappers' tiling and selection knobs (`S`, `v1`..`v5`,
`interpret`) have no counterpart, and the decoders take every lane count of
the stream format (16..8192), not only N >= 128.

The library is built with nvcc for sm_90a at first use, from the sources in
this package (`csrc/rans.cu`), into `genozip_tpu_torch/build/`, and loaded
with ctypes. Each
wrapper checks its tensors; on CUDA tensors it launches its kernel (and adds
one to its launch count) or raises, and on CPU tensors it runs the kernel's
plain version from `ops.rans_torch`. Any failure of the kernel route on the
card (nvcc, loading, a launch, a CUDA error) raises `DeviceKernelError`, which
codec trials and calibration pass on instead of treating it as a codec
rejection.
"""

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading

import torch

from . import rans_torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
# library name -> source; rans_micro and devfns_micro (the ARITH and PBWT
# chain floors) hold microbenchmarks that only chip_smoke.py builds and
# runs; aes is the AES-256-CTR kernel (aes_cuda.py), align the seed aligner
# kernel (align_cuda.py), arith the ARITH-W32 coder (arith_cuda.py) and pbwt
# the PBWT (pbwt_cuda.py)
SOURCES = {"rans": "rans.cu", "rans_micro": "rans_micro.cu", "aes": "aes.cu",
           "align": "seed_align.cu", "arith": "arith.cu", "pbwt": "pbwt.cu",
           "devfns_micro": "devfns_micro.cu"}



class DeviceKernelError(RuntimeError):
    """A kernel route (rANS, AES in aes_cuda.py, the seed aligner in
    align_cuda.py, ARITH in arith_cuda.py or the PBWT in pbwt_cuda.py)
    failed on the card."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise DeviceKernelError("nvcc not found: the rANS kernels need the CUDA "
                            "toolkit")


def lib_path(name: str = "rans") -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    deps = [os.path.join(_CSRC, SOURCES[name])] + [
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith(".cuh")]
    return any(os.path.getmtime(d) > os.path.getmtime(out) for d in deps)


def nvcc_cmd(src: str, out: str, verbose: bool = False) -> list:
    """The nvcc command that builds the CUDA source `src` into the shared
    library `out` for sm_90a, with csrc/ on the include path (its headers
    also serve a source outside it); with `verbose` ptxas reports each
    kernel's registers and spills."""
    return [_nvcc()] + (["-Xptxas=-v"] if verbose else []) + [
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-I", _CSRC, "-o", out, src]


def build(verbose: bool = False, names=("rans",)) -> str:
    """Compile each named source of SOURCES into build/lib<name>.so unless it
    is up to date; the nvcc processes run side by side. Returns nvcc's
    resource reports when `verbose`."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = nvcc_cmd(os.path.join(_CSRC, SOURCES[name]), tmp, verbose)
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports, errors = [], []
    for name, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {SOURCES[name]} failed ({proc.returncode}):"
                          f"\n{err}")
            continue
        os.replace(tmp, lib_path(name))
        reports.append(f"{SOURCES[name]}:\n{err}")
    if errors:
        raise DeviceKernelError("\n".join(errors))
    return "\n".join(reports)


class KernelLib:
    """One library of SOURCES: built and loaded with ctypes at first use
    (`lib()`), its entry points given their `signatures` ({name: (argtypes,
    restype)}), and a launch count for each of its `kernels` (`launches`),
    which `launched` adds to."""

    def __init__(self, name: str, signatures: dict, kernels=None):
        self.name, self.signatures = name, signatures
        self.launches = dict.fromkeys(kernels or signatures, 0)
        self._lock = threading.Lock()
        self._lib = None

    def lib(self):
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    build(names=(self.name,))
                    path = lib_path(self.name)
                    try:
                        L = ctypes.CDLL(path)
                    except OSError as e:
                        raise DeviceKernelError(f"cannot load {path}: {e}") \
                            from e
                    for fn, (args, res) in self.signatures.items():
                        getattr(L, fn).argtypes = args
                        getattr(L, fn).restype = res
                    self._lib = L
        return self._lib

    def launched(self, kernel: str, rc: int):
        """Raise DeviceKernelError if the launch returned a CUDA error, else
        count it."""
        if rc != 0:
            raise DeviceKernelError(f"{kernel}: CUDA error {rc} at launch")
        with self._lock:
            self.launches[kernel] += 1

    def reset_launches(self):
        for k in self.launches:
            self.launches[k] = 0


_vp, _ci = ctypes.c_void_p, ctypes.c_int
_ENC_ARGS = [_vp] * 7 + [_ci, ctypes.c_longlong, _vp]
_DEC_ARGS = [_vp] * 5 + [_ci, _vp]
_LIB = KernelLib("rans", {
    "rans_encode_o0": (_ENC_ARGS, _ci), "rans_decode_o0": (_DEC_ARGS, _ci),
    "rans_encode_o1": (_ENC_ARGS, _ci), "rans_decode_o1": (_DEC_ARGS, _ci)})
KERNELS = tuple(_LIB.launches)
launches, lib, reset_launches = _LIB.launches, _LIB.lib, _LIB.reset_launches


def _check(name, t, dtype, ndim=None, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {ndim}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def _same_device(*ts):
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device {dev} not supported")
    return dev


def _tab_shape(order, R):
    return (R, 2, 256) if order == 0 else (R, 2, 256, 256)


def _encode(order, data, meta, tab, n_words, n_states):
    name = f"rans_encode_o{order}"
    R = meta.shape[0]
    _check("data", data, torch.uint8, 1)
    _check("meta", meta, torch.int64, shape=(R, rans_torch.META))
    _check("tab", tab, torch.int32, shape=_tab_shape(order, R))
    dev = _same_device(data, meta, tab)
    if dev.type == "cpu":
        return rans_torch.encode_plain(order, data, meta, tab, n_words, n_states)
    words = torch.empty(n_words, dtype=torch.int16, device=dev)
    p = torch.empty(R, dtype=torch.int64, device=dev)
    states = torch.empty(n_states, dtype=torch.int32, device=dev)
    if R:
        n = data.numel()
        work = torch.empty(encode_work_bytes(order, R, n), dtype=torch.uint8,
                           device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(lib(), name)(
                data.data_ptr(), meta.data_ptr(), tab.data_ptr(),
                work.data_ptr(), words.data_ptr(), p.data_ptr(),
                states.data_ptr(), R, n, stream)
        _LIB.launched(name, rc)
    return words, p, states


def encode_work_bytes(order: int, R: int, n: int) -> int:
    """Device scratch of an encode launch of R streams of n symbols in all
    (`EncWork` in csrc/rans_common.cuh): order 1's packed entries (512 KB a
    stream), then T bytes of symbol rows (8-step words), 2T of renorm words,
    T/4 of emit masks and the scan's chunk sums, T = n + R * ENC_PAD
    rounded up to 64; stream r's part starts at `rans_torch.enc_bases`."""
    T = (n + R * rans_torch.ENC_PAD + 63) & ~63
    return (R << 19 if order == 1 else 0) + 3 * T + T // 4 + \
        4 * ((T >> 7) + R + 1)


def decode_work_bytes(order: int, R: int, n_out: int) -> int:
    """Device scratch of a decode launch: order 1's slot entries (4 MB a
    stream), then every stream's symbols in (step, lane) order, K*N < n +
    8192 bytes each at a 16-byte aligned offset."""
    return (R << 22 if order == 1 else 0) + n_out + \
        R * (rans_torch.MAX_LANES + 16)


def _decode(order, words, meta, tab, n_out):
    name = f"rans_decode_o{order}"
    R = meta.shape[0]
    _check("words", words, torch.int16, 1)
    _check("meta", meta, torch.int64, shape=(R, rans_torch.META))
    _check("tab", tab, torch.int32, shape=_tab_shape(order, R))
    dev = _same_device(words, meta, tab)
    if dev.type == "cpu":
        return rans_torch.decode_plain(order, words, meta, tab, n_out)
    if words.data_ptr() % 16:
        raise ValueError("words: the decoders copy 16-byte chunks and need a "
                         "16-byte aligned tensor")
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    work = torch.empty(decode_work_bytes(order, R, n_out), dtype=torch.uint8,
                       device=dev)
    if R:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(lib(), name)(
                words.data_ptr(), meta.data_ptr(), tab.data_ptr(),
                work.data_ptr(), out.data_ptr(), R, stream)
        _LIB.launched(name, rc)
    return out


def rans_encode_o0(data, meta, tab, n_words: int, n_states: int):
    """R order-0 streams: (words int16, p int64 (R,), states int32)."""
    return _encode(0, data, meta, tab, n_words, n_states)


def rans_encode_o1(data, meta, tab, n_words: int, n_states: int):
    """R order-1 streams with full 256x256 tables."""
    return _encode(1, data, meta, tab, n_words, n_states)


def rans_decode_o0(words, meta, tab, n_out: int):
    """R order-0 streams -> uint8 (n_out,)."""
    return _decode(0, words, meta, tab, n_out)


def rans_decode_o1(words, meta, tab, n_out: int):
    """R order-1 streams -> uint8 (n_out,)."""
    return _decode(1, words, meta, tab, n_out)


@contextlib.contextmanager
def _device_errors(device, what: str):
    """On a CUDA device, turn any failure (copies, allocation, a sticky CUDA
    error surfacing at a sync) into DeviceKernelError."""
    try:
        yield
    except DeviceKernelError:
        raise
    except Exception as e:
        if torch.device(device).type != "cuda":
            raise
        raise DeviceKernelError(f"{what} on {device}: {e}") from e


def encode_many(datas, order: int, device, n_lanes: int | None = None) -> list:
    """Encode R payloads in one launch on `device`; each result equals
    `rans_np.encode(d, order, n_lanes=n_lanes)`. With order 0 and a fixed
    `n_lanes` this is also the counterpart of the pre-v6 multi-stream
    `rans_pallas.encode_many`."""
    b = rans_torch.prepare_encode(datas, order, n_lanes)
    fn = rans_encode_o0 if order == 0 else rans_encode_o1
    with _device_errors(device, fn.__name__):
        words, p, states = fn(b.data.to(device), b.meta.to(device),
                              b.tab.to(device), b.n_words, b.n_states)
        return rans_torch.finish_encode(b, words, p, states)


def decode_many(bufs, device) -> list:
    """Decode R streams of one order in one launch on `device`."""
    b = rans_torch.prepare_decode(bufs)
    fn = rans_decode_o0 if b.order == 0 else rans_decode_o1
    with _device_errors(device, fn.__name__):
        out = fn(b.words.to(device), b.meta.to(device), b.tab.to(device),
                 b.n_out)
        return rans_torch.finish_decode(b, out)


def _one_stream(buf, order: int, device) -> bytes:
    if len(buf) < 2 or buf[1] != order:
        raise ValueError(f"not an order-{order} rANS stream")
    return decode_many([buf], device)[0]


def encode(data, n_lanes: int = 1024, device="cuda") -> bytes:
    """Order-0 encode of one stream; equals `rans_np.encode(data, 0,
    n_lanes=n_lanes)`."""
    return encode_many([data], 0, device, n_lanes)[0]


def decode(buf, device="cuda") -> bytes:
    """Order-0 decode of one stream of any lane count."""
    return _one_stream(buf, 0, device)


def encode_order1(data, n_lanes: int = 1024, device="cuda") -> bytes:
    """Order-1 encode of one stream; equals `rans_np.encode(data, 1,
    n_lanes=n_lanes)`."""
    return encode_many([data], 1, device, n_lanes)[0]


def decode_order1(buf, device="cuda") -> bytes:
    """Order-1 decode of one stream of any lane count."""
    return _one_stream(buf, 1, device)
