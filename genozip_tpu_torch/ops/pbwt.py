"""Positional Burrows-Wheeler transform for haplotype matrices.

Counterpart of genozip_tpu/ops/pbwt.py `pbwt_encode`/`pbwt_decode` on their
numpy path (reference src/codec_pbwt.c, the PBWT permutation of the VCF
genotype matrix). Durbin's algorithm: haplotypes are kept sorted by reverse
prefix; each variant row is emitted in the current permutation order (long
runs of equal alleles, which suit RLE and rANS), then the permutation is
refined by a stable sort on the emitted alleles. The row loop is serial on
the host: `pbwt_encode`/`pbwt_decode` run it in the C++ host runtime (a
counting sort a row), as genozip_tpu does with its native runtime;
`pbwt_encode_np`/`pbwt_decode_np` vectorize each row over the haplotypes in
numpy. `pbwt_encode_torch`/`pbwt_decode_torch` are the counterparts of
genozip_tpu's device twins `pbwt_encode_jnp`/`pbwt_decode_jnp`: the
`pbwt_encode`/`pbwt_decode` kernels (csrc/pbwt.cu, ops/pbwt_cuda.py) on the
card, their plain PyTorch version on the CPU. As in genozip_tpu, the VCF
seg and recon call the host functions, not the device twins.
"""

import numpy as np
import torch

from .. import native
from . import pbwt_cuda


def pbwt_encode(A: np.ndarray) -> np.ndarray:
    """A: (n_variants, H) uint8 allele matrix -> Y, each row permuted by the
    evolving PBWT order."""
    return native.pbwt_encode(A)


def pbwt_decode(Y: np.ndarray) -> np.ndarray:
    """Inverse of `pbwt_encode`."""
    return native.pbwt_decode(Y)


def pbwt_encode_np(A: np.ndarray) -> np.ndarray:
    """A: (n_variants, H) uint8 allele matrix (values 0..255).
    Returns Y: (n, H), each row permuted by the evolving PBWT order."""
    n, H = A.shape
    perm = np.arange(H, dtype=np.int64)
    Y = np.empty_like(A)
    for i in range(n):
        y = A[i][perm]
        Y[i] = y
        # a stable sort of perm by y keeps the PBWT order within each allele
        perm = perm[np.argsort(y, kind="stable")]
    return Y


def pbwt_decode_np(Y: np.ndarray) -> np.ndarray:
    """Inverse of `pbwt_encode_np`."""
    n, H = Y.shape
    perm = np.arange(H, dtype=np.int64)
    A = np.empty_like(Y)
    for i in range(n):
        y = Y[i]
        A[i][perm] = y
        perm = perm[np.argsort(y, kind="stable")]
    return A


def _device_of(A, device):
    if device is not None:
        return device
    return A.device if isinstance(A, torch.Tensor) else "cuda"


def pbwt_encode_torch(A, device=None) -> torch.Tensor:
    """`pbwt_encode_jnp`'s counterpart: A (n, H) uint8, a tensor (run on its
    device unless `device` is given) or an array (run on `device`, the card
    by default) -> Y, a tensor on that device."""
    return pbwt_cuda.encode_many([A], _device_of(A, device))[0]


def pbwt_decode_torch(Y, device=None) -> torch.Tensor:
    """`pbwt_decode_jnp`'s counterpart: the inverse of `pbwt_encode_torch`."""
    return pbwt_cuda.decode_many([Y], _device_of(Y, device))[0]
