"""Positional Burrows-Wheeler transform for haplotype matrices.

Counterpart of genozip_tpu/ops/pbwt.py `pbwt_encode`/`pbwt_decode` on their
numpy path (reference src/codec_pbwt.c, the PBWT permutation of the VCF
genotype matrix). Durbin's algorithm: haplotypes are kept sorted by reverse
prefix; each variant row is emitted in the current permutation order (long
runs of equal alleles, which suit RLE and rANS), then the permutation is
refined by a stable sort on the emitted alleles. The row loop is serial on
the host; each row is vectorized over the haplotypes.
"""

import numpy as np


def pbwt_encode(A: np.ndarray) -> np.ndarray:
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


def pbwt_decode(Y: np.ndarray) -> np.ndarray:
    """Inverse of `pbwt_encode`."""
    n, H = Y.shape
    perm = np.arange(H, dtype=np.int64)
    A = np.empty_like(Y)
    for i in range(n):
        y = Y[i]
        A[i][perm] = y
        perm = perm[np.argsort(y, kind="stable")]
    return A
