"""The PBWT in plain PyTorch: the plain version of the `pbwt_encode` and
`pbwt_decode` kernels (csrc/pbwt.cu), and the launch table both routes
share.

The function is genozip_tpu's `pbwt_encode_jnp` / `pbwt_decode_jnp`
(`genozip_tpu/ops/pbwt.py` :46 and :61, XLA device functions): for each
variant row, in order, the row is emitted in the current permutation order
(decode: scattered back through it), then the permutation is stably sorted
by the emitted values (`torch.argsort(stable=True)`), one row after
another on the matrix's device.

A launch of the kernels takes R matrices through a table of int64 rows
(`META` columns): (offset of the matrix in the flat buffer, n, H, offset in
int32 words of its 2 H words of permutation scratch, used when H >
`SMEM_H`).
"""

import torch

META = 4
SMEM_H = 4096          # the kernel keeps perm in shared memory up to this H


def encode_plain(A: torch.Tensor) -> torch.Tensor:
    """A: (n, H) uint8 -> Y (n, H), each row in the evolving PBWT order."""
    n, H = A.shape
    perm = torch.arange(H, device=A.device)
    Y = torch.empty_like(A)
    for i in range(n):
        y = A[i][perm]
        Y[i] = y
        perm = perm[torch.argsort(y, stable=True)]
    return Y


def decode_plain(Y: torch.Tensor) -> torch.Tensor:
    """The inverse of `encode_plain`."""
    n, H = Y.shape
    perm = torch.arange(H, device=Y.device)
    A = torch.empty_like(Y)
    for i in range(n):
        y = Y[i]
        A[i, perm] = y
        perm = perm[torch.argsort(y, stable=True)]
    return A


def prepare(mats) -> tuple:
    """(flat uint8 tensor of the matrices, meta int64 (R, META), int32 words
    of scratch) of R (n, H) uint8 tensors on one device."""
    meta, off, work = [], 0, 0
    for A in mats:
        if A.dim() != 2 or A.dtype != torch.uint8:
            raise ValueError(f"a PBWT matrix is 2-D uint8, got {A.dtype} of "
                             f"{A.dim()} dims")
        n, H = A.shape
        meta.append((off, n, H, work))
        off += n * H
        if H > SMEM_H:
            work += 2 * H
    dev = mats[0].device if mats else torch.device("cpu")
    flat = torch.cat([A.reshape(-1) for A in mats]) if mats else \
        torch.zeros(0, dtype=torch.uint8, device=dev)
    return flat, torch.tensor(meta, dtype=torch.int64,
                              device=dev).reshape(-1, META), work


def check_meta(meta: torch.Tensor, n_flat: int, work_words: int):
    """ValueError unless every matrix of a launch table lies inside the flat
    buffer and, past SMEM_H, its 2 H words of scratch inside the work."""
    for r, (o, n, H, w) in enumerate(meta.cpu().tolist()):
        if min(o, n, H, w) < 0 or o + n * H > n_flat or \
                (H > SMEM_H and w + 2 * H > work_words):
            raise ValueError(f"launch table row {r} ({o}, {n}, {H}, {w}) "
                             "outside its buffers")


def split(flat: torch.Tensor, meta: torch.Tensor) -> list:
    """The R matrices of a flat buffer laid out by `prepare`."""
    return [flat[o:o + n * H].view(n, H)
            for o, n, H, _ in meta.cpu().tolist()]


def batch_plain(flat: torch.Tensor, meta: torch.Tensor,
                decode: bool) -> torch.Tensor:
    """The plain version of one launch: the flat buffer of the R results."""
    fn = decode_plain if decode else encode_plain
    out = torch.empty_like(flat)
    for A, Y in zip(split(flat, meta), split(out, meta)):
        Y.copy_(fn(A))
    return out
