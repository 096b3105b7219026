"""The PBWT in plain PyTorch: the plain version of the `pbwt_encode` and
`pbwt_decode` kernels (csrc/pbwt.cu), torch mirrors of the kernels' pieces,
and the launch table both routes share.

The function is genozip_tpu's `pbwt_encode_jnp` / `pbwt_decode_jnp`
(`genozip_tpu/ops/pbwt.py` :46 and :61, XLA device functions): for each
variant row, in order, the row is emitted in the current permutation order
(decode: scattered back through it), then the permutation is stably sorted
by the emitted values (`torch.argsort(stable=True)`), one row after
another on the matrix's device.

The mirrors repeat the kernels' arithmetic so that the CPU can test it; no
CUDA path calls them. `row_positions` is the stable counting sort of a row
as the encoder's block does it (codes of the present values, warp
segments, per-warp ranks and counts, code groups, column prefixes);
`row_sigmas` the decoder's first phase (every row's sort order at once);
`compose_chain` its second (the permutations composed in groups of rows,
`group_rows`).

A launch of the kernels takes R matrices through a table of int64 rows
(`META` columns; `prepare` makes it on the host, and the wrapper copies it
to the card without waiting on it): (offset of the matrix in the flat buffer, n, H, offset in
int32 words, a multiple of 4, of its scratch). The scratch
(`scratch_words`): the decoder's sort orders (n rows of H u16, each padded
to 8 entries; int32 padded to 4 past H = 65,535), then, past `SMEM_H`,
perm and its sorted copy (2 H int32), which the kernels keep in shared
memory up to `SMEM_H`.
"""

import torch

META = 4
SMEM_H = 12288         # the kernels keep perm in shared memory up to this H
U16_H = 65535          # sort orders as u16 up to this H
# a warp's counts are u16: its segment, ceil(H / 992) x 32 values at the
# 31 sorting warps `pbwt_cuda.threads_for` gives wide rows, stays <= 65,535
MAX_H = 2047 * 992
CHAIN_SMEM = 18 * SMEM_H + 64   # the decoder's chain's shared memory
MAX_GROUP = 32                  # the decoder's rows a barrier, at most


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


def row_positions(y: torch.Tensor, n_warps: int) -> torch.Tensor:
    """The destination in the stably sorted row of each value of the row y
    (H,) uint8, as the kernels' block of `n_warps` warps computes it: a
    value's code is the number of present values below it; warp w takes
    the contiguous segment of seg steps of 32 values from w seg 32 (seg =
    ceil(H / 32 n_warps), rounded up to a power of two up to 16); a
    value's position among its warp's equal codes is its
    rank in its step plus the warp's count of its code before the step;
    the codes, in groups of 32, get their totals over the warps and the
    totals' exclusive scan, carried from group to group, and each warp
    adds its column prefix (the counts of the warps before it).
    Returns dest (H,) int64: the sorted row is y placed at dest."""
    H = y.numel()
    steps = -(-H // (32 * n_warps))
    seg = next((s for s in (1, 2, 4, 8, 16) if steps <= s), steps)
    present = torch.zeros(256, dtype=torch.int64)
    present[y.cpu().long()] = 1
    np_ = int(present.sum())
    code_of = present.cumsum(0) - present
    code = torch.full((n_warps * seg * 32,), np_, dtype=torch.int64)
    code[:H] = code_of[y.cpu().long()]
    steps = code.view(n_warps, seg, 32)
    lower = torch.ones(32, 32, dtype=torch.bool).tril(-1)   # lane l' < l
    rank = ((steps[..., :, None] == steps[..., None, :]) & lower).sum(-1)
    per_step = torch.nn.functional.one_hot(steps, np_ + 1).sum(2)
    before = per_step.cumsum(1) - per_step     # the warp's count before
    wpos = before.gather(2, steps) + rank
    cnt = per_step.sum(1)[:, :np_]             # (warp, code) counts
    first = torch.zeros(n_warps, np_ + 1, dtype=torch.int64)
    carry = 0
    for g in range(0, np_, 32):                # the codes, 32 at a time
        group = cnt[:, g:g + 32]
        tot = group.sum(0)
        column = group.cumsum(0) - group
        first[:, g:g + group.shape[1]] = carry + tot.cumsum(0) - tot + column
        carry += int(tot.sum())
    warp = torch.arange(n_warps)[:, None, None].expand_as(steps)
    dest = first[warp, steps] + wpos
    return dest.reshape(-1)[:H].to(y.device)


def row_sigmas(Y: torch.Tensor, n_warps: int = 4) -> torch.Tensor:
    """The decoder's first phase: sigma (n, H) int64, each row's stable
    sort order (`torch.argsort(Y, dim=1, stable=True)`), by row_positions:
    sigma_i[dest_i[j]] = j."""
    n, H = Y.shape
    sig = torch.empty((n, H), dtype=torch.int64, device=Y.device)
    pos = torch.arange(H, device=Y.device)
    for i in range(n):
        sig[i, row_positions(Y[i], n_warps)] = pos
    return sig


def group_rows(H: int) -> int:
    """The decoder's rows a group, as csrc/pbwt.cu `group_rows` sizes them
    to its shared memory: its chain takes a barrier a group."""
    if H > SMEM_H:
        return 1
    Hp = (H + 7) // 8 * 8
    g = (CHAIN_SMEM - 4 * SMEM_H - 64) // (6 * Hp + 5 * H)
    return max(1, min(MAX_GROUP, g))


def compose_chain(sigmas: torch.Tensor, Y: torch.Tensor,
                  group: int = 1) -> torch.Tensor:
    """The decoder's second phase: A (n, H) with A[i, perm_i] = Y[i] and
    perm_{i+1} = perm_i[sigma_i], perm_0 the identity, as the kernels run
    it in groups of `group` rows: within a group from row i0, rho_k =
    sigma_i0 o ... o sigma_(i0+k-1) (rho[j] = rho_prev[sigma[j]], the
    first phase's composition), every row's perm_(i0+k) = perm_i0[rho_k],
    all gathered from the group's first perm."""
    n, H = Y.shape
    perm = torch.arange(H, device=Y.device)
    A = torch.empty_like(Y)
    for i0 in range(0, n, group):
        rho = torch.arange(H, device=Y.device)
        for i in range(i0, min(i0 + group, n)):
            A[i, perm[rho]] = Y[i]
            rho = rho[sigmas[i]]
        perm = perm[rho]
    return A


def scratch_words(n: int, H: int, decode: bool) -> int:
    """int32 words of one matrix's scratch, a multiple of 4 (16 bytes)."""
    words = 0
    if decode:
        words += n * (((H + 7) // 8 * 8) // 2 if H <= U16_H
                      else (H + 3) // 4 * 4)
    if H > SMEM_H:
        words += 2 * H
    return (words + 3) // 4 * 4


def prepare(mats, decode: bool = False) -> tuple:
    """(flat uint8 tensor of the matrices on their device, meta int64 (R,
    META) on the host, int32 words of scratch) of R (n, H) uint8 tensors on
    one device, for an encode or, with `decode`, a decode launch."""
    meta, off, work = [], 0, 0
    for A in mats:
        if A.dim() != 2 or A.dtype != torch.uint8:
            raise ValueError(f"a PBWT matrix is 2-D uint8, got {A.dtype} of "
                             f"{A.dim()} dims")
        n, H = A.shape
        meta.append((off, n, H, work))
        off += n * H
        work += scratch_words(n, H, decode)
    dev = mats[0].device if mats else torch.device("cpu")
    flat = torch.cat([A.reshape(-1) for A in mats]) if mats else \
        torch.zeros(0, dtype=torch.uint8, device=dev)
    return flat, torch.tensor(meta, dtype=torch.int64).reshape(-1, META), \
        work


def check_meta(meta: torch.Tensor, n_flat: int, work_words: int,
               decode: bool = False):
    """ValueError unless every matrix of a launch table lies inside the flat
    buffer, is at most MAX_H wide, and its scratch (`scratch_words`, at a
    16-byte aligned offset) lies inside the work."""
    for r, (o, n, H, w) in enumerate(meta.cpu().tolist()):
        if min(o, n, H, w) < 0 or o + n * H > n_flat or H > MAX_H or \
                w % 4 or w + scratch_words(n, H, decode) > work_words:
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
