"""The PBWT kernels' arithmetic on the CPU, through the torch mirrors of
ops/pbwt_torch.py (the encoder's row sort `row_positions`, the decoder's
phases `row_sigmas` and `compose_chain`), against `torch.argsort(stable=
True)`, the plain versions `encode_plain`/`decode_plain` and genozip_tpu's
`pbwt_encode_jnp`/`pbwt_decode_jnp` on CPU JAX; and the launch table's
scratch layout and block sizes. Every comparison is exact. Inputs come from
numpy seeds."""

import numpy as np
import pytest
import torch

from genozip_tpu_torch.ops import pbwt, pbwt_cuda, pbwt_torch


def corpus(name: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "gt":                    # cfg1's GT: 0, 1 and '.' as 254
        return rng.choice(np.array([0, 1, 254], np.uint8), (24, 96),
                          p=[0.7, 0.28, 0.02])
    if name == "multi":                 # the VCF's GT values, 0..10
        return rng.integers(0, 11, (16, 70)).astype(np.uint8)
    if name == "all256":                # every value in every row
        return np.stack([rng.permutation(np.arange(320) % 256)
                         for _ in range(6)]).astype(np.uint8)
    if name == "many":                  # more than 32 present values
        return rng.integers(0, 100, (8, 150)).astype(np.uint8)
    if name == "h1":
        return rng.integers(0, 3, (12, 1)).astype(np.uint8)
    if name == "h401":                  # rows off 16-byte alignment
        return rng.choice(np.array([0, 1, 254], np.uint8), (6, 401),
                          p=[0.6, 0.38, 0.02])
    if name == "h4097":
        return rng.integers(0, 11, (3, 4097)).astype(np.uint8)
    if name == "n1":
        return rng.integers(0, 3, (1, 64)).astype(np.uint8)
    raise KeyError(name)


CORPORA = ("gt", "multi", "all256", "many", "h1", "h401", "h4097", "n1")


@pytest.mark.parametrize("n_warps", (1, 4, 13, 32))
@pytest.mark.parametrize("name", CORPORA)
def test_row_positions_sort_the_row_stably(name, n_warps):
    A = torch.from_numpy(corpus(name))
    for y in A[:3]:
        dest = pbwt_torch.row_positions(y, n_warps)
        order = torch.empty_like(dest)
        order[dest] = torch.arange(y.numel())
        assert torch.equal(order, torch.argsort(y, stable=True))


@pytest.mark.parametrize("name", CORPORA)
def test_encoder_rows_by_row_positions(name):
    """The encoder's chain with each row sorted by row_positions equals the
    plain version and the numpy spec."""
    A = torch.from_numpy(corpus(name))
    n, H = A.shape
    perm = torch.arange(H)
    Y = torch.empty_like(A)
    for i in range(n):
        Y[i] = A[i][perm]
        nxt = torch.empty_like(perm)
        nxt[pbwt_torch.row_positions(Y[i], 4)] = perm
        perm = nxt
    assert torch.equal(Y, pbwt_torch.encode_plain(A))
    assert (Y.numpy() == pbwt.pbwt_encode_np(A.numpy())).all()


@pytest.mark.parametrize("name", CORPORA)
def test_decoder_phases_equal_plain(name):
    A = corpus(name)
    Y = torch.from_numpy(pbwt.pbwt_encode_np(A))
    sig = pbwt_torch.row_sigmas(Y)
    assert torch.equal(sig, torch.argsort(Y, dim=1, stable=True))
    want = pbwt_torch.decode_plain(Y)
    for group in (1, 3, pbwt_torch.group_rows(A.shape[1])):
        B = pbwt_torch.compose_chain(sig, Y, group)
        assert torch.equal(B, want)
        assert (B.numpy() == A).all()


def test_group_rows():
    """The decoder's chain takes a barrier a group: 32 rows at cfg1's
    width, 3 at 1000 Genomes', 1 at the top of shared memory and past."""
    gr = pbwt_torch.group_rows
    assert gr(1) == gr(400) == pbwt_torch.MAX_GROUP
    assert gr(5008) == 3 and gr(pbwt_torch.SMEM_H) == 1
    assert gr(pbwt_torch.SMEM_H + 1) == 1
    for H in (1, 401, 4097, 5008, pbwt_torch.SMEM_H):
        g, Hp = gr(H), (H + 7) // 8 * 8     # three groups in the rings
        assert 4 * pbwt_torch.SMEM_H + g * (6 * Hp + 5 * H) + 64 <= \
            pbwt_torch.CHAIN_SMEM


@pytest.mark.parametrize("name", ("gt", "all256", "h401"))
def test_mirrors_equal_jnp(name):
    import jax.numpy as jnp
    from genozip_tpu.ops import pbwt as ref_pbwt
    A = corpus(name)[:4]
    Yj = np.asarray(ref_pbwt.pbwt_encode_jnp(jnp.asarray(A)))
    Y = torch.from_numpy(Yj.copy())
    B = pbwt_torch.compose_chain(pbwt_torch.row_sigmas(Y, 13), Y, 3)
    assert (B.numpy() == np.asarray(ref_pbwt.pbwt_decode_jnp(
        jnp.asarray(Yj)))).all()
    assert (B.numpy() == A).all()


def test_scratch_layout():
    """Decode: n rows of sort orders (u16 padded to 8, int32 past U16_H
    padded to 4), then past SMEM_H perm and its copy; encode: perm past
    SMEM_H only; each matrix's scratch 16-byte aligned."""
    sw = pbwt_torch.scratch_words
    assert sw(3, 400, False) == 0 and sw(3, 400, True) == 3 * 200
    assert sw(2, 401, True) == 2 * 204
    assert sw(1, 1, True) == 4 and sw(0, 400, True) == 0
    H = pbwt_torch.SMEM_H + 1
    assert sw(5, H, False) == 2 * H + 2
    assert sw(5, H, True) == 5 * (-(-H // 8) * 4) + 2 * H + 2
    W = pbwt_torch.U16_H + 1
    assert sw(2, W, True) == 2 * ((W + 3) // 4 * 4) + 2 * W
    mats = [torch.zeros((3, h), dtype=torch.uint8) for h in (1, 401, 45)]
    _, meta, work = pbwt_torch.prepare(mats, decode=True)
    assert all(w % 4 == 0 for w in meta[:, 3].tolist())
    flat = torch.zeros(3 * 447, dtype=torch.uint8)
    pbwt_torch.check_meta(meta, flat.numel(), work, decode=True)
    bad = meta.clone()
    bad[1, 3] += 2                       # not 16-byte aligned
    with pytest.raises(ValueError):
        pbwt_torch.check_meta(bad, flat.numel(), work + 8, decode=True)
    wide = torch.tensor([[0, 1, pbwt_torch.MAX_H + 1, 0]])
    with pytest.raises(ValueError):      # a warp's u16 counts would wrap
        pbwt_torch.check_meta(wide, 1 << 22, 1 << 24)


def test_threads_for():
    """Sorting warps and a helper warp: the encoder 2 steps a warp up to H
    = 1,024, 8 past it; the decoder a thread a value of its chain."""
    def meta(*hs):
        return torch.tensor([[0, 1, h, 0] for h in hs], dtype=torch.int64)
    tf = pbwt_cuda.threads_for
    assert tf(meta(1)) == 64 and tf(meta(400)) == 256
    assert tf(meta(45, 5008)) == 32 * 21
    assert tf(meta(pbwt_torch.SMEM_H + 1)) == 1024
    assert tf(meta(400), decode=True) == 416
    assert tf(meta(5008), decode=True) == 1024
    for H in (1, 400, 1025, 4097, 5008, pbwt_torch.SMEM_H):
        for decode in (False, True):
            T = tf(meta(H), decode)
            assert T % 32 == 0 and 64 <= T <= 1024
            assert -(-H // (T - 32)) <= 16   # steps kept in registers
