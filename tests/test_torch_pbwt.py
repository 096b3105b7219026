"""genozip_tpu_torch's PBWT device functions: `ops.pbwt.pbwt_encode_torch`
/ `pbwt_decode_torch` (the `pbwt_encode`/`pbwt_decode` kernels of
csrc/pbwt.cu on the card, their plain PyTorch version ops/pbwt_torch.py on
the CPU) against genozip_tpu's device twins `pbwt_encode_jnp` /
`pbwt_decode_jnp` (on CPU JAX), the port's numpy version and its host
runtime. Every comparison is exact (tolerance 0). Inputs come from numpy
seeds; the haplotype generator is tests/test_pbwt.py's. The JAX package is
imported inside the tests that use it, so the `cuda`-marked tests also run
where jax is not installed."""

import numpy as np
import pytest
import torch

from genozip_tpu_torch import native
from genozip_tpu_torch.ops import pbwt, pbwt_cuda, pbwt_torch


def synth_haplotypes(rng, n=300, H=200):
    """Correlated genotype matrix (haplotypes share ancestry blocks)."""
    founders = rng.integers(0, 2, (8, n)).astype(np.uint8)
    assign = rng.integers(0, 8, H)
    A = founders[assign].T.copy()  # (n, H)
    flips = rng.random((n, H)) < 0.01
    A[flips] ^= 1
    return A


def matrix(name: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "haplotypes":
        return synth_haplotypes(rng, 100, 64)
    if name == "multiallelic":          # the VCF's GT values, 0..10
        return rng.integers(0, 11, (50, 30)).astype(np.uint8)
    if name == "bytes":                 # any value 0..255
        return rng.integers(0, 256, (40, 70)).astype(np.uint8)
    if name == "one_haplotype":
        return rng.integers(0, 3, (20, 1)).astype(np.uint8)
    if name == "no_rows":
        return np.zeros((0, 16), np.uint8)
    if name == "ragged_warp":           # H not a multiple of 32
        return synth_haplotypes(rng, 60, 45)
    raise KeyError(name)


MATRICES = ("haplotypes", "multiallelic", "bytes", "one_haplotype",
            "no_rows", "ragged_warp")


@pytest.mark.parametrize("name", MATRICES)
def test_torch_equals_jnp(name):
    import jax.numpy as jnp
    from genozip_tpu.ops import pbwt as ref_pbwt
    A = matrix(name)
    Yj = np.asarray(ref_pbwt.pbwt_encode_jnp(jnp.asarray(A)))
    Yt = pbwt.pbwt_encode_torch(torch.from_numpy(A))
    assert Yt.device.type == "cpu" and Yt.dtype == torch.uint8
    assert Yt.shape == A.shape and (Yt.numpy() == Yj).all()
    assert (pbwt.pbwt_encode_torch(A, device="cpu").numpy() == Yj).all()
    assert (Yj == pbwt.pbwt_encode_np(A)).all()
    assert (native.pbwt_encode(A) == Yj).all()
    # each package inverts the other's
    Aj = np.asarray(ref_pbwt.pbwt_decode_jnp(jnp.asarray(Yt.numpy())))
    assert (Aj == A).all()
    back = pbwt.pbwt_decode_torch(torch.from_numpy(Yj.copy()))
    assert (back.numpy() == A).all()


def test_many_matrices_in_one_launch():
    """One launch table: matrices of several shapes, one of them past the
    kernel's shared-memory perm (H > SMEM_H), each as alone."""
    rng = np.random.default_rng(17)
    mats = [matrix(k) for k in MATRICES]
    mats.append(rng.integers(0, 3, (6, pbwt_torch.SMEM_H + 37))
                .astype(np.uint8))
    enc = pbwt_cuda.encode_many(mats, "cpu")
    for A, Y in zip(mats, enc):
        assert (Y.numpy() == pbwt.pbwt_encode_np(A)).all()
    dec = pbwt_cuda.decode_many([Y.numpy() for Y in enc], "cpu")
    for A, B in zip(mats, dec):
        assert B.shape == A.shape and (B.numpy() == A).all()
    # scratch: past SMEM_H perm and its sorted copy, 2 H int32 words
    # (rounded to 16 bytes); the decoder adds every row's sort order
    _, meta, work = pbwt_torch.prepare([torch.from_numpy(A) for A in mats])
    assert meta[-1, 3] == 0 and work == 2 * (pbwt_torch.SMEM_H + 37) + 2
    _, meta, work = pbwt_torch.prepare([torch.from_numpy(A) for A in mats],
                                       decode=True)
    sig = [A.shape[0] * -(-A.shape[1] // 8) * 4 for A in mats]
    assert meta[:, 3].tolist() == [sum(sig[:i]) for i in range(len(mats))]
    assert work == sum(sig) + 2 * (pbwt_torch.SMEM_H + 37) + 2


def test_wrappers_check_their_tensors():
    with pytest.raises(ValueError):
        pbwt_cuda.encode_many([np.zeros(8, np.uint8)], "cpu")
    with pytest.raises(ValueError):
        pbwt_cuda.encode_many([np.zeros((2, 2), np.int32)], "cpu")
    flat, meta, work = pbwt_torch.prepare([torch.zeros((3, 4),
                                                       dtype=torch.uint8)])
    with pytest.raises(ValueError):
        pbwt_cuda.pbwt_encode(flat, meta[:, :3].contiguous(), work)
    with pytest.raises(ValueError):          # no room for the sort orders
        pbwt_cuda.pbwt_decode(flat, meta, work)
    _, dmeta, dwork = pbwt_torch.prepare([torch.zeros((3, 4),
                                                      dtype=torch.uint8)],
                                         decode=True)
    before = dict(pbwt_cuda.launches)
    pbwt_cuda.pbwt_decode(flat, dmeta, dwork)
    assert pbwt_cuda.launches == before      # the plain version: no launch
    with pytest.raises(ValueError):
        pbwt_cuda.pbwt_decode(flat, dmeta, dwork - 1)
    for col, value in ((0, 1), (1, 4), (2, -1)):
        bad = meta.clone()
        bad[0, col] = value                  # past the flat buffer
        with pytest.raises(ValueError):
            pbwt_cuda.pbwt_encode(flat, bad, work)
    big = torch.zeros((2, pbwt_torch.SMEM_H + 1), dtype=torch.uint8)
    flat, meta, work = pbwt_torch.prepare([big])
    with pytest.raises(ValueError):          # its scratch past the work
        pbwt_cuda.pbwt_encode(flat, meta, work - 1)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _card_matrices():
    """One launch: the CPU matrices, a cfg1-wide and a 1000 Genomes-wide
    one, all 256 values in every row, H = 401 (rows and matrices off 16-byte
    alignment), the top of the shared-memory range and one past it (perm in
    the scratch), and one past u16 sort orders."""
    rng = np.random.default_rng(23)
    mats = [matrix(k) for k in MATRICES]
    mats.append(synth_haplotypes(rng, 200, 400))
    mats.append(rng.integers(0, 11, (30, 5008)).astype(np.uint8))
    mats.append(np.stack([rng.permutation(np.arange(512) % 256)
                          for _ in range(12)]).astype(np.uint8))
    mats.append(rng.choice(np.array([0, 1, 254], np.uint8), (40, 401),
                           p=[0.7, 0.28, 0.02]))
    mats.append(rng.integers(0, 3, (6, pbwt_torch.SMEM_H)).astype(np.uint8))
    mats.append(rng.integers(0, 3, (5, pbwt_torch.SMEM_H + 1))
                .astype(np.uint8))
    mats.append(rng.integers(0, 3, (3, pbwt_torch.U16_H + 65))
                .astype(np.uint8))          # sort orders as int32
    return mats


@pytest.mark.cuda
def test_pbwt_encode_kernel_equals_plain_on_the_card():
    _needs_card()
    mats = _card_matrices()
    before = pbwt_cuda.launches["pbwt_encode"]
    got = pbwt_cuda.encode_many(mats, "cuda")
    assert pbwt_cuda.launches["pbwt_encode"] == before + 1
    for A, Y in zip(mats, got):
        want = pbwt_torch.encode_plain(torch.from_numpy(A).cuda())
        assert torch.equal(Y, want)
        assert (Y.cpu().numpy() == pbwt.pbwt_encode_np(A)).all()


@pytest.mark.cuda
def test_pbwt_decode_kernel_equals_plain_on_the_card():
    _needs_card()
    mats = _card_matrices()
    Ys = [pbwt.pbwt_encode_np(A) for A in mats]
    before = pbwt_cuda.launches["pbwt_decode"]
    got = pbwt_cuda.decode_many(Ys, "cuda")
    assert pbwt_cuda.launches["pbwt_decode"] == before + 1
    for A, Y, B in zip(mats, Ys, got):
        assert torch.equal(B, pbwt_torch.decode_plain(
            torch.from_numpy(Y).cuda()))
        assert (B.cpu().numpy() == A).all()
