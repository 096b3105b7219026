"""genozip_tpu_torch's ARITH-W32 coder: the plain PyTorch version
(ops/arith_torch.py) of the `arith_encode`/`arith_decode` kernels and the
entry points (ops/arith_cuda.py) against genozip_tpu's device twin
(`arith_jax`, on CPU JAX), the normative numpy spec `arith_np` and the
port's host runtime (`native.arith_encode`); and the tensor bit packing
(`pack_torch`/`unpack_torch`) against genozip_tpu's `pack_jnp`/
`unpack_jnp`. Every comparison is exact byte equality (tolerance 0).
Inputs come from numpy seeds. The JAX package is imported inside the tests
that use it, so the `cuda`-marked tests also run where jax is not
installed."""

import numpy as np
import pytest
import torch

from genozip_tpu_torch import native
from genozip_tpu_torch.ops import arith_cuda, arith_np, arith_torch, pack
from genozip_tpu_torch.ops.rans_cuda import DeviceKernelError, _device_errors

QUALS = np.frombuffer(b"FFF:,#", np.uint8)
LANES = (16, 64, 256, 1024)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of steps of small tensor ops: one
    intra-op thread, so that test workers sharing the cores do not
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def corpus(name: str) -> np.ndarray:
    """The named payload, from a numpy seed. `drift` moves its alphabet
    along the stream, so the order-0 model halves (at 16 lanes every 85
    steps) while it adapts; `same` makes order 1's one context halve."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "empty":
        return np.zeros(0, np.uint8)
    if name == "one":
        return np.frombuffer(b"Q", np.uint8).copy()
    if name == "short":                 # n < N at every lane count
        return rng.choice(QUALS, 9)
    if name == "multiple":              # n a multiple of every N
        return rng.choice(QUALS, 4 * 1024)
    if name == "same":
        return np.full(3000, 0x46, np.uint8)
    if name == "uniform":
        return rng.integers(0, 256, 20000).astype(np.uint8)
    if name == "all256":
        return np.tile(np.arange(256, dtype=np.uint8), 9)
    if name == "drift":
        syms = np.frombuffer(b"ABCDEFGHIJKLMNOP", np.uint8)
        return np.concatenate([rng.choice(syms[i:i + 4], 1000,
                                          p=[0.7, 0.2, 0.07, 0.03])
                               for i in range(12)])
    raise KeyError(name)


CORPORA = ("empty", "one", "short", "multiple", "same", "uniform", "all256",
           "drift")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy())


def _all_routes_equal_jax(a, order, N):
    from genozip_tpu.ops import arith_jax
    want = arith_jax.encode(a, order=order, n_lanes=N)
    assert arith_torch.encode_plain(_t(a), order, N) == want
    assert arith_cuda.encode(a.tobytes(), order, N, device="cpu") == want
    assert want == arith_np.encode(a, order=order, n_lanes=N)
    # each package decodes the other's stream
    assert arith_torch.decode_plain(want) == a.tobytes()
    assert arith_cuda.decode(want, device="cpu") == a.tobytes()
    assert arith_jax.decode(arith_torch.encode_plain(_t(a), order, N)) == \
        a.tobytes()


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name", CORPORA)
def test_plain_equals_arith_jax(name, order):
    """The lane count of `choose_num_lanes` (16 for all but `uniform`,
    64 there)."""
    _all_routes_equal_jax(corpus(name), order, None)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("N", LANES)
def test_lane_counts_equal_arith_jax(N, order):
    for name in ("one", "short", "multiple", "same", "all256", "drift"):
        _all_routes_equal_jax(corpus(name), order, N)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n", [65537, 262144])
def test_large_payloads_equal_arith_np_and_native(n, order):
    """Past what the JAX scan takes in a test: up to 256 KiB (64 and 256
    lanes), against the spec and the host runtime."""
    rng = np.random.default_rng(n + order)
    a = rng.choice(np.frombuffer(b"FFFFF:F,#AB!x", np.uint8), n)
    got = arith_cuda.encode(a, order, device="cpu")
    assert got == arith_np.encode(a, order=order)
    assert got == native.arith_encode(a.tobytes(), order)
    assert arith_cuda.decode(got, device="cpu") == a.tobytes()
    assert native.arith_decode(got) == a.tobytes()


@pytest.mark.parametrize("order", [0, 1])
def test_many_streams_in_one_launch(order):
    """One launch table of mixed sizes (and so mixed lane counts) and of
    three streams of one size (coded side by side by the plain version):
    each stream as alone; a decode batch of both orders in input order; a
    stream that runs out of bytes fails alone."""
    datas = [corpus(k) for k in ("empty", "uniform", "one", "drift")]
    datas += [corpus("uniform")[i * 5000:(i + 1) * 5000] for i in range(3)]
    enc = arith_cuda.encode_many(datas, order, device="cpu")
    assert enc == [arith_np.encode(d, order=order) for d in datas]
    other = arith_np.encode(datas[1], order=1 - order)
    got = arith_cuda.decode_many(enc + [other], device="cpu")
    assert got == [d.tobytes() for d in datas] + [datas[1].tobytes()]
    fixed = arith_cuda.encode_many(datas, order, n_lanes=1024, device="cpu")
    assert fixed == [arith_np.encode(d, order=order, n_lanes=1024)
                     for d in datas]
    cut = enc[4:5] + [enc[5][:len(enc[5]) - 40]] + enc[6:]
    [(b, _)] = arith_torch.prepare_decode(cut)
    _, status = arith_cuda.arith_decode(b.bufs, b.meta, order, b.n_out)
    assert status.tolist() == [5000, arith_torch.TRUNCATED, 5000]


@pytest.mark.parametrize("order", [0, 1])
def test_damaged_streams_raise(order):
    a = corpus("drift")
    good = arith_np.encode(a, order=order)
    for route in (lambda b: arith_cuda.decode(b, device="cpu"),
                  arith_torch.decode_plain):
        with pytest.raises(ValueError):          # shorter than the header
            route(good[:4])
        with pytest.raises(ValueError):          # a body cut short
            route(good[:len(good) // 2])
        with pytest.raises(ValueError):          # under the 4 N bytes
            route(good[:6 + 4 * 16 - 1])
        with pytest.raises(ValueError):          # order 2
            route(good[:1] + b"\x02" + good[2:])
        with pytest.raises(ValueError):          # 2^11 lanes
            route(b"\x0b" + good[1:])
        longer = good[:2] + (len(a) * 2).to_bytes(4, "little") + good[6:]
        with pytest.raises(ValueError):          # n past the body
            route(longer)


def test_lane_counts_the_kernels_refuse():
    with pytest.raises(ValueError):
        arith_cuda.encode(b"abc", 0, n_lanes=2048, device="cpu")
    with pytest.raises(ValueError):
        arith_cuda.encode(b"abc", 0, n_lanes=48, device="cpu")
    with pytest.raises(ValueError):
        arith_cuda.encode(b"abc", 2, device="cpu")


def test_wrappers_check_their_tensors():
    b = arith_torch.prepare_encode([b"abcd"], 0)
    with pytest.raises(TypeError):
        arith_cuda.arith_encode(b.data.to(torch.int32), b.meta, 0, b.out_len)
    with pytest.raises(ValueError):
        arith_cuda.arith_encode(b.data, b.meta[:, :4].contiguous(), 0,
                                b.out_len)
    before = dict(arith_cuda.launches)
    out, lens = arith_cuda.arith_encode(b.data, b.meta, 0, b.out_len)
    assert arith_torch.finish_encode(b, out, lens) == \
        [arith_np.encode(b"abcd", order=0)]
    # a CPU launch is the plain version: no kernel launch is counted
    assert arith_cuda.launches == before
    with pytest.raises(DeviceKernelError):
        with _device_errors("cuda", "arith_encode"):
            raise MemoryError("out of memory")


def test_tensor_streams_are_laid_out_on_their_device():
    """Streams given as tensors on one device are concatenated there (on
    the card: no round trip through the host); bytes and arrays on the
    host. Both give the same launch table and the same streams."""
    datas = [corpus("drift")[:500], corpus("short"), corpus("empty")]
    ref = arith_torch.prepare_encode(datas, 1)
    got = arith_torch.prepare_encode([_t(d) for d in datas], 1)
    assert torch.equal(got.data, ref.data) and \
        torch.equal(got.meta, ref.meta) and got.out_len == ref.out_len
    assert arith_cuda.encode_many([_t(d) for d in datas], 1, device="cpu") \
        == [arith_np.encode(d, order=1) for d in datas]


def test_encoder_slot_overflow_is_reported():
    """A slot too small for the stream gives length -1, which
    finish_encode refuses (the kernel reports it the same way)."""
    b = arith_torch.prepare_encode([corpus("uniform")], 0)
    b.meta[0, 3] = arith_torch.HEADER + 4 * 64 + 10   # 64 lanes
    out, lens = arith_cuda.arith_encode(b.data, b.meta, 0, b.out_len)
    assert lens.tolist() == [-1]
    with pytest.raises(RuntimeError):
        arith_torch.finish_encode(b, out, lens)


@pytest.mark.parametrize("col,value", [(0, 1), (1, 5000), (2, -1),
                                       (3, 99999999), (4, 11), (3, 60)])
def test_launch_tables_outside_their_buffers_are_refused(col, value):
    """A table row that reaches past its buffers (or has more than 1024
    lanes, or an encode slot under its header and 4 N bytes) is refused
    before any kernel sees its pointers; a decode row with a body under 4 N
    bytes too."""
    b = arith_torch.prepare_encode([corpus("drift")[:4000]], 1)
    b.meta[0, col] = value
    with pytest.raises(ValueError):
        arith_cuda.arith_encode(b.data, b.meta, 1, b.out_len)
    [(d, _)] = arith_torch.prepare_decode(
        [arith_np.encode(corpus("drift")[:4000], order=1)])
    d.meta[0, 1] = 4 * 16 - 1
    with pytest.raises(ValueError):
        arith_cuda.arith_decode(d.bufs, d.meta, 1, d.n_out)


# --- pack_torch / unpack_torch against pack_jnp / unpack_jnp ---------------

@pytest.mark.parametrize("n", [0, 1, 7, 13, 1001])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_pack_torch_equals_pack_jnp(width, n):
    import jax.numpy as jnp
    from genozip_tpu.ops import pack as ref_pack
    rng = np.random.default_rng(width * 1000 + n)
    for hi in (1 << width, 256):        # values in range, then any byte
        v = rng.integers(0, hi, n).astype(np.uint8)
        want = np.asarray(ref_pack.pack_jnp(jnp.asarray(v), width))
        got = pack.pack_torch(_t(v), width)
        assert got.dtype == torch.uint8 and (got.numpy() == want).all()
        if hi == 1 << width:
            assert (want == pack.pack_np(v, width)).all()
        back = np.asarray(ref_pack.unpack_jnp(jnp.asarray(want), width, n))
        assert (pack.unpack_torch(got, width, n).numpy() == back).all()


def test_pack_torch_sums_where_pack_np_ors():
    """pack_jnp adds the shifted values (mod 256); pack_np ORs them. The
    tensor version keeps pack_jnp's sum."""
    v = np.array([5, 1, 0, 0], np.uint8)        # 5 | 1 << 2 = 5; 5 + 4 = 9
    assert pack.pack_np(v, 2).tolist() == [5]
    assert pack.pack_torch(_t(v), 2).tolist() == [9]
    with pytest.raises(ValueError):
        pack.pack_torch(_t(v), 3)


# --- the kernels on the card ------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("order", [0, 1])
def test_arith_encode_kernel_equals_plain_on_the_card(order):
    _needs_card()
    datas = [corpus(k) for k in CORPORA]
    for N in (None,) + LANES:
        before = arith_cuda.launches["arith_encode"]
        got = arith_cuda.encode_many(datas, order, N, device="cuda")
        assert arith_cuda.launches["arith_encode"] == before + 1
        assert got == arith_cuda.encode_many(datas, order, N, device="cpu")
        assert got == [arith_np.encode(d, order=order, n_lanes=N)
                       for d in datas]


@pytest.mark.cuda
@pytest.mark.parametrize("order", [0, 1])
def test_arith_decode_kernel_equals_plain_on_the_card(order):
    _needs_card()
    datas = [corpus(k) for k in CORPORA]
    for N in (None,) + LANES:
        bufs = [arith_np.encode(d, order=order, n_lanes=N) for d in datas]
        before = arith_cuda.launches["arith_decode"]
        assert arith_cuda.decode_many(bufs, "cuda") == \
            [d.tobytes() for d in datas]
        assert arith_cuda.launches["arith_decode"] == before + 1
    good = arith_np.encode(corpus("drift"), order=order)
    with pytest.raises(ValueError):
        arith_cuda.decode(good[:len(good) // 2], device="cuda")


@pytest.mark.cuda
def test_tensor_streams_on_the_card_stay_there():
    _needs_card()
    datas = [corpus("drift"), corpus("uniform")]
    b = arith_torch.prepare_encode([_t(d).cuda() for d in datas], 0)
    assert b.data.is_cuda
    assert arith_cuda.encode_many([_t(d).cuda() for d in datas], 0) == \
        [arith_np.encode(d, order=0) for d in datas]
