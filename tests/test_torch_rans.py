"""genozip_tpu_torch rANS coders: the plain PyTorch versions of the four
kernels against the normative numpy spec (rans_np) and against the JAX
package's Pallas kernels run in interpret mode, and the wrappers' contract.
Every comparison is exact byte equality. The Pallas module is imported
inside the tests that use it, so the `cuda`-marked tests also run where jax
is not installed."""

import numpy as np
import pytest
import torch

from genozip_tpu.ops import rans_np
from genozip_tpu_torch.ops import rans_cuda, rans_torch

QUALS = np.frombuffer(b"FFFF:F,#ABx", np.uint8)


def _streams(seed, N):
    """Edge-case payloads for lane count N: empty, n < N (lanes of length
    0, K = 1), n not a multiple of N, a one-symbol alphabet (f = 4096) and a
    256-symbol alphabet."""
    rng = np.random.default_rng(seed)
    sizes = [0, 1, max(N // 2 - 1, 1), N + 1, 3 * N + 7, 20000]
    datas = [rng.choice(QUALS, s).tobytes() for s in sizes]
    datas.append(b"\x07" * 3000)
    datas.append(rng.integers(0, 256, 9000, dtype=np.uint8).tobytes())
    return datas


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("N", [16, 64, 256, 1024, 8192, None])
def test_plain_equals_rans_np(order, N):
    datas = _streams(N or 5, N or 16)
    enc = rans_cuda.encode_many(datas, order, "cpu", n_lanes=N)
    assert enc == [rans_np.encode(d, order, n_lanes=N) for d in datas]
    assert rans_cuda.decode_many(enc, "cpu") == datas


@pytest.mark.parametrize("order", [0, 1])
def test_plain_decodes_mixed_lane_counts(order):
    """One decode launch takes streams of any lane counts."""
    rng = np.random.default_rng(11)
    datas = [rng.choice(QUALS, s).tobytes() for s in (40000, 300, 5000)]
    bufs = [rans_np.encode(d, order, n_lanes=N)
            for d, N in zip(datas, (8192, 16, 512))]
    assert rans_cuda.decode_many(bufs, "cpu") == datas


def test_slot_entries_match_the_spec():
    """The packed slot entries (symbol | (f-1) << 8 | (slot-cum) << 20)
    hold rans_np's slot->symbol table and the symbol's freq and cum; rows
    that do not sum to 4096 are 0."""
    rng = np.random.default_rng(12)
    freqs = [rans_np.normalize_freqs(rng.integers(0, 50, 256) *
                                     (rng.random(256) < k / 8))
             for k in range(1, 9)]
    freqs.append(np.eye(256, dtype=np.uint32)[7] * 4096)
    f = np.stack(freqs).astype(np.int64)
    tab = torch.from_numpy(np.stack([f, np.cumsum(f, 1) - f], 1)
                           .astype(np.int32))
    ent = rans_torch.slot_entries(tab).numpy()
    for r, fr in enumerate(f):
        sym = np.repeat(np.arange(256), fr)
        cum = np.cumsum(fr) - fr
        assert np.array_equal(ent[r] & 0xFF, sym)
        assert np.array_equal(((ent[r] >> 8) & 0xFFF) + 1, fr[sym])
        assert np.array_equal(ent[r] >> 20, np.arange(4096) - cum[sym])
    o1 = torch.zeros((1, 2, 256, 256), dtype=torch.int32)
    o1[0, :, 3] = tab[0]
    e1 = rans_torch.slot_entries(o1)
    assert e1.shape == (1, 256, 4096)
    assert torch.equal(e1[0, 3], torch.from_numpy(ent[0]))
    assert int(e1[0, :3].abs().sum()) == 0 and int(e1[0, 4:].abs().sum()) == 0


def _umulhi(x, m):
    """floor(x * m / 2^32) for u32 values held in int64, without overflow."""
    return (x * (m >> 16) + ((x * (m & 0xFFFF)) >> 16)) >> 16


def test_enc_entries_divide_exactly():
    """The encoders' packed entries, through the reciprocal formula in int64,
    give x // f and x % f for every f in [1, 4096], at the edges (2^16,
    (f << 20) - 1, 2^32 - 1, k*f - 1, k*f, k*f + 1) and at 10^4 seeded u32
    values; x' = x + bias + q * (4096 - f) is the spec's (x//f << 12) + x%f +
    c (f = 1: q = x - 1, bias = c + 4095)."""
    rng = np.random.default_rng(13)
    f = np.arange(1, 4097, dtype=np.int64).reshape(16, 256)
    c = rng.integers(0, 4096, f.shape)
    tab = torch.from_numpy(np.stack([f, c], 1).astype(np.int32))
    ent = rans_torch.enc_entries(tab)
    assert ent.shape == (16, 256, 2)
    top = (1 << 32) - 1
    rand = torch.from_numpy(rng.integers(1, 1 << 32, 10000, dtype=np.int64))
    for row in range(16):
        fr = torch.from_numpy(f[row])[:, None]
        cr = torch.from_numpy(c[row])[:, None]
        lo, m = ent[row, :, 0:1], ent[row, :, 1:2]
        assert torch.equal(lo & 0x1FFF, fr)
        k = torch.tensor([2, 3, 1000, 65537], dtype=torch.int64)[None, :]
        kmax = top // fr
        edges = torch.cat([
            torch.full_like(fr, 1 << 16), torch.clamp((fr << 20) - 1, max=top),
            torch.full_like(fr, top), k * fr - 1, k * fr, k * fr + 1,
            kmax * fr - 1, kmax * fr], dim=1)
        edges = torch.clamp(edges, min=1, max=top)
        x = torch.cat([edges, rand[None, :].expand(256, -1)], dim=1)
        hi = _umulhi(x, m)
        q = (hi + ((x - hi) >> 1)) >> ((lo >> 26) & 0xF)
        one = fr == 1
        assert torch.equal(torch.where(one, q + 1, q), x // fr)
        assert torch.equal(torch.where(one, x - (q + 1), x - q * fr), x % fr)
        bias = (lo >> 13) & 0x1FFF
        assert torch.equal(x + bias + q * (4096 - fr),
                           ((x // fr) << 12) + x % fr + cr)
    zero = rans_torch.enc_entries(torch.zeros((1, 2, 256, 256),
                                              dtype=torch.int32))
    assert zero.shape == (1, 256, 256, 2) and int(zero.abs().sum()) == 0


@pytest.mark.parametrize("N", [16, 64, 1024, 8192])
def test_stripe_rows_equal_to_matrix(N):
    """stripe_rows (the plain stripe_kernel) holds each stream's symbols as
    rans_np._to_matrix does, (K, N) with m[t, l] = data[l*K + t] and 0 past
    the lane's chunk, in words of 8 steps: lane l's steps 8b .. 8b+7 at
    (b, l), the top block's steps past K 0. Streams with short last lanes,
    empty lanes, K not a multiple of 8 and n = 0 share one batch, each at
    its enc_bases offset and clear of the next."""
    rng = np.random.default_rng(N)
    sizes = [3 * N - 1, 0, 5 * N - N // 2 + 1, N // 2 + 3, 1, 2 * N,
             17 * N + 5]
    datas = [rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in sizes]
    b = rans_torch.prepare_encode(datas, 0, N)
    rows = rans_torch.stripe_rows(b.data, b.meta).numpy()
    bases = rans_torch.enc_bases(b.meta).numpy()
    assert rows.shape[0] == (len(b.data) + len(datas) * rans_torch.ENC_PAD
                             + 63) // 64 * 64
    for r, d in enumerate(datas):
        want, K, _ = rans_np._to_matrix(np.frombuffer(d, np.uint8), N)
        Kp = (K + 7) // 8 * 8
        blocks = rows[bases[r]:bases[r] + Kp * N].reshape(Kp // 8, N, 8)
        got = blocks.transpose(0, 2, 1).reshape(Kp, N)
        assert np.array_equal(got[:K], want)
        assert not got[K:].any()
        assert bases[r] % 16 == 0
        end = bases[r + 1] if r + 1 < len(datas) else rows.shape[0]
        assert bases[r] + Kp * N <= end


@pytest.mark.parametrize("order", [0, 1])
def test_encode_work_holds_every_stream(order):
    """The encoders' scratch (EncWork): every stream's rows, words, masks
    and chunk sums (one per 8 steps) lie inside encode_work_bytes and apart
    from the other streams', for mixed lane counts and empty streams."""
    rng = np.random.default_rng(order)
    sizes = [0, 1, 20000, 16, 300000, 5, 70001, 0]
    datas = [rng.integers(0, 4, s, dtype=np.uint8).tobytes() for s in sizes]
    lanes = [None, 16, 8192]
    for N in lanes:
        b = rans_torch.prepare_encode(datas, order, N)
        R, n = len(datas), len(b.data)
        T = (n + R * rans_torch.ENC_PAD + 63) // 64 * 64
        ent = R << 19 if order == 1 else 0
        total = rans_cuda.encode_work_bytes(order, R, n)
        bases = rans_torch.enc_bases(b.meta).tolist()
        spans = {"rows": [], "words": [], "masks": [], "sums": []}
        for r, m in enumerate(b.meta.tolist()):
            K, Nr = m[3], m[2]
            M = K * ((Nr + 31) // 32)
            base = bases[r]
            Kp = (K + 7) // 8 * 8
            spans["rows"].append((ent + base, ent + base + Kp * Nr))
            spans["words"].append((ent + T + 2 * base,
                                   ent + T + 2 * (base + Kp * Nr)))
            spans["masks"].append((ent + 3 * T + 4 * (base // 16),
                                   ent + 3 * T + 4 * (base // 16 + M)))
            s0 = (base >> 7) + r
            spans["sums"].append((ent + 3 * T + T // 4 + 4 * s0,
                                  ent + 3 * T + T // 4 + 4 * (s0 + Kp // 8)))
        limits = {"rows": ent + T, "words": ent + 3 * T,
                  "masks": ent + 3 * T + T // 4, "sums": total}
        for key, sp in spans.items():
            for (a0, a1), (b0, _) in zip(sp, sp[1:]):
                assert a1 <= b0, (key, N)
            assert sp[-1][1] <= limits[key], (key, N)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("N", [16, 64, 1024, 8192])
def test_plain_decode_short_last_lanes(order, N):
    """One decode batch of streams whose last lane is short (n = K*N - d),
    plus one with lanes that hold nothing and a 256-symbol one, against
    rans_np.decode and, where the Pallas decoders take N (N >= 128), against
    them in interpret mode."""
    rng = np.random.default_rng(N + order)
    sizes = [3 * N - 1, 5 * N - N // 2 + 1, N // 2 + 3]
    datas = [rng.choice(QUALS, s).tobytes() for s in sizes]
    datas.append(rng.integers(0, 256, 2 * N + 5, dtype=np.uint8).tobytes())
    bufs = [rans_np.encode(d, order, n_lanes=N) for d in datas]
    got = rans_cuda.decode_many(bufs, "cpu")
    assert got == [rans_np.decode(b) for b in bufs] == datas
    if N >= 128:
        from genozip_tpu.ops import rans_pallas
        want = rans_pallas.decode_many_v6(bufs, S=4, R=8, interpret=True) \
            if order == 0 else rans_pallas.decode_many_o1(bufs, S=8,
                                                          interpret=True)
        assert got == want


def _pallas_inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.choice(QUALS, s).tobytes() for s in (6000, 37, 1, 2500)]


def test_encode_o0_vs_encode_many_v6():
    from genozip_tpu.ops import rans_pallas
    datas = _pallas_inputs(1)
    ref = rans_pallas.encode_many_v6(datas, n_lanes=256, S=4, R=8,
                                     interpret=True)
    assert rans_cuda.encode_many(datas, 0, "cpu", n_lanes=256) == ref


def test_decode_o0_vs_decode_many_v6_and_decode_many():
    from genozip_tpu.ops import rans_pallas
    datas = _pallas_inputs(2)
    bufs = [rans_np.encode(d, 0, n_lanes=256) for d in datas]
    got = rans_cuda.decode_many(bufs, "cpu")
    assert got == rans_pallas.decode_many_v6(bufs, S=4, R=8, interpret=True)
    assert got == rans_pallas.decode_many(bufs, S=8, interpret=True)
    assert got == datas


def test_encode_o1_vs_encode_many_o1_v6():
    from genozip_tpu.ops import rans_pallas
    datas = _pallas_inputs(3)
    ref = rans_pallas.encode_many_o1_v6(datas, n_lanes=256, S=4, R=8,
                                        interpret=True)
    assert rans_cuda.encode_many(datas, 1, "cpu", n_lanes=256) == ref


def test_decode_o1_vs_decode_many_o1_v6():
    from genozip_tpu.ops import rans_pallas
    datas = _pallas_inputs(4)
    bufs = [rans_np.encode(d, 1, n_lanes=256) for d in datas]
    got = rans_cuda.decode_many(bufs, "cpu")
    assert got == rans_pallas.decode_many_o1_v6(bufs, S=4, R=8,
                                                interpret=True)
    assert got == datas


def test_order1_256_symbols_vs_full_table_kernels():
    """A 256-symbol order-1 alphabet: beyond the palette kernels, served by
    the full-table K5/K6 kernels on the TPU and by the same port kernels."""
    from genozip_tpu.ops import rans_pallas
    rng = np.random.default_rng(5)
    datas = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
             for s in (9000, 700)]
    enc = rans_cuda.encode_many(datas, 1, "cpu", n_lanes=256)
    assert enc == rans_pallas.encode_many_o1(datas, n_lanes=256, S=8,
                                             interpret=True)
    got = rans_cuda.decode_many(enc, "cpu")
    assert got == rans_pallas.decode_many_o1(enc, S=8, interpret=True)
    assert got == datas


def test_wrappers_run_plain_on_cpu_without_counting():
    b = rans_torch.prepare_encode([b"ACGTACGTTT" * 50], 0)
    before = dict(rans_cuda.launches)
    words, p, states = rans_cuda.rans_encode_o0(b.data, b.meta, b.tab,
                                                b.n_words, b.n_states)
    assert rans_cuda.launches == before
    assert rans_torch.finish_encode(b, words, p, states)[0] == \
        rans_np.encode(b"ACGTACGTTT" * 50, 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device"])
def test_wrappers_check_their_tensors(bad):
    b = rans_torch.prepare_encode([b"ACGT" * 100, b"TTTT"], 1)
    data, meta, tab = b.data, b.meta, b.tab
    if bad == "dtype":
        data = data.to(torch.int32)
    elif bad == "shape":
        tab = tab[:1]
    elif bad == "contiguous":
        meta = meta.t().contiguous().t()
    else:
        meta = meta.to("meta")
    with pytest.raises((TypeError, ValueError)):
        rans_cuda.rans_encode_o1(data, meta, tab, b.n_words, b.n_states)


def test_decode_rejects_truncated_stream():
    buf = rans_np.encode(b"ACGT" * 1000, 0, n_lanes=64)
    with pytest.raises(ValueError):
        rans_cuda.decode_many([buf[:40]], "cpu")


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_device_errors_are_kernel_errors_only_on_the_card(device):
    """On a CUDA device any failure of the route becomes DeviceKernelError;
    on the CPU the original error passes through unchanged."""
    want = rans_cuda.DeviceKernelError if device == "cuda" else MemoryError
    with pytest.raises(want) as exc:
        with rans_cuda._device_errors(device, "rans_encode_o0"):
            raise MemoryError("out of memory")
    assert "out of memory" in str(exc.value)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [0, 1])
def test_kernels_equal_plain_on_the_card(order):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    datas = _streams(9, 256) + [np.random.default_rng(9).choice(
        QUALS, 2 << 20).tobytes()]
    enc = rans_cuda.encode_many(datas, order, "cuda")
    assert enc == rans_cuda.encode_many(datas, order, "cpu")
    assert rans_cuda.decode_many(enc, "cuda") == datas
    # mixed lane counts (choose_num_lanes: 16 .. 8192) in one launch, a
    # one-symbol stream (f = 4096) and n = 0, then every stream at N = 16
    # and at N = 8192
    rng = np.random.default_rng(10)
    mixed = [rng.choice(QUALS, s).tobytes() for s in (40, 5000, 300000)]
    mixed += [b"", b"\x07" * 100000, rng.integers(0, 256, 70000,
                                                   dtype=np.uint8).tobytes()]
    for lanes in (None, 16, 8192):
        enc = rans_cuda.encode_many(mixed, order, "cuda", lanes)
        assert enc == [rans_np.encode(d, order, n_lanes=lanes) for d in mixed]
        assert rans_cuda.decode_many(enc, "cuda") == mixed


# --- single-stream entry points (TPU kernel rows 8-16) ----------------------

ENTRY_QUALS = np.frombuffer(b"FFFFF:F,#AB!x", np.uint8)


@pytest.mark.parametrize("n,N,S", [(33000, 256, 4), (131072, 128, 16),
                                   (100, 128, 1)])
def test_entry_encode_vs_pallas_encode(n, N, S):
    """encode() against rans_pallas.encode (encode_order0_device)."""
    from genozip_tpu.ops import rans_pallas
    data = np.random.default_rng(n).choice(ENTRY_QUALS, n).tobytes()
    got = rans_cuda.encode(data, n_lanes=N, device="cpu")
    assert got == rans_pallas.encode(data, n_lanes=N, S=S, interpret=True)
    assert got == rans_np.encode(data, 0, n_lanes=N)


DECODE_VARIANTS = {"v1": {"v1": True}, "v2": {"S": 4, "v2": True},
                   "v3": {"S": 8, "v3": True}, "v4": {"S": 8, "v4": True},
                   "v5": {"S": 8, "v5": True}}


@pytest.mark.parametrize("variant", list(DECODE_VARIANTS))
def test_entry_decode_vs_pallas_decode_variants(variant):
    """decode() against each of rans_pallas.decode's kernels
    (decode_order0_device and its v2-v5)."""
    from genozip_tpu.ops import rans_pallas
    data = np.random.default_rng(7).choice(ENTRY_QUALS, 33000).tobytes()
    buf = rans_np.encode(data, 0, n_lanes=256)
    got = rans_cuda.decode(buf, device="cpu")
    assert got == rans_pallas.decode(buf, interpret=True,
                                     **DECODE_VARIANTS[variant])
    assert got == data


def test_entry_order1_vs_pallas_order1():
    """encode_order1()/decode_order1() against encode_order1_device and
    decode_order1_device."""
    from genozip_tpu.ops import rans_pallas
    data = np.random.default_rng(8).choice(
        np.frombuffer(b"FFFFF:F,#", np.uint8), 40000).tobytes()
    enc = rans_cuda.encode_order1(data, n_lanes=256, device="cpu")
    assert enc == rans_pallas.encode_order1(data, n_lanes=256, S=8,
                                            interpret=True)
    assert enc == rans_np.encode(data, 1, n_lanes=256)
    got = rans_cuda.decode_order1(enc, device="cpu")
    assert got == rans_pallas.decode_order1(enc, S=8, interpret=True)
    assert got == data


def test_entry_encode_many_vs_pre_v6_encode_many():
    """encode_many(..., 0, n_lanes=N) against the pre-v6 multi-stream
    rans_pallas.encode_many (encode_many_device)."""
    from genozip_tpu.ops import rans_pallas
    rng = np.random.default_rng(9)
    datas = [rng.choice(ENTRY_QUALS, n).tobytes() for n in (33000, 0, 1, 5170)]
    datas.append(b"F" * 4000)
    got = rans_cuda.encode_many(datas, 0, "cpu", n_lanes=256)
    assert got == rans_pallas.encode_many(datas, n_lanes=256, S=4,
                                          interpret=True)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("N", [16, 64, 8192])
def test_entry_decoders_take_every_lane_count(order, N):
    """The Pallas decoders refuse N < 128; the port decodes every N of the
    stream format."""
    data = np.random.default_rng(N + order).choice(ENTRY_QUALS, 20000).tobytes()
    enc_fn = rans_cuda.encode if order == 0 else rans_cuda.encode_order1
    dec_fn = rans_cuda.decode if order == 0 else rans_cuda.decode_order1
    enc = enc_fn(data, n_lanes=N, device="cpu")
    assert enc == rans_np.encode(data, order, n_lanes=N)
    assert dec_fn(enc, device="cpu") == data


def test_entry_decoders_check_the_order():
    buf = rans_np.encode(b"ACGT" * 500, 1, n_lanes=64)
    with pytest.raises(ValueError, match="order-0"):
        rans_cuda.decode(buf, device="cpu")
    with pytest.raises(ValueError, match="order-1"):
        rans_cuda.decode_order1(rans_np.encode(b"ACGT" * 500, 0), device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("N", [128, 1024])
def test_entry_points_on_the_card(N):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    data = np.random.default_rng(N).choice(ENTRY_QUALS, 200000).tobytes()
    for order, enc_fn, dec_fn in ((0, rans_cuda.encode, rans_cuda.decode),
                                  (1, rans_cuda.encode_order1,
                                   rans_cuda.decode_order1)):
        enc = enc_fn(data, n_lanes=N, device="cuda")
        assert enc == enc_fn(data, n_lanes=N, device="cpu")
        assert dec_fn(enc, device="cuda") == data
