"""The pieces of the redesigned ARITH-W32 kernels (csrc/arith_model.cuh,
csrc/arith.cu) as their plain PyTorch mirrors in ops/arith_torch.py,
against their definitions: the two-level lookup and search on packed group
sums against torch.cumsum rows, the event slots against the order
arith_np.assemble_stream lays out, and the step's update with its crossing
test and one halving against arith_np's model; then the corpora
that exercise that layout against genozip_tpu's `arith_jax` on CPU JAX.
Every comparison is exact (tolerance 0); inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

from genozip_tpu_torch.ops import arith_np, arith_torch as at
from tests.test_torch_arith import NEW_CORPORA, _all_routes_equal_jax, corpus


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensor ops: one intra-op thread, so that test workers sharing
    the cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed):
    """Frequency rows (8, 256) of the kinds a coder holds: uniform, random
    under MAX_TOTAL, skewed to one symbol, skewed to the last group, and
    each of them halved once or twice (f >= 1 throughout)."""
    rng = np.random.default_rng(seed)
    rows = [np.ones(256, np.int64),
            rng.integers(1, 120, 256),
            np.where(np.arange(256) == 200, at.MAX_TOTAL - 255, 1),
            np.where(np.arange(256) >= 240, 1900, 1)]
    out = []
    for r in rows:
        out += [r, (r + 1) >> 1, (((r + 1) >> 1) + 1) >> 1]
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_lookup_equals_cumsum_rows(seed):
    freq = _models(seed)
    assert int(freq.sum(-1).max()) <= at.MAX_TOTAL
    sym = torch.arange(256).expand(freq.shape[0], 256)
    f, c = at.lookup_grouped(freq[:, None, :].expand(-1, 256, -1), sym)
    cum = freq.cumsum(-1)
    assert torch.equal(f, freq)
    assert torch.equal(c, cum - freq)


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_search_equals_cumsum_rows(seed):
    """Every v below each row's total, as the decoder takes it: the symbol
    is the number of inclusive cums <= v."""
    freq = _models(seed)
    cum = freq.cumsum(-1)
    for r in range(freq.shape[0]):
        tot = int(cum[r, -1])
        v = torch.arange(tot)
        s, f, c = at.search_grouped(freq[r].expand(tot, 256), v)
        want = (cum[r][None, :] <= v[:, None]).sum(-1)
        assert torch.equal(s, want)
        assert torch.equal(f, freq[r][want])
        assert torch.equal(c, cum[r][want] - freq[r][want])


def test_packed_prefix_adds_exactly_up_to_the_largest_total():
    """Partial sums up to MAX_TOTAL + 1024 * INC (a total during an
    update) stay in their u16 halves."""
    big = at.MAX_TOTAL + 1024 * at.INC
    assert big < 1 << 16
    halves = torch.tensor([big // 16] * 15 + [big - 15 * (big // 16)])
    w = at.pack_halves(halves)
    for k in range(17):
        assert int(at.prefix16(w, torch.tensor(k))) == int(halves[:k].sum())
    n, below, above = at.find16(w, torch.tensor(big - 1))
    assert (int(n), int(below), int(above)) == \
        (15, int(halves[:15].sum()), big)


def _emissions(rng, N, steps):
    """Random renorm counts (steps, N), 0..MAX_EVENTS each, with one step of
    every lane at the bound and one of none."""
    e = rng.integers(0, at.MAX_EVENTS + 1, (steps, N))
    e[1] = at.MAX_EVENTS
    e[2] = 0
    return e


@pytest.mark.parametrize("N", [1, 16, 64, 1024])
def test_event_slots_follow_assemble_stream(N):
    """The encoder's placement (lane l's b-th byte at 4 l + b, else at the
    slot of its (b - 4)-th event) with the slots of `event_slots` gives
    assemble_stream's stream, and the decoder reading its i-th event at its
    slot gets the lane's (4 + j)-th byte."""
    rng = np.random.default_rng(N)
    counts = _emissions(rng, N, 6)
    ev_lane, slots, base = [], [], 0          # the spec's (step, it, lane)
    for e in counts:
        s, total = at.event_slots(torch.from_numpy(e))
        for i in range(at.MAX_EVENTS):
            ev_lane += [l for l in range(N) if e[l] > i]
        slots.append(s.numpy() + np.where(s.numpy() >= 0, base, 0))
        base += total
    ev_lane = np.array(ev_lane, np.int64)
    ev_byte = rng.integers(0, 256, ev_lane.shape[0]).astype(np.uint8)
    flush = rng.integers(0, 256, (N, 4)).astype(np.uint8)
    want = arith_np.assemble_stream(ev_lane, ev_byte, flush, N)
    # each lane's emitted bytes in order: its events', then the flush
    emitted = [list(ev_byte[ev_lane == l]) + list(flush[l]) for l in range(N)]
    lane_slots = [[int(x) for st in slots for x in st[l] if x >= 0]
                  for l in range(N)]
    body = np.full(4 * N + base, -1)
    for l in range(N):
        for b, byte in enumerate(emitted[l]):
            body[4 * l + b if b < 4 else 4 * N + lane_slots[l][b - 4]] = byte
    assert body.tolist() == list(want)
    for l in range(N):
        for j, sl in enumerate(lane_slots[l]):
            assert body[4 * N + sl] == emitted[l][j + 4]


def _spec_model(order, freq, total):
    m = arith_np._Model(order)
    m.freq, m.total = freq.numpy().astype(np.uint32), \
        total.numpy().astype(np.uint32)
    return m


@pytest.mark.parametrize("order,N,case", [
    (1, 64, "random"), (1, 1024, "one_context"), (0, 1024, "skewed"),
    (0, 256, "random"), (1, 256, "near_max")])
def test_step_update_equals_arith_np(order, N, case):
    """Steps of the kernels' update (update_step) against arith_np's model:
    the frequencies, the totals and the group sums they imply; every context
    taken over MAX_TOTAL listed exactly once, whatever the order of the
    lanes' total adds; one halving brings each under. `one_context`: all
    1024 lanes (32 warps) push one context past MAX_TOTAL in one step."""
    rng = np.random.default_rng(N + order)
    nctx = 256 if order else 1
    freq = torch.ones((nctx, 256), dtype=torch.int64)
    if case == "near_max":
        freq[:, 7] = at.MAX_TOTAL - 255 - 3 * at.INC
    total = freq.sum(-1)
    gsum = at.group_sums(freq)
    for step in range(12):
        if case == "one_context":
            ctx = torch.full((N,), 5, dtype=torch.int64)
            sym = torch.from_numpy(rng.integers(0, 4, N))
        else:
            ctx = torch.from_numpy(rng.integers(0, nctx, N))
            sym = torch.from_numpy(
                rng.integers(0, 4, N) if case == "skewed"
                else rng.integers(0, 256, N))
        active = torch.from_numpy(np.arange(N) < N - step * (N // 16))
        spec = _spec_model(order, freq, total)
        spec.update(ctx.numpy(), sym.numpy(), active.numpy())
        over = sorted({int(c) for c in ctx[active]
                       if int(total[c]) + at.INC * int(
                           ((ctx == c) & active).sum()) > at.MAX_TOTAL})
        runs = []
        for seed in range(3):
            f, g, t = freq.clone(), gsum.clone(), total.clone()
            perm = None if seed == 0 else np.random.default_rng(
                seed).permutation(int(active.sum())).tolist()
            listed = at.update_step(f, g, t, ctx, sym, active, order, perm)
            assert sorted(listed) == over and len(listed) == len(set(listed))
            runs.append((f, g, t))
        for f, g, t in runs:
            assert torch.equal(f, runs[0][0]) and torch.equal(t, runs[0][2])
        freq, gsum, total = runs[0]
        assert (freq.numpy() == spec.freq).all()
        assert (total.numpy() == spec.total).all()
        assert torch.equal(gsum, at.group_sums(freq))
        assert int(total.max()) <= at.MAX_TOTAL
    if case == "one_context":
        assert int(total[5]) < at.MAX_TOTAL


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name,N", NEW_CORPORA)
def test_layout_corpora_equal_arith_jax(name, N, order):
    """All 256 symbols descending (the longest walks), one symbol at N =
    1024 (a halving every step at order 0), K = 38 (not a multiple of 16)
    and n = 1 at N = 1024: every route equals arith_jax."""
    _all_routes_equal_jax(corpus(name), order, N)


def test_threads_for_a_warp_or_the_widest_lane_count():
    """A block has one thread a lane of the widest stream and at least a
    warp: the redesigned kernels no longer need a thread a symbol."""
    from genozip_tpu_torch.ops import arith_cuda
    for sizes, lanes, want in (([10], 16, 32), ([10, 5000], None, 64),
                               ([70000], 256, 256), ([9], 1024, 1024)):
        b = at.prepare_encode([b"x" * n for n in sizes], 0, lanes)
        assert arith_cuda.threads_for(b.meta) == want
