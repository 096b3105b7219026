"""The port's C++ host runtime (genozip_tpu_torch/native) against its
oracles: each function against the port's numpy version of it, against
genozip_tpu's native runtime (genozip_tpu/native, where it loads) and
against genozip_tpu's numpy path, on seeded inputs with the edge rows that
matter (n = 0, one row, empty rows, a BAM chain cut mid-record, int lists
with '-', '+', leading zeros, overflow and junk, CRLF). Then whole archives
with the library on the port's path: each equals genozip_tpu's numpy-path
bytes and decodes in both directions; an archive that genozip_tpu wrote
with its native runtime carries the "x64" digest, which the port checks.
The AVX-512 rANS cores are held against the build without them, and two
threads call the library at once.

The library builds here with g++ at first use (a few seconds)."""

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import native as ref_native
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu import seg as ref_seg
from genozip_tpu.datatypes.vcf import VcfDT as RefVcfDT
from genozip_tpu.ops import pack as ref_pack
from genozip_tpu.utils import ragged as ref_ragged
from genozip_tpu_torch import codecs, native, piz_pipeline, seg, synth
from genozip_tpu_torch import zip_pipeline
from genozip_tpu_torch.codecs import bwt, qual
from genozip_tpu_torch.contexts import dedup_col, dedup_col_np
from genozip_tpu_torch.datatypes.bam import BamDT, bam_scan, bam_scan_np
from genozip_tpu_torch.datatypes.fastq import FastqDT
from genozip_tpu_torch.datatypes.sam import SamDT
from genozip_tpu_torch.datatypes.vcf import VcfDT
from genozip_tpu_torch.ops import arith_np, pack, pbwt, rans_np
from genozip_tpu_torch.ref.refstore import RefGenome
from genozip_tpu_torch.utils import ragged
from genozip_tpu_torch.utils.ragged import Col
from tests.test_torch_sam import zip_both
from tests.test_torch_vcf import synth_gatk_vcf

JAX_NATIVE = ref_native.available()
needs_jax_native = pytest.mark.skipif(
    not JAX_NATIVE, reason="genozip_tpu's native runtime did not load")


def _read(p):
    with open(p, "rb") as f:
        return f.read()


def _col(rows):
    return Col.from_list([bytes(r) for r in rows])


def _ref_numpy(monkeypatch):
    """genozip_tpu on its numpy host path with its device path off."""
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    monkeypatch.setenv("GXZ_NO_REF_CACHE", "1")
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def test_library_is_built_from_the_repo_into_build():
    L = native.lib()
    assert os.path.exists(native.LIB)
    assert native.LIB.endswith(os.path.join("genozip_tpu_torch", "build",
                                            "libgxz_host.so"))
    with open(native.SOURCE) as f:
        src = f.read()
    for banned in ("zlib.h", "libdeflate", "-lz"):
        assert banned not in src
    assert L.gxz_host_avx512_compiled() in (0, 1)
    # up to date: a second build is a no-op
    assert native.build() == 0.0


def test_a_failed_build_raises_with_the_compiler_message(tmp_path):
    with pytest.raises(native.HostRuntimeError, match="g\\+\\+"):
        native.build(str(tmp_path / "bad.so"),
                     native.CXXFLAGS + ("--no-such-flag",))
    with pytest.raises(native.HostRuntimeError, match="cannot load"):
        native.load(str(tmp_path / "missing.so"))


def test_rebuilds_when_the_flags_change(tmp_path):
    out = str(tmp_path / "h.so")
    assert native.build(out) > 0
    assert native.build(out) == 0.0
    assert native.build(out, native.CXXFLAGS + native.NO_AVX512) > 0
    assert native.load(out).gxz_host_avx512_compiled() == 0


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(11)
    out = {"empty": b"", "one": b"A", "zeros_3000": bytes(3000)}
    for n in (17, 1023, 1024, 5000, 70_000):
        out[f"random_{n}"] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        out[f"dna_{n}"] = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                                     n).tobytes()
        out[f"geom_{n}"] = np.minimum(rng.geometric(0.2, n), 255).astype(
            np.uint8).tobytes()
    return out


PAYLOADS = _payloads()


@pytest.fixture(scope="module")
def scalar_lib(tmp_path_factory):
    """A build with the AVX-512 rANS cores compiled out."""
    out = str(tmp_path_factory.mktemp("noavx") / "noavx.so")
    native.build(out, native.CXXFLAGS + native.NO_AVX512)
    return native.load(out)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_rans_equals_rans_np(name, order, scalar_lib):
    d = PAYLOADS[name]
    ref = rans_np.encode(d, order=order)
    assert native.rans_encode(d, order) == ref
    assert native.rans_encode(d, order, so=scalar_lib) == ref
    assert native.rans_decode(ref) == d
    assert native.rans_decode(ref, so=scalar_lib) == d


@pytest.mark.parametrize("order", [0, 1])
def test_rans_decodes_kernel_lane_counts(order, scalar_lib):
    """Streams with other lane counts than choose_num_lanes (the device
    kernels' N = 1024 and 8192)."""
    d = PAYLOADS["geom_70000"]
    for n_lanes in (16, 1024, 8192):
        blob = rans_np.encode(d, order=order, n_lanes=n_lanes)
        assert native.rans_decode(blob) == d
        assert native.rans_decode(blob, so=scalar_lib) == d


@pytest.mark.parametrize("order", [0, 1])
def test_rans_refuses_damaged_streams(order):
    blob = bytearray(rans_np.encode(PAYLOADS["geom_5000"], order=order))
    for cut in (3, 20, len(blob) // 2):
        with pytest.raises(Exception):
            native.rans_decode(bytes(blob[:cut]))
    if order == 0:
        bad = bytearray(blob)
        bad[6 + 32] ^= 0x40             # a frequency: the table breaks
        with pytest.raises(ValueError):
            native.rans_decode(bytes(bad))


def test_rans_without_avx512_equals_rans_np(scalar_lib):
    L = scalar_lib
    assert not L.avx and not L.gxz_host_avx512_compiled()
    for name in ("one", "random_1024", "dna_5000", "geom_70000"):
        d = PAYLOADS[name]
        for order in (0, 1):
            ref = rans_np.encode(d, order=order)
            assert native.rans_encode(d, order, so=L) == ref
            assert native.rans_decode(ref, so=L) == d


@needs_jax_native
@pytest.mark.parametrize("name", ["random_1023", "dna_5000", "geom_70000"])
def test_rans_and_arith_equal_jax_native(name):
    d = PAYLOADS[name]
    for order in (0, 1):
        assert native.rans_encode(d, order) == ref_native.rans_encode(d,
                                                                      order)
        assert native.arith_encode(d, order) == \
            ref_native.arith_encode(d, order)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name", ["empty", "one", "random_1023", "dna_5000",
                                  "geom_70000", "zeros_3000"])
def test_arith_equals_arith_np(name, order):
    d = PAYLOADS[name]
    ref = arith_np.encode(d, order=order)
    assert native.arith_encode(d, order) == ref
    assert native.arith_decode(ref) == d
    with pytest.raises(ValueError):
        native.arith_decode(ref[:max(6, len(ref) // 2)] if len(ref) > 70
                            else ref[:4])


@pytest.mark.parametrize("name", ["empty", "one", "dna_1023", "geom_5000"])
def test_byte_hist_pack_and_acgt_equal_numpy(name):
    a = np.frombuffer(PAYLOADS[name], np.uint8)
    assert (native.byte_hist(a) == np.bincount(a, minlength=256)).all()
    # PACK: at most 16 symbols
    b = a % 16 if name != "dna_1023" else a
    syms = np.nonzero(np.bincount(b, minlength=256))[0].astype(np.uint8)
    for width in (1, 2, 4):
        if syms.shape[0] > (1 << width):
            continue
        lut = np.zeros(256, np.uint8)
        lut[syms] = np.arange(syms.shape[0])
        packed = native.pack_lut(b, lut, width)
        assert packed.tobytes() == pack.pack_np(lut[b], width).tobytes()
        assert (native.unpack_lut(packed, b.shape[0], width, syms) == b).all()
    pk, ep, eb = native.acgt_pack(a)
    rpk, rep_, reb = pack.seq_pack_2bit(a)
    assert pk.tobytes() == rpk.tobytes() and (ep == rep_).all() and \
        (eb == reb).all()
    assert native.acgt_unpack(pk, a.shape[0], ep, eb).tobytes() == a.tobytes()


def test_pack_and_acgt_refuse_damaged_payloads():
    with pytest.raises(ValueError):          # code 3 with 3 symbols
        native.unpack_lut(np.array([0xFF], np.uint8), 4, 2,
                          np.frombuffer(b"ACG", np.uint8))
    with pytest.raises(ValueError):          # short packed bytes
        native.unpack_lut(np.zeros(1, np.uint8), 9, 2,
                          np.frombuffer(b"ACGT", np.uint8))
    with pytest.raises(ValueError):          # exception past n
        native.acgt_unpack(np.zeros(2, np.uint8), 8, np.array([8]),
                           np.array([78], np.uint8))


@pytest.mark.parametrize("n", [1, 2, 1000, 20_000])
def test_bwt_walk_equals_numpy(n):
    rng = np.random.default_rng(n)
    a = rng.choice(np.frombuffer(b"ACGT\n@+", np.uint8), n)
    last, prim = bwt.bwt_forward(a)
    got = bwt.bwt_inverse(last, prim)
    assert got.tobytes() == a.tobytes()
    assert got.tobytes() == bwt.bwt_inverse_np(last, prim).tobytes()
    with pytest.raises(ValueError):
        bwt.bwt_inverse(last, n + 1)


@pytest.mark.parametrize("shape", [(0, 5), (1, 1), (7, 3), (300, 64)])
def test_pbwt_equals_numpy(shape):
    rng = np.random.default_rng(shape[0])
    A = (rng.random(shape) < 0.2).astype(np.uint8)
    A[::5] = rng.integers(0, 4, A[::5].shape)
    Y = pbwt.pbwt_encode(A)
    assert (Y == pbwt.pbwt_encode_np(A)).all()
    assert (pbwt.pbwt_decode(Y) == A).all()
    assert (pbwt.pbwt_decode_np(Y) == A).all()
    if JAX_NATIVE and shape[0]:
        assert (Y == ref_native.pbwt_encode(A)).all()


# ---------------------------------------------------------------------------
# BAM
# ---------------------------------------------------------------------------

def _bam_chain(n, seed=3):
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n):
        body = rng.integers(0, 256, int(rng.integers(32, 300)),
                            dtype=np.uint8).tobytes()
        parts.append(len(body).to_bytes(4, "little") + body)
    return np.frombuffer(b"".join(parts), np.uint8)


BAM_CUTS = {
    "empty": lambda c: c[:0],
    "length_only": lambda c: c[:3],
    "one_record": lambda c: c[:4 + int(c[:4].view("<u4")[0])],
    "whole_chain": lambda c: c,
    "cut_mid_record": lambda c: c[:c.shape[0] - 7],
    "cut_mid_length": lambda c: c[:4 + int(c[:4].view("<u4")[0]) + 2],
}


@pytest.mark.parametrize("cap", [1 << 20, 17])
@pytest.mark.parametrize("cut", sorted(BAM_CUTS))
def test_bam_scan_equals_python_loop(cut, cap):
    data = BAM_CUTS[cut](_bam_chain(200))
    got = bam_scan(data, cap)
    ref = bam_scan_np(data, cap)
    assert (got[0] == ref[0]).all() and got[1] == ref[1]
    if JAX_NATIVE:
        jr = ref_native.bam_scan(np.ascontiguousarray(data), cap)
        assert (got[0] == jr[0]).all() and got[1] == jr[1]


def _nibble_rows(seed=5):
    rng = np.random.default_rng(seed)
    lseq = rng.integers(0, 40, 200)
    lseq[:3] = (0, 1, 2)
    nb = (lseq + 1) // 2
    data = rng.integers(0, 256, int(nb.sum()), dtype=np.uint8)
    off = np.concatenate([[0], np.cumsum(nb)])
    return Col(data, off), lseq


def test_nibble_expand_and_renibble_equal_numpy():
    seq, lseq = _nibble_rows()
    dt = BamDT()
    a, ok = dt._seq_ascii(seq, lseq)
    ra, rok = BamDT._seq_ascii_np(seq, lseq)
    assert a.data.tobytes() == ra.data.tobytes()
    assert (a.offsets == ra.offsets).all() and (ok == rok).all()
    assert not ok.all()                      # odd rows with a pad nibble
    back = BamDT._renibble(a)
    rback = BamDT._renibble_np(a)
    assert back.data.tobytes() == rback.data.tobytes()
    assert (back.offsets == rback.offsets).all()
    # a row that says it is longer than its bytes reads on, as numpy does
    lseq2 = lseq.copy()
    lseq2[5] += 2
    a2, _ = dt._seq_ascii(seq, lseq2)
    ra2, _ = BamDT._seq_ascii_np(seq, lseq2)
    assert a2.data.tobytes() == ra2.data.tobytes()
    lseq2[-1] += 4                           # past the data: both raise
    with pytest.raises(IndexError):
        dt._seq_ascii(seq, lseq2)
    with pytest.raises(IndexError):
        BamDT._seq_ascii_np(seq, lseq2)


# ---------------------------------------------------------------------------
# SAM against the genome
# ---------------------------------------------------------------------------

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _sam_case(seed, n=300):
    """Reads with M/I/D/S/=/X/N/H ops against a 20 kbp genome, some rows not
    by reference, a few bytes off ACGT."""
    rng = np.random.default_rng(seed)
    G = 20_000
    codes = rng.integers(0, 4, G).astype(np.uint8)
    cig, seqs, pos, rn = [], [], [], []
    for i in range(n):
        ops = []
        for _ in range(int(rng.integers(1, 5))):
            ops.append((int(rng.integers(1, 30)),
                        "MMMM=XIDSN"[int(rng.integers(0, 10))]))
        if i % 17 == 0:
            ops = [(5, "H")] + ops
        cig.append("".join(f"{a}{b}" for a, b in ops).encode())
        rl = sum(a for a, b in ops if b in "MIS=X")
        s = ACGT[rng.integers(0, 4, rl)]
        s[rng.random(rl) < 0.02] = ord("N")
        seqs.append(s.tobytes())
        pos.append(str(int(rng.integers(1, G - 300))).encode()
                   if i % 11 else b"0")
        rn.append(b"c1" if i % 13 else b"c9")
    return codes, _col(seqs), _col(cig), _col(pos), _col(rn)


def _sam_dt(codes, internal):
    dt = SamDT()
    ref = RefGenome(codes.copy(), [{"name": "c1", "gpos": 0,
                                    "length": codes.shape[0]}])
    if internal:
        ref.internal = True
        ref.is_set = np.zeros(codes.shape[0], bool)
        ref.is_set[: codes.shape[0] // 2] = True
    return dt, ref


@pytest.mark.parametrize("internal", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seq_diff_and_recon_equal_numpy(seed, internal):
    codes, seq, cig, pos, rn = _sam_case(seed)
    dt, ref = _sam_dt(codes, internal)
    dt2, ref2 = _sam_dt(codes, internal)
    ctxs = {}
    dt._seg_seq_vs_ref(ctxs, seq, rn, pos, cig, ref)
    n = len(seq)
    fo = dt2._flat_ops(cig, n)
    pv, pok = ragged.atoi(pos)
    gbase = dt2._gbase_of(rn, ref2)
    gpos0 = gbase + pv - 1
    by_ref = ctxs["SQBITMAP"].local.astype(bool)
    assert by_ref.any() and not by_ref.all()
    if internal:
        ref2.read_unset = np.zeros(ref2.length, bool)
    mr, mp, mb, nonref = dt2._seq_diff_np(seq, by_ref, gpos0, fo, ref2)
    assert (ctxs["SEQMISP"].local == mp).all()
    assert ctxs["SEQMISB"].local.tobytes() == mb.tobytes()
    assert (ctxs["SEQNM"].local ==
            np.bincount(mr, minlength=n)[by_ref]).all()
    assert ctxs["NONREF"].local.tobytes() == nonref.tobytes()
    if internal:
        assert ref.read_unset.any()
        assert (ref.read_unset == ref2.read_unset).all()
    # PIZ: the rebuild equals numpy's before and after the patches
    pctxs = {k: _PCtx(v) for k, v in ctxs.items()}
    dt.ref = ref
    got = dt._recon_seq_vs_ref(pctxs, seq.lens, pos, rn, cig)
    assert got.data.tobytes() == seq.data.tobytes()
    nr_need = np.where(~by_ref, seq.lens, np.bincount(
        fo["oprow"], weights=fo["oplen"] * (dt._INS_LUT[fo["letters"]]
                                            & by_ref[fo["oprow"]]),
        minlength=n).astype(np.int64))
    nr_off = np.concatenate([[0], np.cumsum(nr_need)])
    out_off = np.concatenate([[0], np.cumsum(seq.lens)])
    ins_before = dt._seg_excl_cumsum(
        fo["oplen"] * dt._INS_LUT[fo["letters"]], fo["oprow"], n)
    raw = native.seq_recon(out_off, by_ref, gpos0, fo["letters"],
                           fo["oplen"], fo["oprow"], fo["roff"], fo["goff"],
                           ins_before, ref.codes, pack.ACGT, dt._MATCH_LUT,
                           dt._INS_LUT, nonref, nr_off)
    assert raw.tobytes() == dt._seq_recon_np(
        fo, by_ref, seq.lens, gpos0, out_off, nonref, nr_off,
        ref).tobytes()
    with pytest.raises(IndexError):     # a NONREF stream one byte short
        native.seq_recon(out_off, by_ref, gpos0, fo["letters"], fo["oplen"],
                         fo["oprow"], fo["roff"], fo["goff"], ins_before,
                         ref.codes, pack.ACGT, dt._MATCH_LUT, dt._INS_LUT,
                         nonref[:-1], np.minimum(nr_off, nonref.shape[0] - 1))


class _PCtx:
    """The parts of a PIZ context _recon_seq_vs_ref reads."""

    def __init__(self, v):
        self.local = v.local

    def nums(self):
        return np.asarray(self.local)


@pytest.mark.parametrize("seed", [4, 5])
def test_ref_populate_equals_numpy(seed):
    """Overlapping reads: the last one wins a base; bases read while unset
    (read_unset) stay unset; blk_set is the touched blocks' recount."""
    rng = np.random.default_rng(seed)
    G, blk = 3 * 4096 + 100, 4096
    seq = _col([ACGT[rng.integers(0, 4, int(rng.integers(1, 200)))].tobytes()
                for _ in range(400)])
    starts = rng.integers(0, G - 200, 400)
    rows = np.sort(rng.choice(400, 300, replace=False))
    nblk = -(-G // blk)
    states = []
    for use_native in (True, False):
        codes = np.zeros(G, np.uint8)
        is_set = np.zeros(nblk * blk, bool)
        is_set[:1000] = True
        codes[:1000] = 3
        read_unset = np.zeros(G, bool)
        read_unset[2000:2500] = True
        blk_set = np.zeros(nblk, np.int64)
        blk_set[0] = 1000
        ref = RefGenome(codes, [])
        ref.is_set, ref.read_unset, ref.blk_set = is_set, read_unset, blk_set
        if use_native:
            native.ref_populate(seq.data, seq.offsets, rows, starts[rows],
                                pack.BASE2BIT, codes, is_set, blk_set, blk,
                                read_unset)
        else:
            SamDT()._populate_rows_np(seq, rows, np.asarray(starts), ref)
        states.append((codes.copy(), is_set.copy(), ref.blk_set.copy()))
    for a, b in zip(*states):
        assert (a == b).all()
    assert not states[0][1][2000:2500].any()


# ---------------------------------------------------------------------------
# ragged columns, the tokenizer, dedup
# ---------------------------------------------------------------------------

def _rows(seed, n, maxlen=12, alphabet=b"0123456789-,:;\tab\r\x01"):
    rng = np.random.default_rng(seed)
    al = np.frombuffer(alphabet, np.uint8)
    return [al[rng.integers(0, al.shape[0], int(rng.integers(0, maxlen)))]
            .tobytes() for _ in range(n)]


ROWSETS = {
    "n0": [],
    "one_row": [b"123"],
    "empty_rows": [b"", b"", b"7", b""],
    "junk_200": _rows(1, 200),
    "long_300": _rows(2, 300, maxlen=40),
    "digits_500": _rows(3, 500, alphabet=b"0123456789"),
    "crlf": [b"12\r", b"a1b22c333\r", b"\r", b"-5\r"],
    # a token a byte: more runs than half the bytes
    "one_digit_rows": [b"7"] * 300,
}


@pytest.mark.parametrize("name", sorted(ROWSETS))
def test_tokenize_equals_numpy_and_jax(name):
    col = _col(ROWSETS[name])
    for mt in (1, 3, seg.MAX_TOKENS):
        got = seg.tokenize_col(col.data, col.offsets, mt)
        ref = seg._tokenize_np(col.data, col.offsets, mt)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and (g == r).all()
        if JAX_NATIVE:
            jr = ref_native.tokenize(col.data, col.offsets, mt)
            for g, r in zip(got, jr):
                assert (g == r).all()


@pytest.mark.parametrize("name", sorted(ROWSETS))
def test_atoi_itoa_count_equal_numpy_and_jax(name):
    col = _col(ROWSETS[name] + [
        b"-", b"-0", b"007", b"+5", b"0", b"9223372036854775807",
        b"-9223372036854775808", b"99999999999999999999",
        b"12345678901234567890123"])
    v, ok = ragged.atoi(col)
    rv, rok = ragged.atoi_np(col)
    assert (ok == rok).all() and (v == rv).all()     # also rows that fail
    jv, jok = ref_ragged.atoi(col)                   # genozip_tpu, numpy
    assert (ok == jok).all() and (v[ok] == jv[ok]).all()
    for sep in (ord(","), ord("\r"), 1):
        assert (ragged.count_sep_per_row(col, sep) ==
                ragged.count_sep_per_row_np(col, sep)).all()
    vals = np.concatenate([v, [0, -1, np.iinfo(np.int64).min,
                               np.iinfo(np.int64).max]])
    a, b = ragged.itoa(vals), ragged.itoa_np(vals)
    assert a.data.tobytes() == b.data.tobytes() and \
        (a.offsets == b.offsets).all()
    if JAX_NATIVE:
        jd, jo = ref_native.itoa(vals)
        assert jd.tobytes() == a.data.tobytes()


@pytest.mark.parametrize("name", sorted(ROWSETS))
def test_range_copies_equal_numpy(name, monkeypatch):
    col = _col(ROWSETS[name])
    n = len(col)
    rng = np.random.default_rng(n)
    idx = rng.integers(0, max(n, 1), 3 * n) if n else np.zeros(0, np.int64)
    take = ragged.take(col, idx)
    inter = ragged.interleave([col, col], sep_after=[b":", None])
    half = np.arange(n) % 2 == 0
    merged = ragged.merge_rows(n, [(np.nonzero(half)[0],
                                    ragged.take(col, np.nonzero(half)[0])),
                                   (np.nonzero(~half)[0],
                                    ragged.take(col, np.nonzero(~half)[0]))])
    monkeypatch.setattr(ragged, "NATIVE_MIN_BYTES", 1 << 60)
    for a, b in ((take, ragged.take(col, idx)),
                 (inter, ragged.interleave([col, col],
                                           sep_after=[b":", None])),
                 (merged, col)):
        assert a.data.tobytes() == b.data.tobytes()
        assert (a.offsets == b.offsets).all()


def test_copy_ranges_refuses_ranges_outside_the_buffers():
    dst = np.zeros(4, np.uint8)
    with pytest.raises(IndexError):
        native.copy_ranges(np.zeros(4, np.uint8), [2], dst, [0], [3])
    with pytest.raises(IndexError):
        native.copy_ranges(np.zeros(4, np.uint8), [0], dst, [2], [3])
    assert not dst.any()


def test_wrappers_refuse_rows_outside_their_data():
    """The C++ side trusts row offsets and indices: the bindings check
    them first."""
    data = np.frombuffer(b"12,3:4", np.uint8)
    for bad in ([0, 4, 2, 6], [0, 3, 9], [-1, 3, 6]):
        for fn in (lambda o: native.count_eq(data, o, ord(",")),
                   lambda o: native.atoi(data, o),
                   lambda o: native.tokenize(data, o, 8),
                   lambda o: native.row_hash(data, o),
                   lambda o: native.int_list_stats(data, o),
                   lambda o: native.split_fields(data, o, ord(":"), 2)):
            with pytest.raises(ValueError):
                fn(np.array(bad))
    with pytest.raises(IndexError):
        native.reverse_rows(data.copy(), [0, 3, 6], [2])
    with pytest.raises(IndexError):
        native.rows_equal_rep(data, [0, 3, 6], [0, 5])


@pytest.mark.parametrize("name", ["junk_200", "long_300", "digits_500"])
def test_dedup_equals_numpy_and_row_hash_equals_jax(name):
    rows = ROWSETS[name]
    col = _col(rows + rows[::3] + [b"x" * 120, b"x" * 120])
    u, inv = dedup_col(col)
    ru, rinv = dedup_col_np(col)
    assert u.data.tobytes() == ru.data.tobytes() and (inv == rinv).all()
    if JAX_NATIVE:
        assert (native.row_hash(col.data, col.offsets) ==
                ref_native.row_hash(col.data, col.offsets)).all()
    rep = np.arange(len(col))
    assert native.rows_equal_rep(col.data, col.offsets, rep)
    rep[1] = 0
    assert native.rows_equal_rep(col.data, col.offsets, rep) == \
        (col.row(0) == col.row(1))


@pytest.mark.parametrize("comp", [False, True])
def test_orient_equals_numpy(comp):
    col = _col(ROWSETS["long_300"] + [b"", b"A", b"ACGTN"])
    rev = np.random.default_rng(1).random(len(col)) < 0.5
    a, b = qual.orient(col, rev, comp), qual.orient_np(col, rev, comp)
    assert a.data.tobytes() == b.data.tobytes()
    assert qual.orient(a, rev, comp).data.tobytes() == col.data.tobytes()


@pytest.mark.parametrize("text", [b"", b"@r\nA\n+\nF\n", b"@r\nA\n+\nF\n@s\n",
                                  b"\n" * 9, b"@a\nAC\n+\nFF\n" * 5 + b"@b"])
def test_fastq_vb_boundary_equals_numpy(text):
    a = np.frombuffer(text, np.uint8)
    assert FastqDT().vb_boundary(a.copy(), False) == FastqDT.vb_boundary_np(a)


# ---------------------------------------------------------------------------
# VCF
# ---------------------------------------------------------------------------

INT_LISTS = [b"1,2,3", b"", b"0", b"0,0", b"5,2,2,9", b"-1,2", b"+5", b"01,2",
             b"1,,2", b"1,", b",1", b"-0", b"12345678901234567890",
             b"123456789012345678,1", b"999999999999999999,999999999999999999",
             b"1\r", b"a", b"7,8\r", b"3", b"10,20"]


@pytest.mark.parametrize("tok_mark", [False, True])
def test_int_lists_equal_numpy(tok_mark):
    rows = INT_LISTS * 3 + _rows(7, 150, alphabet=b"0123456789,,-")
    if tok_mark:
        rows = rows + [b"1,\x012"]
    col = _col(rows)
    vals, f_of, nv, ok = VcfDT._comma_ints(col)
    rvals, rf_of, rnv, rok = VcfDT._comma_ints_np(col)
    assert (ok == rok).all() and ok.any() != tok_mark
    # the values of the rows that parse, and their counts
    assert (vals == rvals[rok[rf_of]]).all()
    assert (nv[ok] == rnv[ok]).all() and not nv[~ok].any()
    for fn, rfn in ((VcfDT._ad_sums, VcfDT._ad_sums_np),
                    (VcfDT._pl_gq, VcfDT._pl_gq_np)):
        (a, aok), (b, bok) = fn(col), rfn(col)
        assert (aok == bok).all() and (a == b).all()
    # genozip_tpu's numpy path gives the same
    jvals, _jf, _jn, jok = RefVcfDT._comma_ints(col) if not JAX_NATIVE else \
        _jax_numpy(RefVcfDT._comma_ints, col)
    assert (jok == ok).all()


def _jax_numpy(fn, *a):
    real = ref_native.available
    ref_native.available = lambda: False
    try:
        return fn(*a)
    finally:
        ref_native.available = real


@needs_jax_native
def test_int_list_stats_equal_jax_native():
    """genozip_tpu's native sums are exact; the port's are numpy's (in
    double): they agree below 2^53."""
    col = _col([r for r in INT_LISTS if len(r) < 16] +
               _rows(8, 100, alphabet=b"0123456789,"))
    got = native.int_list_stats(col.data, col.offsets)
    ref = ref_native.int_list_stats(col.data, col.offsets)
    for g, r in zip(got, ref):
        assert (g == r).all()
    pv, pn, pok = native.int_list_parse(col.data, col.offsets)
    rv, rn, rok = ref_native.int_list_parse(col.data, col.offsets)
    assert (pv == rv).all() and (pn == rn).all() and (pok == rok).all()


@pytest.mark.parametrize("T", [1, 2, 4])
def test_split_and_join_fields_equal_numpy(T):
    rows = [b"0/1:5:6", b"", b"1|1", b"0/0:3:4:5:6", b":", b"::", b"a:b"] * 20
    col = _col(rows)
    fs, fl, nf = native.split_fields(col.data, col.offsets, ord(":"), T)
    for i, r in enumerate(rows):
        parts = r.split(b":")
        assert nf[i] == (0 if not r else min(len(parts), T + 1))
        for t in range(min(len(parts), T) if r else 0):
            assert col.data[fs[t, i]:fs[t, i] + fl[t, i]].tobytes() == \
                parts[t]
    if JAX_NATIVE:
        js, jl, jn = ref_native.split_fields(col.data, col.offsets,
                                             ord(":"), T)
        assert (jn == nf).all() and (jl == fl).all()
    got, ref = VcfDT._cell_fields(col, T), VcfDT._cell_fields_np(col, T)
    assert (got[0] == ref[0]).all() and (got[1] == ref[1]).all()
    assert sorted(got[2]) == sorted(ref[2]) == sorted(got[3])
    for t in got[2]:
        assert (got[2][t] == ref[2][t]).all()
        assert got[3][t].data.tobytes() == ref[3][t].data.tobytes()
        assert (got[3][t].offsets == ref[3][t].offsets).all()
    # join: cells of 0..3 subfields
    nsub = np.array([i % 4 for i in range(40)], np.int64)
    subs = _col(_rows(9, int(nsub.sum()), alphabet=b"0123:/|"))
    sub_off = np.concatenate([[0], np.cumsum(nsub)])
    out, off = native.join_cells(subs.data, subs.offsets, nsub, ord(":"))
    ref = VcfDT._join_cells_np(subs, sub_off, nsub, len(nsub))
    assert out.tobytes() == ref.data.tobytes() and (off == ref.offsets).all()


# ---------------------------------------------------------------------------
# XXH64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 4099])
def test_xxh64(n):
    d = bytes(range(256)) * (n // 256 + 1)
    d = d[:n]
    h = native.xxh64(d)
    if n == 0:
        assert h == 0xEF46DB3751D8E999       # the XXH64 test vector
    if JAX_NATIVE:
        assert h == ref_native.xxh64(d)
        assert native.xxh64(d, 7) == ref_native.xxh64(d, 7)


# ---------------------------------------------------------------------------
# threads: ctypes drops the GIL
# ---------------------------------------------------------------------------

def test_two_threads_call_the_library_at_once():
    d = PAYLOADS["geom_70000"]
    want = rans_np.encode(d, order=1)
    chain = _bam_chain(2000, seed=9)
    want_scan = bam_scan_np(chain, 1 << 20)
    start = threading.Barrier(2)

    def enc(_):
        start.wait()
        return all(native.rans_encode(d, 1) == want for _ in range(8))

    def scan(_):
        start.wait()
        ok = True
        for _ in range(40):
            got = bam_scan(chain, 1 << 20)
            ok &= bool((got[0] == want_scan[0]).all()) and \
                got[1] == want_scan[1]
        return ok

    with ThreadPoolExecutor(2) as ex:
        a = ex.submit(enc, 0)
        b = ex.submit(scan, 0)
        assert a.result() and b.result()


# ---------------------------------------------------------------------------
# whole archives with the library on: genozip_tpu's numpy-path bytes
# ---------------------------------------------------------------------------

@pytest.fixture
def port_and_numpy_reference(monkeypatch):
    _ref_numpy(monkeypatch)
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    yield
    codecs.disable_device_rans()


def _gff(path):
    rng = np.random.default_rng(4)
    rows = [b"##gff-version 3\n"]
    for i in range(3000):
        rows.append(b"chr1\tsrc\tgene\t%d\t%d\t.\t+\t.\tID=g%d;Name=G%d;"
                    b"Note=%s\n" % (i * 50 + 1, i * 50 + 40, i, i % 97,
                                    b"x" * int(rng.integers(0, 9))))
    with open(path, "wb") as f:
        f.write(b"".join(rows))


ARCHIVES = {
    # cfg3-shaped FASTQ, VBs of 64 KiB
    "fastq": (lambda p: synth.write_fastq(p, 400 << 10, seed=3, block=1000),
              64 << 10, ".fastq"),
    # a BGZF BAM with REF_INTERNAL over several VBs (fault F11's case)
    "bam_ref_internal": (lambda p: synth.write_bam(
        p, 300 << 10, seed=5, genome_len=1 << 20, window_reads=1500),
        96 << 10, ".bam"),
    # VCF with AD/PL int lists, DP and GQ predictions
    "vcf_int_lists": (lambda p: open(p, "wb").write(synth_gatk_vcf(1500)),
                      64 << 10, ".vcf"),
    "gff": (_gff, 64 << 10, ".gff"),
}


@pytest.mark.parametrize("name", sorted(ARCHIVES))
def test_archive_equals_numpy_path(name, tmp_path, port_and_numpy_reference):
    write, vb, ext = ARCHIVES[name]
    src = str(tmp_path / f"in{ext}")
    write(src)
    port, refz = zip_both(src, vb)
    h = piz_pipeline.PizReader(port).file_hdr
    if name == "bam_ref_internal":
        assert h["ref_internal"] and h["num_vbs"] >= 2


def _zip_jax_native(src, out, monkeypatch, x64_delta=0):
    """genozip_tpu with its native runtime (libdeflate ZLIB, x64 digests);
    x64_delta shifts every x64 it writes, the adler32 staying right."""
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    ref_codecs.disable_device_rans()
    real = ref_native.xxh64
    monkeypatch.setattr(ref_native, "xxh64",
                        lambda d, seed=0: (real(d, seed) + x64_delta)
                        & ((1 << 64) - 1))
    ref_zip.zip_file(src, out, vb_size=64 << 10)
    monkeypatch.setattr(ref_native, "xxh64", real)


@needs_jax_native
def test_x64_archive_decodes_and_a_wrong_x64_is_refused(tmp_path,
                                                        monkeypatch):
    src = str(tmp_path / "r.fastq")
    synth.write_fastq(src, 200 << 10, seed=8, block=1000)
    good, bad = str(tmp_path / "g.gxz"), str(tmp_path / "b.gxz")
    _zip_jax_native(src, good, monkeypatch)
    _zip_jax_native(src, bad, monkeypatch, x64_delta=1)
    pr = piz_pipeline.PizReader(good)
    assert pr.num_vbs() >= 1
    assert all(pr.load_vb(i)[0].get("x64") is not None
               for i in range(1, pr.num_vbs() + 1))
    pr.close()
    piz_pipeline.piz_file(good, str(tmp_path / "o"))
    assert _read(str(tmp_path / "o")) == _read(src)
    with pytest.raises(ValueError, match="xxh64"):
        piz_pipeline.piz_file(bad, str(tmp_path / "o2"))
    # genozip_tpu refuses it too
    with pytest.raises(AssertionError, match="xxh64"):
        ref_piz.piz_file(bad, str(tmp_path / "o3"))
