"""genozip_tpu_torch encryption (--password) against genozip_tpu.

The AES-256-CTR kernel's plain PyTorch version against genozip_tpu.crypt's
keystream (its native C++ route and its `cryptography` route, each where
present, and its pure-Python route at small sizes), at the sizes and
counter carries that chip_smoke.py checks the kernel at; the key derivation
and tag; and encrypted archives (--password with --md5) of FASTQ, SAM
(gencomp components) and VCF, byte-equal to genozip_tpu's with the salt
fixed in both packages, each package decoding the other's. As in
test_torch_sam.py, the port's rANS kernels take their plain route for
payloads of 16 KiB and up, and genozip_tpu runs on its numpy host path.
Every comparison is exact bytes."""

import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from genozip_tpu import crypt as ref_crypt
from genozip_tpu import filters as ref_filters
from genozip_tpu import native as ref_native
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu_torch import cli, crypt, piz_pipeline, synth
from genozip_tpu_torch import zip_pipeline
from genozip_tpu_torch.ops import aes_cuda, aes_torch
from tests.test_torch_sam import host_reference  # noqa: F401

SALT = bytes(range(7, 23))
PW = "hunter2"
SIZES = (0, 1, 15, 16, 17, 4095, 4097, 1 << 20)
# counter0 = salt[:8] || offset (8 bytes, little-endian): a plain one, one
# whose offset's top byte is 0xFF (the first increment carries), one whose
# low 8 bytes are all 0xFF (the carry reaches the salt half) and the
# 128-bit wrap
COUNTERS = {"plain": bytes(range(16)),
            "carry_byte7": b"\x11" * 8 + b"\x00" * 7 + b"\xff",
            "carry_low8": b"\x22" * 8 + b"\xff" * 8,
            "wrap128": b"\xff" * 16}


def _read(p):
    with open(p, "rb") as f:
        return f.read()


def _ref_routes():
    routes = {}
    if ref_native.available():
        routes["native"] = ref_native.aes256_ctr
    try:
        import cryptography  # noqa: F401
        routes["cryptography"] = ref_crypt._aes256_ctr_py
    except ImportError:
        pass
    routes["pure"] = ref_crypt._aes256_ctr_pure
    return routes


@pytest.mark.parametrize("ctr", list(COUNTERS))
@pytest.mark.parametrize("n", SIZES)
def test_plain_aes_equals_reference(n, ctr):
    rng = np.random.default_rng(n + 1)
    key = rng.integers(0, 256, 32, np.uint8).tobytes()
    data = rng.integers(0, 256, n, np.uint8).tobytes()
    got = aes_cuda.aes256_ctr(key, COUNTERS[ctr], data, "cpu")
    assert len(got) == n
    for name, fn in _ref_routes().items():
        if n == 0 or (name == "pure" and n > 4097):
            continue   # native takes no empty buffer; pure runs ~100 KB/s
        assert got == fn(key, COUNTERS[ctr], data), name
    assert aes_cuda.aes256_ctr(key, COUNTERS[ctr], got, "cpu") == data


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on u32 arrays (selector nibbles 0-7 only): byte
    i of the result is byte (sel >> 4i) & 7 of the 8 bytes y:x."""
    v = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros(np.shape(x), np.uint64)
    for i in range(4):
        k = (sel >> (4 * i)) & 7
        out |= ((v >> np.uint64(8 * k)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _model_keystream(rk, ctr_hi, ctr_lo, nblk):
    """The keystream of csrc/aes.cu's rounds, as numpy: one T0 table
    replicated over 32 copies and read at (x << 5) | lane, T1-T3 by
    __byte_perm rotations, the last round's S-box byte taken from T0 and
    the words put in memory order by the last round's selectors. Returns
    the keystream bytes of blocks 0 .. nblk-1."""
    ror8, ror16, ror24 = 0x0321, 0x1032, 0x2103
    lo_pair, hi_pair, join = 0x0051, 0x5100, 0x7610
    s = np.frombuffer(aes_torch.SBOX, np.uint8).astype(np.uint32)
    s2 = ((s << 1) ^ ((s >> 7) * 0x1B)) & 0xFF
    T = np.repeat((s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s), 32)
    b = np.arange(nblk, dtype=np.uint64)
    lane = (b % 32).astype(np.uint32)
    with np.errstate(over="ignore"):
        lo = np.uint64(ctr_lo) + b
        hi = np.uint64(ctr_hi) + (lo < np.uint64(ctr_lo)).astype(np.uint64)
    w = [(hi >> np.uint64(32)).astype(np.uint32),
         (hi & np.uint64(0xFFFFFFFF)).astype(np.uint32),
         (lo >> np.uint64(32)).astype(np.uint32),
         (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
    st = [w[i] ^ np.uint32(rk[i]) for i in range(4)]

    def look(x):
        return T[(x.astype(np.int64) << 5) | lane]

    def quad(i):
        a, b_, c, d = (st[(i + k) % 4] for k in range(4))
        return look(a >> 24), look((b_ >> 16) & 0xFF), \
            look((c >> 8) & 0xFF), look(d & 0xFF)
    for r in range(1, 14):
        new = []
        for i in range(4):
            a, b_, c, d = quad(i)
            new.append(a ^ _byte_perm(b_, 0 * b_, ror8) ^
                       _byte_perm(c, 0 * c, ror16) ^
                       _byte_perm(d, 0 * d, ror24) ^ np.uint32(rk[4 * r + i]))
        st = new
    words = []
    for i in range(4):
        a, b_, c, d = quad(i)
        last = int.from_bytes(rk[56 + i].to_bytes(4, "big"), "little")
        words.append(_byte_perm(_byte_perm(a, b_, lo_pair),
                                _byte_perm(c, d, hi_pair), join) ^
                     np.uint32(last))
    return np.stack(words, 1).astype("<u4").view(np.uint8).reshape(-1)


@pytest.mark.parametrize("ctr", list(COUNTERS))
@pytest.mark.parametrize("n", SIZES)
def test_replicated_table_model_equals_plain(n, ctr):
    """The kernel's round, modelled in numpy (selectors, byte positions,
    copy addressing), equals the plain version at the sizes and counter
    carries the kernel is checked at on the card."""
    rng = np.random.default_rng(n + 7)
    rk = aes_torch.round_keys(rng.integers(0, 256, 32, np.uint8).tobytes())
    hi, lo = aes_torch.split_counter(COUNTERS[ctr])
    data = rng.integers(0, 256, n, np.uint8)
    want = aes_torch.aes256_ctr_plain(rk, hi, lo,
                                      torch.from_numpy(data.copy())).numpy()
    ks = _model_keystream(rk, hi, lo, (n + 15) // 16)
    assert np.array_equal(data ^ ks[:n], want)


def test_key_schedule_equals_fips197():
    """The key schedule equals genozip_tpu's pure-Python expansion, and the
    plain version gives FIPS-197 appendix C.3 (one block of AES-256): CTR
    of a zero block is the block cipher of the counter."""
    key = bytes(range(32))
    ref_rk = ref_crypt._expand_key256(key)
    assert aes_torch.round_keys(key) == tuple(
        int.from_bytes(bytes(ref_rk[r][4 * c:4 * c + 4]), "big")
        for r in range(15) for c in range(4))
    ks = aes_cuda.aes256_ctr(key, bytes.fromhex(
        "00112233445566778899aabbccddeeff"), bytes(16), "cpu")
    assert ks.hex() == "8ea2b7ca516745bfeafc49904b496089"


def test_derive_key_and_tag_equal():
    for pw, salt in ((PW, SALT), ("", b"\0" * 16), ("pässwörd", os.urandom(16))):
        key = crypt.derive_key(pw, salt)
        assert key == ref_crypt.derive_key(pw, salt)
        assert crypt.key_tag(key) == ref_crypt.key_tag(key)
    for off in (0, 64, 1 << 40):
        assert crypt.counter0(SALT, off) == ref_crypt.counter0(SALT, off)
    assert crypt.FLAG_ENCRYPTED == ref_crypt.FLAG_ENCRYPTED
    assert len(crypt.new_salt()) == 16


def test_wrapper_takes_the_plain_route_on_the_cpu_only():
    """On a CPU tensor the wrapper runs the plain version in place and
    counts no launch; it refuses what the kernel does not take."""
    rk = aes_torch.round_keys(bytes(32))
    before = dict(aes_cuda.launches)
    t = torch.zeros(40, dtype=torch.uint8)
    out = aes_cuda.aes256_ctr_xor_(t, rk, 0, 0)
    assert out is t and int(t.sum()) > 0 and aes_cuda.launches == before
    with pytest.raises(TypeError):
        aes_cuda.aes256_ctr_xor_(torch.zeros(4, dtype=torch.int32), rk, 0, 0)
    with pytest.raises(ValueError):
        aes_cuda.aes256_ctr_xor_(torch.zeros(8, dtype=torch.uint8), rk[:59],
                                 0, 0)


@pytest.fixture
def fixed_salt(monkeypatch):
    monkeypatch.setattr(crypt, "new_salt", lambda: SALT)
    monkeypatch.setattr(ref_crypt, "new_salt", lambda: SALT)


def _fastq(d):
    p = str(d / "r.fastq")
    synth.write_fastq(p, 300 << 10, seed=3, block=1000)
    return p


def _sam(d):
    p = str(d / "a.sam")
    synth.write_sam(p, 300 << 10, seed=4, genome_len=1 << 20,
                    window_reads=1500)
    return p


def _vcf(d):
    p = str(d / "v.vcf")
    synth.write_vcf(p, 200 << 10, seed=7, samples=20)
    return p


def _bam(d):
    p = str(d / "a.bam")
    synth.write_bam(p, 200 << 10, seed=4, genome_len=1 << 20,
                    window_reads=1500)
    return p


def zip_both_encrypted(src, **kw):
    """Both packages zip `src` with --password (salt fixed); the archives
    must be the same bytes, and each package decodes both back to `src`."""
    port, refz = src + ".port.gxz", src + ".ref.gxz"
    zip_pipeline.zip_file(src, port, password=PW, **kw)
    ref_zip.zip_file(src, refz, password=PW, **kw)
    assert _read(port) == _read(refz)
    ext = os.path.splitext(src)[1]
    piz_pipeline.piz_file(refz, src + ".o1" + ext, password=PW)
    ref_piz.piz_file(port, src + ".o2" + ext, password=PW)
    piz_pipeline.piz_file(port, src + ".o3" + ext, password=PW)
    for i in (1, 2, 3):
        assert _read(src + f".o{i}{ext}") == _read(src), f"decode {i}"
    return port


@pytest.mark.parametrize("make", [_fastq, _sam, _vcf, _bam],
                         ids=["fastq", "sam_gencomp", "vcf", "bam"])
def test_encrypted_archive_equals_reference(host_reference, fixed_salt,
                                            tmp_path, make):
    src = make(tmp_path)
    port = zip_both_encrypted(src, use_md5=True)
    pr = piz_pipeline.PizReader(port, password=PW)
    h = pr.file_hdr
    pr.close()
    assert h["enc"] == {"salt": SALT.hex(),
                        "tag": crypt.key_tag(crypt.derive_key(PW, SALT))}
    assert h["md5"] and len(h["md5"]) == 32
    if make is _sam:
        assert h["gencomp"] and h["ref_internal"]


def test_dp_password_equals_plain_and_reference(host_reference, fixed_salt,
                                                tmp_path):
    """`zip --dp 4 --password` (zip_file(dp=4) on four CPU devices) with
    the salt fixed writes the port's plain encrypted archive's bytes and
    genozip_tpu's zip_file(dp=8) ones; both packages decode it."""
    src = _fastq(tmp_path)
    plain, dp, refz = (src + s for s in (".plain.gxz", ".dp.gxz", ".ref.gxz"))
    zip_pipeline.zip_file(src, plain, password=PW, vb_size=64 << 10)
    zip_pipeline.zip_file(src, dp, password=PW, vb_size=64 << 10, dp=4)
    ref_zip.zip_file(src, refz, password=PW, vb_size=64 << 10, dp=8)
    assert _read(dp) == _read(plain) == _read(refz)
    piz_pipeline.piz_file(dp, src + ".o1", password=PW)
    ref_piz.piz_file(dp, src + ".o2", password=PW)
    assert _read(src + ".o1") == _read(src + ".o2") == _read(src)


def test_wrong_and_missing_password(host_reference, tmp_path):
    src = _fastq(tmp_path)
    z = src + ".gxz"
    zip_pipeline.zip_file(src, z, password=PW)
    for pw, msg in (("wrong", "wrong password"),
                    (None, "archive is encrypted — --password required")):
        with pytest.raises(AssertionError, match=msg):
            ref_piz.piz_file(z, None, password=pw)
        with pytest.raises(ValueError, match=msg):
            piz_pipeline.piz_file(z, None, password=pw)
        argv = ["unzip", z, "--test", "--device", "cpu"]
        with pytest.raises(ValueError, match=msg):
            cli.main(argv + (["--password", pw] if pw else []))
    # a section read without the key, as `ls --stats` would
    with pytest.raises(ValueError, match="is encrypted"):
        cli.main(["ls", z, "--stats"])
    cli.main(["unzip", z, "--test", "--password", PW, "--device", "cpu"])


def test_no_plaintext_in_archive(host_reference, tmp_path):
    """genozip_tpu's test_codecs.py encryption case, on the port."""
    data = b"".join(b"@r%d\nACGTACGTAC\n+\nFFFF:FFFFF\n" % i
                    for i in range(500))
    src = tmp_path / "e.fastq"
    src.write_bytes(data)
    z = str(src) + ".gxz"
    zip_pipeline.zip_file(str(src), z, password=PW)
    piz_pipeline.piz_file(z, str(src) + ".out", password=PW)
    assert _read(str(src) + ".out") == data
    zb = _read(z)
    assert b"ACGTACGTAC" not in zb and b"FFFF:FFFFF" not in zb


def _cat_args(z, **kw):
    base = dict(input=z, reference=None, password=PW, head=None, tail=None,
                grep=None, downsample=None, regions=None, no_header=False,
                header_only=False, seq_only=False, qual_only=False,
                one_vb=None, r1=False, r2=False, interleave=False,
                bases=None, count=False, lines=None, qnames=None)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("route", ["plain", "sam"])
def test_cat_password(host_reference, fixed_salt, tmp_path, route,
                      capsysbinary):
    """cat --password on the plain route (a SAM archive, --head) and the
    --sam route (a BAM archive) equals genozip_tpu's cat. genozip_tpu's
    plain route drops the password (fault F15), so there its cat of the
    same input's unencrypted archive is the reference."""
    src = _sam(tmp_path) if route == "plain" else _bam(tmp_path)
    z = src + ".gxz"
    zip_pipeline.zip_file(src, z, password=PW)
    ref = io.BytesIO()
    if route == "plain":
        with pytest.raises(AssertionError, match="--password required"):
            ref_filters.cat_filtered(_cat_args(z, head=50), io.BytesIO())
        ref_zip.zip_file(src, src + ".plain.gxz")
        ref_filters.cat_filtered(_cat_args(src + ".plain.gxz", head=50), ref)
        argv = ["--head", "50"]
    else:
        ref_filters.cat_translated_sam(_cat_args(z), ref)
        argv = ["--sam"]
    cli.main(["cat", z, "--password", PW, "--device", "cpu"] + argv)
    got = capsysbinary.readouterr().out
    assert got == ref.getvalue() and got.count(b"\n") >= 50
    with pytest.raises(ValueError, match="wrong password"):
        cli.main(["cat", z, "--password", "x", "--device", "cpu"] + argv)


@pytest.mark.cuda
def test_aes_kernel_equals_plain_on_the_card():
    """At every size and carrying counter, and at sizes past one pass of the
    persistent grid (its blocks cover about 3 MiB at once on an H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(11)
    key = rng.integers(0, 256, 32, np.uint8).tobytes()
    for n in SIZES + (3 << 20, (8 << 20) + 5, 64 << 20):
        data = rng.integers(0, 256, n, np.uint8).tobytes()
        for c0 in COUNTERS.values():
            before = aes_cuda.launches["aes256_ctr"]
            got = aes_cuda.aes256_ctr(key, c0, data, "cuda")
            assert got == aes_cuda.aes256_ctr(key, c0, data, "cpu")
            assert aes_cuda.launches["aes256_ctr"] == before + (n > 0)
