"""genozip_tpu_torch codecs against genozip_tpu's, byte for byte.

The port's rANS device threshold is lowered to 16 KiB on the CPU, so its
payloads and their nested streams (ACGT's packed SEQ, PACK's packed QUAL,
DOMQ's and RLE's sub-streams) go through the kernels' plain PyTorch versions;
the reference codes them on the host with its device path off and on its
numpy host path (`genozip_tpu.native.available` patched to False), as the
port does everywhere."""

import numpy as np
import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import native as ref_native
from genozip_tpu_torch import codecs
from genozip_tpu_torch.ops import rans_torch
from genozip_tpu_torch.synth import qual_rows

C = codecs
# codecs whose payloads here reach the device route (rANS >= 16 KiB)
DEVICE_ROUTED = {C.RANS0, C.RANS1, C.PACK0, C.PACK1, C.ACGT, C.DELTA_RANS,
                 C.DOMQ, C.STRIPE4}


@pytest.fixture(autouse=True)
def device_route(monkeypatch):
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    yield
    codecs.disable_device_rans()


def _payload(kind: str) -> bytes:
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "qual":          # 4-bin Illumina quality
        return qual_rows(rng, 800, 150).tobytes()
    if kind == "qual_dom":      # one dominant score (DOMQ candidate)
        q = np.full(60000, ord("F"), np.uint8)
        hit = rng.random(60000) < 0.1
        q[hit] = rng.choice(np.frombuffer(b"#,:", np.uint8), int(hit.sum()))
        return q.tobytes()
    if kind == "seq":           # DNA with a few N
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), 80000)
        s[rng.integers(0, 80000, 40)] = ord("N")
        return s.tobytes()
    if kind == "ints":          # u32 array (lengths, deltas)
        return rng.integers(0, 5000, 30000).astype("<u4").tobytes()
    if kind == "runs":          # long runs (RLE)
        return np.repeat(rng.integers(0, 4, 3000).astype(np.uint8),
                         rng.integers(1, 60, 3000)).tobytes()
    return b"".join(b"@SRR8861483.%d %d length=150\n" % (i, i)
                    for i in range(2000))   # text


CASES = [(C.NONE, "text"), (C.RANS0, "qual"), (C.RANS1, "qual"),
         (C.RANS0, "text"), (C.RANS1, "ints"), (C.PACK0, "qual"),
         (C.PACK1, "qual"), (C.PACK1, "seq"), (C.ACGT, "seq"),
         (C.ACGT_LZ, "seq"), (C.DELTA_RANS, "ints"), (C.RLE0, "runs"),
         (C.DOMQ, "qual_dom"), (C.STRIPE4, "ints"), (C.ZLIB, "text"),
         (C.BZ2, "text"), (C.LZMA, "text"), (C.ARITH0, "qual"),
         (C.ARITH1, "qual")]


@pytest.mark.parametrize("codec,kind", CASES,
                         ids=[f"{C.NAMES[c]}-{k}" for c, k in CASES])
def test_compress_equals_reference(codec, kind, monkeypatch):
    calls = []
    for fn in ("encode_plain", "decode_plain"):
        orig = getattr(rans_torch, fn)
        monkeypatch.setattr(rans_torch, fn, lambda *a, _f=orig, _n=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    data = _payload(kind)
    blob = codecs.compress(data, codec)
    assert blob == ref_codecs.compress(data, codec)
    assert codecs.decompress(blob, codec, len(data)) == data
    assert ref_codecs.decompress(blob, codec, len(data)) == data
    if codec in DEVICE_ROUTED:
        assert "encode_plain" in calls and "decode_plain" in calls


@pytest.mark.parametrize("order", [0, 1])
def test_batched_sections_equal_host_streams(order):
    """compress_many_rans (one launch for a VB's sections, any R) writes
    the host coder's bytes, and decompress_many_rans inverts it."""
    datas = [_payload(k) for k in ("qual", "text", "ints")]
    blobs = codecs.compress_many_rans(datas, order)
    codec = C.RANS0 if order == 0 else C.RANS1
    assert blobs == [ref_codecs.compress(d, codec) for d in datas]
    assert codecs.decompress_many_rans(blobs) == datas


def test_codec_assignment_matches_reference():
    from genozip_tpu.codecs import assign as ref_assign
    from genozip_tpu_torch.codecs import assign
    for kind, cat in (("qual", "qual"), ("seq", "seq"), ("ints", "int"),
                      ("text", "text")):
        data = _payload(kind)
        assert assign.assign_best(data, cat) == ref_assign.assign_best(data, cat)


def test_device_cuda_without_gpu_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        codecs.enable_device_rans("cuda")


def test_not_ported_codec_raises():
    """Every codec of genozip_tpu is ported (BWT too, its bytes
    equal to genozip_tpu's); a codec id that neither package knows raises."""
    data = _payload("text")
    assert codecs.compress(data, C.BWT) == ref_codecs.compress(data, C.BWT)
    for fn in (lambda: codecs.compress(b"x" * 100, 99),
               lambda: codecs.decompress(b"x", 99, 1)):
        with pytest.raises(ValueError, match="unknown codec 99"):
            fn()
