"""Codec auto-assignment: trial-compress a sample with candidates, commit the
winner per context so later VBs inherit it.

Counterpart of genozip_tpu/codecs/assign.py, unchanged in behaviour so both
packages pick the same codecs. Reference parity: src/codec.c:175-349
codec_assign_best_codec —
CODEC_ASSIGN_SAMPLE_SIZE trial over {NONE, RANS*, ARITH*, BZ2, BSC, LZMA} with
a (size, time) sort and similarity tie-break; winners committed to the global
context under a mutex. Here assignment runs on the first VB that carries the
context (deterministic: VBs are merged in VB order) and is cached in the
ZIP-side global context state.
"""



import numpy as np

from . import (NONE, RANS0, RANS1, PACK0, PACK1, ZLIB, BZ2, LZMA, ACGT,
               ACGT_LZ, DELTA_RANS, RLE0, DOMQ, STRIPE4, ARITH0, ARITH1,
               DeviceKernelError, compress)

SAMPLE_SIZE = 64 * 1024
MIN_SIZE_TO_COMPRESS = 64

# 'fast' trims trial candidates (reference --fast), 'best' widens them and
# samples more (reference --best, codec.c:196 5-VB agreement analog)
_mode = "normal"


def set_mode(mode: str):
    global _mode
    assert mode in ("fast", "normal", "best")
    _mode = mode


def get_mode() -> str:
    return _mode


def candidates_for(data: np.ndarray, category: str):
    """Candidate codec list by payload category ('seq', 'qual', 'b250',
    'int', 'text')."""
    nuniq = None
    if data.shape[0]:
        nuniq = np.unique(data[:4096]).shape[0]
    cands = [RANS0, RANS1]
    if category == "seq":
        # LZMA only in 'best': the reference's own ACGT verdict
        # (codec_acgt.c:15 "25X faster than LZMA, slightly better ratio").
        # ACGT_LZ rides in normal mode: on repeat-family genomes LZ
        # matches in the packed domain buy ~25% the entropy stage can't
        # see; the speed-penalty model gates it on non-repetitive seq
        cands = [ACGT, ACGT_LZ, RANS1] if _mode != "best" \
            else [ACGT, ACGT_LZ, RANS1, LZMA]
    elif category == "qual":
        cands = [RANS1, ARITH1, RANS0]
        if nuniq is not None and nuniq <= 16:
            cands = [PACK1, RANS1, ARITH1, RANS0]
        if data.shape[0]:
            counts = np.bincount(data[:4096], minlength=256)
            if counts.max() > 0.7 * min(data.shape[0], 4096):
                cands = [DOMQ] + cands
    elif category == "b250":
        cands = [RANS0, ARITH0, RANS1, ZLIB]
    elif category == "int":
        cands = [RANS0, RANS1, DELTA_RANS, STRIPE4, ZLIB]
    elif category == "float":
        cands = [STRIPE4, RANS1, ZLIB]
    elif category == "text":
        cands = [RANS1, ARITH1, ZLIB, BZ2, LZMA]
    elif category == "pbwt":
        # PBWT output is long runs: RLE first, entropy coders as backstop
        cands = [RLE0, RANS1, PACK1, RANS0]
    if _mode == "fast":
        cands = [c for c in cands
                 if c not in (BZ2, LZMA, ACGT_LZ)][:2] or cands[:1]
    elif _mode == "best":
        from . import BWT
        for extra in (BZ2, LZMA, ZLIB, BWT):
            if extra not in cands:
                cands.append(extra)
    return cands


def _strided_sample(a: np.ndarray, size: int) -> bytes:
    """Representative sample: evenly-spaced chunks across the WHOLE payload.
    A head sample misleads on demuxed/grouped streams (e.g. channel-sorted
    QUAL), where the head is one channel's distribution."""
    if a.shape[0] <= size:
        return a.tobytes()
    k = 16
    chunk = size // k
    step = (a.shape[0] - chunk) // max(k - 1, 1)
    return b"".join(a[i * step:i * step + chunk].tobytes() for i in range(k))


# Deterministic effective speed model (MB/s), the same constants as
# genozip_tpu's so both packages pick the same codecs. They are model
# inputs, not measurements of this port. Measured wall time here would make
# codec choice depend
# on host load — breaking the by-construction determinism the dp-sharded
# byte-identity guarantee rests on (host merge == collective merge). The
# reference measures real time (codec.c:175-349) and accepts the
# nondeterminism; we trade exact reference behavior for reproducibility.
SPEED_MBPS = {NONE: 20000.0, RANS0: 140.0, RANS1: 90.0, PACK0: 300.0,
              PACK1: 250.0, ZLIB: 60.0, BZ2: 14.0,
              LZMA: 2.0, ACGT: 200.0, ACGT_LZ: 15.0,
              DELTA_RANS: 130.0, RLE0: 200.0, DOMQ: 130.0, STRIPE4: 80.0,
              ARITH0: 32.0, ARITH1: 18.0}


def _model_time(codec: int, nbytes: int) -> float:
    from . import BWT
    speed = SPEED_MBPS.get(codec, 10.0 if codec == BWT else 50.0)
    return nbytes / (speed * 1e6)


def _trial(a: np.ndarray, sample: bytes, codec: int, two_point: bool):
    """Compress the sample; cost = deterministic modeled time (see
    SPEED_MBPS). Returns (est_full_size, modeled_seconds)."""
    blob = compress(sample, codec)
    sz = len(blob)
    dt = _model_time(codec, len(sample))
    n1 = len(sample) // 4
    if two_point and n1 >= 4096:
        # extrapolate the marginal (per-byte) rate: fixed costs (static rANS
        # tables, headers) bias a small sample toward adaptive coders whose
        # advantage vanishes at full size
        sz1 = len(compress(sample[:n1], codec))
        rate = max(sz - sz1, 0) / (len(sample) - n1)
        est = sz + rate * (a.shape[0] - len(sample))
    else:
        est = sz * (a.shape[0] / max(len(sample), 1))
    return est, dt


def _pick(scored, payload_n: float):
    """(size, time) similarity rule (src/codec.c:171-172): a similar-speed
    candidate wins at >1% smaller; a slower one must earn its wall time in
    proportion — a q-times-slower coder on the write critical path needs ~2%
    extra ratio per doubling (MB/s is the headline metric; in 'best' mode
    ratio wins at the reference's flat 5%)."""
    best, best_size, best_t = NONE, payload_n, 0.0
    for codec, est, dt in scored:
        if best is not NONE and dt > best_t * 1.5 + 5e-4:
            if _mode == "best":
                need = 0.95
            else:
                # MB/s is the headline metric: ~5% extra ratio per speed
                # doubling, so an LZMA-class (20-30x slower) coder must
                # win by >25% to displace a SIMD coder on the hot path
                q = dt / max(best_t, 1e-5)
                need = max(0.60, 1.0 - 0.03 - 0.05 * min(np.log2(q), 6.0))
        else:
            need = 0.99
        if est < best_size * need:
            best, best_size, best_t = codec, est, dt
    return best


def assign_best(data: bytes | np.ndarray, category: str = "text") -> int:
    a = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else data.view(np.uint8).reshape(-1)
    if a.shape[0] < MIN_SIZE_TO_COMPRESS:
        return NONE
    size = SAMPLE_SIZE * (4 if _mode == "best" else 1)
    sample = _strided_sample(a, size)
    scored = []
    for codec in candidates_for(a, category):
        try:
            est, dt = _trial(a, sample, codec, a.shape[0] > 4 * len(sample))
        except DeviceKernelError:
            raise           # a broken card is not a codec rejection
        except Exception:
            continue
        scored.append((codec, est, dt))
    # runoff: small-sample estimates misrank codecs whose strength is
    # context depth (e.g. PACK+order-1 = order-4 on 2-bit data needs data to
    # learn) — re-trial the near-tied candidates on a 1MB strided sample.
    # Runs once per context per file (first-sight commit).
    if a.shape[0] > (256 << 10) and len(scored) > 1 and _mode != "fast":
        floor = min(est for _, est, _ in scored)
        finalists = [c for c, est, _ in scored if est <= floor * 1.3]
        if len(finalists) > 1:
            big = _strided_sample(a, 1 << 20)
            scored = []
            for codec in finalists:
                try:
                    est, dt = _trial(a, big, codec, False)
                except DeviceKernelError:
                    raise
                except Exception:
                    continue
                scored.append((codec, est, dt))
    return _pick(scored, float(a.shape[0]))
