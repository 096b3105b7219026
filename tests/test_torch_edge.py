"""genozip_tpu's edge-case battery and archive fuzz against the port, whose
host work goes through its C++ host runtime (genozip_tpu_torch/native).

The inputs are those of tests/test_edge_cases.py (its CASES, the random
tabular junk, the long reads, the garbage through each datatype) and
tests/test_fastq_desc.py, imported from those files, which stay as they
are. Each is zipped by both packages: the archives are the same bytes and
each package decodes the other's back to the input, or both refuse the
input. The fuzz of tests/test_fuzz_archive.py is repeated on the port's
archive (the same bytes as genozip_tpu's): bit flips in every section type
and truncations must make the port's unzip fail or give the input back,
never other bytes; a flip in a payload the port reads (B250, LOCAL, DICT)
must fail. genozip_tpu runs on its numpy host path with its device path
off; the port's rANS kernels take their plain PyTorch route from 16 KiB."""

import os

import numpy as np
import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import native as ref_native
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu_torch import codecs, piz_pipeline, zip_pipeline
from genozip_tpu_torch.format import sections as fmt
from tests.test_edge_cases import CASES
from tests.test_fastq_desc import make_len_fastq, make_saux_fastq
from tests.test_fuzz_archive import _mk_archive
from tests.test_torch_sam import zip_both


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def host_reference(monkeypatch):
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    monkeypatch.setenv("GXZ_NO_REF_CACHE", "1")
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    codecs.enable_device_rans("cpu", min_size=16 << 10)
    yield
    codecs.disable_device_rans()


def _dt_of(name):
    if name.endswith(".bin"):
        return "generic"
    if name.endswith(".me23"):
        return "me23"
    return None


def _both(tmp_path, name, data, dt_name=None, vb_size=1 << 20):
    src = str(tmp_path / name)
    with open(src, "wb") as f:
        f.write(data)
    kw = {"dt_name": dt_name} if dt_name else {}
    return zip_both(src, vb_size, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_edge_case_equals_reference(tmp_path, name):
    _both(tmp_path, name, CASES[name], _dt_of(name))


def _junk_rows(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(300):
        nf = int(rng.integers(1, 12))
        fields = [bytes(rng.integers(32, 127, rng.integers(0, 20))
                        .astype(np.uint8)).replace(b"\t", b" ")
                  .replace(b"\n", b" ") for _ in range(nf)]
        rows.append(b"\t".join(fields))
    return b"\n".join(rows) + b"\n"


@pytest.mark.parametrize("dt", ["vcf", "bed", "gff"])
def test_random_tabular_junk_equals_reference(tmp_path, dt):
    _both(tmp_path, f"junk.{dt}", _junk_rows(31337), dt_name=dt)


def test_long_reads_equal_reference(tmp_path):
    rng = np.random.default_rng(31337)
    out = []
    for i in range(30):
        L = int(rng.integers(5000, 20000))
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), L)
        qual = rng.integers(33, 90, L).astype(np.uint8)
        out.append(b"@nanopore_%d ch=%d\n" % (i, i % 4) + seq.tobytes()
                   + b"\n+\n" + qual.tobytes() + b"\n")
    _both(tmp_path, "long.fastq", b"".join(out))


@pytest.mark.parametrize("name", ["saux", "saux_dual", "len"])
def test_fastq_desc_inputs_equal_reference(tmp_path, name):
    data = {"saux": lambda: make_saux_fastq(),
            "saux_dual": lambda: make_saux_fastq(dual=True),
            "len": lambda: make_len_fastq()}[name]()
    _both(tmp_path, name + ".fastq", data, vb_size=64 << 10)


@pytest.mark.parametrize("dt", ["vcf", "sam", "gff", "bed", "fastq",
                                "fasta", "generic"])
def test_garbage_input_equals_reference_or_both_refuse(tmp_path, dt):
    rng = np.random.default_rng(sum(dt.encode()))
    raw = rng.integers(32, 127, 60000).astype(np.uint8)
    raw[rng.integers(0, raw.shape[0], 1500)] = ord("\n")
    raw[rng.integers(0, raw.shape[0], 800)] = ord("\t")
    src = str(tmp_path / f"g.{dt}.txt")
    with open(src, "wb") as f:
        f.write(raw.tobytes())
    errors = []
    for mod, out in ((zip_pipeline, src + ".p.gxz"),
                     (ref_zip, src + ".r.gxz")):
        try:
            mod.zip_file(src, out, dt_name=dt, vb_size=16 << 10)
            errors.append(None)
        except Exception as e:          # a clean refusal
            errors.append(str(e))
    assert errors[0] == errors[1]
    if errors[0] is None:
        assert _read(src + ".p.gxz") == _read(src + ".r.gxz")
        piz_pipeline.piz_file(src + ".p.gxz", src + ".out")
        assert _read(src + ".out") == raw.tobytes()


# ---------------------------------------------------------------------------
# archive fuzz (tests/test_fuzz_archive.py on the port)
# ---------------------------------------------------------------------------

def _port_archive(tmp_path, kind):
    """_mk_archive's input zipped by the port; it equals genozip_tpu's."""
    src, z, data = _mk_archive(tmp_path, kind)
    pz = src + ".port.gxz"
    zip_pipeline.zip_file(src, pz, vb_size=64 * 1024)
    assert _read(pz) == _read(z)
    return pz, data


def _outcome(z, expect):
    """'ok' (the input back), 'error' (an exception) or 'WRONG'."""
    out = z + ".fuzz_out"
    try:
        piz_pipeline.piz_file(z, out)
    except Exception:
        return "error"
    return "ok" if _read(out) == expect else "WRONG"


@pytest.mark.parametrize("kind", ["fastq", "sam"])
def test_bitflips_in_every_section_type_fail_or_round_trip(tmp_path, kind):
    z, expect = _port_archive(tmp_path, kind)
    blob = bytearray(_read(z))
    with open(z, "rb") as f:
        index = fmt.ZReader(f).index
    by_type = {}
    for e in index:
        by_type.setdefault(e.sec_type, []).append(e)
    offs = sorted(e.offset for e in index)
    end_of = {o: (offs[i + 1] if i + 1 < len(offs) else len(blob))
              for i, o in enumerate(offs)}
    outcomes = {}
    for st, ents in by_type.items():
        for e in ents[:2]:
            lo, hi = e.offset, end_of[e.offset]
            spots = [lo + 8, lo + 50]
            if hi - lo > fmt.HDR_SIZE:
                pay = hi - lo - fmt.HDR_SIZE
                spots += [lo + fmt.HDR_SIZE + pay // 10,
                          lo + fmt.HDR_SIZE + (6 * pay) // 10]
            for at in spots:
                if at >= len(blob):
                    continue
                mut = bytearray(blob)
                mut[at] ^= 0x40
                zf = str(tmp_path / "mut.gxz")
                with open(zf, "wb") as f:
                    f.write(bytes(mut))
                outcomes[(st, e.offset, at)] = _outcome(zf, expect)
    assert "WRONG" not in outcomes.values(), outcomes
    consumed = {fmt.SEC_B250, fmt.SEC_LOCAL, fmt.SEC_DICT}
    payload = [v for (st, off, at), v in outcomes.items()
               if st in consumed and at - off >= fmt.HDR_SIZE]
    assert payload and all(v == "error" for v in payload), outcomes


@pytest.mark.parametrize("kind", ["fastq", "sam"])
def test_truncations_fail(tmp_path, kind):
    z, expect = _port_archive(tmp_path, kind)
    blob = _read(z)
    for frac in (0.2, 0.5, 0.9, 0.999):
        zf = str(tmp_path / "trunc.gxz")
        with open(zf, "wb") as f:
            f.write(blob[:int(len(blob) * frac)])
        assert _outcome(zf, expect) == "error", frac


@pytest.mark.parametrize("kind", ["fastq", "sam"])
def test_reference_decodes_the_ports_archive(tmp_path, kind):
    z, expect = _port_archive(tmp_path, kind)
    ref_piz.piz_file(z, z + ".out")
    assert _read(z + ".out") == expect
    assert os.path.getsize(z) < len(expect)
