"""genozip_tpu_torch decodes archives that genozip_tpu wrote with its
device rANS path on.

genozip_tpu's device path (`codecs.enable_device_rans`) codes the payloads
of its size threshold and up on its own lane counts and pads the nested
SEQ and QUAL streams to a whole number of lane steps (fault F2): the
archive bytes differ from the host path's, which the port writes. The port must still read them, on its host
route and through its kernels' plain versions (`--device cpu`). The
reference runs its device path in JAX on the CPU, with batching off, so each
payload goes through the single-stream coder; its C++ runtime stays off."""

import pytest

from genozip_tpu import codecs as ref_codecs
from genozip_tpu import native as ref_native
from genozip_tpu import zip_pipeline as ref_zip
from genozip_tpu_torch import cli, codecs, piz_pipeline, synth
from genozip_tpu_torch.format import sections as fmt


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def device_archive(tmp_path_factory):
    """A small cfg3 FASTQ and genozip_tpu's device-path archive of it (and
    its host-path archive, which differs)."""
    d = tmp_path_factory.mktemp("devarch")
    fq = str(d / "r.fastq")
    synth.write_fastq(fq, 600 << 10, seed=21, block=1000)
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_native, "available", lambda: False)
    mp.delenv("GXZ_DEVICE_RANS", raising=False)
    try:
        ref_codecs.enable_device_rans(min_size=64 * 1024, batch=False)
        ref_zip.zip_file(fq, str(d / "dev.gxz"), vb_size=256 << 10)
        ref_codecs.disable_device_rans()
        ref_zip.zip_file(fq, str(d / "host.gxz"), vb_size=256 << 10)
    finally:
        ref_codecs.disable_device_rans()
        mp.undo()
    assert _read(d / "dev.gxz") != _read(d / "host.gxz")
    return d, fq


def _sections(path):
    """{(type, vb, dict id): (codec, uncompressed length, payload)}."""
    out = {}
    with open(path, "rb") as f:
        zr = fmt.ZReader(f)
        for ent in zr.sections():
            comp, meta = zr.read_section_raw(ent)
            out[(ent.sec_type, ent.vb_i, ent.dict_id)] = \
                (meta["codec"], meta["uncomp_len"], comp)
    return out


def test_device_archive_differs_from_host_archive(device_archive):
    """The archive carries what the port must read: a section coded by the
    same codec as on the host path, with other bytes (the padded nested
    QUAL stream inside PACK1)."""
    d, _ = device_archive
    dev, host = _sections(d / "dev.gxz"), _sections(d / "host.gxz")
    same_codec_other_bytes = [
        k for k, (c, n, z) in dev.items()
        if k in host and host[k][:2] == (c, n) and host[k][2] != z]
    assert same_codec_other_bytes
    assert any(dev[k][0] == codecs.PACK1 for k in same_codec_other_bytes)


@pytest.mark.parametrize("route", ["host", "cpu"])
def test_port_decodes_device_archive(device_archive, route, tmp_path):
    """The host route (no device rANS) and the kernels' plain versions on
    the CPU (`unzip --device cpu`) give back the input."""
    d, fq = device_archive
    out = str(tmp_path / "o")
    if route == "host":
        codecs.disable_device_rans()
        piz_pipeline.piz_file(str(d / "dev.gxz"), out)
    else:
        try:
            cli.main(["unzip", str(d / "dev.gxz"), "-o", out, "--device",
                      "cpu"])
        finally:
            codecs.disable_device_rans()
    assert _read(out) == _read(fq)
