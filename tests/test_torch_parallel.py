"""The multi-device slice of genozip_tpu_torch against genozip_tpu:
`zip --dp` (ShardedZipEncoder), `piz_file_dp` (ShardedPizDecoder), the
collective dict merge, `zip --mesh` (the seed aligner's plain version),
`zip --hosts` (torch.distributed gloo workers) and the flagship step.

The port runs on D CPU devices (the kernels' plain versions): its zip
paths after `codecs.enable_device_rans("cpu")`, its classes on
`devices=["cpu"] * D`. The reference runs on the 8 virtual CPU devices of
tests/conftest.py with its device rANS path off and on its numpy host
path. Every comparison is exact:
these are integer paths and archive bytes. Faults F16 (the sharded
aligner's doubled mismatch count near a slab boundary), F17 (options
dropped without a word) and F5 (multi-host SAM without gencomp, the
scratch directory left behind) are shown and not copied."""

import gzip
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genozip_tpu import native as ref_native
from genozip_tpu import codecs as ref_codecs
from genozip_tpu import piz_pipeline as ref_piz, zip_pipeline as ref_zip
from genozip_tpu.ops import pack as ref_pack, rans_np as ref_rans_np
from genozip_tpu.parallel import aligner_sharded as ref_as
from genozip_tpu.parallel import flagship as ref_flagship
from genozip_tpu.parallel import mesh_aligner as ref_mesh
from genozip_tpu.parallel import zip_sharded as ref_zs
from genozip_tpu.ref import refstore as ref_refstore
from genozip_tpu_torch import cli, codecs, piz_pipeline, synth, zip_pipeline
from genozip_tpu_torch.ops import align_cuda, align_torch, rans_np
from genozip_tpu_torch.parallel import aligner_sharded, flagship, multihost
from genozip_tpu_torch.parallel import zip_sharded
from genozip_tpu_torch.parallel.mesh_aligner import MeshAligner
from genozip_tpu_torch.parallel.piz_sharded import ShardedPizDecoder, piz_file_dp
from genozip_tpu_torch.ref import refstore
from tests.test_aligner import sample_reads, synth_genome

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VB = 256 << 10


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture
def reference_host_path(monkeypatch):
    """genozip_tpu with its device rANS path off, on its numpy host path."""
    monkeypatch.setenv("GXZ_DEVICE_RANS", "0")
    monkeypatch.setenv("GXZ_NO_REF_CACHE", "1")
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_codecs.disable_device_rans()
    yield
    ref_codecs.disable_device_rans()


@pytest.fixture
def port_on_cpu():
    """The port's kernels on the CPU (their plain versions), so that its
    multi-device paths run on N CPU devices."""
    codecs.enable_device_rans("cpu")
    yield
    codecs.disable_device_rans()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A small cfg3-shaped FASTQ, a gencomp SAM, a genome with its
    .ref.gxz and reads off it."""
    d = tmp_path_factory.mktemp("par")
    # VB 1 takes the first MiB (the calibration peek), so the FASTQ and
    # SAM are larger than that: several VBs, and the SAM's gencomp
    synth.write_fastq(str(d / "r.fastq"), 2560 << 10, seed=11, block=1000)
    synth.write_sam(str(d / "a.sam"), 1536 << 10, seed=4, genome_len=1 << 20,
                    window_reads=1500)
    g = synth.genome(np.random.default_rng(9), 300 << 10)
    synth.write_fasta(str(d / "g.fa"), g)
    # under one k-mer a slot: the mesh aligner reads refhash layer 0 only
    refstore.make_reference(str(d / "g.fa"), str(d / "g.ref.gxz"),
                            hash_bits=20)
    synth.write_paired_fastq(str(d / "m.fastq"), str(d / "m2.fastq"), g,
                             300 << 10, seed=12, block=1000)
    # BGZF BAM and gzip FASTQ sources (fault F18's inputs)
    synth.write_bam(str(d / "a.bam"), 1536 << 10, seed=4,
                    genome_len=1 << 20, window_reads=1500)
    with open(d / "r.fastq", "rb") as f, \
            gzip.open(d / "r.fastq.gz", "wb", compresslevel=6) as gz:
        gz.write(f.read())
    return d


# --- zip --dp ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["r.fastq", "a.sam"])
def test_dp_archive_equals_zip_file_and_reference(inputs, name, tmp_path,
                                                  reference_host_path):
    """zip_file(dp=D) on D CPU devices writes zip_file's bytes at D = 1, 2
    and 8, and genozip_tpu's zip_file(dp=8) bytes (its dp=8 on the 8
    virtual devices); both packages unzip it."""
    src = str(inputs / name)
    zip_pipeline.zip_file(src, str(tmp_path / "plain.gxz"), vb_size=VB)
    plain = _read(tmp_path / "plain.gxz")
    codecs.enable_device_rans("cpu")
    try:
        for D in (1, 2, 8):
            z = str(tmp_path / f"dp{D}.gxz")
            zip_pipeline.zip_file(src, z, vb_size=VB, dp=D)
            assert _read(z) == plain, f"dp={D}"
    finally:
        codecs.disable_device_rans()
    ref_zip.zip_file(src, str(tmp_path / "ref.gxz"), vb_size=VB, dp=8)
    assert _read(tmp_path / "ref.gxz") == plain
    piz_pipeline.piz_file(str(tmp_path / "dp8.gxz"), str(tmp_path / "o1"))
    ref_piz.piz_file(str(tmp_path / "dp8.gxz"), str(tmp_path / "o2"))
    assert _read(tmp_path / "o1") == _read(src) == _read(tmp_path / "o2")


def test_dp_batches_vbs_over_devices(inputs, tmp_path, monkeypatch,
                                    port_on_cpu):
    """Under dp, built VBs are flushed D at a time, in VB order, with the
    streams of one sharded encode of the batch, whose eligible sections go
    to encode_many on the devices; without dp, a batch is one VB. Few
    sections of these small VBs reach 4 KiB without a stream compressed
    already, so eligibility is lowered to 64 bytes here; the archives
    still equal zip_file's."""
    from genozip_tpu_torch.ops import rans_cuda
    monkeypatch.setattr(zip_sharded.ShardedZipEncoder, "eligible",
                        lambda self, n: n >= 64)
    calls, batches = [], []
    orig = rans_cuda.encode_many
    monkeypatch.setattr(rans_cuda, "encode_many", lambda d, o, dev, n=None:
                        calls.append((len(d), o, str(dev))) or
                        orig(d, o, dev, n))
    orig_batch = zip_pipeline.ZipJob.flush_batch
    monkeypatch.setattr(zip_pipeline.ZipJob, "flush_batch",
                        lambda self, b: batches.append(
                            [x["vb_i"] for x in b]) or orig_batch(self, b))
    stats = zip_pipeline.zip_file(str(inputs / "r.fastq"),
                                  str(tmp_path / "z.gxz"), vb_size=VB, dp=3)
    n = stats.num_vbs
    assert n >= 4
    assert [v for b in batches for v in b] == list(range(1, n + 1))
    assert [len(b) for b in batches] == [3] * (n // 3) + [n % 3] * (n % 3 > 0)
    assert calls and {c[2] for c in calls} == {"cpu"}
    batches.clear()
    zip_pipeline.zip_file(str(inputs / "r.fastq"), str(tmp_path / "p.gxz"),
                          vb_size=VB)
    assert batches == [[i] for i in range(1, n + 1)]
    assert _read(tmp_path / "z.gxz") == _read(tmp_path / "p.gxz")


def _streams(rng):
    datas, items = [], []
    for n, order in ((0, 0), (100, 0), (5000, 1), (20000, 0), (70001, 1),
                     (4096, 0), (4095, 1), (65536, 0), (30000, 1)):
        d = rng.choice(np.frombuffer(b"FFFF:F,#ABx", np.uint8), n).tobytes()
        datas.append(d)
        items.append((d, order))
    return datas, items


@pytest.mark.parametrize("D", [1, 3, 8])
def test_sharded_encoder_and_decoder_equal_rans_np(D):
    """ShardedZipEncoder and ShardedPizDecoder on D CPU devices: each
    stream equals rans_np.encode, each payload comes back; mixed sizes,
    both orders, streams under min_size and an empty one."""
    datas, items = _streams(np.random.default_rng(D))
    enc = zip_sharded.ShardedZipEncoder(D, devices=["cpu"] * D)
    assert enc.D == D and enc.eligible(4096) and not enc.eligible(4095)
    blobs = enc.encode_sections(items)
    assert blobs == [rans_np.encode(d, o) for d, o in items]
    assert blobs == [ref_rans_np.encode(d, o) for d, o in items]
    dec = ShardedPizDecoder(D, min_size=1024, devices=["cpu"] * D)
    assert dec.decode_sections(blobs) == datas


# --- piz_file_dp --------------------------------------------------------------

@pytest.mark.parametrize("name", ["r.fastq", "a.sam", "a.bam", "r.fastq.gz"])
def test_piz_file_dp_equals_piz_file(inputs, name, tmp_path):
    """piz_file_dp writes piz_file's bytes, to a file named as the source
    (the BGZF BAM's BGZF-exact, the source itself; the gzip FASTQ's the
    same text) and in memory (the text); fault F18: the port does not copy
    genozip_tpu's piz_file_dp for these sources."""
    src = str(inputs / name)
    ext = os.path.splitext(name)[1]
    z = str(tmp_path / "z.gxz")
    zip_pipeline.zip_file(src, z, vb_size=48 << 10)
    piz_pipeline.piz_file(z, str(tmp_path / "host"))
    host = _read(tmp_path / "host")
    piz_pipeline.piz_file(z, str(tmp_path / ("host" + ext)))
    named = _read(tmp_path / ("host" + ext))
    if ext == ".gz":
        assert gzip.decompress(named) == gzip.decompress(_read(src)) == host
    elif ext == ".bam":
        assert named == _read(src) and gzip.decompress(named) == host
    else:
        assert named == host == _read(src)
    for dp in (3, 8):
        assert piz_file_dp(z, dp=dp) == host
        out = str(tmp_path / f"dp{dp}{ext}")
        assert piz_file_dp(z, out, dp=dp) is None
        assert _read(out) == named


def test_piz_file_dp_components_and_partial_output(inputs, tmp_path):
    """A paired archive's components go to .1 and .2 as piz_file writes
    them; a failing run leaves no partial output."""
    ref = str(inputs / "g.ref.gxz")
    z = str(tmp_path / "p.gxz")
    zip_pipeline.zip_pair(str(inputs / "m.fastq"), str(inputs / "m2.fastq"),
                          z, vb_size=48 << 10, reference=ref)
    out = str(tmp_path / "p.out")
    piz_file_dp(z, out, dp=4, reference=ref)
    assert _read(out + ".1") == _read(inputs / "m.fastq")
    assert _read(out + ".2") == _read(inputs / "m2.fastq")
    bad = str(tmp_path / "bad.gxz")
    zip_pipeline.zip_file(str(inputs / "r.fastq"), bad, vb_size=48 << 10)
    raw = bytearray(_read(bad))
    raw[len(raw) // 3] ^= 0xFF        # a byte inside a VB's sections
    with open(bad, "wb") as f:
        f.write(raw)
    with pytest.raises(Exception):
        piz_file_dp(bad, str(tmp_path / "bad.out"), dp=2)
    assert not os.path.exists(tmp_path / "bad.out")


# --- the collective dict merge ------------------------------------------------

def _merge_inputs():
    rng = np.random.default_rng(31)
    D, W = 8, 48
    hashes = (rng.integers(0, 60, (D, W)).astype(np.uint64)
              * np.uint64(0x9E3779B97F4A7C15))
    valid = rng.random((D, W)) > 0.3
    hi = (hashes >> np.uint64(32)).astype(np.uint32)
    lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hashes, valid, hi, lo


def test_collective_merge_equals_reference_and_twin():
    hashes, valid, hi, lo = _merge_inputs()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("dp",))
    want, nwant = ref_zs.make_collective_merge(mesh, hi.shape[1])(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    got, ngot = zip_sharded.collective_merge(hi, lo, valid)
    twin, ntwin = zip_sharded.collective_merge_host_twin(hashes, valid)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), twin)
    assert ngot == int(nwant) == ntwin
    ref_twin, nref = ref_zs.collective_merge_host_twin(hashes, valid)
    assert np.array_equal(twin, ref_twin) and ntwin == nref
    # torch tensors in, and the all-ones hash of an invalid slot
    hi[0, :3] = lo[0, :3] = 0xFFFFFFFF
    valid[0, 1] = True
    want, nwant = ref_zs.make_collective_merge(mesh, hi.shape[1])(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    got, ngot = zip_sharded.collective_merge(
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert ngot == int(nwant)


GLOO_MERGE = """
import datetime, json, sys
import numpy as np
import torch.distributed as dist
from genozip_tpu_torch.parallel.zip_sharded import collective_merge
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
z = np.load(path)
rows = slice(4 * rank, 4 * rank + 4)
out, n = collective_merge(z["hi"][rows], z["lo"][rows], z["valid"][rows],
                          group=dist.group.WORLD)
dist.barrier()
dist.destroy_process_group()
print("RESULT", json.dumps({"out": out.tolist(), "n": n}))
"""


def test_collective_merge_over_a_two_rank_gloo_group(tmp_path):
    """Each of 2 gloo ranks passes its 4 rows; both get the whole merge."""
    hashes, valid, hi, lo = _merge_inputs()
    path = str(tmp_path / "m.npz")
    np.savez(path, hi=hi, lo=lo, valid=valid)
    port = str(multihost._free_port())
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_MERGE, str(r), port,
                               path], stdout=subprocess.PIPE, text=True,
                              env=env) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    twin, ntwin = zip_sharded.collective_merge_host_twin(hashes, valid)
    for p, o in zip(procs, outs):
        assert p.returncode == 0
        got = json.loads(o.split("RESULT ", 1)[1])
        assert np.array_equal(np.array(got["out"]), twin)
        assert got["n"] == ntwin


# --- the seed aligner ----------------------------------------------------------

def _edge_batch(ref, Lb, rng):
    """Reads of length 1, 15, 16, 17, Lb - 1 and Lb and 100 off the genome,
    forward and reverse-complemented, with substitutions and codes above 3
    (a read's N byte maps to 0 in the FASTQ path; the kernel takes any
    byte), padded to Lb with zeros."""
    G = ref.length
    lens = []
    rows = []
    for L in (1, 15, 16, 17, Lb - 1, Lb, 100, 100, 100, 100):
        p = int(rng.integers(0, G - L))
        c = ref.codes[p:p + L].copy()
        if rng.random() < 0.5:
            c = (c ^ 3)[::-1]
        if L > 20:
            c[rng.integers(0, L, 3)] = rng.integers(0, 8, 3)
        row = np.zeros(Lb, np.uint8)
        row[:L] = c
        rows.append(row)
        lens.append(L)
    return np.stack(rows), np.asarray(lens, np.int32)


def _reads_batch(ref, n, L):
    from genozip_tpu_torch.ops import pack
    from genozip_tpu_torch.utils import ragged
    from genozip_tpu_torch.utils.ragged import Col
    reads = sample_reads(ref, n_reads=n, read_len=L, mut_rate=0.01)
    mat, lens = ragged.to_matrix(Col.from_list(reads))
    return pack.BASE2BIT[mat], lens


def _jax_local(ref, codes, lens):
    """genozip_tpu's make_sharded_aligner on a (1, 1) mesh, on the port's
    slab layout of `ref`."""
    Lb = codes.shape[1]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("dp", "mp"))
    slabs, starts, rh = aligner_sharded.shard_genome(ref, 1, Lb)
    step = ref_as.make_sharded_aligner(mesh, Lb, ref.hash_bits)
    out = step(jnp.asarray(codes), jnp.asarray(lens.astype(np.int32)),
               jnp.asarray(slabs), jnp.asarray(starts.astype(np.uint32)),
               jnp.asarray(rh), jnp.asarray([ref.length], np.uint32))
    return [np.asarray(x) for x in out]


def _plain(ref, codes, lens):
    rh = np.array(ref.refhash[:1 << ref.hash_bits], np.uint32).view(np.int32)
    out = align_cuda.seed_align(
        torch.from_numpy(np.ascontiguousarray(codes, np.uint8)),
        torch.from_numpy(np.asarray(lens, np.int32)),
        torch.from_numpy(np.array(ref.codes, np.uint8)),
        torch.from_numpy(rh), ref.hash_bits)
    return [t.numpy() for t in out]


@pytest.fixture(scope="module")
def genome():
    fa = synth_genome(120000, 2)
    return ref_refstore.fasta_to_genome(fa, hash_bits=18), \
        refstore.fasta_to_genome(fa, hash_bits=18)


@pytest.mark.parametrize("batch", ["edge", "reads"])
def test_seed_align_plain_equals_sharded_local(genome, batch):
    """The plain version equals genozip_tpu's `local` on a (1, 1) mesh,
    output for output, and genozip_tpu's MeshAligner(n_devices=1)."""
    jref, pref = genome
    rng = np.random.default_rng(3)
    if batch == "edge":
        codes, lens = _edge_batch(pref, 128, rng)
    else:
        codes, lens = _reads_batch(pref, 200, 96)
        pad = np.zeros((codes.shape[0], 128), np.uint8)
        pad[:, :codes.shape[1]] = codes
        codes = pad
    gpos, fwd, nmm, aligned = _plain(pref, codes, lens)
    jg, jf, jn, ja = _jax_local(pref, codes, lens)
    assert np.array_equal(gpos, jg.astype(np.uint32).astype(np.int64))
    assert np.array_equal(fwd, jf.astype(bool))
    assert np.array_equal(nmm, jn.astype(np.int32))
    assert np.array_equal(aligned, ja.astype(bool))
    assert aligned.sum() >= len(lens) // 2
    if batch == "reads":
        want = ref_mesh.MeshAligner(jref, n_devices=1).align_batch(
            jref, codes[:, :96], lens)
        for D in (1, 3):
            got = MeshAligner(pref, devices=["cpu"] * D).align_batch(
                pref, codes[:, :96], lens)
            for k in ("aligned", "gpos", "is_fwd", "nmm"):
                assert np.array_equal(got[k], want[k]), (D, k)


@pytest.mark.parametrize("mp,max_read_len", [(1, 128), (3, 256), (4, 1024)])
def test_shard_genome_equals_reference(genome, mp, max_read_len):
    """The port's copy of shard_genome lays out the slabs, their starts
    and the padded refhash layer 0 as genozip_tpu's does."""
    jref, pref = genome
    got = aligner_sharded.shard_genome(pref, mp, max_read_len)
    want = ref_as.shard_genome(jref, mp, max_read_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_seed_align_short_genome_and_checks(genome):
    """A genome under 16 bases aligns nothing, before any launch; the
    wrapper refuses a refhash of the wrong size and a read longer than the
    halo."""
    _, pref = genome
    tiny = refstore.RefGenome(pref.codes[:15].copy(), pref.contigs,
                              pref.refhash, pref.hash_bits)
    al = MeshAligner(pref, devices=["cpu"])
    res = al.align_batch(tiny, np.zeros((3, 10), np.uint8),
                         np.full(3, 10, np.int64))
    assert not res["aligned"].any() and (res["gpos"] == 0).all()
    with pytest.raises(ValueError, match="mesh halo"):
        al.align_batch(pref, np.zeros((2, 1100), np.uint8),
                       np.full(2, 1100, np.int64))
    with pytest.raises(ValueError, match="slots"):
        align_cuda.seed_align(torch.zeros((1, 128), dtype=torch.uint8),
                              torch.ones(1, dtype=torch.int32),
                              torch.zeros(64, dtype=torch.uint8),
                              torch.zeros(100, dtype=torch.int32), 7)


def test_f16_sharded_aligner_doubles_mismatches_at_a_slab_boundary():
    """Fault F16: genozip_tpu's MeshAligner(n_devices=8) (mp = 4) scores a
    read that starts just after a slab boundary on two ranks and adds both
    counts; the port gives the single count at any device count."""
    rng = np.random.default_rng(16)
    codes_g = rng.integers(0, 4, 40000).astype(np.uint8)
    fa = b">c\n" + ref_pack.ACGT[codes_g].tobytes() + b"\n"
    jref = ref_refstore.fasta_to_genome(fa, hash_bits=16)
    pref = refstore.fasta_to_genome(fa, hash_bits=16)
    L, slab = 100, 10000
    reads = np.zeros((4, L), np.uint8)
    for i, s in enumerate((slab + 10, 2 * slab + 200, 5000, 3 * slab + 700)):
        r = codes_g[s:s + L].copy()
        r[[20, 50]] ^= 1                 # off the seeds at 0, 28, 56, 84
        reads[i] = r
    lens = np.full(4, L, np.int64)
    jax_res = ref_mesh.MeshAligner(jref, n_devices=8).align_batch(
        jref, reads, lens)
    assert jax_res["nmm"].tolist() == [4, 4, 2, 4]
    for D in (1, 4, 8):
        got = MeshAligner(pref, devices=["cpu"] * D).align_batch(
            pref, reads, lens)
        assert got["nmm"].tolist() == [2, 2, 2, 2]
        assert got["gpos"].tolist() == jax_res["gpos"].tolist()


@pytest.mark.parametrize("D", [1, 4])
def test_mesh_zip_equals_reference_mesh_archive(inputs, D, tmp_path,
                                                reference_host_path,
                                                port_on_cpu):
    """zip --mesh (D CPU devices) writes genozip_tpu's zip_file(mesh=1)
    bytes; both packages unzip it; most reads align."""
    ref = str(inputs / "g.ref.gxz")
    src = str(inputs / "m.fastq")
    z = str(tmp_path / "port.gxz")
    zip_pipeline.zip_file(src, z, vb_size=VB, reference=ref, mesh=D)
    ref_zip.zip_file(src, str(tmp_path / "ref.gxz"), vb_size=VB,
                     reference=ref, mesh=1)
    assert _read(z) == _read(tmp_path / "ref.gxz")
    piz_pipeline.piz_file(z, str(tmp_path / "o1"), reference=ref)
    ref_piz.piz_file(z, str(tmp_path / "o2"), reference=ref)
    assert _read(tmp_path / "o1") == _read(src) == _read(tmp_path / "o2")
    pr = piz_pipeline.PizReader(z, ref)
    try:
        bm = pr.load_vb(1, 0)[1]["SQBITMAP"]["local"][0]
    finally:
        pr.close()
    assert bm.astype(bool).mean() > 0.9


def test_mesh_cli_launches_the_aligner(inputs, tmp_path, monkeypatch):
    """`zip --mesh 2 --device cpu` goes through seed_align (its plain
    version here), in the zip:align region."""
    calls = []
    orig = align_torch.seed_align_plain
    monkeypatch.setattr(align_torch, "seed_align_plain",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    z = str(tmp_path / "c.gxz")
    cli.main(["zip", str(inputs / "m.fastq"), "--reference",
              str(inputs / "g.ref.gxz"), "--mesh", "2", "-o", z, "--device",
              "cpu", "-q", "--vblock", "1"])
    codecs.disable_device_rans()
    assert len(calls) >= 2
    assert all(s[1] == 256 for s in calls)     # 150 bp reads, Lb = 256


# --- zip --hosts ---------------------------------------------------------------

def test_hosts_archive_equals_zip_file(inputs, tmp_path, monkeypatch):
    """Two gloo worker processes write zip_file's archive; their scratch
    directory is gone afterwards (F5); a SAM input is refused (F5)."""
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    src = str(inputs / "r.fastq")
    z = str(tmp_path / "h.gxz")
    multihost.zip_file_multihost(src, z, n_procs=2, vb_size=VB, device="cpu",
                                 timeout=240)
    zip_pipeline.zip_file(src, str(tmp_path / "p.gxz"), vb_size=VB)
    assert _read(z) == _read(tmp_path / "p.gxz")
    assert os.listdir(scratch) == []
    with pytest.raises(ValueError, match="F5"):
        multihost.zip_file_multihost(str(inputs / "a.sam"), z, n_procs=2,
                                     device="cpu")


def test_hosts_worker_failure_raises_and_cleans_up(tmp_path, monkeypatch):
    """A worker that fails makes the call raise; the others are killed and
    neither the archive nor the scratch directory stays."""
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    src = str(tmp_path / "x.fastq")
    with open(src, "wb") as f:
        f.write(b"@a\nACGT\n+\nFFFF\n")
    z = str(tmp_path / "x.gxz")
    with pytest.raises(RuntimeError, match="workers failed"):
        multihost.zip_file_multihost(src, z, n_procs=2, device="nodevice",
                                     timeout=120)
    assert not os.path.exists(z) and os.listdir(scratch) == []


# --- the CLI's refusals (F17, F14) ----------------------------------------------

REFUSED = [
    (["--dp", "2", "--pair", "{d}/m2.fastq"], "--dp is not supported with --pair (fault F17)"),
    (["--mesh", "2", "--pair", "{d}/m2.fastq", "--reference", "{d}/g.ref.gxz"],
     "--mesh is not supported with --pair (fault F17)"),
    (["--dp", "2", "--deep", "{d}/m2.fastq"], "--dp is not supported with --deep (fault F17)"),
    (["--mesh", "2", "--deep", "{d}/m2.fastq", "--reference", "{d}/g.ref.gxz"],
     "--mesh is not supported with --deep (fault F17)"),
    (["--dp", "2", "--tar", "{t}/a.tar"], "--dp is not supported with --tar (fault F17)"),
    (["--mesh", "2"], "--mesh needs --reference (fault F17"),
    (["--hosts", "2", "--reference", "{d}/g.ref.gxz"], "--reference is not supported with --hosts (fault F17)"),
    (["--hosts", "2", "--input-type", "fastq"], "--input-type is not supported with --hosts (fault F17)"),
    (["--hosts", "2", "--threads", "2"], "--threads is not supported with --hosts (fault F17)"),
    (["--hosts", "2", "--truncate"], "--truncate is not supported with --hosts (fault F17)"),
    (["--hosts", "2", "--bamass", "{d}/a.sam"], "--bamass is not supported with --hosts (fault F17)"),
    (["--hosts", "2", "--optimize"], "--optimize is not supported with --hosts (fault F17)"),
    (["--hosts", "2", "--REFERENCE"], "--REFERENCE is not supported with --hosts (fault F17)"),
    (["--hosts", "2", "--dp", "2"], "--dp is not supported with --hosts (fault F17)"),
    (["--hosts", "2", "--best"], "--best is not supported with --hosts (fault F17)"),
    (["--hosts", "2", "--password", "pw"], "--password is not supported with --hosts (fault F14)"),
    (["--hosts", "2", "--md5"], "--md5 is not supported with --hosts (fault F14)"),
]


@pytest.mark.parametrize("extra,msg", REFUSED,
                         ids=[" ".join(e[:2]) + f"-{i}"
                              for i, (e, _) in enumerate(REFUSED)])
def test_f17_refusals(inputs, tmp_path, extra, msg):
    """Fault F17: genozip_tpu's zip drops these options without a word;
    the port refuses them before reading the input, naming the fault."""
    argv = ["zip", str(inputs / "m.fastq"), "-o", str(tmp_path / "z.gxz"),
            "--device", "cpu"] + [a.format(d=inputs, t=tmp_path) for a in extra]
    with pytest.raises(ValueError) as e:
        cli.main(argv)
    codecs.disable_device_rans()
    assert msg in str(e.value)
    assert not os.path.exists(tmp_path / "z.gxz")


# --- the flagship step -----------------------------------------------------------

def _decoder_words(w, e):
    """The words of a (K, N) block whose emit flag is set, in the decoder's
    read order (step, then lane)."""
    return np.asarray(w).astype(np.int64)[np.asarray(e)]


def test_flagship_step_equals_reference():
    seq, qual, freq, cum = ref_flagship.example_batch(reads=256, read_len=64)
    want = ref_flagship.fastq_encode_step(jnp.asarray(seq), jnp.asarray(qual),
                                          jnp.asarray(freq), jnp.asarray(cum))
    got = flagship.fastq_encode_step(torch.from_numpy(seq),
                                     torch.from_numpy(qual),
                                     torch.from_numpy(freq.astype(np.int64)),
                                     torch.from_numpy(cum.astype(np.int64)))
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]).astype(np.int64))
    assert np.array_equal(got[2].numpy(), _decoder_words(want[2], want[3]))
    assert got[3] == int(want[4])
    hist = np.bincount(qual.reshape(-1), minlength=256)
    f, c = flagship.normalize_freqs(torch.from_numpy(hist))
    jf, jc = ref_flagship.normalize_freqs_jnp(jnp.asarray(hist))
    assert np.array_equal(f.numpy(), np.asarray(jf).astype(np.int64))
    assert np.array_equal(c.numpy(), np.asarray(jc).astype(np.int64))


@pytest.mark.parametrize("hist_seed", [0, 1, 2])
def test_flagship_normalize_equals_reference(hist_seed):
    """normalize_freqs equals normalize_freqs_jnp below the int32 limit
    (every bin under 524,288 counts), skewed and sparse histograms and
    the empty one included."""
    rng = np.random.default_rng(hist_seed)
    hists = [np.zeros(256, np.int64),
             rng.integers(0, 500000, 256),
             np.where(rng.random(256) < 0.05, rng.integers(1, 9000, 256), 0),
             np.bincount(rng.integers(0, 3, 1000), minlength=256)]
    for h in hists:
        f, c = flagship.normalize_freqs(torch.from_numpy(h))
        jf, jc = ref_flagship.normalize_freqs_jnp(jnp.asarray(h, jnp.int32))
        assert np.array_equal(f.numpy(), np.asarray(jf).astype(np.int64))
        assert np.array_equal(c.numpy(), np.asarray(jc).astype(np.int64))


def test_flagship_sharded_step_equals_reference():
    """make_sharded_step on 8 CPU devices (dp 4 x sp 2) equals
    genozip_tpu's on its 8 virtual devices, shard by shard."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    jmesh = ref_flagship.make_mesh(8)
    dp, sp = jmesh.shape["dp"], jmesh.shape["sp"]
    seq, qual, _, _ = ref_flagship.example_batch(reads=64 * dp,
                                                 read_len=64 * sp)
    sh = NamedSharding(jmesh, P("dp", "sp"))
    want = ref_flagship.make_sharded_step(jmesh)(
        jax.device_put(jnp.asarray(seq), sh),
        jax.device_put(jnp.asarray(qual), sh))
    mesh = flagship.make_mesh(devices=["cpu"] * 8)
    assert (mesh.dp, mesh.sp) == (dp, sp)
    packed, states, words, nbytes = flagship.make_sharded_step(mesh)(seq, qual)
    assert packed.numpy().tobytes() == np.asarray(want[0]).tobytes()
    assert np.array_equal(states.numpy(), np.asarray(want[1]).astype(np.int64))
    assert nbytes == np.asarray(want[4]).tolist()
    w, e = np.asarray(want[2]), np.asarray(want[3])
    N = w.shape[1] // 8
    for d in range(8):
        sl = slice(d * N, (d + 1) * N)
        assert np.array_equal(words[d].numpy(), _decoder_words(w[:, sl],
                                                               e[:, sl]))
