"""The sample, the planted faults and the hashing pipe."""

import hashlib

import pytest

from benchmark import taps
from benchmark.sink import HashSink


def test_sample_is_drawn_from_the_seed_and_keeps_k():
    a, b = taps.Sample(2**31 + 3, 2), taps.Sample(2**31 + 3, 2)
    da = [a.keep(i) for i in range(50)]
    assert da == [b.keep(i) for i in range(50)]
    assert da[:2] == [0, 1]
    assert set(da) - {None} == {0, 1}
    kept = [taps.Sample(s, 2) for s in range(400)]
    last = sum(1 for s in kept if [s.keep(i) for i in range(10)][9]
               is not None)
    assert 40 < last < 120          # file 9 is kept with odds 2/10


def test_faults_alter_the_batch():
    ins, outs = [b"aaaa", b"bbbb", b"cccc"], [b"xx", b"yy", b"zz"]
    assert taps.FAULTS["flip"](ins, outs)[0] != b"xx"
    assert taps.FAULTS["flip"](ins, outs)[1:] == [b"yy", b"zz"]
    assert taps.FAULTS["half_batch"](ins, outs) == [b"xx", b"\0\0", b"\0\0"]
    assert taps.FAULTS["unchanged"](ins, outs) == ins


def test_sink_hashes_what_is_written(tmp_path):
    data = bytes(range(256)) * 40000
    sink = HashSink(str(tmp_path / "out.fastq"))
    try:
        for k in (1, 3, 0):

            def write(path):
                with open(path, "wb") as f:
                    f.write(data * k)
            assert sink.restore(write) == (
                hashlib.sha256(data * k).hexdigest(), len(data) * k)
            assert sink.restore(write, digest=False) == (None, len(data) * k)
    finally:
        sink.close()
    assert not (tmp_path / "out.fastq").exists()


def test_sink_survives_a_writer_that_never_opens(tmp_path):
    sink = HashSink(str(tmp_path / "out.bam"))
    try:
        def fail(path):
            raise ValueError("the writer failed before it opened")
        with pytest.raises(ValueError):
            sink.restore(fail)

        def half(path):
            with open(path, "wb") as f:
                f.write(b"x" * 100000)
                raise ValueError("the writer failed midway")
        with pytest.raises(ValueError):
            sink.restore(half)

        def write(path):
            with open(path, "wb") as f:
                f.write(b"abc")
        assert sink.restore(write) == (hashlib.sha256(b"abc").hexdigest(), 3)
    finally:
        sink.close()
