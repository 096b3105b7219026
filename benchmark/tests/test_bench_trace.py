"""The trace reduction on made-up spans."""

import pytest

from benchmark import trace


def test_kernel_names():
    for name, base, short in (
            ("void rans::encode_lanes_kernel<0, true>(long const*, int "
             "const*)", "encode_lanes_kernel", "rans::encode_lanes_kernel<0, "
             "true>"),
            ("(anonymous namespace)::scatter_kernel(long const*)",
             "scatter_kernel", "scatter_kernel"),
            ("void (anonymous namespace)::rans_decode_kernel<1>(unsigned "
             "short const*)", "rans_decode_kernel", "rans_decode_kernel<1>"),
            ("Memcpy HtoD (Pageable -> Device)",
             "Memcpy HtoD (Pageable -> Device)",
             "Memcpy HtoD (Pageable -> Device)")):
        assert trace.kernel_base(name) == base
        assert trace.short_name(name) == short


def test_union_busy_idle_and_labels():
    spans = [("void a_kernel(int)", 10, 20), ("void a_kernel(int)", 15, 30),
             ("Memcpy HtoD (Pageable -> Device)", 50, 60),
             ("void b_kernel<1>(int)", 95, 130)]
    host = [("zip:seg", 1, 0, 40), ("zip:seg-wait", 2, 35, 80),
            ("zip:merge+write", 2, 80, 100), ("inner", 1, 5, 12)]
    s = trace.Summary(spans, (0, 100), host)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(35e-6)        # 10-30, 50-60, 95-100
    assert s.kernel_s["a_kernel"] == pytest.approx(25e-6)
    assert s.kernel_s["b_kernel"] == pytest.approx(5e-6)
    # idle 0-10, 30-50, 60-95
    assert s.idle_s == pytest.approx({
        "inner": 5e-6, "zip:seg": 5e-6 + 5e-6,
        "zip:seg+zip:seg-wait": 5e-6, "zip:seg-wait": 10e-6 + 20e-6,
        "zip:merge+write": 15e-6})
    b = s.breakdown()
    assert b["device_ops"][0] == ["a_kernel", pytest.approx(25e-6)]
    assert len(b["idle_gaps"]) <= 10


def test_no_region_label_and_empty_trace():
    s = trace.Summary([], (0, 1e6), [])
    assert s.busy_s == 0 and s.idle_s == {"host: no region": 1.0}
