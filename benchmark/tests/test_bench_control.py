"""The comparison that decides `correct` fails where it must: a whole run of
each cell, on the CPU at a small size (the kernels' plain versions, the
chip check skipped), with the timed path broken underneath. The control is
the program's own lossy path (`--optimize`: QUAL binned), which breaks the
configurations' guarantee of a byte-exact restore; the faults are planted
in the batched rANS calls of the cell's traffic (`benchmark/taps.py`). A
sound run of each cell comes out correct."""

import pytest

from benchmark import harness

SMALL = {"fastq_illumina_se": {"nbytes": 1 << 20, "block": 2000},
         "bam_wgs_sorted": {"nbytes": 1 << 20, "window_reads": 4000}}
# the cells of BENCHMARK.json (the BAM cells are out while the program's
# BGZF level discovery fails their byte-exact restore: PERF.md)
CELLS = sorted(w["name"] for w in harness.manifest()["workloads"])


def _run(cell, seed, fault=None):
    config = harness.cell_file(cell)["config"]
    return harness.run_cell(cell, seed, 0.5, False, device="cpu",
                            overrides=SMALL[config],
                            min_size=16384, fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell, 2**31 + 5)
    assert r["correct"], r
    assert r["checks"]["rans_streams_checked"]["value"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["optimize", "flip", "half_batch",
                                   "unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_are_not_correct(cell, fault):
    r = _run(cell, 2**31 + 6, fault)
    assert not r["correct"], r
    checks = {k: v["value"] for k, v in r["checks"].items()}
    if fault == "optimize":
        # the streams are sound; the restored bytes are not
        assert checks["rans_streams_wrong"] == 0
        assert checks["restored_wrong"] >= 1
    else:
        assert checks["rans_streams_wrong"] >= 1
