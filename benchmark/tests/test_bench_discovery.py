"""A new cell, configuration or per-layer metric is new files only: a copy
of the benchmark's folder with files added, and no file edited, runs
them."""

import json
import shutil

from benchmark import harness


def test_new_cell_config_and_metric_are_found(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((bench / "configs" / "fastq_illumina_se.json")
                     .read_text())
    cfg["name"] = "fastq_small"
    cfg["params"]["nbytes"] = 1 << 20
    (bench / "configs" / "fastq_small.json").write_text(json.dumps(cfg))
    cell = {"config": "fastq_small", "traffic": "zip", "chips": 1,
            "params": {"clients": 1, "files": 2}, "why": "a test cell"}
    (bench / "workloads" / "small.zip.json").write_text(json.dumps(cell))
    (bench / "metrics" / "files_done.zip.py").write_text(
        "def read(run):\n    return float(run.done) or None\n")
    man = harness.manifest()
    man["workloads"].append(dict(name="small.zip", **{
        k: cell[k] for k in ("config", "traffic", "chips", "why")}))
    man["per_layer"].append({"name": "files_done.zip", "unit": "files",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry", "moves": "zip_MBps",
                             "workloads": ["small.zip"]})
    for m in man["end_to_end"]:
        if m["name"] in ("zip_MBps", "ratio"):
            m["workloads"].append("small.zip")
    r = harness.run_cell("small.zip", 7, 0.5, False, device="cpu",
                         bench=str(bench), man=man,
                         overrides={"block": 2000}, min_size=16384)
    assert r["correct"], r
    assert set(r["metrics"]) == {"zip_MBps", "ratio", "setup_s"}
    r = harness.run_cell("small.zip", 8, 0.5, True, device="cpu",
                         bench=str(bench), man=man,
                         overrides={"block": 2000}, min_size=16384)
    assert r["correct"], r
    assert r["metrics"]["files_done.zip"]["value"] >= 1
    assert "seg_thread_s_per_GB" not in r["metrics"]
