"""BENCHMARK.json against the rules it is checked by, and the files it
names."""

import json
import os
import re

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in MAN["workloads"]}
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 << 10
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= len(MAN["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and \
        1 <= MAN["run_seconds"] <= 51


def test_budget_fits_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in MAN["configs"]] + list(CELLS) + \
        [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    for group in (MAN["configs"], MAN["workloads"],
                  MAN["end_to_end"] + MAN["per_layer"]):
        ns = [x["name"] for x in group]
        assert len(ns) == len(set(ns))
    for n in names:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] \
            and "\t" not in w["why"]
    for m in MAN["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        for k in ("source", "why"):
            assert 1 <= len(c[k]) <= 200 and "\n" not in c[k] \
                and "\t" not in c[k]
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_on_one_chip_and_every_config_used():
    assert all(w["chips"] == 1 for w in MAN["workloads"])
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_each_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for cell in CELLS:
        e2e = [m for m in MAN["end_to_end"] if harness.applies(m, cell)]
        assert len(e2e) >= 2, cell
        assert any(harness.applies(m, cell) for m in MAN["per_layer"]), cell


def test_per_layer_cells_report_what_they_move():
    for m in MAN["per_layer"]:
        moved = E2E[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert harness.applies(moved, cell), (m["name"], cell)


def test_layers_named_alike_and_rooflines_in_percent():
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
            assert m["source"] == "device_trace"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_files_agree(cell):
    w = harness.cell_file(cell)
    assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
        CELLS[cell]["config"], CELLS[cell]["traffic"], CELLS[cell]["chips"],
        CELLS[cell]["why"])
    assert os.path.exists(os.path.join(harness.BENCH, "ops",
                                       f"{w['traffic']}.py"))


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_files_agree(config):
    entry = next(c for c in MAN["configs"] if c["name"] == config)
    assert entry["file"] == f"benchmark/configs/{config}.json"
    c = harness.config_file(config)
    assert c["source"] == entry["source"]
    assert sorted(c["reduced"]) == sorted(entry["reduced"])
    assert set(c["reduced"]) <= set(c["params"])
    assert os.path.exists(os.path.join(harness.BENCH, "gen",
                                       f"{c['generator']}.py"))


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(harness.metric_reader(metric))


def test_manifest_is_plain_json():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        assert json.load(f) == MAN
