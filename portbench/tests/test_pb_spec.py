"""BENCHMARK.json against the contract's shape, and every cell finding its
files by name."""

import json
import re

import pytest

import tiny
from harness import spec

BENCH = spec.benchmark()
KNOWN = tiny.bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
ALL_CELLS = [w["name"] for w in KNOWN["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_cell_finds_its_files(cell):
    c = spec.Cell(cell, KNOWN)
    assert c.chips == 1
    assert c.kind().run and c.model().check and c.model().control_check
    assert set(c.params["limits"]) and all(v >= 0 for v in c.params["limits"].values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("bench", [BENCH, KNOWN], ids=["benchmark", "with_unadmitted"])
def test_names_units_and_bounds(bench):
    cells = [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics] + cells + [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_hold_what_they_state():
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    for c in KNOWN["configs"]:
        data = spec.load_json(spec.REPO / c["file"])
        assert c["file"].startswith("portbench/configs/") and data["name"] == c["name"]
        assert c["reduced"] == data["reduced"] == []
        assert c["source"].startswith("https://") and len(c["source"]) <= 200


def test_a_metric_file_is_named_by_its_metric_less_its_group():
    assert spec.reader_path("mfu.train").name == "mfu.py"
    assert spec.reader_path("attention_fwd_roofline.batch").name == "attention_fwd_roofline.py"
