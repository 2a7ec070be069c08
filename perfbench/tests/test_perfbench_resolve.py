"""BENCHMARK.json keeps the schema its runner reads, and every cell and metric
in it resolves to its files by name."""

import json
import math
import os
import re

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def spec():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_every_cell_and_metric_resolves():
    bench = harness.Bench()
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        assert callable(cell.driver)
        assert cell.config and cell.traffic["limits"]
        assert os.path.exists(bench.traffic_path(w["traffic"]))
    for m in bench.spec["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_keys_names_and_units():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(s["paths"][0] + "/")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    allowed = {"name", "unit", "better", "source", "workloads"}
    for m in s["end_to_end"]:
        assert set(m) <= allowed | {"bound"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) <= allowed | {"layer", "moves"}
        assert m["source"] in SOURCES
    for e in s["configs"] + s["workloads"] + s["end_to_end"] + s["per_layer"]:
        assert NAME.match(e["name"]), e["name"]
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for key in ("configs", "workloads", "end_to_end"):
        names = [e["name"] for e in s[key]]
        assert len(names) == len(set(names))
    assert len(json.dumps(s)) <= 64 * 1024


def test_every_cell_reports_what_it_must():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25

    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]
    for w in s["workloads"]:
        mine = [m["name"] for m in s["end_to_end"] if reports(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(reports(m, w["name"]) for m in s["per_layer"])
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in s["workloads"]]):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    used = {w["config"] for w in s["workloads"]}
    assert used == {c["name"] for c in s["configs"]}


def test_a_full_check_fits_with_every_cell():
    s = spec()
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (s["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200, total
    assert math.isclose(s["run_seconds"], int(s["run_seconds"]))
