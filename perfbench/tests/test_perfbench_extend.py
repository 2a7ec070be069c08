"""A configuration, a mix, a cell and a per-layer metric are added as
new files and entries alone: the harness finds them by name, and no
file that was there changes."""

import hashlib
import json
import os
import shutil

from perfbench import harness

from conftest import make_root


def digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "perfbench")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_cell_of_added_files_loads(tmp_path):
    root = make_root(tmp_path)
    before = digests(root)
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "configs", "towerruins.json")) as fh:
        conf = json.load(fh)
    conf["name"] = "towerruins-b"
    with open(os.path.join(pb, "configs", "towerruins-b.json"), "w") as fh:
        json.dump(conf, fh)
    shutil.copy(os.path.join(pb, "traffic", "gen-tiny.json"),
                os.path.join(pb, "traffic", "gen-added.json"))
    with open(os.path.join(pb, "metrics", "samples_in_window.py"),
              "w") as fh:
        fh.write("def read(ctx):\n    return ctx.window.get('samples')\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "towerruins-b", "source": "x",
                            "file": "perfbench/configs/towerruins-b.json",
                            "reduced": [], "why": "added"})
    spec["workloads"].append({"name": "towerruins-b.gen-added",
                              "config": "towerruins-b",
                              "traffic": "gen-added", "chips": 1,
                              "why": "added"})
    spec["per_layer"].append({"name": "samples_in_window", "unit": "count",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "reverse chain",
                              "moves": "gen_s_per_sample",
                              "workloads": ["towerruins-b.gen-added"]})
    for m in spec["end_to_end"]:
        if "towerruins.gen-ddim100" in m.get("workloads", ()):
            m["workloads"].append("towerruins-b.gen-added")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)

    bench = harness.Bench(root, pb)
    cell = bench.cell("towerruins-b.gen-added")
    assert cell.config["name"] == "towerruins-b"
    assert cell.traffic["driver"] == "generate"
    assert [m["name"] for m in cell.end_to_end] == ["gen_s_per_sample",
                                                    "setup_s"]
    assert "samples_in_window" in [m["name"] for m in cell.per_layer]
    read = bench.reader("samples_in_window")
    assert read(type("Ctx", (), {"window": {"samples": 3}})()) == 3
    after = digests(root)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        "perfbench/configs/towerruins-b.json",
        "perfbench/traffic/gen-added.json",
        "perfbench/metrics/samples_in_window.py"}
