"""The test cells: the benchmark's files copied into a temporary
checkout, with small cells added as files and entries only (their
configurations and mixes under tiny/), run on the CPU."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
sys.path.insert(0, ROOT)

# test cell -> (configuration, mix, the benchmark cell whose metrics it
# reports)
CELLS = {
    "towerruins.gen-tiny": ("towerruins", "gen-tiny",
                            "towerruins.gen-ddim100"),
    "towerruins.train-diffusion-tiny": ("towerruins-tiny",
                                        "train-diffusion-tiny",
                                        "towerruins.train-diffusion"),
}


def make_root(tmp) -> str:
    """A checkout in `tmp` holding the benchmark with the test cells
    added; returns its root."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(BENCH, os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "checkpoints"),
               os.path.join(root, "checkpoints"))
    for kind in ("configs", "traffic"):
        for f in os.listdir(os.path.join(TINY, kind)):
            shutil.copy(os.path.join(TINY, kind, f),
                        os.path.join(root, "perfbench", kind, f))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append({
        "name": "towerruins-tiny", "source": "https://arxiv.org/abs/2305.15399",
        "file": "perfbench/configs/towerruins-tiny.json", "reduced": [],
        "why": "a test size"})
    for cell, (conf, mix, like) in CELLS.items():
        spec["workloads"].append({"name": cell, "config": conf,
                                  "traffic": mix, "chips": 1,
                                  "why": "a test size"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh, indent=1)
    return root


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    from perfbench import harness
    root = make_root(tmp_path_factory.mktemp("perfbench"))
    return harness.Bench(root, os.path.join(root, "perfbench"))
