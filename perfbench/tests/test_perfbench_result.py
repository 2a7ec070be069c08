"""The result line: exactly `correct`, `attempted`, `failed`, `metrics`,
`device`, `breakdown` when traced, and the numbers compared last under
`checks`; no result and a non-zero exit where there is no card."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness, tracing

from conftest import ROOT, make_root

FAKE = '''
import time


class Driver:
    def __init__(self, cell, seed, device, root):
        self.info = {}

    def setup(self):
        pass

    def plan(self, seconds, trace):
        pass

    def window(self):
        self.info = {"t0": time.perf_counter(), "samples": 2,
                     "chain_steps": 4, "stages": [
                         {"dir": "a", "stage": "chain", "seconds": 0.5},
                         {"dir": "a", "stage": "export", "seconds": 0.25}],
                     "metrics": {"gen_s_per_sample": 1.5},
                     "attempted": 2, "failed": 0}
        return self.info

    def check(self):
        return {"chain_rel": {"value": 0.1, "limit": 0.2}}
'''


@pytest.fixture
def fake_bench(tmp_path):
    root = make_root(tmp_path)
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "drivers", "fake.py"), "w") as fh:
        fh.write(FAKE)
    with open(os.path.join(pb, "traffic", "fake.json"), "w") as fh:
        json.dump({"driver": "fake", "limits": {}}, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["workloads"].append({"name": "towerruins.fake",
                              "config": "towerruins", "traffic": "fake",
                              "chips": 1, "why": "a fake driver"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "towerruins.gen-ddim100" in m.get("workloads", ()):
            m["workloads"].append("towerruins.fake")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return harness.Bench(root, pb)


def test_untraced_line(fake_bench):
    r = harness.run(fake_bench, "towerruins.fake", 2 ** 33 + 1, 1.0, False,
                    "cpu", 0.0)
    line = json.loads(json.dumps(r))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 2
    assert set(line["metrics"]) == {"gen_s_per_sample", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"] == {"chain_rel": {"value": 0.1, "limit": 0.2}}


def test_traced_line(fake_bench, monkeypatch):
    import contextlib

    @contextlib.contextmanager
    def fake_traced(enabled, out):
        yield
        out["trace"] = tracing.Trace(
            [(0.0, 4e5, "conv3x3_bf16_kernel"), (5e5, 6e5, "mlp_bf16")],
            [(0.0, 1e6, "perfbench.window"), (4e5, 5e5, "aten::add")],
            0.0, 1e6, 1.0)
    monkeypatch.setattr(tracing, "traced", fake_traced)
    r = harness.run(fake_bench, "towerruins.fake", 7, 1.0, True, "cpu", 0.0)
    line = json.loads(json.dumps(r))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["device"]["busy_s"] == pytest.approx(0.5)
    assert line["device"]["window_s"] == 1.0
    assert line["metrics"]["idle_share.gen"]["value"] == pytest.approx(50.0)
    assert line["metrics"]["chain_ms_per_step"]["value"] == \
        pytest.approx(1e3 * 0.5 / 8)
    assert "gen_s_per_sample" not in line["metrics"]
    gaps = dict(line["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"perfbench.window": 0.4, "aten::add": 0.1})
    assert [n for n, _ in line["breakdown"]["device_ops"]] == [
        "conv3x3_bf16_kernel", "mlp_bf16"]


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "towerruins.gen-ddim100", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    root = tmp_path / "bare"
    root.mkdir()
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "towerruins.gen-ddim100", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
