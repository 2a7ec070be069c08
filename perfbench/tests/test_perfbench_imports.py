"""No run loads JAX or the JAX package, compared by whole top-level
names (`sin3dm_tpu_torch` is allowed, `sin3dm_tpu` is not); the plain
reference loads nothing of the program either."""

import json
import os
import subprocess
import sys

from conftest import ROOT

HARNESS = """
import glob, json, os, sys
sys.path.insert(0, {root!r})
from perfbench import harness, tracing, control
from perfbench.counts import kernels, model, peaks
bench = harness.Bench()
for w in bench.spec["workloads"]:
    bench.cell(w["name"])
for m in bench.spec["per_layer"]:
    bench.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.reference import (adamw, autoencoder, compare, diffusion,
                                 mesh, png, precision, tree, unet)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(script: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", script.format(root=ROOT)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300, check=True)
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = top_level(HARNESS)
    assert not mods & {"jax", "jaxlib", "flax", "sin3dm_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = top_level(REFERENCE)
    assert not mods & {"jax", "jaxlib", "flax", "sin3dm_tpu",
                       "sin3dm_tpu_torch"}


def test_a_run_loads_no_jax(tiny_bench):
    script = f"""
import json, sys, time
sys.path.insert(0, {ROOT!r})
from perfbench import harness
bench = harness.Bench({tiny_bench.root!r}, {tiny_bench.bench_dir!r})
r = harness.run(bench, "towerruins.train-diffusion-tiny", 5, 0.5, False,
                "cpu", time.perf_counter())
mods = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps([r["correct"], mods]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600,
                       check=True)
    _, mods = json.loads(p.stdout.strip().splitlines()[-1])
    assert "sin3dm_tpu_torch" in mods
    assert not set(mods) & {"jax", "jaxlib", "flax", "sin3dm_tpu"}
