"""The benchmark's harness: runs one cell of `BENCHMARK.json` once.

Everything is found by name.  A cell (an entry of `workloads`) names its
configuration, whose `file` is a JSON of sizes and settings, and its
traffic mix, `traffic/<mix>.json` under this folder: the mix's data,
whose "driver" names the code that runs that kind of work,
`drivers/<driver>.py` (class `Driver`).  Each per-layer metric is read
by `metrics/<metric>.py` (function `read(ctx)`, None where it finds
nothing to read).  A new configuration, mix, cell or metric is new files
and entries; nothing here names one.

A run: set-up (the mix's `Driver` builds the program's objects from the
configuration and the seed and warms every shape the window uses), the
measured window (traced with `--trace 1`), the device's peak memory,
then `Driver.check` against the plain reference (`reference/`),
whose numbers and limits decide `correct`.  The result is the last line
of standard output, one JSON object; the numbers compared are also the
last lines of standard error.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "sin3dm_tpu")


def environment(root: str) -> None:
    """The process's settings, before torch is imported: the program's
    kernel caches at fixed paths inside the checkout, cuBLAS's fixed
    workspace (read once, at the first cuBLAS call; the training cells
    run under deterministic algorithms, which need it), and no Flax
    behind any library."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build",
                                                  "perfbench", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build",
                                                      "perfbench", "torch")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ["USE_FLAX"] = "0"


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Cell(SimpleNamespace):
    """One cell: its entries, its configuration's and mix's data, its
    driver class, and its end-to-end and per-layer metric entries."""


class Bench:
    """`BENCHMARK.json` at `root`, with the cells' files under
    `bench_dir`."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR):
        self.root, self.bench_dir = root, bench_dir
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def named(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    @staticmethod
    def applies(entry: dict, cell: str) -> bool:
        return "workloads" not in entry or cell in entry["workloads"]

    def traffic_path(self, mix: str) -> str:
        return os.path.join(self.bench_dir, "traffic", f"{mix}.json")

    def driver_path(self, driver: str) -> str:
        return os.path.join(self.bench_dir, "drivers", f"{driver}.py")

    def reader_path(self, metric: str) -> str:
        return os.path.join(self.bench_dir, "metrics", f"{metric}.py")

    def cell(self, name: str) -> Cell:
        w = self.named("workloads", name)
        conf = self.named("configs", w["config"])
        traffic = load_json(self.traffic_path(w["traffic"]))
        driver = load_module(self.driver_path(traffic["driver"]),
                             f"perfbench_driver_{traffic['driver']}")
        return Cell(name=name, workload=w,
                    config=load_json(os.path.join(self.root, conf["file"])),
                    traffic=traffic, driver=driver.Driver,
                    end_to_end=[m for m in self.spec["end_to_end"]
                                if self.applies(m, name)],
                    per_layer=[m for m in self.spec["per_layer"]
                               if self.applies(m, name)])

    def reader(self, metric: str):
        return load_module(self.reader_path(metric),
                           "perfbench_metric_" + metric.replace(".", "_")
                           .replace("-", "_")).read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def built_libraries(root: str) -> int:
    """How many shared libraries the checkout's build directory holds."""
    n = 0
    for _, _, files in os.walk(os.path.join(root, "build")):
        n += sum(f.endswith(".so") for f in files)
    return n


def run(bench: Bench, workload: str, seed: int, seconds: float,
        trace: bool, device: str, t_start: float) -> dict:
    """One run of one cell; returns the result's fields."""
    import torch
    from .tracing import traced

    cell = bench.cell(workload)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    built_before = built_libraries(bench.root)
    drv = cell.driver(cell, seed=seed, device=device, root=bench.root)
    drv.setup()
    built = built_libraries(bench.root) - built_before
    drv.plan(seconds, trace)
    out: Dict = {}
    with traced(trace, out):
        info = drv.window()
    setup_s = info["t0"] - t_start
    mem = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError("the run loaded " + ", ".join(found))
    t_check = time.perf_counter()
    checks = drv.check()
    t_check = time.perf_counter() - t_check
    for k, v in getattr(drv, "extra", {}).get("readings", {}).items():
        print(f"perfbench: reading {k}: {v!r}", file=sys.stderr)

    metrics = {}
    if not trace:
        values = dict(info["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"the mix's Driver gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    tr = out.get("trace")
    if trace:
        ctx = SimpleNamespace(trace=tr, window=info, config=cell.config,
                              traffic=cell.traffic, cell=workload)
        for m in cell.per_layer:
            v = bench.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(mem)}
    if trace:
        dev["busy_s"] = tr.busy_s if tr else 0.0
        dev["window_s"] = tr.window_s if tr else 0.0
    result = {"correct": info["failed"] == 0 and all(
                  c["value"] <= c["limit"] for c in checks.values()),
              "attempted": int(info["attempted"]),
              "failed": int(info["failed"]),
              "metrics": metrics, "device": dev}
    if trace and tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    print(f"perfbench: the check took {t_check:.3f} s", file=sys.stderr)
    print(f"perfbench: set-up {setup_s:.3f} s, {built} kernel or geometry "
          f"libraries built in it (a first run in this checkout builds "
          f"them); {dev['kind']}, {power_limit() if device == 'cuda' else ''}",
          file=sys.stderr)
    return result


def parse(argv):
    import argparse
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        bench = Bench()
        chips = int(bench.named("workloads", args.workload)["chips"])
        import torch
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < chips:
            print(f"perfbench: {args.workload} needs {chips} CUDA "
                  f"device(s); found {found}", file=sys.stderr)
            return 2
        print(f"perfbench: {torch.cuda.get_device_name(0)} x"
              f"{torch.cuda.device_count()}, {power_limit()}",
              file=sys.stderr)
        result = run(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", t_start)
    except Exception:
        traceback.print_exc()
        return 1
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
