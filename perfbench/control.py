"""Readings for the limits that decide `correct`:

    python3 perfbench/control.py --workload CELL --seconds S --seeds N [N ...]

For each seed, in one process: the cell's set-up, a window of S
seconds, and its check, which also computes the control: the reference
put in the program's place, its products at the precision below the
one the configuration states (the mix's "control": fp8 below bf16,
bf16 below float32 with TF32), and for the training cells the
reference with half of each batch left out.  Prints one JSON line a
seed with the program's readings, the control's and the fault's, then
the largest program reading and the smallest control reading of each
number.  The benchmark's own runs do not run this.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    import json
    import time
    import traceback

    sys.path.insert(0, ROOT)
    from perfbench import harness
    harness.environment(ROOT)
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.Bench()
    cell = bench.cell(a.workload)
    ctl = cell.traffic["control"]
    print(f"control {a.workload}: {ctl}; {harness.power_limit()}",
          flush=True)
    rows = []
    for seed in a.seeds:
        t0 = time.perf_counter()
        try:
            drv = cell.driver(cell, seed=seed, device=a.device,
                              root=bench.root)
            drv.setup()
            t1 = time.perf_counter()
            drv.plan(a.seconds, False)
            info = drv.window()
            checks = drv.check(ctl)
        except Exception:
            traceback.print_exc()
            rows.append({"seed": seed, "error": True})
            continue
        row = {"seed": seed, "setup_s": t1 - t0, **info["metrics"],
               "attempted": info["attempted"], "failed": info["failed"],
               "correct": all(c["value"] <= c["limit"]
                              for c in checks.values()),
               **drv.extra}
        rows.append(row)
        print(json.dumps(row), flush=True)
    ok = [r for r in rows if not r.get("error")]

    def numbers(part, k):
        return [r[part][k] for r in ok
                if isinstance(r[part].get(k), (int, float))]
    if ok:
        summary = {"program_max": {k: max(numbers("readings", k))
                                   for k in ok[0]["readings"]
                                   if numbers("readings", k)}}
        for part in ("control", "half_batch"):
            if part in ok[0]:
                summary[f"{part}_min"] = {k: min(numbers(part, k))
                                          for k in ok[0][part]
                                          if numbers(part, k)}
        print(json.dumps(summary), flush=True)
    return 0 if len(ok) == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
