"""On the card: each cell runs once, short, and comes out correct with
a well-formed line.  Skips where there is no card (decided inside the
test); run on the card with

    python3 -m pytest -q perfbench/tests/test_perfbench_card.py
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["towerruins.gen-ddim100",
                                  "towerruins.train-diffusion"])
def test_cell_runs_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        cell, "--seed", str(2 ** 32 + 5), "--seconds", "4",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["setup_s"]["value"] > 0
