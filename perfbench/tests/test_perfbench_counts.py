"""counts/ gives the bounds the kernel table was measured against:
K1 0.04535 ms a batch-2 UNet forward, K2 0.4503 ms for the geometry and
texture heads over a [376832, 64] slab (0.2251 ms at cout 2), the
batch-32 train step 4.662 ms at the TF32 peak."""

import json
import os

import pytest

from perfbench.counts import kernels, model, peaks

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def towerruins():
    with open(os.path.join(HERE, "configs", "towerruins.json")) as fh:
        return json.load(fh)


def test_k1_forward_bound():
    f, b, n = kernels.k1_forward(towerruins()["unet"], (92, 128, 92), 2)
    ms, by = peaks.bound_ms(f, b, "bf16")
    assert n == 8 and by == "operations"
    assert ms == pytest.approx(0.04535, abs=5e-6)


@pytest.mark.parametrize("couts,want", [((1, 3), 0.4503), ((2,), 0.2251),
                                        ((1,), 0.2249)])
def test_k2_slab_bound(couts, want):
    f = b = 0.0
    for c in couts:
        ff, bb = kernels.k2_launch(376832, 64, c, 256, 4)
        f, b = f + ff, b + bb
    assert peaks.bound_ms(f, b, "bf16")[0] == pytest.approx(want, abs=5e-5)


def test_train_step():
    step = model.unet_train_step(towerruins()["unet"], (92, 128, 92), 32)
    assert peaks.bound_ms(step, 0, "tf32")[0] == pytest.approx(4.662,
                                                                abs=1e-3)


def test_block_widths_match_the_tag():
    assert model.block_widths(towerruins()["unet"]) == [
        (0, 64, 64), (1, 64, 128), (1, 128, 128), (0, 192, 64)]
