"""counts/tnorm.py: the bytes of the sampler's triplane norm at the
towerruins tag's planes, and the roofline reader's silence where the
trace holds no norm kernel."""

import json
import os
import types

import pytest

from perfbench.counts import peaks, tnorm

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def towerruins():
    with open(os.path.join(HERE, "configs", "towerruins.json")) as fh:
        return json.load(fh)


def test_one_launch_bytes():
    """The level-0 in norm of the skip-concat block: 32,016 pixels of
    192 channels in and out in bf16, six means over 312 + 312 lines,
    gamma, beta, A and B in fp32."""
    planes = [(92, 128), (92, 92), (128, 92)]
    got = tnorm.tnorm_launch(1, planes, 192, False, True)
    assert got == 4 * 32016 * 192 + 2 * 192 * 624 + 24 * 192 + 24 * 192
    assert got == 24837120.0


def test_forward_bytes_and_launches():
    nbytes, n = tnorm.tnorm_forward(towerruins()["unet"], (92, 128, 92), 1)
    assert n == 9
    ms, by = peaks.bound_ms(0.0, nbytes, "bf16")
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert nbytes == 72519168.0


def _ctx(kernel_s):
    trace = types.SimpleNamespace(
        kernel_seconds=lambda *names: kernel_s)
    window = {"samples": 3, "chain_steps": 1000, "batch": 1,
              "plane_sizes": (92, 128, 92)}
    return types.SimpleNamespace(trace=trace, window=window,
                                 config=towerruins())


def _reader():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tnorm_roofline", os.path.join(HERE, "metrics", "tnorm_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reader_is_silent_without_the_kernel():
    assert _reader().read(_ctx(0.0)) is None


def test_reader_share():
    nbytes, _ = tnorm.tnorm_forward(towerruins()["unet"], (92, 128, 92), 1)
    bound_s = 3000 * nbytes / 3.35e12
    assert _reader().read(_ctx(4 * bound_s)) == pytest.approx(25.0)
