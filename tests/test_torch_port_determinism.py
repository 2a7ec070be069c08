"""Training repeats bit for bit: `cli.train.main` runs with deterministic
algorithms only (`core.rng.deterministic_algorithms`) and restores the
caller's flags; two runs of one command dump the same bits; the UNet's
2x bilinear upsample, written as sums of shifted slices so that its
backward is deterministic on the card, gives `resize_bilinear`'s bits and
`F.interpolate`'s numbers and gradients."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sin3dm_tpu_torch.cli import train as train_cli
from sin3dm_tpu_torch.core import nn as tnn
from sin3dm_tpu_torch.core import rng as trng
from test_torch_port_ae_train import write_npz

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ENC = os.path.join(ROOT, "checkpoints", "towerruins", "encoding")
DIFFUSION = ["--model_channels", "32", "--diff_batch_size", "2",
             "--diff_n_iters", "3", "--save_interval", "3",
             "--log_interval", "1", "--steps", "25"]
AE = ["-fdg", "2", "-fdt", "4", "-fdup", "16", "-hd", "32", "-nh", "2",
      "--enc_batch_size", "512", "--fm_reso", "16", "--enc_n_iters", "4",
      "--log_interval", "2", "--rec_reso", "32", "--only_enc"]


def _flags():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


def _dumps(tag):
    """Every array of every checkpoint and feat.npz under `tag`."""
    out = {}
    for d, _, files in os.walk(tag):
        for name in sorted(files):
            if name.endswith((".pt", ".pth", ".npz")):
                path = os.path.join(d, name)
                with np.load(path) as z:
                    for k in z.files:
                        out[(os.path.relpath(path, tag), k)] = z[k]
    return out


@pytest.mark.parametrize("stage", ["diffusion", "ae"])
def test_two_runs_of_one_command_dump_equal_bits(tmp_path, stage):
    if stage == "diffusion":
        extra = ["--enc_log", ENC, *DIFFUSION]
    else:
        extra = ["--data_path", write_npz(str(tmp_path / "s.npz")), *AE]
    runs = []
    for i in range(2):
        tag = tmp_path / f"tag{i}"
        train_cli.main(["--tag", str(tag), "--device", "cpu", *extra])
        runs.append(_dumps(tag))
    assert len(runs[0]) >= 3 and runs[0].keys() == runs[1].keys()
    for k, v in runs[0].items():
        assert v.dtype == runs[1][k].dtype and v.tobytes() == \
            runs[1][k].tobytes(), k


def test_main_trains_deterministically_and_restores_the_flags(
        monkeypatch, tmp_path):
    seen = []

    def fake(args, group=None):
        seen.append((_flags(), os.environ["CUBLAS_WORKSPACE_CONFIG"]))

    monkeypatch.setattr(train_cli, "train_diffusion", fake)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.benchmark = True
    try:
        train_cli.main(["--tag", str(tmp_path / "tag"), "--enc_log", ENC,
                        "--device", "cpu", *DIFFUSION])
        assert seen == [((True, True, False), ":4096:8")]
        assert _flags() == (False, False, True)
        # a value the caller set is kept
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
        train_cli.main(["--tag", str(tmp_path / "tag2"), "--enc_log", ENC,
                        "--device", "cpu", *DIFFUSION])
        assert seen[1] == ((True, True, False), ":16:8")
        assert _flags() == (False, False, True)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before


def test_flags_restored_when_the_block_raises():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with pytest.raises(ValueError):
            with trng.deterministic_algorithms():
                warn_only = torch.is_deterministic_algorithms_warn_only_enabled
                assert not warn_only()
                raise ValueError
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("shape", [(2, 6, 8, 3), (1, 1, 5, 2), (3, 9, 4, 4)])
def test_upsample2x_is_resize_and_interpolate(shape):
    """Bit for bit `resize_bilinear(x, (2H, 2W))`; within 2 fp32 ulps of
    the largest value of `F.interpolate`, forward and backward; bf16 as
    `F.interpolate`'s single rounding."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    H, W = shape[1:3]
    got = tnn.upsample2x_bilinear(x)
    assert torch.equal(got, tnn.resize_bilinear(x, (2 * H, 2 * W)))

    def interp(v):
        return F.interpolate(v.permute(0, 3, 1, 2), size=(2 * H, 2 * W),
                             mode="bilinear", align_corners=False
                             ).permute(0, 2, 3, 1)

    tol = 2 * 2.0 ** -23
    assert (got - interp(x)).abs().max() <= tol * x.abs().max()
    g = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    (tnn.upsample2x_bilinear(xa) * g).sum().backward()
    (interp(xb) * g).sum().backward()
    assert (xa.grad - xb.grad).abs().max() <= 4 * tol * xb.grad.abs().max()
    xh = x.bfloat16()
    diff = (tnn.upsample2x_bilinear(xh).float() - interp(xh).float()).abs()
    assert diff.max() <= 2.0 ** -8 * x.abs().max()
