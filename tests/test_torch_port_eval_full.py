"""The port's `eval_full.main` against the JAX package's on one results
layout: 3 generated dirs (a `voxel.npz` and 8 renders each) and a
reference dir (an `sdf_grid` npz and its renders), with seeded
weights in the 5 published files: the same keys, LP/Div within 1e-6,
SSFID and SIFID within 1e-4 relative, LPIPS within 1e-5 relative.
Without the weight files both give the same three skip notes, and
`--device cuda` without a card raises.  The renders are 96x96: at 64x64
the dims-192 features have 144 pixels for 192 channels, and scipy's
`sqrtm` of the singular covariance products takes seconds each."""

import json
import os

import numpy as np
import pytest
import torch

from sin3dm_tpu.evaluation import eval_full as jev
from sin3dm_tpu.evaluation import parity
from sin3dm_tpu_torch.evaluation import eval_full as tev
from sin3dm_tpu_torch.rendering import softraster as tsr

from test_torch_port_mesh_sampler import write_textured_sphere

WEIGHT_ENV = ("SSFID_WEIGHTS", "INCEPTION_WEIGHTS", "ALEXNET_WEIGHTS",
              "LPIPS_WEIGHTS")
TOL = {"LP": 1e-6, "Div": 1e-6, "SSFID": 1e-4, "mv_sifid": 1e-4,
       "mv_lpips": 1e-5}


def _ball(n, r, offset):
    xs = np.linspace(-1, 1, n)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    return np.linalg.norm(g - np.asarray(offset), axis=-1) - r


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    src, ref = root / "results", root / "ref"
    np.savez(_mkdir(ref) / "shape.npz",
             sdf_grid=_ball(40, 0.55, (0, 0, 0)).astype(np.float32))
    obj = write_textured_sphere(str(root / "mesh" / "ref"))
    tsr.render_multiview(obj, str(ref / "renderings"), res=96)
    for i in range(3):
        d = _mkdir(src / f"{i:03d}")
        off = (0.08 * i, -0.05 * i, 0.03)
        np.savez(d / "voxel.npz", vox_grid=_ball(40, 0.5 + 0.03 * i,
                                                 off) < 0)
        obj = write_textured_sphere(str(root / "mesh" / f"{i:03d}"),
                                    n_th=8 + 2 * i, n_ph=16, seed=i + 1)
        tsr.render_multiview(obj, str(d / "renderings"), res=96)
    w = _mkdir(root / "weights")
    files = {"ssfid_weights": parity.synth_clsshapenet_state_dict(0),
             "inception_weights": parity.synth_inception_stem_state_dict(0),
             "alexnet_weights": parity.synth_alexnet_state_dict(0),
             "lpips_weights": parity.synth_lpips_state_dict(0)}
    for name, sd in files.items():
        torch.save(sd, w / f"{name}.pth")
    flags = [f"--{name}={w / name}.pth" for name in files]
    return str(src), str(ref), flags


def _mkdir(p):
    os.makedirs(p, exist_ok=True)
    return p


def test_metrics_equal_jax(layout, tmp_path, monkeypatch):
    src, ref, flags = layout
    for k in WEIGHT_ENV:
        monkeypatch.delenv(k, raising=False)
    want = jev.main(["-s", src, "-r", ref, "-o", str(tmp_path / "j.json"),
                     *flags])
    seconds = {}
    got = tev.main(["-s", src, "-r", ref, "--device", "cpu", *flags],
                   seconds=seconds)
    assert sorted(got) == sorted(want)
    assert not any(k.endswith("_note") for k in got), got
    with open(os.path.join(src, "eval_results.json")) as f:
        assert json.load(f) == got
    for k, w in want.items():
        tol = next(t for p, t in TOL.items() if k.startswith(p))
        if k.startswith(("LP", "Div")):
            assert abs(got[k] - w) <= tol, (k, got[k], w)
        else:
            assert abs(got[k] - w) <= tol * abs(w), (k, got[k], w)
    assert sorted(seconds) == ["div", "lp", "lpips", "sifid192", "sifid64",
                               "ssfid"]


def test_skip_notes_equal_jax(layout, tmp_path, monkeypatch):
    src, ref, _ = layout
    for k in WEIGHT_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    want = jev.main(["-s", src, "-r", ref, "-o", "j.json"])
    got = tev.main(["-s", src, "-r", ref, "-o", "t.json", "--device",
                    "cpu"])
    notes = {k: v for k, v in got.items() if k.endswith("_note")}
    assert sorted(notes) == ["SSFID_note", "lpips_note", "sifid_note"]
    assert got == want


def test_cuda_without_a_card_raises(layout):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    src, ref, _ = layout
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.main(["-s", src, "-r", ref])
