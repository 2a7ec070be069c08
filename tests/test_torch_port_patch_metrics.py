"""The port's LP-IoU / LP-F-score / Div against the JAX package's: the
identities of `tests/test_evaluation.py`, and on two committed towerruins
grids (92x128x92 after pooling, ~1,100 patches each) the per-patch arrays
equal JAX's bit for bit (0/1 products summed in fp32 are exact), the
four LP metrics and Div within 1e-6."""

import os

import numpy as np
import pytest
import torch

from sin3dm_tpu.evaluation import patch_metrics as jpm
from sin3dm_tpu_torch.evaluation import patch_metrics as tpm

GRID = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "checkpoints", "towerruins", "results_parity",
                    "{:03d}", "r256_voxel.npz")


def _sphere_grid(n=64, r=0.5, offset=(0.0, 0.0, 0.0)):
    xs = np.linspace(-1, 1, n)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    return np.linalg.norm(g - np.asarray(offset), axis=-1) < r


def _t(g):
    return tpm.pool_to(g)


def test_lp_identities_and_bounds():
    g = _sphere_grid(64)
    g2 = _sphere_grid(64, 0.5, offset=(0.12, 0, 0))
    iou, f1 = tpm.eval_lp([_t(g)], _t(g))
    assert iou == pytest.approx(1.0, abs=1e-6)
    assert f1 == pytest.approx(1.0, abs=1e-6)
    res = tpm.eval_lp_full([_t(g)], _t(g))
    assert all(v == pytest.approx(1.0, abs=1e-6) for v in res.values())
    res2 = tpm.eval_lp_full([_t(g2)], _t(g))
    assert res2["LP-IOU-percent"] < 1.0
    assert res2["LP-IOU-percent"] <= res2["LP-F-score-percent"] + 1e-9
    assert res2 == jpm.eval_lp_full([g2], g)
    assert tpm.eval_lp([_t(g2)], _t(g)) == jpm.eval_lp([g2], g)


def test_div_and_pool_equal_jax():
    g = _sphere_grid(48)
    g2 = _sphere_grid(48, 0.5, offset=(0.3, 0, 0))
    assert tpm.eval_div([_t(g), _t(g)]) == pytest.approx(0.0, abs=1e-9)
    d = tpm.eval_div([_t(g), _t(g2)])
    assert 0.0 < d < 1.0
    assert d == jpm.eval_div([g, g2])
    # grids of other sizes are zero-padded to the larger
    assert tpm.grid_iou(_t(g), _t(g2[:40])) == jpm.grid_iou(g, g2[:40])
    p = np.zeros((256, 130, 64), bool)
    p[10, 10, 10] = True
    got = tpm.pool_to(p, 128)
    assert got.dtype == torch.bool and tuple(got.shape) == (128, 65, 64)
    np.testing.assert_array_equal(got.numpy(), jpm.pool_to(p, 128))


def test_patches_equal_jax_in_lattice_order():
    g = _sphere_grid(40, 0.6, offset=(0.1, -0.2, 0))
    want = jpm.extract_patches(g)
    got = tpm.extract_patches(_t(g))
    assert got.dtype == torch.float32 and len(want) > 30
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert len(tpm.extract_patches(_t(np.zeros((20, 20, 20), bool)))) == 0


def test_committed_grids_per_patch_equal_jax(tmp_path):
    jref = jpm.load_voxel_npz(GRID.format(0))
    jgen = jpm.load_voxel_npz(GRID.format(1))
    tref = tpm.load_voxel_npz(GRID.format(0))
    tgen = tpm.load_voxel_npz(GRID.format(1))
    assert tuple(tref.shape) == jref.shape == (92, 128, 92)
    np.testing.assert_array_equal(tref.numpy(), jref)
    jpatch = jpm.extract_patches(jref)
    tpatch = tpm.extract_patches(tref)
    assert 1000 < len(tpatch) < 1300
    for want, got in zip(jpm.lp_score_arrays(jgen, jpatch),
                         tpm.lp_score_arrays(tgen, tpatch)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the reference written as an sdf_grid, as eval_full reads it
    np.savez(tmp_path / "ref.npz",
             sdf_grid=np.where(np.load(GRID.format(0))["vox_grid"], -1.0,
                               1.0).astype(np.float32))
    tsdf = tpm.load_sdf_npz_as_voxel(str(tmp_path / "ref.npz"))
    np.testing.assert_array_equal(tsdf.numpy(), jref)
    want = jpm.eval_lp_full([jgen, jref], jref)
    got = tpm.eval_lp_full([tgen, tsdf], tsdf)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert abs(tpm.eval_div([tgen, tsdf]) - jpm.eval_div([jgen, jref])) \
        <= 1e-6
