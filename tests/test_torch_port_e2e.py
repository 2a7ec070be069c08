"""The port's whole chain on the CPU, through its entry points: a cube OBJ
-> `mesh_sampler` -> `cli.train` (AE and diffusion, `tests/test_e2e.py`'s
budgets) -> `cli.sample` DDIM-10 -> the renderer -> `eval_full`.  No JAX
comparison: JAX's training draws from threefry."""

import json
import os

import numpy as np
import pytest

from test_torch_port_mesh_sampler import write_cube_obj


@pytest.mark.slow
def test_full_pipeline_cli(tmp_path, monkeypatch):
    from sin3dm_tpu_torch.cli import sample as sample_cli
    from sin3dm_tpu_torch.cli import train as train_cli
    from sin3dm_tpu_torch.dataio import mesh_sampler
    from sin3dm_tpu_torch.evaluation import eval_full
    from sin3dm_tpu_torch.rendering import softraster

    monkeypatch.chdir(tmp_path)
    obj = str(tmp_path / "mesh" / "model.obj")
    os.makedirs(os.path.dirname(obj))
    write_cube_obj(obj)

    npz = str(tmp_path / "cube.npz")
    mesh_sampler.main(["-s", obj, "-d", npz, "--reso", "24", "--n_surf",
                       "20000", "--watertight"])
    with np.load(npz) as data:
        assert (data["sdf_grid"] < 0).mean() > 0.5
        signs = np.sign(data["sdf_near_surf"])
        assert (signs > 0).any() and (signs < 0).any()
        np.testing.assert_allclose(data["tex_on_surf"].mean(axis=0),
                                   [0.8, 0.3, 0.2], atol=0.05)

    tag = str(tmp_path / "exp")
    train_cli.main([
        "--tag", tag, "--data_path", npz, "--device", "cpu",
        "--fm_reso", "16", "--enc_n_iters", "60", "--enc_batch_size",
        "1024", "--diff_n_iters", "30", "--diff_batch_size", "4",
        "--save_interval", "30", "--log_interval", "50", "--rec_reso", "24"])
    for f in ("encoding/ckpt_final.pth", "encoding/feat.npz",
              "diffusion/ema_0.9999_000030.pt", "encoding/rec/object.obj"):
        assert os.path.exists(os.path.join(tag, f)), f

    sample_cli.main([
        "--tag", tag, "--device", "cpu", "--n_samples", "2", "--use_ddim",
        "true", "--timestep_respacing", "ddim10", "--reso", "24",
        "--n_faces", "300", "--texreso", "64"])
    for i in range(2):
        d = f"{tag}/results/{i:03d}"
        for f in ("feat.npz", "object.obj", "voxel.npz"):
            assert os.path.exists(os.path.join(d, f)), f

    assert len(softraster.main(["-s", f"{tag}/results"])) == 2
    softraster.render_multiview(obj, str(tmp_path / "renderings"))
    results = eval_full.main(["-s", f"{tag}/results", "-r", str(tmp_path),
                              "--device", "cpu"])
    assert "LP_IOU" in results and "Div" in results
    assert 0.0 <= results["LP_IOU"] <= 1.0
    with open(f"{tag}/results/eval_results.json") as f:
        assert json.load(f) == results
