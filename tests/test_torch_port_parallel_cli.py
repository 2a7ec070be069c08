"""The CLIs on several ranks, on the CPU at a tiny size (gloo ranks
started by the port's `spawn`):

- `cli.train --n_devices 2 --device cpu --data_path` a sphere npz: the
  AE stage on one device in the launching process (as JAX's CLI runs
  it), then diffusion data-parallel on 2 ranks (a batch of 2, one row
  each): both ranks end at the last step with the same parameters, and
  the checkpoints are written once.
- `cli.sample` from that tag, fp32 (`SIN3DM_SAMPLE_DTYPE=train`),
  DDIM4, `--vox`: `--sample_devices 2` and `--sample_spatial 2` write
  each sample's feat.npz within 2e-5 of `--sample_devices 1`'s; the
  spatial path in bf16 (the CLI's default dtype) gives finite planes of
  the tag's sizes.
- The mesh path over 2 ranks from the committed towerruins tag at an
  eighth of its planes (a 2-step tag samples no surface): each rank
  decodes its sample to a non-empty `object.obj`, from a feat.npz within
  2e-5 of the one-process `--vox` run's.
- `cli.sample` under the `SIN3DM_DIST` bootstrap: two processes started
  by hand (`python -m sin3dm_tpu_torch.cli.sample`, gloo over a
  `tcp://localhost` store) are the group. `--sample_devices 0` writes
  each sample's feat.npz bit for bit as this process's batch-1 chain of
  the same index (the ranks run this process's intra-op thread count);
  `--sample_spatial 2` within 1e-4 of each plane's largest of this
  process's run. A count above 1 that is not the group's size is
  refused with a ValueError that names the size.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sin3dm_tpu_torch.cli import sample as sample_cli
from sin3dm_tpu_torch.cli import train as train_cli
from test_ae import _make_sphere_npz

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOWER = os.path.join(ROOT, "checkpoints", "towerruins")
TINY = ["-fdg", "2", "-fdt", "4", "-fdup", "16", "-hd", "32", "-nh", "2",
        "--enc_batch_size", "512", "--fm_reso", "16", "--enc_n_iters",
        "20", "--log_interval", "10", "--rec_reso", "16",
        "--model_channels", "32", "--diff_batch_size", "2",
        "--diff_n_iters", "2", "--save_interval", "2", "--steps", "25"]
SAMPLE = ["--device", "cpu", "--use_ddim", "true", "--timestep_respacing",
          "ddim4", "--reso", "16", "--n_samples", "2"]


@pytest.fixture(scope="module")
def tag(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_cli")
    npz = str(d / "sphere.npz")
    _make_sphere_npz(npz)
    tag = d / "tag"
    res = train_cli.main(["--tag", str(tag), "--data_path", npz, "--device",
                          "cpu", "--n_devices", "2", *TINY])
    return tag, res


def test_train_cli_ae_on_one_device_then_dp_diffusion(tag):
    tag, res = tag
    # the AE stage ran here, on one device: its trainer is this process's
    assert res.ae is not None and res.ae.group is None
    assert (tag / "encoding" / "ckpt_final.pth").exists()
    assert (tag / "encoding" / "feat.npz").exists()
    ranks = res.diffusion
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["step"] == 2 for r in ranks)
    assert ranks[0]["params_sha256"] == ranks[1]["params_sha256"]
    assert sorted(p.name for p in (tag / "diffusion").glob("*.pt")) == [
        "ema_0.9999_000002.pt", "opt000002.pt"]


def _feats(paths):
    out = {}
    for p in paths:
        with np.load(p) as f:
            out[os.path.basename(os.path.dirname(p))] = {k: f[k]
                                                         for k in f.files}
    return out


def test_sample_cli_dp_and_spatial_match_one_device(tag, tmp_path,
                                                    monkeypatch):
    tag, _ = tag
    monkeypatch.setenv("SIN3DM_SAMPLE_DTYPE", "train")
    runs = {}
    for name, extra in (("one", ["--sample_devices", "1"]),
                        ("dp", ["--sample_devices", "2"]),
                        ("spatial", ["--sample_spatial", "2"])):
        runs[name] = sample_cli.main(["--tag", str(tag), "--vox", *SAMPLE,
                                      "--output", str(tmp_path / name),
                                      *extra])
    assert "ranks" not in runs["one"]
    want = _feats(runs["one"]["paths"])
    assert sorted(want) == ["000", "001"]
    for name in ("dp", "spatial"):
        res = runs[name]
        assert len(res["ranks"]) == 2
        got = _feats(res["paths"])
        assert sorted(got) == sorted(want), name
        for j in want:
            for k, w in want[j].items():
                np.testing.assert_allclose(got[j][k], w, rtol=0, atol=2e-5,
                                           err_msg=f"{name} {j} {k}")
            assert (tmp_path / name / j / "r16_voxel.npz").exists()
    # DP: each rank drew and decoded its own sample
    assert [len(r["paths"]) for r in runs["dp"]["ranks"]] == [1, 1]
    # spatial: every rank ran both chains, rank 0 saved and decoded
    assert [len(r["paths"]) for r in runs["spatial"]["ranks"]] == [2, 0]
    assert all(r["collectives"]["all_reduce"] > 0
               for r in runs["spatial"]["ranks"])
    assert all(r["launches"]["k1"] == 0 for r in runs["spatial"]["ranks"])


def test_sample_cli_bf16_spatial(tag, tmp_path):
    tag, _ = tag
    res = sample_cli.main(["--tag", str(tag), "--vox", *SAMPLE, "--output",
                           str(tmp_path), "--sample_spatial", "2"])
    feats = _feats(res["paths"])
    assert sorted(feats) == ["000", "001"]
    for planes in feats.values():
        assert [v.shape for v in planes.values()] == [(6, 16, 16)] * 3
        assert all(np.isfinite(v).all() for v in planes.values())


def test_sample_cli_dp_mesh_path(tmp_path, monkeypatch):
    monkeypatch.setenv("SIN3DM_SAMPLE_DTYPE", "train")
    small = ["--tag", TOWER, "--device", "cpu", "--resize", "0.125",
             "0.125", "0.125", "--use_ddim", "true", "--timestep_respacing",
             "ddim4", "--reso", "32", "--n_samples", "2"]
    vox = sample_cli.main([*small, "--vox", "--output", str(tmp_path / "v")])
    mesh = sample_cli.main([*small, "--texreso", "64", "--n_faces", "500",
                            "--output", str(tmp_path / "m"),
                            "--sample_devices", "2"])
    want, got = _feats(vox["paths"]), _feats(mesh["paths"])
    assert sorted(got) == sorted(want) == ["000", "001"]
    for j in want:
        for k, w in want[j].items():
            np.testing.assert_allclose(got[j][k], w, rtol=0, atol=2e-5)
        with open(tmp_path / "m" / j / "object.obj") as f:
            assert sum(line.startswith("f ") for line in f) > 0
    assert [[s["dir"][-3:] for s in r["stages"] if s["stage"] == "chain"]
            for r in mesh["ranks"]] == [["000"], ["001"]]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _bootstrapped_sample(argv, n=2):
    """`cli.sample` in n processes started by hand with the SIN3DM_DIST
    variables; fails with a process's stderr where one fails."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sin3dm_tpu_torch.cli.sample", *argv],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, SIN3DM_DIST="1",
                 SIN3DM_COORDINATOR=f"localhost:{port}",
                 SIN3DM_NUM_PROCESSES=str(n), SIN3DM_PROCESS_ID=str(r),
                 SIN3DM_SAMPLE_DTYPE="train", PYTHONPATH=ROOT,
                 OMP_NUM_THREADS=str(torch.get_num_threads())))
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in outs]


def test_sample_cli_bootstrap_dp_and_spatial(tag, tmp_path, monkeypatch):
    tag, _ = tag
    monkeypatch.setenv("SIN3DM_SAMPLE_DTYPE", "train")
    base = ["--tag", str(tag), "--vox", *SAMPLE]
    # this process: each index's batch-1 chain, and the CLI's own run
    sampler, C, sizes, _ = sample_cli._build_sampler(
        sample_cli.cfgmod.sample_args(base))
    batch1 = {f"{j:03d}": [p[0].permute(2, 0, 1).numpy()
                           for p in sampler(0, j, 1, C, sizes)]
              for j in range(2)}
    one = _feats(sample_cli.main(base + ["--output", str(tmp_path / "one")])
                 ["paths"])
    outs = {}
    for name, extra in (("dp", ["--sample_devices", "0"]),
                        ("spatial", ["--sample_spatial", "2"])):
        outs[name] = _bootstrapped_sample(
            base + ["--output", str(tmp_path / name), *extra])
    assert "backend gloo" in outs["dp"][0]
    keys = ("feat_xy", "feat_xz", "feat_yz")
    for name in ("dp", "spatial"):
        got = _feats([str(tmp_path / name / j / "feat.npz")
                      for j in ("000", "001")])
        for j in ("000", "001"):
            assert (tmp_path / name / j / "r16_voxel.npz").exists()
            for k, want in zip(keys, batch1[j]):
                if name == "dp":
                    np.testing.assert_array_equal(got[j][k], want,
                                                  err_msg=f"dp {j} {k}")
                else:
                    w = one[j][k]
                    assert np.abs(got[j][k] - w).max() <= \
                        1e-4 * np.abs(w).max(), f"spatial {j} {k}"


@pytest.mark.parametrize("flags", [["--sample_devices", "2"],
                                   ["--sample_spatial", "3"]])
def test_sample_cli_bootstrap_refuses_a_count_not_the_group(
        tag, monkeypatch, flags):
    """In a bootstrapped group of 4 a count above 1 other than 4 is
    refused before anything is sampled."""
    from sin3dm_tpu_torch import parallel
    tag, _ = tag
    group = parallel.DataGroup(0, 4, torch.device("cpu"), "gloo")
    monkeypatch.setattr(parallel, "maybe_initialize_distributed",
                        lambda device: group)
    with pytest.raises(ValueError, match="bootstrapped group of 4"):
        sample_cli.main(["--tag", str(tag), "--vox", *SAMPLE, *flags])
