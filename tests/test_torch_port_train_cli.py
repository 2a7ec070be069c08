"""The training slice as a whole: the port's `cli.train` on the committed
towerruins encoding (`--enc_log`), on the CPU with a narrow UNet
(model_channels 32) and a few steps.

- It writes `args.json` and `ema_*` / `opt*` under JAX's names, which the
  JAX package's `load_pytree` reads into the port's values (the EMA into
  `init_unet`'s tree, the optimiser state into `opt.init(params)`'s).
- The port resumes from a JAX-written pair: at JAX's step, the
  parameters and every EMA from the EMA file, the moments and counts from
  the opt file.
- `cli.sample --vox` runs from the EMA the port wrote.
- `--n_devices 2` whose batch does not divide trains on one device, as
  JAX's CLI does; `SIN3DM_DIST=1` without a coordinator and `--device
  cuda` (the default) without a card raise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core import checkpoint as jckpt
from sin3dm_tpu.core.checkpoint import _path_str
from sin3dm_tpu.models import unet as JU
from sin3dm_tpu.training import diffusion as JD
from sin3dm_tpu_torch.cli import sample as sample_cli
from sin3dm_tpu_torch.cli import train as train_cli
from sin3dm_tpu_torch.core import checkpoint as tckpt
from sin3dm_tpu_torch.core import config as cfgmod
from sin3dm_tpu_torch.core.triplane import load_triplane_npz
from sin3dm_tpu_torch.diffusion.gaussian import tables_to_device
from sin3dm_tpu_torch.models import unet as TU
from sin3dm_tpu_torch.training import diffusion as TD

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ENC = os.path.join(ROOT, "checkpoints", "towerruins", "encoding")
NARROW = ["--model_channels", "32", "--diff_batch_size", "1",
          "--diff_n_iters", "2", "--save_interval", "2", "--log_interval",
          "1", "--steps", "25"]


def _argv(tag, *extra):
    return ["--tag", str(tag), "--enc_log", ENC, "--device", "cpu",
            *NARROW, *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tag = tmp_path_factory.mktemp("train") / "tag"
    return tag, train_cli.main(_argv(tag)).diffusion


def _leaves(tree):
    return {_path_str(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_cli_writes_args_and_jax_named_checkpoints(trained):
    tag, loop = trained
    diff = tag / "diffusion"
    with open(diff / "args.json") as f:
        args = json.load(f)
    assert (args["in_channels"], args["out_channels"],
            args["model_channels"], args["diff_n_iters"]) == (12, 12, 32, 2)
    assert os.path.realpath(tag / "encoding") == os.path.realpath(ENC)
    assert sorted(p for p in os.listdir(diff) if p.endswith(".pt")) == [
        "ema_0.9999_000002.pt", "opt000002.pt"]
    assert loop.state.step == 2 and loop.state.count == 2


def test_jax_load_pytree_reads_the_port_files(trained):
    tag, loop = trained
    diff = tag / "diffusion"
    params_like = JU.init_unet(jax.random.PRNGKey(0),
                               JU.UNetConfig(model_channels=32))
    ema, _ = jckpt.load_pytree(str(diff / "ema_0.9999_000002.pt"),
                               params_like)
    st = loop.state
    port = dict(tckpt.leaves_with_paths(st.tree(st.ema[0])))
    got = _leaves(ema)
    assert list(got) == list(port)
    for p, v in got.items():
        assert np.array_equal(v, port[p].numpy()), p
    opt = JD.make_optimizer(JD.DiffusionTrainerConfig(lr_anneal_steps=2))
    ost, _ = jckpt.load_pytree(str(diff / "opt000002.pt"),
                               opt.init(params_like))
    assert int(ost[0].count) == 2 and int(ost[2].count) == 2
    for name, buf in (("mu", st.mu), ("nu", st.nu)):
        port = dict(tckpt.leaves_with_paths(st.tree(buf)))
        for p, v in _leaves(getattr(ost[0], name)).items():
            assert np.array_equal(v, port[p].numpy()), (name, p)


def test_port_resumes_from_a_jax_written_pair(tmp_path):
    """JAX writes step 3's EMA and opt state; the port's loop resumes there
    and trains on to step 4."""
    tag = tmp_path / "tag"
    args = cfgmod.train_args(_argv(tag, "--resume", "1", "--diff_n_iters",
                                   "4", "--save_interval", "4"))
    jcfg = JU.UNetConfig(model_channels=32)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a + 0.01 * rng.standard_normal(a.shape),
                              jnp.float32),
        JU.init_unet(jax.random.PRNGKey(1), jcfg))
    tcfg = cfgmod.diffusion_trainer_config_from_args(args)
    opt = JD.make_optimizer(JD.DiffusionTrainerConfig(lr_anneal_steps=4))
    st = opt.init(params)
    three = jnp.asarray(3, jnp.int32)
    st = (st[0]._replace(
        count=three,
        mu=jax.tree_util.tree_map(lambda a: a + 1e-3, st[0].mu),
        nu=jax.tree_util.tree_map(lambda a: a + 1e-6, st[0].nu)),
          st[1], st[2]._replace(count=three))
    diff = tag / "diffusion"
    jckpt.save_pytree(str(diff / "ema_0.9999_000003.pt"), params)
    jckpt.save_pytree(str(diff / "opt000003.pt"), st)

    ucfg = cfgmod.unet_config_from_args(args)
    feat = load_triplane_npz(cfgmod.encoding_feat_path(str(tag)))
    loop = TD.DiffusionTrainLoop(
        lambda p, x, t: TU.unet_train_apply(p, ucfg, x, t),
        TU.init_unet(torch.Generator().manual_seed(0), ucfg),
        tables_to_device(cfgmod.schedule_from_args(args).tables_f32(),
                         "cpu"),
        cfgmod.diffusion_config_from_args(args), tcfg, str(diff),
        feat.map(lambda p: p[None]), resume=True)
    s = loop.state
    assert (loop.resume_step, s.step, s.count, s.sched_count) == (3, 3, 3, 3)
    want = _leaves(params)
    for buf in [s.flat] + s.ema:
        for p, v in tckpt.leaves_with_paths(s.tree(buf)):
            assert np.array_equal(v.numpy(), want[p]), p
    for p, v in tckpt.leaves_with_paths(s.tree(s.mu)):
        assert np.array_equal(v.numpy(), want[p] * 0 + 1e-3), p
    loop.run(1)
    assert s.step == 4 and s.count == 4
    assert os.path.exists(diff / "ema_0.9999_000004.pt")
    assert tckpt.adamw_from_tree(tckpt.load_tree(
        str(diff / "opt000004.pt"))[0])[0] == 4


def test_sample_cli_runs_from_the_port_ema(trained, tmp_path):
    tag, _ = trained
    res = sample_cli.main([
        "--tag", str(tag), "--device", "cpu", "--vox", "--use_ddim", "true",
        "--timestep_respacing", "ddim4", "--resize", "0.125", "0.125",
        "0.125", "--reso", "32", "--output", str(tmp_path)])
    assert len(res["paths"]) == 1
    d = os.path.dirname(res["paths"][0])
    with np.load(os.path.join(d, "feat.npz")) as f:
        assert all(np.isfinite(f[k]).all() for k in f.files)
    with np.load(os.path.join(d, "r32_voxel.npz")) as v:
        assert v["vox_grid"].ndim == 3


def test_n_devices_that_do_not_divide_the_batch_train_on_one(tmp_path,
                                                            capsys):
    """As JAX's CLI, `--n_devices 2` with a batch of 1 trains on this one
    device (the port says why); the loop and its files are the
    single-process run's."""
    res = train_cli.main(_argv(tmp_path / "tag", "--n_devices", "2"))
    assert "does not divide over the ranks" in capsys.readouterr().out
    assert isinstance(res.diffusion, TD.DiffusionTrainLoop)
    assert res.diffusion.group is None and res.diffusion.state.step == 2
    assert (tmp_path / "tag" / "diffusion" / "ema_0.9999_000002.pt").exists()


def test_bootstrap_without_a_coordinator_raises(tmp_path, monkeypatch):
    """`SIN3DM_DIST=1` without the coordinator's variables: ValueError
    naming them, before anything trains."""
    monkeypatch.setenv("SIN3DM_DIST", "1")
    for v in ("SIN3DM_COORDINATOR", "SIN3DM_NUM_PROCESSES",
              "SIN3DM_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError, match="SIN3DM_COORDINATOR"):
        train_cli.main(_argv(tmp_path / "tag"))
    assert not list((tmp_path / "tag" / "diffusion").glob("*.pt"))


def test_train_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    argv = [a for a in _argv(tmp_path / "tag") if a not in ("--device",
                                                             "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(argv)
