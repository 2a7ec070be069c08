"""The AE stage as a whole, on the CPU at small widths (hidden 32, 2
hidden layers, fdim_up 16) on a synthetic 32^3 sphere npz:

- the AE optimiser's checkpoint leaf paths equal those of JAX's
  `save_pytree` of `make_optimizer(...).init(params)` (and, at the
  committed tag's width, those of the committed `ckpt_final.pth`);
- the port's `ckpt_final.pth` is read by JAX's `AETrainer.load_ckpt` and
  `load_train_state` (params, optimiser state and step equal), and the
  port reads a JAX-written one;
- N + N iterations resumed from `ckpt_latest.pth` equal 2N uninterrupted
  ones, exactly (as `tests/test_ae_resume.py` holds JAX to);
- `cli.train --device cpu` without `--enc_log` writes the encoding
  (args.json, checkpoints, eval_stat.json, feat.npz of
  `compute_featmap_size` planes, the `rec` mesh) and then the diffusion
  stage's EMA; `--only_enc` stops after the AE; `--only_enc` with
  `--enc_log` is refused before anything is trained.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from sin3dm_tpu.core import checkpoint as jckpt
from sin3dm_tpu.core.checkpoint import _path_str
from sin3dm_tpu.models import autoencoder as jae
from sin3dm_tpu.training import ae as jtr
from sin3dm_tpu_torch.cli import train as train_cli
from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
from sin3dm_tpu_torch.core import checkpoint as tckpt
from sin3dm_tpu_torch.models import autoencoder as tae
from sin3dm_tpu_torch.training import ae as ttr
from test_torch_port_ae_train import write_npz

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ENC = os.path.join(ROOT, "checkpoints", "towerruins", "encoding")
SMALL = dict(fdim_geo=2, fdim_tex=4, fdim_up=16, hidden_dim=32,
             n_hidden_layers=2)
SMALL_FLAGS = ["-fdg", "2", "-fdt", "4", "-fdup", "16", "-hd", "32",
               "-nh", "2", "--enc_batch_size", "512", "--fm_reso", "16"]


def _tcfg(n_iters):
    return dict(enc_batch_size=512, enc_n_iters=n_iters, fm_reso=16)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_npz(str(tmp_path_factory.mktemp("ae_ckpt") / "s.npz"))


def _jax_leaves(tree):
    return {_path_str(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("split", [0.2, 0.0])
def test_opt_state_leaf_paths_equal_jax(split, tmp_path):
    cfg = jae.AEConfig(**SMALL)
    params = jae.init_autoencoder(jax.random.PRNGKey(0), cfg)
    jc = jtr.AETrainerConfig(enc_lr_split=split)
    opt = jtr.make_optimizer(jc, jae.geo_param_labels(params))
    jckpt.save_pytree(str(tmp_path / "j.pth"), {
        "params": params, "opt_state": opt.init(params),
        "step": np.zeros((), np.int32)})
    st = ttr.init_train_state(
        tae.init_autoencoder(torch.Generator().manual_seed(0),
                             tae.AEConfig(**SMALL)),
        ttr.AETrainerConfig(enc_lr_split=split))
    tckpt.save_tree(str(tmp_path / "t.pth"), {
        "params": st.tree(st.flat), "opt_state": ttr.opt_tree(st),
        "step": np.zeros((), np.int32)})
    want = jckpt.peek_paths(str(tmp_path / "j.pth"))
    assert tckpt.peek_paths(str(tmp_path / "t.pth")) == want
    if split:
        assert "opt_state/0/0/.count" in want and \
            "opt_state/0/2/.count" in want


def test_opt_state_paths_equal_the_committed_ckpt(tmp_path):
    """At the committed tag's width (its encoding args.json), the port's
    final checkpoint has the committed JAX-written file's leaf paths, and
    the port's `load_train_state` reads that file."""
    st = ttr.init_train_state(tae.init_autoencoder(
        torch.Generator().manual_seed(0), tae.AEConfig()),
        ttr.AETrainerConfig())
    path = str(tmp_path / "ckpt_final.pth")
    tckpt.save_tree(path, {"params": st.tree(st.flat),
                           "opt_state": ttr.opt_tree(st),
                           "step": np.zeros((), np.int32)})
    committed = os.path.join(ENC, "ckpt_final.pth")
    assert tckpt.peek_paths(path) == tckpt.peek_paths(committed)
    tr = ttr.AETrainer(str(tmp_path / "read"), tae.AEConfig(), "cpu")
    tr.log_dir = ENC
    params, opt, step = tr.load_train_state("final")
    st2 = ttr.init_train_state(ae_params_from_jax(params),
                               ttr.AETrainerConfig())
    ttr.load_opt_tree(st2, opt)
    assert step == st2.count == st2.sched_count == 25000
    assert tr.meta["grid_shape"] == [184, 256, 184]


@pytest.fixture(scope="module")
def port_trained(npz, tmp_path_factory):
    log = str(tmp_path_factory.mktemp("port_ae") / "enc")
    tr = ttr.AETrainer(log, tae.AEConfig(**SMALL), "cpu",
                       ttr.AETrainerConfig(**_tcfg(6)))
    tr.load_data(npz)
    stat = tr.train(0, log_every=1000, eval_every=6)
    return tr, stat


def test_jax_reads_the_port_ckpt_final(port_trained):
    tr, stat = port_trained
    assert stat["mean_tsdf_acc"] > 0.5
    with open(os.path.join(tr.log_dir, "eval_stat.json")) as f:
        assert json.load(f) == pytest.approx(stat, nan_ok=True)
    jt = jtr.AETrainer(tr.log_dir, jae.AEConfig(**SMALL),
                       jtr.AETrainerConfig(**_tcfg(6)))
    jt.load_ckpt("final")
    st = tr.state
    port = dict(tckpt.leaves_with_paths(st.tree(st.flat)))
    got = _jax_leaves(jt.params)
    assert list(got) == list(port)
    for p, v in got.items():
        assert np.array_equal(v, port[p].numpy()), p
    assert jt.meta == tr.meta
    params, opt_state, step = jtr.AETrainer(
        tr.log_dir, jae.AEConfig(**SMALL),
        jtr.AETrainerConfig(**_tcfg(6))).load_train_state("final")
    assert step == 6
    adam = opt_state[0][0]
    assert int(adam.count) == 6 and int(opt_state[0][2].count) == 6
    for name, buf in (("mu", st.mu), ("nu", st.nu)):
        port = dict(tckpt.leaves_with_paths(st.tree(buf)))
        for p, v in _jax_leaves(getattr(adam, name)).items():
            assert np.array_equal(v, port[p].numpy()), (name, p)
    # the decode's packed weights never reach a checkpoint
    assert not any("k2" in p or "k1" in p for p in tckpt.peek_paths(
        os.path.join(tr.log_dir, "ckpt_final.pth")))


def test_port_reads_a_jax_ckpt_final(npz, tmp_path):
    log = str(tmp_path / "jax_enc")
    jt = jtr.AETrainer(log, jae.AEConfig(**SMALL),
                       jtr.AETrainerConfig(**_tcfg(4)))
    jt.load_data(npz)
    jt.train(jax.random.PRNGKey(0), log_every=1000)
    tr = ttr.AETrainer(log, tae.AEConfig(**SMALL), "cpu")
    tr.load_ckpt("final")
    want = _jax_leaves(jt.params)
    got = dict(tckpt.leaves_with_paths(ttr.strip_packs(tr.params)))
    assert list(got) == list(want)
    for p, v in want.items():
        assert np.array_equal(got[p].numpy(), v), p
    assert tr.meta == jt.meta
    params, opt, step = tr.load_train_state("final")
    st = ttr.init_train_state(ttr.strip_packs(tr.params),
                              ttr.AETrainerConfig(**_tcfg(4)))
    ttr.load_opt_tree(st, opt)
    assert step == st.count == st.sched_count == 4
    jadam = jtr.AETrainer(log, jae.AEConfig(**SMALL), jtr.AETrainerConfig(
        **_tcfg(4))).load_train_state("final")[1][0][0]
    for name, buf in (("mu", st.mu), ("nu", st.nu)):
        port = dict(tckpt.leaves_with_paths(st.tree(buf)))
        for p, v in _jax_leaves(getattr(jadam, name)).items():
            assert np.array_equal(v, port[p].numpy()), (name, p)


def test_resume_equals_uninterrupted_run(npz, tmp_path):
    N = 4
    cfg = ttr.AETrainerConfig(**_tcfg(2 * N))

    def trainer(name):
        tr = ttr.AETrainer(str(tmp_path / name), tae.AEConfig(**SMALL),
                           "cpu", cfg)
        tr.load_data(npz)
        return tr

    full = trainer("full")
    full.train(0, log_every=1000, eval_every=N, save_every=N)
    part = trainer("resumed")
    part.train(0, log_every=1000, eval_every=N, save_every=N,
               n_iters=N + 1)
    assert os.path.exists(tmp_path / "resumed" / "ckpt_latest.pth")
    again = trainer("resumed")
    again.train(0, log_every=1000, eval_every=N, save_every=N,
                resume=True)
    assert again.state.step == full.state.step == 2 * N
    for buf in ("flat", "mu", "nu"):
        assert torch.equal(getattr(again.state, buf),
                           getattr(full.state, buf)), buf


def _cli_argv(tag, npz, *extra):
    return ["--tag", str(tag), "--data_path", npz, "--device", "cpu",
            *SMALL_FLAGS, "--enc_n_iters", "6", "--log_interval", "2",
            "--rec_reso", "32", "--model_channels", "32",
            "--diff_batch_size", "1", "--diff_n_iters", "2",
            "--save_interval", "2", "--steps", "25", *extra]


def test_cli_trains_the_ae_then_diffusion(npz, tmp_path):
    tag = tmp_path / "tag"
    res = train_cli.main(_cli_argv(tag, npz))
    enc = tag / "encoding"
    with open(enc / "args.json") as f:
        args = json.load(f)
    assert (args["data_path"], args["hidden_dim"], args["enc_n_iters"]) == (
        npz, 32, 6)
    for name in ("ckpt_final.pth", "ckpt_latest.pth", "eval_stat.json",
                 "feat.npz", "progress.json"):
        assert os.path.exists(enc / name), name
    fm = ttr.compute_featmap_size((32, 32, 32), 16)
    with np.load(enc / "feat.npz") as f:
        C = SMALL["fdim_geo"] + SMALL["fdim_tex"]
        assert f["feat_xy"].shape == (C, fm[0], fm[1])
        assert f["feat_xz"].shape == (C, fm[0], fm[2])
        assert f["feat_yz"].shape == (C, fm[1], fm[2])
    with open(enc / "progress.json") as f:
        logged = [json.loads(ln) for ln in f if ln.strip()]
    assert [d["ae/iter"] for d in logged] == [0, 2, 4]
    assert all(np.isfinite(d["ae/loss"]) for d in logged)
    assert os.path.getsize(enc / "rec" / "object.obj") > 0
    assert tckpt.peek_paths(str(enc / "ckpt_final.pth"))[-1] == "step"
    assert res.ae.state.step == 6 and res.diffusion.state.step == 2
    assert os.path.exists(tag / "diffusion" / "ema_0.9999_000002.pt")


def test_only_enc_stops_after_the_ae(npz, tmp_path):
    tag = tmp_path / "tag"
    res = train_cli.main(_cli_argv(tag, npz, "--only_enc",
                                   "--enc_n_iters", "2"))
    assert res.diffusion is None and res.ae.state.step == 2
    assert os.path.exists(tag / "encoding" / "feat.npz")
    assert not any(p.endswith(".pt")
                   for p in os.listdir(tag / "diffusion"))


def test_only_enc_refuses_a_reused_encoding(npz, tmp_path):
    """--enc_log links T/encoding to a trained encoding: training the AE
    there would write over it."""
    enc = tmp_path / "enc"
    enc.mkdir()
    with open(os.path.join(ENC, "args.json")) as f:
        args = json.load(f)
    with open(enc / "args.json", "w") as f:
        json.dump(dict(args, data_path=npz), f)
    with pytest.raises(ValueError, match="write over it"):
        train_cli.main(["--tag", str(tmp_path / "tag"), "--enc_log",
                        str(enc), "--device", "cpu", "--only_enc"])
    assert sorted(os.listdir(enc)) == ["args.json"]
