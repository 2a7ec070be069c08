"""Port parity: reading the reference's torch checkpoints
(`compat/torch_import.py`) against the JAX package's mapping.

State dicts come from JAX's `unet_state_dict_from_params` /
`ae_state_dict_from_params` over JAX-initialised (perturbed) params at
small widths, as tensors in a `torch.save` file.  The port's mapping
gives JAX's tree bit for bit; the port's `unet_apply` and point decode on
it match JAX's within 1e-5 of the output's scale (fp32, CPU); the
reverse mappings are equal key for key; the converted containers read
back equal through JAX's `load_pytree`; `cli.sample --device cpu` from a
reference-format tag equals the npz tag bit for bit; files that
`torch.load(weights_only=True)` refuses raise ValueError naming them."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.compat import torch_import as jti
from sin3dm_tpu.core import checkpoint as jckpt
from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.models import autoencoder as jae
from sin3dm_tpu.models import unet as JU
from sin3dm_tpu.training import ae as jtr
from sin3dm_tpu_torch.cli import import_torch_ckpt
from sin3dm_tpu_torch.cli import sample as sample_cli
from sin3dm_tpu_torch.compat import torch_import as tti
from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax, \
    unet_params_from_jax
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.models import autoencoder as tae
from sin3dm_tpu_torch.models import unet as TU
from sin3dm_tpu_torch.training import ae as ttr
from test_torch_port_ae_train import write_npz

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TAG = os.path.join(ROOT, "checkpoints", "towerruins")
REL = 1e-5
AE_SMALL = dict(fdim_geo=2, fdim_tex=4, fdim_up=16, hidden_dim=32,
                n_hidden_layers=2)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a))).astype(np.float32), tree)


def _save_tensors(path, sd):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)


def _assert_trees_equal(got, want):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert np.array_equal(np.asarray(a), np.asarray(b)), p


def _assert_close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 1e-3
    assert np.abs(np.asarray(got) - want).max() <= REL * scale


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[True, False], ids=["rollout", "raw"])
def unet_case(request, tmp_path_factory):
    rollout = request.param
    kw = dict(in_channels=4, model_channels=32, out_channels=4,
              rollout=rollout)
    jcfg, tcfg = JU.UNetConfig(**kw), TU.UNetConfig(**kw)
    params = _perturbed(JU.init_unet(jax.random.PRNGKey(0), jcfg), 1)
    src = str(tmp_path_factory.mktemp("unet") / "ema_0.9999_000010.pt")
    _save_tensors(src, jti.unet_state_dict_from_params(params, jcfg))
    return jcfg, tcfg, params, src


def test_unet_transplant_equals_jax(unet_case):
    jcfg, tcfg, params, src = unet_case
    assert tti.is_torch_file(src)
    tree = tti.unet_params_from_state_dict(tti.load_torch_file(src), tcfg)
    _assert_trees_equal(tree, params)
    assert all(a.flags.c_contiguous for a in jax.tree_util.tree_leaves(tree))

    rng = np.random.default_rng(2)
    H, W, D = 12, 16, 10
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, H, W, 4), (2, H, D, 4), (2, W, D, 4))]
    t = np.array([999, 17], np.int64)
    want = jax.jit(JU.unet_apply, static_argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg,
        JT(*map(jnp.asarray, planes)), jnp.asarray(t, jnp.int32))
    got = TU.unet_apply(unet_params_from_jax(tree), tcfg,
                        TT(*map(torch.from_numpy, planes)),
                        torch.from_numpy(t))
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w)


def test_unet_reverse_mapping_equals_jax(unet_case):
    jcfg, tcfg, params, _ = unet_case
    want = jti.unet_state_dict_from_params(params, jcfg)
    got = tti.unet_state_dict_from_params(params, tcfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k


def test_import_diffusion_ema_reads_in_jax(unet_case, tmp_path):
    jcfg, tcfg, params, src = unet_case
    dst = str(tmp_path / "ema_0.9999_000010.pt")
    tti.import_diffusion_ema(src, dst, tcfg)
    assert not tti.is_torch_file(dst)
    loaded, meta = jckpt.load_pytree(
        dst, JU.init_unet(jax.random.PRNGKey(0), jcfg))
    assert meta["imported_from"] == os.path.abspath(src)
    _assert_trees_equal(loaded, params)


# ---------------------------------------------------------------------------
# AutoEncoder
# ---------------------------------------------------------------------------

AABB = [-1.0, -1.0, -0.6875, 1.0, 1.0, 0.6875]


def _bundle(sd, aabb):
    return {"net": {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in sd.items()},
            "optimizer": {}, "scheduler": {},
            "Ka": [0.0, 0.0, 0.0], "Kd": [1.0, 1.0, 1.0],
            "Ks": [0.4, 0.4, 0.4], "Ns": 10.0, "aabb": aabb,
            "featmap_size": [16, 16, 11]}


@pytest.fixture(scope="module",
                params=[("skip", "sdftex"), ("base", "sdftex"),
                        ("pbr", "sdfpbr")], ids=lambda p: p[0])
def ae_case(request, tmp_path_factory):
    net, data = request.param
    kw = dict(AE_SMALL, enc_net_type=net, data_type=data)
    jcfg, tcfg = jae.AEConfig(**kw), tae.AEConfig(**kw)
    params = _perturbed(jae.init_autoencoder(jax.random.PRNGKey(3), jcfg), 4)
    sd = jti.ae_state_dict_from_params(params, jcfg, aabb=AABB)
    src = str(tmp_path_factory.mktemp("ae") / "ckpt_final.pth")
    torch.save(_bundle(sd, AABB), src)
    return jcfg, tcfg, params, sd, src


def test_ae_transplant_equals_jax(ae_case):
    jcfg, tcfg, params, sd, src = ae_case
    loaded = tti.load_torch_file(src)
    tree, aabb = tti.ae_params_from_state_dict(loaded["net"], tcfg)
    _assert_trees_equal(tree, params)
    np.testing.assert_array_equal(aabb, np.asarray(AABB, np.float32))

    rng = np.random.default_rng(5)
    C = jcfg.fdim_geo + jcfg.fdim_tex
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, 16, 16, C), (1, 16, 11, C), (1, 16, 11, C))]
    pts = rng.uniform(-0.9, 0.9, (500, 3)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jg, jt = jae.process_planes(jparams, jcfg, JT(*map(jnp.asarray, planes)))
    want = jae.decode_points(jparams, jcfg, jg, jt, jnp.asarray(pts),
                             jnp.asarray(aabb))
    tparams = ae_params_from_jax(tree)
    with torch.no_grad():
        tg, tt = tae.process_planes(tparams, tcfg,
                                    TT(*map(torch.from_numpy, planes)))
        got = tae.decode_points(tparams, tcfg, tg, tt, torch.from_numpy(pts),
                                torch.from_numpy(aabb), fused=False)
    want = np.asarray(want)
    assert got.shape == want.shape
    for c in range(want.shape[1]):
        _assert_close(got.numpy()[:, c], want[:, c])


def test_ae_reverse_mapping_equals_jax(ae_case):
    jcfg, tcfg, params, sd, _ = ae_case
    got = tti.ae_state_dict_from_params(params, tcfg, aabb=AABB)
    assert list(got) == list(sd)
    for k in sd:
        assert got[k].dtype == sd[k].dtype and np.array_equal(got[k], sd[k]), k


@pytest.mark.parametrize("aabb_form", ["list", "tensor"])
def test_import_ae_ckpt_reads_in_jax(ae_case, aabb_form, tmp_path):
    """The bundle's aabb as a list or a tensor: the same meta as JAX's
    `ae_bundle_to_tree`, and a container that JAX's AETrainer reads."""
    jcfg, tcfg, params, sd, _ = ae_case
    aabb = AABB if aabb_form == "list" else torch.tensor(AABB)
    src = str(tmp_path / "ref" / "ckpt_final.pth")
    os.makedirs(os.path.dirname(src))
    torch.save(_bundle(sd, aabb), src)
    dst = str(tmp_path / "out" / "ckpt_final.pth")
    tree, meta = tti.import_ae_ckpt(src, dst, tcfg, threshold=0.1875)
    _, want_meta = jti.ae_bundle_to_tree(_bundle(sd, aabb), jcfg,
                                         threshold=0.1875)
    assert meta == dict(want_meta, imported_from=os.path.abspath(src))
    trainer = jtr.AETrainer(os.path.dirname(dst), jcfg,
                            jtr.AETrainerConfig())
    trainer.load_ckpt("final")
    _assert_trees_equal(trainer.params, params)
    assert trainer.meta == meta


def test_port_trainer_evaluates_a_reference_bundle_as_jax(tmp_path,
                                                         monkeypatch):
    """`AETrainer.load_ckpt` on a reference bundle (no grid_shape in its
    meta): the port's evaluate decodes point by point, as JAX's does;
    with fp32 heads its statistics equal JAX's within 1e-5."""
    monkeypatch.setenv("SIN3DM_DECODE_BF16", "0")
    jcfg, tcfg = jae.AEConfig(**AE_SMALL), tae.AEConfig(**AE_SMALL)
    params = _perturbed(jae.init_autoencoder(jax.random.PRNGKey(6), jcfg), 7)
    sd = jti.ae_state_dict_from_params(params, jcfg, aabb=[-1, -1, -1, 1,
                                                           1, 1])
    log = str(tmp_path / "ref")
    os.makedirs(log)
    torch.save(_bundle(sd, [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]),
               os.path.join(log, "ckpt_final.pth"))
    npz = write_npz(str(tmp_path / "s.npz"))
    tcfg_tr = dict(enc_batch_size=512, fm_reso=16)
    port = ttr.AETrainer(log, tcfg, "cpu", ttr.AETrainerConfig(**tcfg_tr))
    port.load_data(npz)
    port.load_ckpt("final")
    assert "grid_shape" not in port.meta
    jt = jtr.AETrainer(log, jcfg, jtr.AETrainerConfig(**tcfg_tr))
    jt.load_data(npz)
    jt.load_ckpt("final")
    got, want = port.evaluate(), jt.evaluate()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Tags, the CLI, refusals
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_tag(tmp_path_factory):
    """The committed tag written in the reference's torch format."""
    dst = str(tmp_path_factory.mktemp("ref_tag") / "tag")
    import_torch_ckpt.main(["--reverse", "--src", TAG, "--dst", dst])
    return dst


def test_import_tag_round_trip_reads_in_jax(ref_tag, tmp_path):
    dst = str(tmp_path / "npz_tag")
    import_torch_ckpt.main(["--src", ref_tag, "--dst", dst])
    name = "ema_0.9999_025000.pt"
    like = jax.eval_shape(lambda k: JU.init_unet(k, JU.UNetConfig()),
                          jax.random.PRNGKey(0))
    got, _ = jckpt.load_pytree(os.path.join(dst, "diffusion", name), like)
    want, _ = jckpt.load_pytree(os.path.join(TAG, "diffusion", name), like)
    _assert_trees_equal(got, want)
    jt = jtr.AETrainer(os.path.join(dst, "encoding"), jae.AEConfig(),
                       jtr.AETrainerConfig())
    jt.load_ckpt("final")
    ref = jtr.AETrainer(os.path.join(TAG, "encoding"), jae.AEConfig(),
                        jtr.AETrainerConfig())
    ref.load_ckpt("final")
    _assert_trees_equal(jt.params, ref.params)
    for k in ("aabb", "featmap_size", "Ka", "Kd", "Ks", "Ns", "threshold"):
        assert jt.meta[k] == ref.meta[k], k


def test_cli_sample_from_a_reference_tag_equals_the_npz_tag(ref_tag,
                                                            tmp_path):
    argv = ["--vox", "--device", "cpu", "--resize", "0.125", "0.125",
            "0.125", "--use_ddim", "true", "--timestep_respacing", "ddim4",
            "--reso", "32", "--n_samples", "1"]
    npz_tag = tmp_path / "npz_tag"
    npz_tag.mkdir()
    for sub in ("encoding", "diffusion"):
        os.symlink(os.path.join(TAG, sub), npz_tag / sub)
    for tag in (ref_tag, str(npz_tag)):
        sample_cli.main(["--tag", tag, "--output", "out"] + argv)
    for name in ("feat.npz", "r32_voxel.npz"):
        with np.load(os.path.join(ref_tag, "out", "000", name)) as a, \
                np.load(npz_tag / "out" / "000" / name) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


class Payload:
    """A custom class: unpickling it would run arbitrary code."""


@pytest.mark.parametrize("payload", ["class", "ndarray"])
def test_refuses_what_weights_only_refuses(tmp_path, payload):
    path = str(tmp_path / "ckpt_final.pth")
    extra = (Payload() if payload == "class"
             else np.asarray(AABB, np.float32))
    torch.save({"net": {"w": torch.zeros(2)}, "aabb": extra}, path)
    assert tti.is_torch_file(path)
    with pytest.raises(ValueError, match="ckpt_final.pth"):
        tti.load_torch_file(path)
    trainer = ttr.AETrainer(str(tmp_path), tae.AEConfig(), "cpu")
    with pytest.raises(ValueError, match="weights_only"):
        trainer.load_ckpt("final")
