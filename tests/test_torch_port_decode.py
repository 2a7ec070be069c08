"""Port parity of the mesh path's decode: plane sampling, the point
decode, the int8 dense sdf grid and the texel decode over the run-length
wire, against the JAX package on the same numpy inputs.  fp32 heads on
both sides (SIN3DM_DECODE_BF16=0; the JAX side takes its XLA heads on
the CPU, the port `skip_mlp_reference`)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core import checkpoint as jckpt
from sin3dm_tpu.core.gridsample import sample_triplane_features as j_sample
from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.core.triplane import load_triplane_npz as jload
from sin3dm_tpu.models import autoencoder as jae
from sin3dm_tpu.training.ae import AETrainer as JTrainer
from sin3dm_tpu.training.ae import AETrainerConfig as JTCfg
from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
from sin3dm_tpu_torch.core import checkpoint as tckpt
from sin3dm_tpu_torch.core.gridsample import sample_triplane_features
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.core.triplane import load_triplane_npz as tload
from sin3dm_tpu_torch.dataio.grid import grid_resolutions
from sin3dm_tpu_torch.geometry import meshproc, uvatlas
from sin3dm_tpu_torch.models import autoencoder as tae
from sin3dm_tpu_torch.training.ae import AETrainer as TTrainer

torch.set_num_threads(2)
ENC = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                   "towerruins", "encoding")
CONFIGS = [("skip", "sdftex"), ("base", "sdftex"), ("pbr", "sdfpbr")]
SMALL = dict(fdim_up=16, hidden_dim=32, n_hidden_layers=2)


@pytest.fixture(autouse=True)
def _fp32_heads(monkeypatch):
    monkeypatch.setenv("SIN3DM_DECODE_BF16", "0")


def _planes(rng, sizes, c, scale=0.5):
    H, W, D = sizes
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in ((1, H, W, c), (1, H, D, c), (1, W, D, c))]


def _models(net, dt, seed=0):
    """JAX AE params (small widths) and their port copy."""
    jcfg = jae.AEConfig(data_type=dt, enc_net_type=net, **SMALL)
    tcfg = tae.AEConfig(data_type=dt, enc_net_type=net, **SMALL)
    jp = jae.init_autoencoder(jax.random.PRNGKey(seed), jcfg)
    tp = ae_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def test_sample_triplane_features_matches_jax():
    """Random planes and points, a fifth of them outside [-1, 1] (border
    padding): max abs <= 1e-6."""
    rng = np.random.default_rng(0)
    planes = [p[0] for p in _planes(rng, (9, 13, 7), 5, scale=1.0)]
    pts = rng.uniform(-1.0, 1.0, (4000, 3)).astype(np.float32)
    pts[:800] *= 1.4
    want = np.asarray(j_sample(JT(*map(jnp.asarray, planes)),
                               jnp.asarray(pts)))
    got = sample_triplane_features(TT(*map(torch.from_numpy, planes)),
                                   torch.from_numpy(pts)).numpy()
    assert got.shape == want.shape == (4000, 5)
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("net,dt", CONFIGS)
def test_decode_points_matches_jax(net, dt):
    """The same processed planes into both point decodes: <= 1e-5 abs."""
    jcfg, tcfg, jp, tp = _models(net, dt)
    rng = np.random.default_rng(1)
    feat = _planes(rng, (8, 10, 6), jcfg.feat_channels)
    jgp, jtp = jax.jit(lambda p, f: jae.process_planes(p, jcfg, f))(
        jp, JT(*map(jnp.asarray, feat)))
    aabb = np.array([-0.8, -1.0, -0.6, 0.8, 1.0, 0.6], np.float32)
    pts = rng.uniform(-1.0, 1.0, (3000, 3)).astype(np.float32) * aabb[3:]
    want = np.asarray(jax.jit(
        lambda p, g, t, x, a: jae.decode_points(p, jcfg, g, t, x, a))(
            jp, jgp, jtp, jnp.asarray(pts), jnp.asarray(aabb)))

    def t(tri):
        return TT(*[torch.from_numpy(np.array(a)) for a in tri])

    got = tae.decode_points(tp, tcfg, t(jgp), t(jtp), torch.from_numpy(pts),
                            torch.from_numpy(aabb)).numpy()
    assert got.shape == want.shape == (3000, 1 + jcfg.tex_channels)
    assert np.abs(got - want).max() <= 1e-5


@pytest.fixture(scope="module")
def sphere_atlas():
    """A decimated marching-cubes sphere and its UV atlas, built with the
    port's own geometry (`tests/test_texel_runs.py`'s fixture)."""
    n = 48
    g = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    sdf = (np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.7).astype(np.float32)
    v, f = meshproc.sdfgrid_to_mesh(sdf)
    v = v / n * 2 - 1
    v, f = meshproc.mesh_decimation(v, f, 800)
    return v, f


def _trainers(net, dt, seed=0):
    jcfg, tcfg, jp, tp = _models(net, dt, seed)
    meta = {"aabb": [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], "threshold": 0.05,
            "featmap_size": [8, 8, 8]}
    jt = JTrainer("unused", jcfg, JTCfg())
    jt.params, jt.meta = jp, dict(meta)
    tt = TTrainer("unused", tcfg, "cpu")
    tt.params, tt.meta = tp, dict(meta)
    return jcfg, jt, tt


@pytest.mark.parametrize("net,dt", CONFIGS)
def test_decode_texels_runs_matches_jax(sphere_atlas, net, dt):
    """The texel decode over the run-length wire (the compact u16/f16
    pack), packed and expanded by each trainer from the same runs: uint8
    within 1, fewer than 1 % of the values differing."""
    v, f = sphere_atlas
    _, _, _, runs = uvatlas.uv_unwrap_and_rasterize_runs(v, f, 128)
    jcfg, jt, tt = _trainers(net, dt)
    rng = np.random.default_rng(2)
    feat = _planes(rng, (8, 8, 8), jcfg.feat_channels)
    aabb = np.asarray(jt.meta["aabb"])
    chunks, n = jt._dispatch_texels_runs(JT(*map(jnp.asarray, feat)), runs,
                                         aabb)
    want = np.concatenate([np.asarray(c) for c in chunks])[:n]
    fetch, n2 = tt._dispatch_texels_runs(TT(*map(torch.from_numpy, feat)),
                                         runs, aabb)
    got = np.concatenate(fetch.wait())[:n2]
    assert n == n2 == int(runs[:, 6].sum()) > 1000
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def test_int8_dense_grid_matches_jax():
    """The committed towerruins AE on the tag's feat.npz at reso 64:
    `decode_grid_dense(geo_only=True, quant_scale=thr)`.  Every voxel has
    JAX's sign; voxels that differ do so by one bucket (an fp32 value at a
    bucket edge), at most 1e-3 of them; the port's grid is exactly numpy's
    floor(clip(fp32 / thr, -1, 1) * 127) of its own fp32 grid."""
    like = jae.init_autoencoder(jax.random.PRNGKey(0), jae.AEConfig())
    jparams, meta = jckpt.load_subtree(os.path.join(ENC, "ckpt_final.pth"),
                                       like, "params")
    tree, _ = tckpt.load_tree(os.path.join(ENC, "ckpt_final.pth"), "params")
    tparams = ae_params_from_jax(tree)
    thr = float(meta["threshold"])
    res = tuple(int(x) for x in grid_resolutions(np.asarray(meta["aabb"]),
                                                 64))
    jfeat = jload(os.path.join(ENC, "feat.npz")).map(lambda p: p[None])
    want = np.asarray(jax.jit(lambda p, f: jae.decode_grid_dense(
        p, jae.AEConfig(), *jae.process_planes(p, jae.AEConfig(), f), res,
        8, True, False, None, thr))(jparams, jfeat))[..., 0]
    tfeat = tload(os.path.join(ENC, "feat.npz")).map(lambda p: p[None])
    tgp, ttp = tae.process_planes(tparams, tae.AEConfig(), tfeat)
    got = tae.decode_grid_dense(tparams, tae.AEConfig(), tgp, ttp, res,
                                geo_only=True, quant_scale=thr)[..., 0]
    got = got.numpy()
    assert got.dtype == want.dtype == np.int8 and got.shape == res
    np.testing.assert_array_equal(got < 0, want < 0)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"int8 grid {res}: {int((d > 0).sum())} of {d.size} voxels "
          "differ by one bucket")
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3
    f32 = tae.decode_grid_dense(tparams, tae.AEConfig(), tgp, ttp, res,
                                geo_only=True)[..., 0].numpy()
    one = np.float32(1.0)
    np.testing.assert_array_equal(got, np.floor(
        np.clip(f32 / np.float32(thr), -one, one) * np.float32(127.0)
    ).astype(np.int8))
    # the fp16 form of the sdf data type: the fp32 grid rounded once
    f16 = tae.decode_grid_dense(tparams, tae.AEConfig(), tgp, ttp, res,
                                geo_only=True, out_dtype=torch.float16)
    assert f16.dtype == torch.float16 and f16.shape == res + (1,)
    assert (np.floor(np.clip(f16.float().numpy()[..., 0] / thr, -1, 1)
                     * 127) < 0).mean() == pytest.approx((want < 0).mean(),
                                                         abs=1e-3)
