"""Port parity: the autoencoder's training half against the JAX package,
in the three AE configurations (skip/sdftex, base/sdftex, pbr/sdfpbr), at
small widths (hidden 32, 2 hidden layers, fdim_up 16) on a 16x24x20
volume, fp32 on the CPU.

- `init_autoencoder`'s leaf paths and shapes, and `geo_param_labels`,
  equal JAX's (the values are each framework's own draws; the parity
  tests carry JAX's over with `ae_params_from_jax`).
- `conv3d` (k4/s2/p1) and `resize_trilinear` (integer and non-integer
  ratios, up and down) within 1e-5 absolute of JAX's.
- `encode` and `forward` within 1e-5 absolute of JAX's.
- `sample_triplane_features` under autograd: the plane grads within 1e-5
  of the largest grad of `jax.grad` of JAX's function.
- The training forward never calls K2 (its wrapper refuses grad).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core import nn as jnn
from sin3dm_tpu.core.checkpoint import _path_str
from sin3dm_tpu.core.gridsample import sample_triplane_features as jstf
from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.models import autoencoder as jae
from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
from sin3dm_tpu_torch.core import checkpoint as tckpt
from sin3dm_tpu_torch.core import nn as tnn
from sin3dm_tpu_torch.core.gridsample import sample_triplane_features as tstf
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.models import autoencoder as tae

torch.set_num_threads(2)
NETS = [("skip", "sdftex"), ("base", "sdftex"), ("pbr", "sdfpbr")]
SMALL = dict(fdim_geo=2, fdim_tex=4, fdim_up=16, hidden_dim=32,
             n_hidden_layers=2)
VOL = (16, 24, 20)
TOL = 1e-5


def _cfgs(net, dt):
    return (jae.AEConfig(data_type=dt, enc_net_type=net, **SMALL),
            tae.AEConfig(data_type=dt, enc_net_type=net, **SMALL))


def _params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jae.init_autoencoder(jax.random.PRNGKey(seed), jcfg))


def _vol(jcfg, seed=1):
    rng = np.random.default_rng(seed)
    c = 1 + (jcfg.tex_channels if jcfg.use_tex else 0)
    return rng.uniform(-0.05, 0.05, (1,) + VOL + (c,)).astype(np.float32)


@pytest.mark.parametrize("net,dt", NETS)
def test_init_autoencoder_layout_and_labels(net, dt):
    jcfg, tcfg = _cfgs(net, dt)
    jp = jae.init_autoencoder(jax.random.PRNGKey(0), jcfg)
    tp = tae.init_autoencoder(torch.Generator().manual_seed(0), tcfg)
    want = [(_path_str(k), tuple(v.shape))
            for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]]
    got = [(p, tuple(v.shape)) for p, v in tckpt.leaves_with_paths(tp)]
    assert got == want
    jl = [(_path_str(k), v) for k, v in jax.tree_util.tree_flatten_with_path(
        jae.geo_param_labels(jp))[0]]
    assert tckpt.leaves_with_paths(tae.geo_param_labels(tp)) == jl
    # zero out convs, unit norms, torch's bounds elsewhere
    for p, v in tckpt.leaves_with_paths(tp):
        if "out_conv" in p:
            assert not v.any(), p
        elif "/norm/" in p:
            assert torch.equal(v, torch.ones_like(v) if p.endswith("g")
                               else torch.zeros_like(v)), p
        else:
            fan_in = (v.shape[0] if v.dim() == 2 and p.endswith("w")
                      else None)
            if fan_in:
                assert v.abs().max() <= fan_in ** -0.5, p


def test_conv3d_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12, 7, 3)).astype(np.float32)
    w = rng.standard_normal((4, 4, 4, 3, 5)).astype(np.float32) * 0.2
    b = rng.standard_normal(5).astype(np.float32)
    want = np.asarray(jnn.conv3d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                 jnp.asarray(x)))
    got = tnn.conv3d({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                     torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 6, 3, 5)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("out", [
    (16, 24, 14),      # integer ratios, up (x2) and down (/2)
    (11, 5, 13),       # non-integer ratios, both directions
    (24, 36, 7),
])
def test_resize_trilinear_matches_jax(out):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 12, 28, 4)).astype(np.float32)
    want = np.asarray(jnn.resize_trilinear(jnp.asarray(x), out))
    got = tnn.resize_trilinear(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape == (1,) + out + (4,)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("net,dt", NETS)
def test_encode_matches_jax(net, dt):
    jcfg, tcfg = _cfgs(net, dt)
    jp = _params(jcfg)
    vol = _vol(jcfg)
    want = jae.encode(jp, jcfg, jnp.asarray(vol))
    got = tae.encode(ae_params_from_jax(jp), tcfg, torch.from_numpy(vol))
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() <= TOL
    assert got.sizes == (VOL[0] // 2, VOL[1] // 2, VOL[2] // 2)
    assert got.channels == jcfg.feat_channels


@pytest.mark.parametrize("net,dt", NETS)
def test_forward_matches_jax(net, dt):
    jcfg, tcfg = _cfgs(net, dt)
    rng = np.random.default_rng(4)
    # perturb the zero out convs so every branch carries signal
    jp = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), _params(jcfg))
    vol = _vol(jcfg)
    aabb = np.array([-0.8, -1.0, -0.9, 0.8, 1.0, 0.9], np.float32)
    pts = rng.uniform(-1.05, 1.05, (500, 3)).astype(np.float32)
    want = np.asarray(jae.forward(jp, jcfg, jnp.asarray(vol),
                                  jnp.asarray(pts), jnp.asarray(aabb)))
    got = tae.forward(ae_params_from_jax(jp), tcfg, torch.from_numpy(vol),
                      torch.from_numpy(pts), torch.from_numpy(aabb))
    assert got.shape == want.shape == (500, 1 + (jcfg.tex_channels))
    assert np.abs(got.numpy() - want).max() <= TOL


def test_plane_grads_match_jax():
    """`sample_triplane_features`' backward (an accumulating index_put of
    the flat gathers) against `jax.grad` of JAX's, border points
    included."""
    rng = np.random.default_rng(5)
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((6, 9, 5), (6, 7, 5), (9, 7, 5))]
    pts = rng.uniform(-1.1, 1.1, (400, 3)).astype(np.float32)
    cot = rng.standard_normal((400, 5)).astype(np.float32)

    def jloss(xy, xz, yz):
        return jnp.sum(jstf(JT(xy, xz, yz), jnp.asarray(pts)) * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, planes))
    tp = [torch.from_numpy(p).requires_grad_() for p in planes]
    (tstf(TT(*tp), torch.from_numpy(pts)) * torch.from_numpy(cot)
     ).sum().backward()
    for w, t in zip(want, tp):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= TOL * np.abs(w).max()


@pytest.mark.parametrize("net,dt", NETS)
def test_training_forward_takes_the_plain_heads(net, dt, monkeypatch):
    """K2 defines no backward: the training forward must not reach it (on
    the CPU its wrapper would compute the plain version, so the call is
    made to fail here), and its gradient reaches every leaf."""
    jcfg, tcfg = _cfgs(net, dt)
    params = tae.init_autoencoder(torch.Generator().manual_seed(1), tcfg)
    for _, v in tckpt.leaves_with_paths(params):
        v.requires_grad_()

    def no_k2(*a, **k):
        raise AssertionError("K2 called in the training forward")

    monkeypatch.setattr(tae, "skip_mlp", no_k2)
    vol = torch.from_numpy(_vol(jcfg))
    aabb = torch.tensor([-1.0, -1, -1, 1, 1, 1])
    pts = torch.rand(300, 3, generator=torch.Generator().manual_seed(2)) \
        * 2 - 1
    out = tae.forward(params, tcfg, vol, pts, aabb)
    leaves = [v for _, v in tckpt.leaves_with_paths(params)]
    grads = torch.autograd.grad(out.square().sum(), leaves,
                                allow_unused=True)
    missing = [p for (p, _), g in zip(tckpt.leaves_with_paths(params), grads)
               if g is None]
    assert missing == []
