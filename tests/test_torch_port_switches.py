"""The kernels' opt-out switches, against the JAX package.

- `SIN3DM_FUSED_CONV=0`: `cli.sample` builds a UNet config with
  `fused_conv` off, and `unet_apply` then takes no K1 call (nor the
  opt-in configurations, which need it) and equals JAX's
  `fused_conv=False` forward: 1e-4 of the output scale in fp32; in bf16
  the bound of `tests/test_torch_port_unet_bf16.py` (2x JAX's bf16
  distance from fp32 plus 1 %, and 4 % of JAX's bf16 output).
- `SIN3DM_FUSED_HEADS`: parsed as JAX's `AETrainer._fused_heads` where
  set; "0" takes no K2 call and the decode equals JAX's unfused (fp32)
  heads within 1e-5, whatever `SIN3DM_DECODE_BF16` says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.models import autoencoder as jae
from sin3dm_tpu.models import unet as JU
from sin3dm_tpu.training.ae import AETrainer as JTrainer
from sin3dm_tpu.training.ae import AETrainerConfig as JTCfg
from sin3dm_tpu_torch.cli import sample as sample_cli
from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax, \
    unet_params_from_jax
from sin3dm_tpu_torch.core import config as cfgmod
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.models import autoencoder as tae
from sin3dm_tpu_torch.models import unet as TU

torch.set_num_threads(2)
SIZES = (12, 16, 10)
CONFIGS = [("skip", "sdftex"), ("base", "sdftex"), ("pbr", "sdfpbr")]
SMALL = dict(fdim_up=16, hidden_dim=32, n_hidden_layers=2)


def _unet(seed=0):
    jcfg = JU.UNetConfig(model_channels=32)
    params = jax.tree_util.tree_map(
        np.asarray, JU.init_unet(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), params)
    H, W, D = SIZES
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, H, W, 12), (2, H, D, 12), (2, W, D, 12))]
    return jcfg, params, planes, np.array([500, 20], np.int64)


def _port(params, tcfg, planes, t):
    return TU.unet_apply(unet_params_from_jax(params), tcfg,
                         TT(*map(torch.from_numpy, planes)),
                         torch.from_numpy(t))


def _no_k1(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("K1 called with fused_conv off")
    monkeypatch.setattr(TU, "conv3x3_rollout_triplane", refuse)


@pytest.mark.parametrize("value,fused", [(None, True), ("1", True),
                                         ("0", False)])
def test_sample_cli_reads_fused_conv(monkeypatch, value, fused):
    if value is None:
        monkeypatch.delenv("SIN3DM_FUSED_CONV", raising=False)
    else:
        monkeypatch.setenv("SIN3DM_FUSED_CONV", value)
    args = cfgmod.sample_args(["--tag", "checkpoints/towerruins", "--vox"])
    ucfg = sample_cli._unet_config(args)
    assert ucfg.fused_conv is fused
    assert (TU.k1_launches_per_forward(ucfg) == 8) is fused


@pytest.mark.parametrize("opt_in", [None, "SIN3DM_FUSED_ACT",
                                    "SIN3DM_STATS_CHAIN"])
def test_fused_conv_off_fp32_matches_jax(monkeypatch, opt_in):
    """No K1 call; the opt-in configurations are ignored, as in JAX."""
    jcfg, params, planes, t = _unet()
    want = jax.jit(JU.unet_apply, static_argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg,
        JT(*map(jnp.asarray, planes)), jnp.asarray(t, jnp.int32))
    if opt_in:
        monkeypatch.setenv(opt_in, "1")
    _no_k1(monkeypatch)
    tcfg = TU.UNetConfig(model_channels=32, fused_conv=False)
    assert TU.k1_launches_by_form(tcfg) == {}
    got = _port(params, tcfg, planes, t)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        scale = np.abs(w).max()
        assert scale > 1e-3
        assert np.abs(g.numpy() - w).max() <= 1e-4 * scale


def test_fused_conv_off_bf16_matches_jax(monkeypatch):
    jcfg, params, planes, t = _unet(1)
    apply = jax.jit(JU.unet_apply, static_argnums=1)
    jx, jt = JT(*map(jnp.asarray, planes)), jnp.asarray(t, jnp.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref32 = apply(jp, jcfg, jx, jt)
    ref16 = apply(jp, jcfg._replace(compute_dtype=jnp.bfloat16,
                                    fast_norm=True), jx, jt)
    _no_k1(monkeypatch)
    got = _port(params, TU.UNetConfig(
        model_channels=32, compute_dtype=torch.bfloat16, fast_norm=True,
        fused_conv=False), planes, t)
    for g, r32, r16 in zip(got, ref32, ref16):
        g, r32, r16 = g.numpy(), np.asarray(r32), np.asarray(r16)
        scale = np.abs(r32).max()
        jax_err = np.abs(r16 - r32).max()
        assert np.abs(g - r32).max() <= 2 * jax_err + 0.01 * scale
        assert np.abs(g - r16).max() <= 0.04 * scale


@pytest.mark.parametrize("value", ["0", "false", "", "1", "true"])
def test_fused_heads_parsed_as_jax(monkeypatch, value):
    monkeypatch.setenv("SIN3DM_FUSED_HEADS", value)
    jt = JTrainer("unused", jae.AEConfig(**SMALL), JTCfg())
    assert tae.fused_heads() is jt._fused_heads()
    monkeypatch.delenv("SIN3DM_FUSED_HEADS")
    assert tae.fused_heads()          # unset: K2 (JAX: K2 on accelerators)


def _ae(net, dt, seed=0):
    jcfg = jae.AEConfig(data_type=dt, enc_net_type=net, **SMALL)
    tcfg = tae.AEConfig(data_type=dt, enc_net_type=net, **SMALL)
    jp = jae.init_autoencoder(jax.random.PRNGKey(seed), jcfg)
    tp = ae_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    H, W, D = 8, 10, 6
    feat = [(0.5 * rng.standard_normal(s)).astype(np.float32)
            for s in ((1, H, W, jcfg.feat_channels),
                      (1, H, D, jcfg.feat_channels),
                      (1, W, D, jcfg.feat_channels))]
    jgp, jtp = jax.jit(lambda p, f: jae.process_planes(p, jcfg, f))(
        jp, JT(*map(jnp.asarray, feat)))
    return jcfg, tcfg, jp, tp, jgp, jtp


def _counting_k2(monkeypatch):
    calls = []
    real = tae.skip_mlp

    def counting(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)
    monkeypatch.setattr(tae, "skip_mlp", counting)
    return calls


@pytest.mark.parametrize("net,dt", CONFIGS)
def test_fused_heads_off_decode_matches_jax_unfused(monkeypatch, net, dt):
    """bf16 decode operands left on (the default): the switch alone sends
    the heads through the plain fp32 linears, as JAX's unfused decode."""
    monkeypatch.delenv("SIN3DM_DECODE_BF16", raising=False)
    jcfg, tcfg, jp, tp, jgp, jtp = _ae(net, dt)
    rng = np.random.default_rng(2)
    aabb = np.array([-0.8, -1.0, -0.6, 0.8, 1.0, 0.6], np.float32)
    pts = rng.uniform(-1.0, 1.0, (2000, 3)).astype(np.float32) * aabb[3:]
    res = (9, 11, 7)
    want_pts = np.asarray(jax.jit(
        lambda p, g, t, x, a: jae.decode_points(p, jcfg, g, t, x, a))(
            jp, jgp, jtp, jnp.asarray(pts), jnp.asarray(aabb)))
    want_grid = np.asarray(jax.jit(
        lambda p, g, t: jae.decode_grid_dense(p, jcfg, g, t, res, slab=4))(
            jp, jgp, jtp))

    def t(tri):
        return TT(*[torch.from_numpy(np.array(a)) for a in tri])

    calls = _counting_k2(monkeypatch)
    monkeypatch.setenv("SIN3DM_FUSED_HEADS", "0")
    with torch.no_grad():
        got_pts = tae.decode_points(tp, tcfg, t(jgp), t(jtp),
                                    torch.from_numpy(pts),
                                    torch.from_numpy(aabb)).numpy()
    got_grid = tae.decode_grid_dense(tp, tcfg, t(jgp), t(jtp), res,
                                     slab=4).numpy()
    assert calls == []
    assert np.abs(got_pts - want_pts).max() <= 1e-5
    assert np.abs(got_grid - want_grid).max() <= 1e-5
    # unset, the skip heads take K2's wrapper (its plain version here)
    monkeypatch.delenv("SIN3DM_FUSED_HEADS")
    tae.decode_grid_dense(tp, tcfg, t(jgp), t(jtp), res, slab=4)
    n_heads = {"skip": 2, "base": 0, "pbr": 4}[net]
    assert len(calls) == n_heads * -(-res[0] // 4)
