"""Port parity: `unet_apply` in fp32 against the JAX `unet_apply`.

Weights come from `init_unet` (perturbed so the zero-initialised out
convs do not hide the torso) and from the committed EMA checkpoint, both
carried over by `compat/from_jax.py`.  fp32 on the CPU; tolerance 1e-4 of
the output scale."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.models import unet as JU
from sin3dm_tpu_torch.compat.from_jax import unet_params_from_jax
from sin3dm_tpu_torch.core import checkpoint as tckpt
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.models import unet as TU
from sin3dm_tpu_torch.ops.fused_conv import conv3x3_rollout_triplane

torch.set_num_threads(2)
EMA = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                   "towerruins", "diffusion", "ema_0.9999_025000.pt")
_apply = jax.jit(JU.unet_apply, static_argnums=1)


def _inputs(seed, B, C, sizes):
    H, W, D = sizes
    rng = np.random.default_rng(seed)
    return ([rng.standard_normal(s).astype(np.float32)
             for s in ((B, H, W, C), (B, H, D, C), (B, W, D, C))],
            np.array([999, 17][:B], np.int64))


def _compare(np_params, jcfg, tcfg, planes, t, rel):
    want = _apply(jax.tree_util.tree_map(jnp.asarray, np_params), jcfg,
                  JT(*map(jnp.asarray, planes)), jnp.asarray(t, jnp.int32))
    got = TU.unet_apply(unet_params_from_jax(np_params), tcfg,
                        TT(*map(torch.from_numpy, planes)),
                        torch.from_numpy(t))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        scale = np.abs(w).max()
        assert scale > 1e-3
        assert np.abs(g.numpy() - w).max() <= rel * scale


@pytest.mark.parametrize("rollout", [True, False])
def test_init_weights_fp32(rollout):
    jcfg = JU.UNetConfig(in_channels=4, model_channels=32, out_channels=4,
                         rollout=rollout)
    tcfg = TU.UNetConfig(in_channels=4, model_channels=32, out_channels=4,
                         rollout=rollout)
    params = jax.tree_util.tree_map(
        np.asarray, JU.init_unet(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), params)
    planes, t = _inputs(1, 2, 4, (12, 16, 10))
    _compare(params, jcfg, tcfg, planes, t, 1e-4)


@pytest.mark.parametrize("sizes", [(15, 16, 10), (16, 16, 12)])
def test_committed_ema_fp32(sizes):
    """Full-width towerruins UNet; odd sizes take the avg-pool floor and
    the bilinear `_resize_to` fix-up before the skip concat."""
    params, _ = tckpt.load_tree(EMA)
    planes, t = _inputs(2, 1, 12, sizes)
    _compare(params, JU.UNetConfig(), TU.UNetConfig(), planes, t, 1e-4)


def test_k1_launch_count_per_forward(monkeypatch):
    """Every 3x3 conv of a forward goes through K1's triplane wrapper,
    once per triplane conv (one kernel launch in bf16 on the card): 8 per
    forward; the 192-channel conv is one call (the JAX kernel splits it
    and launches once per plane)."""
    cfg = TU.UNetConfig()
    params, _ = tckpt.load_tree(EMA)
    calls = []

    def counting(xs, ws, *rest, **kw):
        assert len(xs) == len(ws) == 3
        calls.append(tuple(ws[0].shape))
        return conv3x3_rollout_triplane(xs, ws, *rest, **kw)

    monkeypatch.setattr(TU, "conv3x3_rollout_triplane", counting)
    planes, t = _inputs(3, 1, 12, (8, 8, 6))
    TU.unet_apply(unet_params_from_jax(params), cfg,
                  TT(*map(torch.from_numpy, planes)), torch.from_numpy(t))
    assert len(calls) == TU.k1_launches_per_forward(cfg) == 8
    assert sum(s[2] == 192 for s in calls) == 1
