"""Port parity of the UNet's two opt-in configurations, under
`SIN3DM_STATS_CHAIN=1` (GroupNorm statistics chained through K1′'s
epilogues) and `SIN3DM_FUSED_ACT=1` (norm + FiLM + SiLU inside K1′),
against the JAX `unet_apply` with `fused_conv=True` and the same switch,
its Pallas kernel in interpret mode.

bf16 bound, that of `tests/test_torch_port_unet_bf16.py`: the port's
output is no further from the fp32 forward than 2x the JAX bf16 output's
distance from it (plus 1% of the output scale), and within 4% of the
output scale of the JAX bf16 output.  fp32 fused-act: summation order
only (JAX applies the coefficients outside its kernel in fp32, the port
inside), 2e-5 of the output scale."""

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
from sin3dm_tpu_torch.ops.fused_conv import (conv3x3_rollout_triplane,
                                             form_name)

torch.set_num_threads(2)
EMA = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                   "towerruins", "diffusion", "ema_0.9999_025000.pt")
SWITCHES = ("SIN3DM_STATS_CHAIN", "SIN3DM_FUSED_ACT")


def _set(monkeypatch, switch):
    for s in SWITCHES:
        monkeypatch.setenv(s, "1" if s == switch else "0")


def _params(mc, seed=0):
    jcfg = JU.UNetConfig(model_channels=mc)
    params = jax.tree_util.tree_map(
        np.asarray, JU.init_unet(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), params)


def _inputs(sizes, seed=1):
    H, W, D = sizes
    rng = np.random.default_rng(seed)
    return ([rng.standard_normal(s).astype(np.float32)
             for s in ((2, H, W, 12), (2, H, D, 12), (2, W, D, 12))],
            np.array([500, 20], np.int64))


def _jax(params, jcfg, planes, t):
    # a fresh jit per call: the switches are read while tracing
    fn = jax.jit(lambda p, x, tt: JU.unet_apply(p, jcfg, x, tt))
    out = fn(jax.tree_util.tree_map(jnp.asarray, params),
             JT(*map(jnp.asarray, planes)), jnp.asarray(t, jnp.int32))
    return [np.asarray(o, np.float32) for o in out]


def _port(params, tcfg, planes, t):
    out = TU.unet_apply(unet_params_from_jax(params), tcfg,
                        TT(*map(torch.from_numpy, planes)),
                        torch.from_numpy(t))
    return [o.float().numpy() for o in out]


@pytest.mark.parametrize("switch", SWITCHES)
def test_bf16_matches_jax_bf16_fused(monkeypatch, switch):
    params = _params(32)
    planes, t = _inputs((12, 16, 10))
    _set(monkeypatch, None)
    ref32 = _jax(params, JU.UNetConfig(model_channels=32), planes, t)
    _set(monkeypatch, switch)
    ref16 = _jax(params, JU.UNetConfig(
        model_channels=32, compute_dtype=jnp.bfloat16, fast_norm=True,
        fused_conv=True), planes, t)
    got = _port(params, TU.UNetConfig(
        model_channels=32, compute_dtype=torch.bfloat16, fast_norm=True),
        planes, t)
    for g, r32, r16 in zip(got, ref32, ref16):
        scale = np.abs(r32).max()
        jax_err = np.abs(r16 - r32).max()
        port_err = np.abs(g - r32).max()
        assert port_err <= 2 * jax_err + 0.01 * scale, (port_err, jax_err)
        assert np.abs(g - r16).max() <= 0.04 * scale


@pytest.mark.parametrize("rollout", [True, False])
def test_fp32_fused_act_matches_jax(monkeypatch, rollout):
    """In fp32 JAX runs its convs without the kernel and applies the
    coefficients outside; the port applies them inside K1′.  The
    non-rollout case is the plain 3x3 conv with `act`."""
    jcfg = JU.UNetConfig(model_channels=32, rollout=rollout)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.05), JU.init_unet(
            jax.random.PRNGKey(2), jcfg))
    planes, t = _inputs((12, 16, 10), seed=3)
    _set(monkeypatch, "SIN3DM_FUSED_ACT")
    want = _jax(params, jcfg._replace(fused_conv=True), planes, t)
    got = _port(params, TU.UNetConfig(model_channels=32, rollout=rollout,
                                      fast_norm=True), planes, t)
    for g, w in zip(got, want):
        scale = np.abs(w).max()
        assert scale > 1e-3
        assert np.abs(g - w).max() <= 2e-5 * scale


def test_fp32_ignores_the_stats_chain(monkeypatch):
    """Like JAX, the chain runs only for a 2-byte compute dtype."""
    params = _params(32)
    planes, t = _inputs((12, 16, 10))
    tcfg = TU.UNetConfig(model_channels=32, fast_norm=True)
    _set(monkeypatch, None)
    want = _port(params, tcfg, planes, t)
    _set(monkeypatch, "SIN3DM_STATS_CHAIN")
    for g, w in zip(_port(params, tcfg, planes, t), want):
        np.testing.assert_array_equal(g, w)


def _spy(monkeypatch, module):
    """Record the input width of every block `module` runs chained."""
    seen = []
    real = module._resblock_apply_stats

    def spy(p, t, *rest):
        seen.append(t.channels)
        return real(p, t, *rest)

    monkeypatch.setattr(module, "_resblock_apply_stats", spy)
    return seen


def test_port_chains_the_blocks_jax_chains(monkeypatch):
    """At the towerruins widths (model_channels 64, mult (1, 2)) both
    chain the three blocks with inputs of at most 128 channels and leave
    the 192-channel up block unchained."""
    params, _ = tckpt.load_tree(EMA)
    planes, t = _inputs((8, 12, 6))
    _set(monkeypatch, "SIN3DM_STATS_CHAIN")
    jax_seen, port_seen = _spy(monkeypatch, JU), _spy(monkeypatch, TU)
    _jax(params, JU.UNetConfig(compute_dtype=jnp.bfloat16, fast_norm=True,
                               fused_conv=True), planes, t)
    _port(params, TU.UNetConfig(compute_dtype=torch.bfloat16,
                                fast_norm=True), planes, t)
    assert port_seen == jax_seen == [64, 64, 128]


@pytest.mark.parametrize("switch", (None,) + SWITCHES)
def test_k1_forms_per_forward(monkeypatch, switch):
    """Every 3x3 conv goes through K1's triplane wrapper (one launch per
    triplane conv in bf16 on the card) in the form `k1_launches_by_form`
    says: at towerruins widths 8 default launches, or 3 act+stats + 3
    act+skip+stats + 2 default under the stats chain, or 8 act under the
    fused act."""
    params, _ = tckpt.load_tree(EMA)
    planes, t = _inputs((8, 12, 6))
    _set(monkeypatch, switch)
    forms = {}

    def counting(xs, ws, bs, col3s, row3s, acts=(None,) * 3,
                 skips=(None,) * 3, emit_stats=False, packed=None):
        f = form_name(acts[0] is not None, skips[0] is not None, emit_stats)
        forms[f] = forms.get(f, 0) + 1
        return conv3x3_rollout_triplane(xs, ws, bs, col3s, row3s, acts,
                                        skips, emit_stats, packed)

    monkeypatch.setattr(TU, "conv3x3_rollout_triplane", counting)
    tcfg = TU.UNetConfig(compute_dtype=torch.bfloat16, fast_norm=True)
    _port(params, tcfg, planes, t)
    assert forms == TU.k1_launches_by_form(tcfg)
    assert sum(forms.values()) == TU.k1_launches_per_forward(tcfg) == 8
    want = {None: {"default": 8}, "SIN3DM_FUSED_ACT": {"act": 8},
            "SIN3DM_STATS_CHAIN": {"act+stats": 3, "act+skip+stats": 3,
                                   "default": 2}}[switch]
    assert forms == want


def test_stats_chain_guard_on_the_out_conv_width(monkeypatch):
    """model_channels 96, mult (1, 2): the level-1 down block's out conv
    takes 192 channels.  JAX chains that block and raises; the port
    leaves it unchained, and its chained forward matches its unchained
    one within the bf16 bound of the JAX package's own stats-chain test
    (`tests/test_fused_conv.py`: 0.05 abs + 0.05 rel, mean < 5e-3)."""
    params = _params(96)
    planes, t = _inputs((8, 12, 6))
    _set(monkeypatch, "SIN3DM_STATS_CHAIN")
    with pytest.raises(ValueError, match="emit_stats"):
        _jax(params, JU.UNetConfig(model_channels=96,
                                   compute_dtype=jnp.bfloat16,
                                   fast_norm=True, fused_conv=True),
             planes, t)
    tcfg = TU.UNetConfig(model_channels=96, compute_dtype=torch.bfloat16,
                         fast_norm=True)
    seen = _spy(monkeypatch, TU)
    got = _port(params, tcfg, planes, t)
    assert seen == [96]          # only the level-0 down block chains
    _set(monkeypatch, None)
    want = _port(params, tcfg, planes, t)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0.05, atol=0.05)
        assert np.abs(g - w).mean() < 5e-3
