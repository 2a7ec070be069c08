"""Port parity: the UNet's training form against the JAX package.

- `init_unet`: JAX's tree paths and shapes; zero convs exactly zero; the
  other leaves inside +-1/sqrt(fan_in), their std within 5 % of the
  uniform's (pooled over every leaf, and per leaf of 4096 or more
  elements).
- `unet_train_apply` in fp32 against JAX's `unet_apply` (its
  `fused_conv=False` route): max abs <= 1e-5 (1 + max |ref|); the grads of
  a fixed loss against `jax.grad`, per leaf within 1e-4 of that leaf's
  largest |g|, also with `use_checkpoint`.  The zero convs take small
  random values first, so every leaf has a gradient.
- bf16 compute (`use_fp16`: bf16 torso, `fast_norm`) at the bound of
  `test_torch_port_unet_bf16.py`.
- The training forward equals the sampler's K1 forward (its plain version
  on the CPU) to 1e-5 (1 + max |ref|); a grad-enabled call into K1 raises.

A narrow UNet (channel_mult (1, 2)) on 8x12x6 planes: model_channels 32
for `init_unet`, 64 where every leaf must have a gradient (at 32 channels
GroupNorm32 holds one channel per group and cancels the bias of each conv
before it exactly).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core.checkpoint import _path_str
from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.models import unet as JU
from sin3dm_tpu_torch.compat.from_jax import unet_params_from_jax
from sin3dm_tpu_torch.core import checkpoint as tckpt
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.models import unet as TU
from sin3dm_tpu_torch.ops import fused_conv as tfc

torch.set_num_threads(2)
C, B = 4, 2
SIZES = (8, 12, 6)


def _cfgs(mc=64, **kw):
    return (JU.UNetConfig(in_channels=C, model_channels=mc, out_channels=C,
                          **kw),
            TU.UNetConfig(in_channels=C, model_channels=mc, out_channels=C,
                          **kw))


def _params(seed=0, **kw):
    jcfg, _ = _cfgs(**kw)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
                   ).astype(np.float32),
        JU.init_unet(jax.random.PRNGKey(seed), jcfg))


def _inputs(seed=1):
    H, W, D = SIZES
    rng = np.random.default_rng(seed)
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, H, W, C), (B, H, D, C), (B, W, D, C))]
    R = [rng.standard_normal(p.shape).astype(np.float32) for p in planes]
    return planes, np.array([999, 17], np.int64), R


def _leaves(tree):
    return {_path_str(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _fan_in(path, shapes):
    w = shapes[path.rsplit("/", 1)[0] + "/w"]
    return math.prod(w[:-1])


def test_init_unet_tree_and_distributions():
    jcfg, tcfg = _cfgs(32)
    want = {p: v.shape for p, v in
            _leaves(JU.init_unet(jax.random.PRNGKey(0), jcfg)).items()}
    got = dict(tckpt.leaves_with_paths(
        TU.init_unet(torch.Generator().manual_seed(0), tcfg)))
    assert list(got) == list(want)
    shapes = {p: tuple(v.shape) for p, v in got.items()}
    assert shapes == {p: tuple(s) for p, s in want.items()}
    pooled = []
    for p, v in got.items():
        v = v.numpy()
        assert v.dtype == np.float32
        name = p.rsplit("/", 1)[1]
        if "out_conv" in p or p.startswith("out/conv"):
            assert not v.any(), p                  # zero-initialised
        elif p.rsplit("/", 2)[-2] in ("xy", "xz", "yz") and "norm" in p:
            assert (v == (1.0 if name == "g" else 0.0)).all(), p
        else:
            bound = 1.0 / math.sqrt(_fan_in(p, shapes))
            assert np.abs(v).max() <= bound, p
            pooled.append(v.ravel() / bound)
            if v.size >= 4096:
                assert abs(v.std() / (bound / math.sqrt(3)) - 1) < 0.05, p
    pooled = np.concatenate(pooled)
    assert abs(pooled.std() * math.sqrt(3) - 1) < 0.05


def _jax_loss(jcfg, planes, t, R):
    def loss(p):
        out = JU.unet_apply(p, jcfg, JT(*map(jnp.asarray, planes)),
                            jnp.asarray(t, jnp.int32))
        return sum(jnp.mean(o * r) for o, r in zip(out, R)), out
    return loss


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """JAX's forward and grads of the fixed loss (one compile for both
    forms of the port)."""
    jcfg, _ = _cfgs()
    planes, t, R = _inputs()
    (_, want), jg = jax.jit(jax.value_and_grad(
        _jax_loss(jcfg, planes, t, R), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, _params()))
    return [np.asarray(w) for w in want], _leaves(jg)


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_train_forward_and_grads_match_jax(use_checkpoint):
    _, tcfg = _cfgs(use_checkpoint=use_checkpoint)
    planes, t, R = _inputs()
    want, jgl = _jax_reference()
    tp = unet_params_from_jax(_params())
    leaves = [v.requires_grad_(True) for _, v in
              tckpt.leaves_with_paths(tp)]
    out = TU.unet_train_apply(tp, tcfg, TT(*map(torch.from_numpy, planes)),
                              torch.from_numpy(t))
    for o, w in zip(out, want):
        assert o.shape == w.shape and o.dtype == torch.float32
        assert np.abs(o.detach().numpy() - w).max() \
            <= 1e-5 * (1 + np.abs(w).max())
    loss = sum((o * torch.from_numpy(r)).mean() for o, r in zip(out, R))
    grads = torch.autograd.grad(loss, leaves)
    for (p, _), g in zip(tckpt.leaves_with_paths(tp), grads):
        w = jgl[p]
        scale = np.abs(w).max()
        assert scale > 0, p                      # every leaf has a gradient
        assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, p


def test_fp64_train_forward_stays_fp64():
    """fp64 parameters and compute (a reference run) keep fp64 through the
    norms' statistics and the timestep embedding, and agree with JAX's
    fp32 forward and grads at the fp32 tolerances."""
    _, tcfg = _cfgs()
    planes, t, R = _inputs()
    want, jgl = _jax_reference()
    tp = unet_params_from_jax(_params())
    leaves = [v.double().requires_grad_(True) for _, v in
              tckpt.leaves_with_paths(tp)]
    tp = tckpt.unflatten_like(tp, leaves)
    out = TU.unet_train_apply(
        tp, tcfg._replace(compute_dtype=torch.float64),
        TT(*[torch.from_numpy(p).double() for p in planes]),
        torch.from_numpy(t))
    for o, w in zip(out, want):
        assert o.dtype == torch.float64
        assert np.abs(o.detach().numpy() - w).max() \
            <= 1e-5 * (1 + np.abs(w).max())
    loss = sum((o * torch.from_numpy(r)).mean() for o, r in zip(out, R))
    grads = torch.autograd.grad(loss, leaves)
    for (p, _), g in zip(tckpt.leaves_with_paths(tp), grads):
        assert g.dtype == torch.float64, p
        w = jgl[p]
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), p


def test_bf16_train_forward_close_to_jax_bf16():
    """The bound of test_torch_port_unet_bf16.py: no further from the fp32
    forward than 2x JAX bf16's distance from it plus 1 % of the output
    scale, and within 4 % of the scale of JAX bf16."""
    jcfg, tcfg = _cfgs()
    params = _params(2)
    planes, t, _ = _inputs(3)
    apply = jax.jit(JU.unet_apply, static_argnums=1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jx, jt = JT(*map(jnp.asarray, planes)), jnp.asarray(t, jnp.int32)
    ref32 = apply(jp, jcfg, jx, jt)
    ref16 = apply(jp, jcfg._replace(compute_dtype=jnp.bfloat16,
                                    fast_norm=True), jx, jt)
    got = TU.unet_train_apply(
        unet_params_from_jax(params),
        tcfg._replace(compute_dtype=torch.bfloat16, fast_norm=True),
        TT(*map(torch.from_numpy, planes)), torch.from_numpy(t))
    for g, r32, r16 in zip(got, ref32, ref16):
        g, r32, r16 = g.numpy(), np.asarray(r32), np.asarray(r16)
        assert g.dtype == np.float32
        scale = np.abs(r32).max()
        assert np.abs(g - r32).max() <= 2 * np.abs(r16 - r32).max() \
            + 0.01 * scale
        assert np.abs(g - r16).max() <= 0.04 * scale


@pytest.mark.parametrize("rollout", [True, False])
def test_train_forward_equals_sampler_forward(rollout):
    _, tcfg = _cfgs(rollout=rollout)
    tp = unet_params_from_jax(_params(4, rollout=rollout))
    planes, t, _ = _inputs(5)
    x = TT(*map(torch.from_numpy, planes))
    want = TU.unet_apply(tp, tcfg, x, torch.from_numpy(t))
    got = TU.unet_train_apply(tp, tcfg, x, torch.from_numpy(t))
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * (1 + w.abs().max())


def test_k1_refuses_a_grad_enabled_call():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 5, 8, generator=g)
    w = torch.randn(3, 3, 8, 8, generator=g, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tfc.conv3x3_rollout(x, w)
    with pytest.raises(RuntimeError, match="no backward"):
        tfc.conv3x3_rollout_triplane([x.requires_grad_()], [w.detach()],
                                     [None], [None], [None], [None], [None])
    with torch.no_grad():                        # the sampler's form
        assert tfc.conv3x3_rollout(x, w).shape == (1, 4, 5, 8)
    # the sampler's forward over parameters that require grad
    _, tcfg = _cfgs()
    tp = unet_params_from_jax(_params())
    for _, v in tckpt.leaves_with_paths(tp):
        v.requires_grad_(True)
    planes, t, _ = _inputs()
    out = TU.unet_apply(tp, tcfg, TT(*map(torch.from_numpy, planes)),
                        torch.from_numpy(t))
    assert not out.xy.requires_grad
