"""Port parity: the bf16 UNet (the sampler's default: bf16 torso,
`fast_norm`, every 3x3 conv through K1's single-rounding semantics)
against the JAX package's bf16 `fused_conv=True` path with its Pallas
kernel in interpret mode.

bf16 rounds at different places in the two frameworks (XLA fuses
elementwise chains in fp32; eager PyTorch rounds after every op; the JAX
kernel splits the 192-channel conv), so the outputs are not bitwise
equal.  The stated bound: the port's bf16 output is no further from the
fp32 forward than 2x the JAX bf16 output's distance from it (plus 1% of
the output scale), and within 4% of the output scale of the JAX bf16
output."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.models import unet as JU
from sin3dm_tpu_torch.compat.from_jax import unet_params_from_jax
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.models import unet as TU

torch.set_num_threads(2)


def test_bf16_close_to_jax_bf16_fused():
    jcfg = JU.UNetConfig(model_channels=32)
    params = jax.tree_util.tree_map(
        np.asarray, JU.init_unet(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), params)
    H, W, D = 12, 16, 10
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, H, W, 12), (2, H, D, 12), (2, W, D, 12))]
    t = np.array([500, 20], np.int64)

    apply = jax.jit(JU.unet_apply, static_argnums=1)
    jx, jt = JT(*map(jnp.asarray, planes)), jnp.asarray(t, jnp.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref32 = apply(jp, jcfg, jx, jt)
    ref16 = apply(jp, jcfg._replace(compute_dtype=jnp.bfloat16,
                                    fast_norm=True, fused_conv=True), jx, jt)
    tcfg = TU.UNetConfig(model_channels=32, compute_dtype=torch.bfloat16,
                         fast_norm=True)
    got = TU.unet_apply(unet_params_from_jax(params), tcfg,
                        TT(*map(torch.from_numpy, planes)),
                        torch.from_numpy(t))
    for g, r32, r16 in zip(got, ref32, ref16):
        g, r32, r16 = g.numpy(), np.asarray(r32), np.asarray(r16)
        assert g.dtype == np.float32   # chain state stays fp32
        scale = np.abs(r32).max()
        jax_err = np.abs(r16 - r32).max()
        port_err = np.abs(g - r32).max()
        assert port_err <= 2 * jax_err + 0.01 * scale, (port_err, jax_err)
        assert np.abs(g - r16).max() <= 0.04 * scale
