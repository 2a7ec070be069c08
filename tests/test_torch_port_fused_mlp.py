"""Port parity of kernel K2's plain version, `skip_mlp_reference`, against
the JAX package's Pallas kernel `skip_mlp_fused` (interpret mode on the
CPU), in fp32 and with bf16 operands.

The CUDA kernel itself runs only on the card: `chip_smoke.py` and
`tests/test_torch_port_cuda.py` hold it against this plain version
there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.models.autoencoder import _mlp_skip_init
from sin3dm_tpu.ops.fused_mlp import skip_mlp_fused
from sin3dm_tpu_torch.ops import fused_mlp as tfm

torch.set_num_threads(2)


def _head(seed, cin, cout, hidden, n_hidden):
    jp = _mlp_skip_init(jax.random.PRNGKey(seed), cin, cout, hidden,
                        n_hidden)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                jp)
    return jp, tp


@pytest.mark.parametrize("cin,cout,hidden,n_hidden,n", [
    (64, 1, 256, 4, 1000),    # the towerruins geometry head
    (64, 3, 256, 4, 777),     # the towerruins texture head
    (32, 4, 64, 2, 300),
])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_matches_pallas(cin, cout, hidden, n_hidden, n, dt):
    """fp32: summation order only, 1e-5 relative to the output scale.
    bf16 operands: both sides multiply the same bf16-rounded operands in
    fp32; a hidden activation whose fp32 sum lands the other side of a
    bf16 rounding boundary moves the output by a fraction of one bf16
    step, so the bound is 2^-8 of the output scale."""
    jp, tp = _head(0, cin, cout, hidden, n_hidden)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((n, cin)) * 0.5).astype(np.float32)
    want = np.asarray(skip_mlp_fused(jp, jnp.asarray(x), tile_n=256,
                                     mxu_dtype=getattr(jnp, dt)))
    got = tfm.skip_mlp(tp, torch.from_numpy(x),
                       mxu_dtype=getattr(torch, dt)).numpy()
    assert got.shape == (n, cout) and got.dtype == np.float32
    scale = np.abs(want).max()
    tol = 1e-5 if dt == "float32" else 2.0 ** -8
    assert np.abs(got - want).max() <= tol * scale


def test_pack_weights_layout_and_checks():
    _, tp = _head(2, 64, 3, 256, 4)
    wts, bias, dims = tfm.pack_weights(tp, torch.bfloat16)
    assert dims == (64, 256, 3, 3, 3)
    assert wts.dtype == torch.bfloat16 and bias.dtype == torch.float32
    layers = tp["first"] + tp["second"]
    assert wts.numel() == sum(lp["w"].numel() for lp in layers)
    torch.testing.assert_close(wts[:64 * 256].view(64, 256),
                               tp["first"][0]["w"].bfloat16())
    _, bad = _head(3, 24, 3, 64, 2)   # cin not a multiple of 16
    with pytest.raises(ValueError, match="multiples of 16"):
        tfm.pack_weights(bad, torch.float32)
