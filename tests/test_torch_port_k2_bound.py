"""The bound on how far two bf16-operand evaluations of K2's skip head may
lie apart, `ops.fused_mlp.skip_mlp_bf16_bound` (the bound `chip_smoke.py`
holds the card's geo grid to): per row it covers the JAX package's Pallas
kernel (interpret mode on the CPU, its own summation order) against the
port's plain version, and inputs that differ by a known amount; and a
real error (an operand chunk left out) breaks it."""

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
    return jp, jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), jp)


def _x(n, cin, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, cin)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("cin,cout,hidden,n_hidden,n", [
    (64, 1, 256, 4, 1000),    # the towerruins geometry head
    (32, 4, 64, 2, 300),
])
def test_bound_covers_pallas_against_plain(cin, cout, hidden, n_hidden, n):
    jp, tp = _head(0, cin, cout, hidden, n_hidden)
    x = _x(n, cin)
    want = np.asarray(skip_mlp_fused(jp, jnp.asarray(x), tile_n=256,
                                     mxu_dtype=jnp.bfloat16))
    got = tfm.skip_mlp_reference(tp, torch.from_numpy(x),
                                 torch.bfloat16).numpy()
    bound = tfm.skip_mlp_bf16_bound(tp, torch.from_numpy(x)).numpy()
    assert bound.shape == (n, cout) and (bound > 0).all()
    assert (np.abs(got - want) <= bound).all()


def test_bound_covers_inputs_apart():
    _, tp = _head(3, 64, 1, 256, 4)
    x = torch.from_numpy(_x(2000, 64, seed=4))
    rng = np.random.default_rng(5)
    e = torch.from_numpy((rng.uniform(-1, 1, x.shape) * 1e-3
                          * np.abs(x.numpy())).astype(np.float32))
    a = tfm.skip_mlp_reference(tp, x, torch.bfloat16)
    b = tfm.skip_mlp_reference(tp, x + e, torch.bfloat16)
    bound = tfm.skip_mlp_bf16_bound(tp, x, e.abs())
    assert ((a - b).abs() <= bound).all()
    # the input's difference widens the bound
    assert (bound >= tfm.skip_mlp_bf16_bound(tp, x)).all()


def test_a_dropped_operand_chunk_breaks_the_bound():
    """The skip layer without its x rows (a chunk a kernel could skip)."""
    _, tp = _head(6, 64, 1, 256, 4)
    x = torch.from_numpy(_x(2000, 64, seed=7))
    bad = {"first": tp["first"], "second": [dict(lp) for lp in tp["second"]]}
    bad["second"][0]["w"] = tp["second"][0]["w"].clone()
    bad["second"][0]["w"][:64] = 0.0
    a = tfm.skip_mlp_reference(tp, x, torch.bfloat16)
    b = tfm.skip_mlp_reference(bad, x, torch.bfloat16)
    assert ((a - b).abs() > tfm.skip_mlp_bf16_bound(tp, x)).float().mean() \
        > 0.5
