"""Port parity: `diffusion/resample.py` against the JAX package.

`_lsm_weights` cold (uniform) and warm; `update_sampler_state` over
batches with repeated timesteps, rows filling inside the batch and rows
already full (JAX scans the batch in order, with whether a row is full
read before the batch); the importance weights of `sample_loss_aware`
for JAX's draws; the uniform sampler's range.  Histories to 1e-6
relative, counts exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.diffusion import resample as jr
from sin3dm_tpu_torch.diffusion import resample as tr

T, H = 6, jr.HISTORY_PER_TERM


def _state(seed, counts):
    rng = np.random.default_rng(seed)
    hist = rng.uniform(0.1, 2.0, (T, H)).astype(np.float32)
    counts = np.asarray(counts, np.int32)
    hist[np.arange(H)[None, :] >= counts[:, None]] = 0.0
    return (jr.SamplerState(jnp.asarray(hist), jnp.asarray(counts)),
            tr.SamplerState(torch.from_numpy(hist),
                            torch.from_numpy(counts.copy())))


@pytest.mark.parametrize("counts", [[0, 3, 10, 9, 10, 1],
                                    [10, 10, 10, 10, 10, 10]])
def test_lsm_weights(counts):
    js, ts = _state(0, counts)
    np.testing.assert_allclose(tr._lsm_weights(ts).numpy(),
                               np.asarray(jr._lsm_weights(js)), rtol=1e-6)


@pytest.mark.parametrize("t", [
    [1, 1, 1, 2, 5, 1],          # a repeated t on a partial row
    [3, 3, 3, 2, 2, 4],          # row 3 fills inside the batch (9 -> 10)
    [4, 4, 0, 2, 4, 0],          # a full row, pushed three times
])
def test_update_sampler_state_in_batch_order(t):
    js, ts = _state(1, [0, 3, 10, 9, 10, 1])
    losses = np.random.default_rng(2).uniform(0, 3, len(t)).astype(
        np.float32)
    want = jr.update_sampler_state(js, jnp.asarray(t), jnp.asarray(losses))
    got = tr.update_sampler_state(ts, torch.tensor(t),
                                  torch.from_numpy(losses))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history),
                               rtol=1e-6, atol=0)


def test_loss_aware_weights_for_jax_draws():
    js, ts = _state(3, [10] * T)
    t, w = jr.sample_loss_aware(jax.random.PRNGKey(0), 64, js)
    np.testing.assert_allclose(
        tr.loss_aware_weights(ts, torch.tensor(np.asarray(t))).numpy(),
        np.asarray(w), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    tt, tw = tr.sample_loss_aware(g, 64, ts)
    assert tt.shape == (64,) and 0 <= int(tt.min()) and int(tt.max()) < T
    np.testing.assert_allclose(
        tw.numpy(), tr.loss_aware_weights(ts, tt).numpy(), rtol=0)


def test_sample_uniform():
    t, w = tr.sample_uniform(torch.Generator().manual_seed(1), 500, T)
    assert t.dtype == torch.int64 and set(t.tolist()) == set(range(T))
    assert torch.equal(w, torch.ones(500))
