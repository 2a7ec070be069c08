"""Port parity: the flat-buffer AdamW both trainers share
(`sin3dm_tpu_torch/training/adamw.py`) against `optax.adamw` on the CPU
in fp32, with and without weight decay and a per-element scale after
AdamW (the AE's geometry split), and the NaN guard's `ok`.

- Three updates at a constant lr: params, mu and nu within 1e-6 of
  their largest magnitude; the counts equal optax's.
- `ok` false keeps the parameters and still advances the moments and
  both counts, as the diffusion trainer's NaN guard does.
"""

from dataclasses import dataclass
from typing import Optional

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sin3dm_tpu_torch.training import adamw

N = 257
LR = np.float32(1e-2)


@dataclass
class _State:
    flat: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    count: int
    sched_count: Optional[int]


def _state(p):
    t = torch.from_numpy(p.copy())
    return _State(t, torch.zeros_like(t), torch.zeros_like(t), 0, 0)


@pytest.mark.parametrize("wd,split", [(0.0, None), (0.01, None),
                                      (0.01, 0.2)])
def test_update_matches_optax(wd, split):
    rng = np.random.default_rng(0)
    p = rng.standard_normal(N).astype(np.float32)
    scale = None
    tx = optax.adamw(float(LR), b1=adamw.B1, b2=adamw.B2, eps=adamw.EPS,
                     weight_decay=wd)
    if split is not None:
        scale = np.where(np.arange(N) < N // 2, split, 1.0).astype(
            np.float32)
        tx = optax.chain(tx, optax.GradientTransformation(
            lambda _: optax.EmptyState(),
            lambda u, s, params=None: (u * scale, s)))
    opt = tx.init(jnp.asarray(p))
    jp = jnp.asarray(p)
    st = _state(p)
    sc = None if scale is None else torch.from_numpy(scale)
    for _ in range(3):
        g = rng.standard_normal(N).astype(np.float32)
        upd, opt = tx.update(jnp.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        adamw.update(st, torch.from_numpy(g), LR, wd, scale=sc)
    adam = opt[0][0] if split is not None else opt[0]
    assert st.count == int(adam.count) == 3 and st.sched_count == 3
    for got, want in ((st.flat, jp), (st.mu, adam.mu), (st.nu, adam.nu)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_guard_keeps_params_and_advances_state():
    rng = np.random.default_rng(1)
    p = rng.standard_normal(N).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    kept, moved = _state(p), _state(p)
    adamw.update(kept, g, LR, 0.01, ok=torch.tensor(False))
    adamw.update(moved, g, LR, 0.01, ok=torch.tensor(True))
    assert torch.equal(kept.flat, torch.from_numpy(p))
    assert not torch.equal(moved.flat, kept.flat)
    assert torch.equal(kept.mu, moved.mu) and torch.equal(kept.nu, moved.nu)
    assert (kept.count, kept.sched_count) == (1, 1)
