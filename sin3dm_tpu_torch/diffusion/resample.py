"""Timestep samplers (counterpart of `sin3dm_tpu/diffusion/resample.py`).

* `uniform`: t ~ U{0..T-1}, weights 1 (the default).
* `loss-second-moment`: importance sampling by a 10-deep history of
  per-timestep losses, uniform until every timestep's history is full.

Draws come from an explicit `torch.Generator`.  The history update runs
on the host, in batch order, as JAX's `lax.scan` does, so a timestep that
repeats in one batch has the same defined result (the sampler's one host
sync per step; the uniform sampler has none).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

HISTORY_PER_TERM = 10
UNIFORM_PROB = 0.001


class SamplerState(NamedTuple):
    """Recent losses per timestep (the loss-aware sampler only)."""
    history: torch.Tensor     # [T, HISTORY_PER_TERM] float32
    counts: torch.Tensor      # [T] int32


def init_sampler_state(num_timesteps: int, device="cpu") -> SamplerState:
    return SamplerState(
        history=torch.zeros((num_timesteps, HISTORY_PER_TERM),
                            dtype=torch.float32, device=device),
        counts=torch.zeros((num_timesteps,), dtype=torch.int32,
                           device=device))


def sample_uniform(gen: torch.Generator, batch: int, num_timesteps: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """t ~ U{0..T-1} `[batch]` int64 and weights 1, on gen's device."""
    t = torch.randint(0, num_timesteps, (batch,), generator=gen,
                      device=gen.device)
    return t, torch.ones((batch,), dtype=torch.float32, device=gen.device)


def _lsm_weights(state: SamplerState) -> torch.Tensor:
    """sqrt(E[loss^2]) per timestep, normalised and mixed with uniform;
    uniform until every history is full."""
    T = state.history.shape[0]
    w = torch.sqrt((state.history ** 2).mean(dim=-1))
    w = w / torch.clamp(w.sum(), min=1e-12)
    w = w * (1 - UNIFORM_PROB) + UNIFORM_PROB / T
    uniform = torch.full((T,), 1.0 / T, dtype=torch.float32,
                         device=w.device)
    return torch.where((state.counts == HISTORY_PER_TERM).all(), w, uniform)


def loss_aware_weights(state: SamplerState, t: torch.Tensor) -> torch.Tensor:
    """Importance weights 1/(T p[t]) of given timesteps."""
    p = _lsm_weights(state)
    return 1.0 / (p.shape[0] * p[t])


def sample_loss_aware(gen: torch.Generator, batch: int, state: SamplerState
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """t drawn with the current weights; weights 1/(T p[t])."""
    p = _lsm_weights(state)
    t = torch.multinomial(p, batch, replacement=True, generator=gen)
    return t, 1.0 / (p.shape[0] * p[t])


def update_sampler_state(state: SamplerState, t: torch.Tensor,
                         losses: torch.Tensor) -> SamplerState:
    """Push per-example losses into the history, one example after
    another in batch order.  As in JAX, whether a row is full is read
    once, before the batch: a row that fills within the batch takes no
    further write there (the slot past its end is dropped)."""
    hist = state.history.detach().cpu().numpy().copy()
    counts = state.counts.cpu().numpy().copy()
    ts = t.cpu().numpy()
    ls = losses.detach().float().cpu().numpy()
    full = counts[ts] == HISTORY_PER_TERM
    for ti, li, fi in zip(ts, ls, full):
        if fi:
            hist[ti] = np.append(hist[ti, 1:], li)
        elif counts[ti] < HISTORY_PER_TERM:
            hist[ti, counts[ti]] = li
        counts[ti] = min(counts[ti] + 1, HISTORY_PER_TERM)
    dev = state.history.device
    return SamplerState(history=torch.from_numpy(hist).to(dev),
                        counts=torch.from_numpy(counts).to(dev))
