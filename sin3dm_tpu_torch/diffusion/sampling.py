"""Sampling loops (counterpart of `sin3dm_tpu/diffusion/sampling.py`).

The JAX package compiles the reverse chain into one `lax.scan`; here it
is a Python loop of eager steps on the device.

Noise contract: sample j depends only on (seed, j).  Every sample owns
one `torch.Generator` on the device, seeded from (seed, j)
(`sample_generators`); its initial noise and then each step's noise are
drawn from that generator alone, so a sample is the same whatever the
batch it was drawn in.  The bits differ from JAX's threefry/rbg streams;
tests hand both sides the same numpy noise through `noise=`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.triplane import Triplane
from .gaussian import DiffusionConfig, ModelFn, ddim_sample_step, \
    p_sample_step


def sample_generators(seed: int, start: int, batch: int,
                      device) -> List[torch.Generator]:
    """One generator per global sample index start..start+batch-1, each
    seeded from (seed, index) through numpy's SeedSequence."""
    gens = []
    for j in range(start, start + batch):
        state = np.random.SeedSequence([int(seed), j]).generate_state(
            2, np.uint32)
        g = torch.Generator(device=device)
        g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
        gens.append(g)
    return gens


def randn_per_sample(gens: Sequence[torch.Generator], channels: int,
                     sizes: Tuple[int, int, int], device) -> Triplane:
    """Batch of standard-normal triplanes; row j drawn from gens[j]."""
    H, W, D = sizes
    shapes = ((H, W, channels), (H, D, channels), (W, D, channels))
    planes = []
    for shape in shapes:
        out = torch.empty((len(gens),) + shape, device=device)
        for j, g in enumerate(gens):
            torch.randn(shape, generator=g, out=out[j])
        planes.append(out)
    return Triplane(*planes)


def _init(gens, batch, channels, sizes, noise, device, step_noise: bool):
    """The initial x_T: `noise` if given, else drawn from `gens`, which
    must hold one generator per sample where the steps draw noise too."""
    if (noise is None or step_noise) and (gens is None
                                          or len(gens) != batch):
        raise ValueError("pass one generator per sample (and, where the "
                         "steps draw no noise, it may be the initial "
                         "noise instead)")
    if noise is not None:
        return noise
    return randn_per_sample(gens, channels, sizes, device)


def p_sample_loop(model: ModelFn, tables, cfg: DiffusionConfig,
                  gens: Optional[Sequence[torch.Generator]], batch: int,
                  channels: int, sizes: Tuple[int, int, int],
                  noise: Optional[Triplane] = None,
                  clip_denoised: bool = True, device="cuda") -> Triplane:
    """Ancestral DDPM sampling.  `noise` replaces the initial draw; the
    per-step noise always comes from `gens`."""
    T = tables["betas"].shape[0]
    x = _init(gens, batch, channels, sizes, noise, device, step_noise=True)
    for t in range(T - 1, -1, -1):
        tb = torch.full((batch,), t, dtype=torch.int64, device=device)
        step_noise = randn_per_sample(gens, channels, sizes, device)
        x = p_sample_step(model, tables, cfg, x, tb, step_noise,
                          clip_denoised=clip_denoised)
    return x


def ddim_sample_loop(model: ModelFn, tables, cfg: DiffusionConfig,
                     gens: Optional[Sequence[torch.Generator]], batch: int,
                     channels: int, sizes: Tuple[int, int, int],
                     noise: Optional[Triplane] = None, eta: float = 0.0,
                     clip_denoised: bool = True,
                     device="cuda") -> Triplane:
    """DDIM sampling over the (respaced) schedule.  With eta == 0 the
    chain depends only on the initial noise and draws nothing more."""
    T = tables["betas"].shape[0]
    x = _init(gens, batch, channels, sizes, noise, device,
              step_noise=eta != 0.0)
    for t in range(T - 1, -1, -1):
        tb = torch.full((batch,), t, dtype=torch.int64, device=device)
        step_noise = (randn_per_sample(gens, channels, sizes, device)
                      if eta != 0.0 else None)
        x = ddim_sample_step(model, tables, cfg, x, tb, step_noise,
                             eta=eta, clip_denoised=clip_denoised)
    return x


def make_sampler(model: ModelFn, tables, cfg: DiffusionConfig,
                 use_ddim: bool = False, eta: float = 0.0,
                 clip_denoised: bool = True, device="cuda"):
    """Return `sample(seed, start, batch, channels, sizes, noise=None)`
    -> Triplane: the reverse chain for global samples start..start+batch-1
    (the port's `make_jit_sampler`)."""
    loop = ddim_sample_loop if use_ddim else p_sample_loop
    kw = {"eta": eta} if use_ddim else {}

    @torch.no_grad()
    def sample(seed: int, start: int, batch: int, channels: int,
               sizes: Tuple[int, int, int],
               noise: Optional[Triplane] = None) -> Triplane:
        gens = sample_generators(seed, start, batch, device)
        return loop(model, tables, cfg, gens, batch, channels, sizes,
                    noise=noise, clip_denoised=clip_denoised,
                    device=device, **kw)

    return sample
