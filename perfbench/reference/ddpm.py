"""The ancestral DDPM chain around the reference UNet, written plainly:
the linear schedule's T steps, x_0 predicted and clipped to [-1, 1],
the posterior mean of x_{t-1}, and the fixed-large variance (the
posterior variance at t = 1, the betas after).

The draws follow the program's documented noise contract: sample j owns
one generator on the card seeded from (seed, j) (`diffusion.py:
step_generator`); its x_T is the xy, xz and yz planes of standard
normals in channels-last order, and every step t = T-1, ..., 0 then
draws the three planes' noise from that generator in the same order
(the last step's draw is multiplied by 0).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .diffusion import linear_betas, nchw, plane_shapes, step_generator
from .precision import fp32
from .unet import Planes, unet


def schedule(steps: int) -> dict:
    """The chain's fp64 tables: the posterior mean's two coefficients and
    the fixed-large standard deviation, per step."""
    betas = linear_betas(steps)
    acp = np.cumprod(1.0 - betas)
    prev = np.append(1.0, acp[:-1])
    post_var = betas * (1.0 - prev) / (1.0 - acp)
    return {"coef_x0": betas * np.sqrt(prev) / (1.0 - acp),
            "coef_xt": (1.0 - prev) * np.sqrt(1.0 - betas) / (1.0 - acp),
            "sigma": np.sqrt(np.append(post_var[1], betas[1:]))}


def draw(gens, sizes, channels, device) -> Planes:
    """One draw of every sample's three planes, NCHW."""
    return tuple(nchw(torch.stack([torch.randn(shape, generator=g,
                                               device=device)
                                   for g in gens]))
                 for shape in plane_shapes(sizes, channels))


def ddpm_chain(P, seed: int, samples: Sequence[int], sizes, channels: int,
               steps: int, device, q: Callable = fp32) -> Planes:
    """x_0 of the given sample indices through the T-step chain."""
    gens = [step_generator(seed, j, device) for j in samples]
    s = schedule(steps)
    x = draw(gens, sizes, channels, device)
    for t in range(steps - 1, -1, -1):
        tt = torch.full((len(samples),), t, dtype=torch.int64,
                        device=device)
        x0 = tuple(o.clamp(-1.0, 1.0) for o in unet(P, x, tt, q))
        noise = draw(gens, sizes, channels, device)
        sd = float(s["sigma"][t]) if t > 0 else 0.0
        x = tuple(float(s["coef_x0"][t]) * a + float(s["coef_xt"][t]) * b
                  + sd * n for a, b, n in zip(x0, x, noise))
    return x
