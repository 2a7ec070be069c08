"""The Gaussian diffusion around the reference UNet, written plainly:
the linear schedule and its DDIM respacing, the DDIM reverse chain
(eta 0, x_0 predicted and clipped to [-1, 1]), the x_0-prediction MSE
training loss, and the draws that both the chain and the training feed
take from a seed.

The draws follow the program's documented contract: sample j (or train
step k) draws from a `torch.Generator` on the card seeded from (seed, j)
through numpy's SeedSequence; a sample's x_T is the xy, xz, yz planes of
standard normals in channels-last order; a train step draws its
timesteps (uniform integers) and then each plane's noise.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from .precision import fp32
from .unet import Planes, unet


def step_generator(seed: int, index: int, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def plane_shapes(sizes, channels) -> Tuple[tuple, tuple, tuple]:
    """Channels-last shapes of the xy, xz and yz planes."""
    H, W, D = sizes
    return (H, W, channels), (H, D, channels), (W, D, channels)


def nchw(p: torch.Tensor) -> torch.Tensor:
    return p.permute(0, 3, 1, 2).contiguous()


def initial_noise(seed: int, samples: Sequence[int], sizes, channels,
                  device) -> Planes:
    """x_T of the given sample indices, NCHW planes."""
    planes = [[], [], []]
    for j in samples:
        g = step_generator(seed, j, device)
        for i, shape in enumerate(plane_shapes(sizes, channels)):
            planes[i].append(torch.randn(shape, generator=g, device=device))
    return tuple(nchw(torch.stack(p)) for p in planes)


def linear_betas(steps: int) -> np.ndarray:
    scale = 1000.0 / steps
    return np.linspace(scale * 0.0001, scale * 0.02, steps, dtype=np.float64)


def ddim_schedule(steps: int, respaced: int) -> Dict[str, np.ndarray]:
    """The kept original timesteps of "ddimN" (the integer stride that
    gives N steps) and their cumulative alphas, fp64."""
    for stride in range(1, steps):
        if len(range(0, steps, stride)) == respaced:
            break
    else:
        raise ValueError(f"no integer stride gives {respaced} steps")
    acp = np.cumprod(1.0 - linear_betas(steps))
    kept = np.arange(0, steps, stride)
    ac = acp[kept]
    return {"timesteps": kept, "alphas_cumprod": ac,
            "alphas_cumprod_prev": np.append(1.0, ac[:-1])}


def ddim_chain(P: Dict[str, torch.Tensor], x: Planes, steps: int,
               respaced: int, q: Callable = fp32) -> Planes:
    """x_0 from x_T through the respaced DDIM chain (eta 0)."""
    s = ddim_schedule(steps, respaced)
    B = x[0].shape[0]
    for i in range(respaced - 1, -1, -1):
        a = float(s["alphas_cumprod"][i])
        ap = float(s["alphas_cumprod_prev"][i])
        t = torch.full((B,), int(s["timesteps"][i]), dtype=torch.int64,
                       device=x[0].device)
        out = unet(P, x, t, q)
        x0 = tuple(o.clamp(-1.0, 1.0) for o in out)
        eps = tuple((xt / np.sqrt(a) - x0p) / np.sqrt(1.0 / a - 1.0)
                    for xt, x0p in zip(x, x0))
        x = tuple(x0p * np.sqrt(ap) + np.sqrt(1.0 - ap) * e
                  for x0p, e in zip(x0, eps))
    return x


def train_draws(seed: int, step: int, batch: int, sizes, channels,
                steps: int, device):
    """(t `[B]`, noise NCHW planes) of train step `step`."""
    g = step_generator(seed, step, device)
    t = torch.randint(0, steps, (batch,), generator=g, device=device)
    noise = tuple(nchw(torch.randn((batch,) + shape, generator=g,
                                   device=device))
                  for shape in plane_shapes(sizes, channels))
    return t, noise


def train_loss(P: Dict[str, torch.Tensor], x0: Planes, t: torch.Tensor,
               noise: Planes, steps: int, q: Callable = fp32
               ) -> torch.Tensor:
    """Per-example loss `[B]`: the three planes' mean squared errors of
    the predicted x_0 at x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) noise,
    summed."""
    acp = torch.as_tensor(np.cumprod(1.0 - linear_betas(steps)),
                          device=t.device)[t]
    a = acp.sqrt().float()[:, None, None, None]
    b = (1.0 - acp).sqrt().float()[:, None, None, None]
    xt = tuple(a * p + b * n for p, n in zip(x0, noise))
    out = unet(P, xt, t, q)
    return sum(((p - o) ** 2).mean(dim=(1, 2, 3)) for p, o in zip(x0, out))
