"""The triplane UNet (Sin3DM's `unet_small`), written plainly.

Planes are NCHW tensors (xy `[B, C, H, W]`, xz `[B, C, H, D]`, yz
`[B, C, W, D]`).  Parameters are {path: tensor} in the checkpoint
container's layout: conv weights `[kh, kw, Cin, Co]`, linear weights
`[in, out]`.  A rollout conv concatenates each plane with the other two
planes' axis means broadcast over it, then convolves the 3C channels
with zero padding; a block is GroupNorm(32) -> SiLU -> rollout 3x3 conv
-> GroupNorm(32) with the time embedding's scale and shift -> SiLU ->
rollout 3x3 conv, plus the input (through a 1x1 conv where the width
changes).  `q` rounds the operands of every convolution and matrix
product (`precision.py`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from .precision import fp32

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
PLANES = ("xy", "xz", "yz")


def linear(P, key, x, q=fp32):
    return q(x) @ q(P[f"{key}/w"]) + P[f"{key}/b"]


def conv(P, key, x, q=fp32):
    """A stride-1 'same' conv of NCHW x with the HWIO weight at key."""
    w = P[f"{key}/w"]
    y = F.conv2d(q(x), q(w.permute(3, 2, 0, 1)),
                 padding=(w.shape[0] // 2, w.shape[1] // 2))
    if f"{key}/b" in P:
        y = y + P[f"{key}/b"][None, :, None, None]
    return y


def tconv(P, key, t: Planes, q=fp32) -> Planes:
    return tuple(conv(P, f"{key}/{k}", x, q) for k, x in zip(PLANES, t))


def rollout(t: Planes) -> Planes:
    """Each plane with the other two planes' axis means broadcast over it."""
    xy, xz, yz = t
    B, C, H, W = xy.shape
    D = xz.shape[3]
    return (torch.cat([xy, yz.mean(3)[:, :, None, :].expand(B, C, H, W),
                       xz.mean(3)[:, :, :, None].expand(B, C, H, W)], 1),
            torch.cat([xz, xy.mean(3)[:, :, :, None].expand(B, C, H, D),
                       yz.mean(2)[:, :, None, :].expand(B, C, H, D)], 1),
            torch.cat([yz, xy.mean(2)[:, :, :, None].expand(B, C, W, D),
                       xz.mean(2)[:, :, None, :].expand(B, C, W, D)], 1))


def group_norm(P, key, x):
    return F.group_norm(x, 32, P[f"{key}/g"], P[f"{key}/b"], eps=1e-5)


def tnorm(P, key, t: Planes) -> Planes:
    return tuple(group_norm(P, f"{key}/{k}", x) for k, x in zip(PLANES, t))


def resblock(P, key, t: Planes, emb, q=fp32) -> Planes:
    h = tuple(F.silu(x) for x in tnorm(P, f"{key}/in_norm", t))
    h = tconv(P, f"{key}/in_conv", rollout(h), q)
    e = linear(P, f"{key}/emb", F.silu(emb), q)[:, :, None, None]
    scale, shift = torch.chunk(e, 2, dim=1)
    h = tuple(F.silu(x * (1 + scale) + shift)
              for x in tnorm(P, f"{key}/out_norm", h))
    h = tconv(P, f"{key}/out_conv", rollout(h), q)
    skip = tconv(P, f"{key}/skip", t, q) if f"{key}/skip/xy/w" in P else t
    return tuple(a + b for a, b in zip(h, skip))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def levels(P) -> Tuple[int, int]:
    """(levels, blocks per level) of the parameters."""
    n_levels = 1 + max(int(k.split("/")[1]) for k in P
                       if k.startswith("down/"))
    n_blocks = 1 + max(int(k.split("/")[2]) for k in P
                       if k.startswith("down/0/"))
    return n_levels, n_blocks


def unet(P: Dict[str, torch.Tensor], x: Planes, t: torch.Tensor,
         q: Callable = fp32) -> Planes:
    """The denoiser's output planes for x at model timesteps t `[B]`."""
    mc = P["time_embed/l1/w"].shape[0]
    emb = timestep_embedding(t, mc)
    emb = linear(P, "time_embed/l2", F.silu(linear(P, "time_embed/l1", emb,
                                                   q)), q)
    n_levels, n_blocks = levels(P)
    h = tconv(P, "in_conv", x, q)
    hs = []
    for lv in range(n_levels):
        if lv:
            h = tuple(F.avg_pool2d(p, 2) for p in h)
        for i in range(n_blocks):
            h = resblock(P, f"down/{lv}/{i}", h, emb, q)
        hs.append(h)
    for lv in range(n_levels):
        if lv == 0:
            h = hs.pop()
        else:
            skip = hs.pop()
            h = tuple(p if p.shape[2:] == s.shape[2:] else
                      F.interpolate(p, size=s.shape[2:], mode="bilinear",
                                    align_corners=False)
                      for p, s in zip(h, skip))
            h = tuple(torch.cat([a, s], 1) for a, s in zip(h, skip))
        for i in range(n_blocks):
            h = resblock(P, f"up/{lv}/{i}", h, emb, q)
        if lv < n_levels - 1:
            h = tuple(F.interpolate(p, size=(2 * p.shape[2], 2 * p.shape[3]),
                                    mode="bilinear", align_corners=False)
                      for p in h)
    h = tuple(F.silu(x) for x in tnorm(P, "out/norm", h))
    return tconv(P, "out/conv", h, q)

