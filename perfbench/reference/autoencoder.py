"""The decoder of Sin3DM's triplane autoencoder (`skip` net), written
plainly.

It runs one conv block per branch and plane (conv -> affine
InstanceNorm -> SiLU -> conv, plus a shortcut), samples the planes
bilinearly at points in [-1, 1]^3 (border padding, half-pixel centres)
and sums them, and decodes with skip-MLP heads: sdf, and sigmoid
colours.

Parameters are {path: tensor} in the checkpoint container's layout
(conv `[kh, kw, Cin, Co]`, linear `[in, out]`); planes are NCHW.  `q`
rounds the operands of the products (`precision.py`): of the heads
where a function takes heads, of the convolutions where it takes
convolutions.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .precision import fp32

PLANES = ("xy", "xz", "yz")


def instance_norm(x, eps, g=None, b=None):
    return F.instance_norm(x, weight=g, bias=b, eps=eps)


def conv2d(P, key, x, q: Callable = fp32):
    w = P[f"{key}/w"]
    return F.conv2d(q(x), q(w.permute(3, 2, 0, 1)), P[f"{key}/b"],
                    padding=(w.shape[0] // 2, w.shape[1] // 2))


def group_block(P, key, t, input_act: bool, input_norm: bool = False,
                q: Callable = fp32):
    out = []
    for k, x in zip(PLANES, t):
        g, b = P[f"{key}/norm/{k}/g"], P[f"{key}/norm/{k}/b"]
        xin = instance_norm(x, 1e-6, g, b) if input_norm else x
        h = F.silu(xin) if input_act else xin
        h = conv2d(P, f"{key}/in_conv/{k}", h, q)
        h = F.silu(instance_norm(h, 1e-6, g, b))
        h = conv2d(P, f"{key}/out_conv/{k}", h, q)
        sc = (conv2d(P, f"{key}/shortcut/{k}", xin, q)
              if f"{key}/shortcut/{k}/w" in P else xin)
        out.append(h + sc)
    return tuple(out)


def process_planes(P, planes, fdim_geo: int, use_tex: bool,
                   q: Callable = fp32):
    """(geometry planes, texture planes or None)."""
    geo = group_block(P, "geo_convs", tuple(p[:, :fdim_geo] for p in planes),
                      input_act=False, q=q)
    if not use_tex:
        return geo, None
    tex = tuple(p[:, fdim_geo:] for p in planes)
    n = 1 + max(int(k.split("/")[1]) for k in P if k.startswith("tex_convs/"))
    tex = group_block(P, "tex_convs/0", tex, input_act=False, q=q)
    for i in range(1, n):
        tex = group_block(P, f"tex_convs/{i}", tex, input_act=True,
                          input_norm=True, q=q)
    return geo, tex


def sample_planes(planes, x: torch.Tensor) -> torch.Tensor:
    """Sum of the planes (`[1, C, ., .]`) sampled at x `[N, 3]` in
    [-1, 1]^3: xy at (x, y), xz at (x, z), yz at (y, z) -> `[N, C]`."""
    out = 0.0
    for p, (r, c) in zip(planes, ((0, 1), (0, 2), (1, 2))):
        grid = torch.stack([x[:, c], x[:, r]], dim=-1)[None, None]
        out = out + F.grid_sample(p, grid, mode="bilinear",
                                  padding_mode="border",
                                  align_corners=False)[0, :, 0].t()
    return out


def n_layers(P, key, half: str) -> int:
    return 1 + max(int(k.split("/")[2]) for k in P
                   if k.startswith(f"{key}/{half}/"))


def skip_head(P, key, x, q: Callable = fp32):
    def lin(i, half, h):
        k = f"{key}/{half}/{i}"
        return q(h) @ q(P[f"{k}/w"]) + P[f"{k}/b"]
    h = x
    for i in range(n_layers(P, key, "first")):
        h = torch.relu(lin(i, "first", h))
    h = torch.cat([x, h], dim=-1)
    n2 = n_layers(P, key, "second")
    for i in range(n2 - 1):
        h = torch.relu(lin(i, "second", h))
    return lin(n2 - 1, "second", h)


def tex_head(P, h, q: Callable = fp32):
    return torch.sigmoid(skip_head(P, "tex_decoder", h, q))


def normalize(pts, aabb):
    lo, hi = aabb[:3], aabb[3:]
    return 2.0 * (pts - lo) / (hi - lo) - 1.0


def grid_resolutions(aabb, reso: int) -> np.ndarray:
    aabb = np.asarray(aabb, np.float64)
    size = aabb[3:] - aabb[:3]
    return (reso * size / size.max()).astype(np.int32)


@torch.no_grad()
def sdf_grid(P, geo, res, q: Callable = fp32, slab: int = 8) -> torch.Tensor:
    """The sdf at the voxel centres of the AABB grid `res` -> `[Nx, Ny,
    Nz]`: each plane resized bilinearly to the grid (half-pixel centres,
    which are the voxel centres), summed, then the geometry head."""
    Nx, Ny, Nz = (int(r) for r in res)

    def resize(p, size):
        return F.interpolate(p, size=size, mode="bilinear",
                             align_corners=False)[0].permute(1, 2, 0)
    g_xy, g_xz, g_yz = (resize(geo[0], (Nx, Ny)), resize(geo[1], (Nx, Nz)),
                        resize(geo[2], (Ny, Nz)))
    out = torch.empty((Nx, Ny, Nz), device=g_xy.device)
    for x0 in range(0, Nx, slab):
        sl = slice(x0, min(x0 + slab, Nx))
        h = (g_xy[sl][:, :, None] + g_xz[sl][:, None] + g_yz[None])
        out[sl] = skip_head(P, "geo_decoder", h.reshape(-1, h.shape[-1]),
                            q).reshape(h.shape[:3])
    return out


def texel_colours(P, tex, pts, aabb, q: Callable = fp32):
    """uint8 colours at world points, as the texture is written:
    clip(c, 0, 1) * 255 truncated."""
    c = tex_head(P, sample_planes(tex, normalize(pts, aabb)), q)
    return (torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.uint8)
