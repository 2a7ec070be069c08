"""Bilinear plane sampling (counterpart of `sin3dm_tpu/core/gridsample.py`).

A coordinate c in [-1, 1] along an axis of S cells maps to the index
u = (c + 1) * (S / 2) - 0.5, interpolated between floor(u) and floor(u)+1
with indices clamped to [0, S-1]: `grid_sample(align_corners=False,
padding_mode='border')` on (row, col) pairs.  The arithmetic is the JAX
package's, operation for operation, over a flat gather; `F.grid_sample`
orders it otherwise and rounds differently.
"""

from __future__ import annotations

import torch


def grid_sample_plane(plane: torch.Tensor, coords: torch.Tensor
                      ) -> torch.Tensor:
    """plane `[H, W, C]`, coords `[N, 2]` (row, col) in [-1, 1] ->
    `[N, C]` (bilinear, border padding, align_corners=False)."""
    H, W, C = plane.shape
    r = (coords[:, 0] + 1.0) * (H * 0.5) - 0.5
    c = (coords[:, 1] + 1.0) * (W * 0.5) - 0.5

    r0 = torch.floor(r)
    c0 = torch.floor(c)
    fr = (r - r0).to(plane.dtype)[:, None]
    fc = (c - c0).to(plane.dtype)[:, None]

    r0i = r0.to(torch.int32)
    c0i = c0.to(torch.int32)
    r1i = torch.clamp(r0i + 1, 0, H - 1).long()
    c1i = torch.clamp(c0i + 1, 0, W - 1).long()
    r0i = torch.clamp(r0i, 0, H - 1).long()
    c0i = torch.clamp(c0i, 0, W - 1).long()

    flat = plane.reshape(H * W, C)
    p00 = flat[r0i * W + c0i]
    p01 = flat[r0i * W + c1i]
    p10 = flat[r1i * W + c0i]
    p11 = flat[r1i * W + c1i]

    top = p00 * (1.0 - fc) + p01 * fc
    bot = p10 * (1.0 - fc) + p11 * fc
    return top * (1.0 - fr) + bot * fr


def sample_triplane_features(planes, pts_norm: torch.Tensor) -> torch.Tensor:
    """Sum of the three plane samples at points `[N, 3]` in [-1, 1]^3:
    xy at (x, y), xz at (x, z), yz at (y, z).  `planes` has no batch dim
    (`[H, W, C]` planes).  Returns `[N, C]`."""
    h = grid_sample_plane(planes.xy, pts_norm[:, (0, 1)])
    h = h + grid_sample_plane(planes.xz, pts_norm[:, (0, 2)])
    h = h + grid_sample_plane(planes.yz, pts_norm[:, (1, 2)])
    return h
