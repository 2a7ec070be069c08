"""AABB grids (the port's own copy of `grid_resolutions` and
`sample_grid_points_aabb` of `sin3dm_tpu/dataio/grid.py`)."""

from __future__ import annotations

import numpy as np


def grid_resolutions(aabb: np.ndarray, resolution: int) -> np.ndarray:
    """Per-axis voxel counts of the AABB grid: `resolution` along the
    longest extent, the others scaled by extent (truncated)."""
    aabb = np.asarray(aabb, np.float64)
    size = aabb[3:] - aabb[:3]
    return (resolution * size / size.max()).astype(np.int32)


def sample_grid_points_aabb(aabb: np.ndarray, resolution: int) -> np.ndarray:
    """The voxel-centre grid of the AABB, per-axis resolution scaled by
    extent: `[Nx, Ny, Nz, 3]` float32."""
    aabb = np.asarray(aabb, np.float64)
    lo, hi = aabb[:3], aabb[3:]
    size = hi - lo
    res = grid_resolutions(aabb, resolution)
    axes = [np.linspace(0.5, res[k] - 0.5, res[k]) / res[k] * size[k] + lo[k]
            for k in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return pts.astype(np.float32)
