"""AABB grids (the port's own copy of `grid_resolutions`,
`sample_grid_points_aabb` and `normalize_aabb` of
`sin3dm_tpu/dataio/grid.py`)."""

from __future__ import annotations

from typing import Tuple

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


def normalize_aabb(v: np.ndarray, reso: int, enlarge_scale: float = 1.03,
                   mult: int = 8) -> Tuple[np.ndarray, np.ndarray, float]:
    """Centre and scale vertices into [-1, 1] and derive the symmetric AABB
    whose per-axis extents are feature-map sizes rounded up to a multiple
    of `mult`, over the largest: (aabb [6], translation [3], scale)."""
    v = np.asarray(v, np.float64)
    aabb_min = v.min(axis=0)
    aabb_max = v.max(axis=0)
    center = (aabb_max + aabb_min) / 2
    bbox_size = (aabb_max - aabb_min).max() * enlarge_scale

    translation = -center
    scale = 1.0 / bbox_size * 2

    aabb_min = (aabb_min * enlarge_scale - center) / bbox_size * 2
    aabb_max = (aabb_max * enlarge_scale - center) / bbox_size * 2
    size = aabb_max - aabb_min
    fm_size = (reso * size / size.max()).astype(np.int32)
    fm_size = (fm_size + mult - 1) // mult * mult
    half = fm_size / fm_size.max()
    aabb = np.concatenate([-half, half])
    return aabb, translation, scale
