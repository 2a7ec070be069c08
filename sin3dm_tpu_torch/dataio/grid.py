"""AABB grid sizes (the port's own copy of
`sin3dm_tpu/dataio/grid.py:grid_resolutions`)."""

from __future__ import annotations

import numpy as np


def grid_resolutions(aabb: np.ndarray, resolution: int) -> np.ndarray:
    """Per-axis voxel counts of the AABB grid: `resolution` along the
    longest extent, the others scaled by extent (truncated)."""
    aabb = np.asarray(aabb, np.float64)
    size = aabb[3:] - aabb[:3]
    return (resolution * size / size.max()).astype(np.int32)
