"""Mesh processing over the native library (counterpart of the mesh-path
part of `sin3dm_tpu/geometry/meshproc.py`): SDF grid to mesh with the
largest connected component, decimation, and random surface samples."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import native


def _largest_component(v: np.ndarray, f: np.ndarray):
    """Keep the connected component with the most faces."""
    comp, n = native.face_components(f, len(v))
    if n > 1:
        f = f[comp == np.argmax(np.bincount(comp, minlength=n))]
        v, f = remove_unreferenced_vertices(v, f)
    return v, f


def sdfgrid_to_mesh(sdf_grid: np.ndarray, only_largest_cc: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """SDF grid -> mesh in index space: pad one layer of +1.0, marching
    cubes at 0, subtract the pad offset, and optionally keep only the
    component with the most faces."""
    g = np.pad(sdf_grid.astype(np.float32), 1, constant_values=1.0)
    v, f = native.marching_cubes(g, 0.0)
    v = v - 1.0
    if only_largest_cc and len(f) > 0:
        v, f = _largest_component(v, f)
    return v, f


def sdfgrid_to_mesh_sparse(sparse, quant: float,
                           only_largest_cc: bool = True
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """`sdfgrid_to_mesh` from the sparse wire (`ops/sparse_grid`, host
    arrays), never building the dense grid; the same vertices and faces
    as the dense path, bit for bit."""
    v, f = native.marching_cubes_sparse(
        sparse.signs, sparse.block_ids, sparse.block_vals,
        int(sparse.count), sparse.shape, sparse.padded, quant)
    v = v - 1.0
    if only_largest_cc and len(f) > 0:
        v, f = _largest_component(v, f)
    return v, f


def remove_unreferenced_vertices(v: np.ndarray, f: np.ndarray
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    used_mask = np.zeros(len(v), dtype=bool)
    used_mask[f.reshape(-1)] = True
    used = np.nonzero(used_mask)[0]
    remap = -np.ones(len(v), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return v[used], remap[f]


def mesh_decimation(v: np.ndarray, f: np.ndarray,
                    face_count: int = 10000
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric decimation to about `face_count` faces; the clustering
    pre-pass hands the quadric stage about 4x the target."""
    if len(f) <= face_count:
        return np.asarray(v, np.float64), np.asarray(f, np.int64)
    return native.decimate(v, f, face_count, prepass_mult=4)


def face_areas(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    tri = v[f]
    return 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)


def sample_mesh_random(v: np.ndarray, f: np.ndarray, n: int,
                       rng: Optional[np.random.Generator] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted random surface samples -> (face_idx [n], bary [n,3])."""
    rng = rng or np.random.default_rng()
    areas = face_areas(v, f)
    fi = rng.choice(len(f), size=n, p=areas / areas.sum())
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    bary = np.stack([1 - r1, r1 * (1 - r2), r1 * r2], axis=-1)
    return fi, bary


def interpolate_barycentric(f: np.ndarray, fi: np.ndarray, bary: np.ndarray,
                            vertex_attr: np.ndarray) -> np.ndarray:
    """Per-vertex attributes interpolated at (face, barycentric) samples."""
    corners = vertex_attr[f[fi]]            # [n, 3, A]
    return (corners * bary[..., None]).sum(axis=1)
