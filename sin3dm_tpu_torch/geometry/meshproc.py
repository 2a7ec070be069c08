"""Mesh processing over the native library (counterpart of
`sin3dm_tpu/geometry/meshproc.py`): SDF grid to mesh with the largest
connected component, decimation, random surface samples, vertex normals,
the winding-number watertight remesh, and the OBJ/MTL scene loader of the
data pipeline."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from . import native
from .meshio import decode_png


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


def estimate_vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    tri = v[f]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    lens = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(lens, 1e-12)


def make_mesh_watertight(v: np.ndarray, f: np.ndarray,
                         resolution: int = 100_000
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Watertight remesh: the winding number on a grid of about
    `resolution` cells (at least 64 along the longest axis, scaled to the
    bounding box padded by 3 %), then marching cubes at 0.5."""
    lo = v.min(axis=0)
    hi = v.max(axis=0)
    size = hi - lo
    pad = 0.03 * size.max()
    lo, hi = lo - pad, hi + pad
    size = hi - lo
    per_axis = max(64, int(round(resolution ** (1 / 3))))
    dims = np.maximum((per_axis * size / size.max()).astype(int), 8)

    xs = [np.linspace(lo[k], hi[k], dims[k]) for k in range(3)]
    grid = np.stack(np.meshgrid(*xs, indexing="ij"), axis=-1)
    bvh = native.MeshBVH(v.astype(np.float32), f.astype(np.int32))
    w = bvh.winding(grid.reshape(-1, 3)).reshape(grid.shape[:3])
    occ = (0.5 - w).astype(np.float32)  # negative inside
    mv, mf = native.marching_cubes(occ, 0.0)
    scale = size / (dims - 1)
    mv = mv * scale[None, :] + lo[None, :]
    return mv, mf


class ObjMaterial:
    """One MTL material: Ka, Kd, Ks, Ns, and the `map_Kd` image as RGBA
    float32 in [0, 1] where the file has one."""

    def __init__(self, name: str):
        self.name = name
        self.Ka = np.array([0.0, 0.0, 0.0])
        self.Kd = np.array([1.0, 1.0, 1.0])
        self.Ks = np.array([0.4, 0.4, 0.4])
        self.Ns = 10.0
        self.map_Kd: Optional[str] = None
        self.image: Optional[np.ndarray] = None


def _load_mtl(path: str) -> dict:
    mats = {}
    cur = None
    try:
        with open(path) as fh:
            for line in fh:
                parts = line.strip().split()
                if not parts:
                    continue
                k = parts[0]
                if k == "newmtl":
                    cur = ObjMaterial(parts[1])
                    mats[parts[1]] = cur
                elif cur is None:
                    continue
                elif k in ("Ka", "Kd", "Ks"):
                    setattr(cur, k, np.array([float(x)
                                              for x in parts[1:4]]))
                elif k == "Ns":
                    cur.Ns = float(parts[1])
                elif k == "map_Kd":
                    cur.map_Kd = parts[-1]
    except FileNotFoundError:
        pass
    return mats


def _corner_index(i: int, n: int) -> int:
    """A 1-based OBJ index (negative: from the end of the `n` so far) as
    0-based."""
    return i - 1 if i > 0 else n + i


def load_obj_scene(path: str) -> dict:
    """Parse an OBJ and its MTL: {"verts" [V, 3] float64, "faces" [F, 3]
    int64 (polygons fanned), "face_uvs" [F, 3, 2] (0 where a corner has
    none), "face_mat" [F] material index, "materials" list of
    ObjMaterial}.  Faces before any `usemtl` get a default material; a
    `map_Kd` image that exists is read as RGBA (PNG only, without PIL)."""
    verts, uvs = [], []
    faces, face_uv_idx, face_mat = [], [], []
    mats: dict = {}
    mat_list = []
    mat_index = {}
    cur_mat = -1

    def get_mat(name):
        if name not in mat_index:
            mat_index[name] = len(mat_list)
            mat_list.append(mats.get(name, ObjMaterial(name)))
        return mat_index[name]

    base = os.path.dirname(path)
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split()
            if not parts:
                continue
            k = parts[0]
            if k == "mtllib":
                mats.update(_load_mtl(os.path.join(base, parts[1])))
            elif k == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif k == "vt":
                uvs.append([float(parts[1]), float(parts[2])])
            elif k == "usemtl":
                cur_mat = get_mat(parts[1])
            elif k == "f":
                idx = []
                for p in parts[1:]:
                    comp = p.split("/")
                    vi = int(comp[0])
                    ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
                    idx.append((vi, ti))
                for i in range(1, len(idx) - 1):
                    tri = [idx[0], idx[i], idx[i + 1]]
                    faces.append([_corner_index(t[0], len(verts))
                                  for t in tri])
                    face_uv_idx.append([_corner_index(t[1], len(uvs))
                                        if t[1] else -1 for t in tri])
                    face_mat.append(cur_mat)

    verts = np.asarray(verts, np.float64)
    uvs_np = np.asarray(uvs, np.float64) if uvs else np.zeros((0, 2))
    faces = np.asarray(faces, np.int64)
    face_uv_idx = np.asarray(face_uv_idx, np.int64)
    face_mat = np.asarray(face_mat, np.int64)
    if (face_mat < 0).any():
        default = len(mat_list)
        mat_list.append(ObjMaterial("default"))
        face_mat = np.where(face_mat < 0, default, face_mat)

    fuv = np.zeros((len(faces), 3, 2))
    valid = face_uv_idx >= 0
    if uvs_np.size:
        fuv[valid] = uvs_np[face_uv_idx[valid]]

    for m in mat_list:
        if m.map_Kd:
            img_path = os.path.join(base, m.map_Kd)
            if os.path.exists(img_path):
                m.image = decode_png(img_path, "RGBA").astype(
                    np.float32) / 255.0

    return {"verts": verts, "faces": faces, "face_uvs": fuv,
            "face_mat": face_mat, "materials": mat_list}
