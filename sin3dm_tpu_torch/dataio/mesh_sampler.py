"""Mesh -> training-data sampler (counterpart of
`sin3dm_tpu/dataio/mesh_sampler.py`).

Writes the npz that the autoencoder reads (`training/ae.py:load_ae_data`):
`pts_grid, sdf_grid, tex_grid, pts_on_surf, tex_on_surf, pts_near_surf,
sdf_near_surf, tex_near_surf, aabb, threshold, Ka, Kd, Ks, Ns`, with the
JAX package's draws, dtypes and 2M on-surface cap, so the same OBJ and
seed give the same file.  Host code: the library's BVH answers the SDF
and closest-point queries (`geometry/native.py:MeshBVH`); texture
colours come from the hit face's material and UV.

Usage: python -m sin3dm_tpu_torch.dataio.mesh_sampler -s model.obj \
           -d shape.npz [--n_surf N] [--watertight]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np

from ..geometry import meshproc, native
from ..geometry.meshio import save_mesh_vf
from .grid import normalize_aabb, sample_grid_points_aabb

# on-surface points kept in the file; the near-surface arrays keep all
ON_SURF_CAP = 2_000_000


def sample_texture_bilinear(image: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """OBJ-convention UV lookup (v = 0 at the image's bottom row),
    bilinear, wrapping in u and clamping in v."""
    H, W = image.shape[:2]
    u = np.mod(uv[:, 0], 1.0) * W - 0.5
    v = (1.0 - np.mod(uv[:, 1], 1.0)) * H - 0.5
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]
    u0w, u1w = u0 % W, (u0 + 1) % W
    v0w, v1w = np.clip(v0, 0, H - 1), np.clip(v0 + 1, 0, H - 1)
    c00 = image[v0w, u0w]
    c01 = image[v0w, u1w]
    c10 = image[v1w, u0w]
    c11 = image[v1w, u1w]
    top = c00 * (1 - fu) + c01 * fu
    bot = c10 * (1 - fu) + c11 * fu
    return top * (1 - fv) + bot * fv


class MeshSampler:
    """SDF and texture sampling of one textured mesh: the SDF from its
    watertight copy, colours from the original's closest face."""

    # channels of `query_tex` that go into the npz
    TEX_CHANNELS = 3

    def __init__(self, path: str):
        self.path = path
        scene = meshproc.load_obj_scene(path)
        self.verts = scene["verts"]
        self.faces = scene["faces"]
        self.face_uvs = scene["face_uvs"]       # [F, 3, 2]
        self.face_mat = scene["face_mat"]       # [F]
        self.materials = scene["materials"]
        self.v_watertight: Optional[np.ndarray] = None
        self.f_watertight: Optional[np.ndarray] = None
        self._bvh_orig: Optional[native.MeshBVH] = None
        self._bvh_wt: Optional[native.MeshBVH] = None

    # the npz carries the first material's parameters
    @property
    def Ka(self):
        return self.materials[0].Ka

    @property
    def Kd(self):
        return self.materials[0].Kd

    @property
    def Ks(self):
        return self.materials[0].Ks

    @property
    def Ns(self):
        return self.materials[0].Ns

    def make_watertight_copy(self, resolution: int = 100_000,
                             is_watertight: bool = False) -> None:
        """The mesh itself where it is watertight, else its winding-number
        remesh, cached beside the OBJ as `<name>_watertight_r<res>.obj`
        (read back on the next run)."""
        if is_watertight:
            print("Watertight mesh, skipping...")
            self.v_watertight = self.verts
            self.f_watertight = self.faces
            return
        cache = self.path.replace(".obj", f"_watertight_r{resolution}.obj")
        if os.path.exists(cache):
            print("Watertight mesh exists, loading...")
            scene = meshproc.load_obj_scene(cache)
            self.v_watertight = scene["verts"]
            self.f_watertight = scene["faces"]
            return
        t0 = time.time()
        self.v_watertight, self.f_watertight = meshproc.make_mesh_watertight(
            self.verts, self.faces, resolution=resolution)
        try:
            save_mesh_vf(cache, self.v_watertight, self.f_watertight)
        except OSError:
            pass
        print("make_watertight_copy time:", time.time() - t0)

    def normalize(self, reso: int = 256, enlarge_scale: float = 1.03,
                  mult: int = 8) -> None:
        self.aabb, translation, scale = normalize_aabb(
            self.verts, reso=reso, enlarge_scale=enlarge_scale, mult=mult)
        self.verts = (self.verts + translation) * scale
        self.v_watertight = (self.v_watertight + translation) * scale
        self._bvh_orig = None
        self._bvh_wt = None

    def _wt_bvh(self) -> native.MeshBVH:
        if self._bvh_wt is None:
            self._bvh_wt = native.MeshBVH(
                self.v_watertight.astype(np.float32),
                self.f_watertight.astype(np.int32))
        return self._bvh_wt

    def _orig_bvh(self) -> native.MeshBVH:
        if self._bvh_orig is None:
            self._bvh_orig = native.MeshBVH(self.verts.astype(np.float32),
                                            self.faces.astype(np.int32))
        return self._bvh_orig

    def sample_watertight_surf(self, n: int = 1_000_000,
                               rng=None) -> np.ndarray:
        fi, bc = meshproc.sample_mesh_random(self.v_watertight,
                                             self.f_watertight, n, rng=rng)
        return meshproc.interpolate_barycentric(self.f_watertight, fi, bc,
                                                self.v_watertight)

    def query_sdf(self, points: np.ndarray) -> np.ndarray:
        sdf, _, _ = self._wt_bvh().signed_distance(points)
        return sdf.astype(np.float64)

    def query_tex(self, points: np.ndarray) -> np.ndarray:
        """RGBA at the closest surface point of the original mesh: the
        material's map where it has one, else its Kd with alpha 1."""
        _, fi, bary = self._orig_bvh().closest(points)
        uv = (self.face_uvs[fi] * bary[..., None]).sum(axis=1)
        mat = self.face_mat[fi]
        colors = np.zeros((len(points), 4))
        for mid in np.unique(mat):
            m = mat == mid
            material = self.materials[mid]
            if material.image is None:
                colors[m, :3] = material.Kd
                colors[m, 3] = 1.0
            else:
                colors[m] = sample_texture_bilinear(material.image, uv[m])
        return colors


def run(src: str, dst: str, reso: int = 256,
        watertight_reso: int = 100_000, n_surf: int = 2_000_000,
        mult: int = 8, threshold: Optional[float] = None,
        enlarge_scale: float = 1.03, watertight: bool = False,
        only_vol: bool = False, seed: int = 0,
        sampler: type = MeshSampler) -> dict:
    """Sample `src` into the npz `dst`; returns the seconds of each stage
    (load, remesh, grid_sdf, surface_sampling, near_sdf, texture_lookups,
    write).  `sampler` is the MeshSampler class whose `query_tex` gives
    the colours (the PBR sampler passes its own)."""
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    if threshold is None:
        threshold = 2.0 / reso * 3
    print("threshold:", threshold)
    secs = dict.fromkeys(("load", "remesh", "grid_sdf", "surface_sampling",
                          "near_sdf", "texture_lookups", "write"), 0.0)
    clock = [time.perf_counter()]

    def lap(stage: str) -> None:
        now = time.perf_counter()
        secs[stage] += now - clock[0]
        clock[0] = now

    C = sampler.TEX_CHANNELS
    rng = np.random.default_rng(seed)
    mesh = sampler(src)
    lap("load")
    mesh.make_watertight_copy(resolution=watertight_reso,
                              is_watertight=watertight)
    mesh.normalize(reso=reso, enlarge_scale=enlarge_scale, mult=mult)
    lap("remesh")

    vol_pts = sample_grid_points_aabb(mesh.aabb, reso)
    vol_shape = vol_pts.shape[:3]
    vol_sdf = mesh.query_sdf(vol_pts.reshape(-1, 3))
    mask = np.abs(vol_sdf) < threshold
    vol_sdf = np.clip(vol_sdf, -threshold, threshold)
    lap("grid_sdf")

    vol_tex = np.zeros((vol_sdf.shape[0], C))
    if mask.any():
        vol_tex[mask] = mesh.query_tex(
            vol_pts.reshape(-1, 3)[mask])[..., :C]
    vol_sdf = vol_sdf.reshape(vol_shape)
    vol_tex = vol_tex.reshape(vol_shape + (C,))
    print("vol_pts:", vol_pts.shape, "vol_sdf:", vol_sdf.shape)
    lap("texture_lookups")

    common = dict(aabb=mesh.aabb, threshold=threshold, Ka=mesh.Ka,
                  Kd=mesh.Kd, Ks=mesh.Ks, Ns=mesh.Ns)
    if only_vol:
        np.savez_compressed(dst, pts_grid=vol_pts, sdf_grid=vol_sdf,
                            tex_grid=vol_tex, **common)
        lap("write")
        return secs

    on_surf_pts = mesh.sample_watertight_surf(n=n_surf, rng=rng)
    lap("surface_sampling")
    on_surf_tex = mesh.query_tex(on_surf_pts)[..., :C]
    lap("texture_lookups")

    near_surf_pts = on_surf_pts + rng.standard_normal(
        on_surf_pts.shape) * 0.005
    near_surf_pts = np.clip(near_surf_pts, mesh.aabb[None, :3],
                            mesh.aabb[None, 3:])
    lap("surface_sampling")
    near_surf_sdf = mesh.query_sdf(near_surf_pts)
    nmask = np.abs(near_surf_sdf) < threshold
    near_surf_sdf = np.clip(near_surf_sdf, -threshold, threshold)
    lap("near_sdf")
    near_surf_tex = np.zeros((near_surf_sdf.shape[0], C))
    if nmask.any():
        near_surf_tex[nmask] = mesh.query_tex(near_surf_pts[nmask])[..., :C]
    lap("texture_lookups")

    # the on-surface points are cut to 2M at random before the write; the
    # near-surface arrays, made from all n_surf of them, are not
    if on_surf_pts.shape[0] > ON_SURF_CAP:
        idx = rng.choice(on_surf_pts.shape[0], ON_SURF_CAP, replace=False)
        on_surf_pts, on_surf_tex = on_surf_pts[idx], on_surf_tex[idx]
    lap("surface_sampling")

    np.savez_compressed(
        dst, pts_grid=vol_pts, sdf_grid=vol_sdf, tex_grid=vol_tex,
        pts_on_surf=on_surf_pts, tex_on_surf=on_surf_tex,
        pts_near_surf=near_surf_pts, sdf_near_surf=near_surf_sdf,
        tex_near_surf=near_surf_tex, **common)
    lap("write")
    print("saved", dst)
    return secs


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("-s", "--src", type=str, required=True)
    p.add_argument("-d", "--dst", type=str, required=True)
    p.add_argument("--reso", type=int, default=256)
    p.add_argument("--watertight_reso", type=int, default=100_000)
    p.add_argument("--n_surf", type=int, default=2_000_000)
    p.add_argument("--mult", type=int, default=8)
    p.add_argument("--threshold", type=float, default=None)
    p.add_argument("--enlarge_scale", type=float, default=1.03)
    p.add_argument("-wt", "--watertight", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> dict:
    p = parser()
    p.add_argument("--only_vol", action="store_true")
    args = p.parse_args(argv)
    return run(args.src, args.dst, reso=args.reso,
               watertight_reso=args.watertight_reso, n_surf=args.n_surf,
               mult=args.mult, threshold=args.threshold,
               enlarge_scale=args.enlarge_scale, watertight=args.watertight,
               only_vol=args.only_vol, seed=args.seed)


if __name__ == "__main__":
    main()
