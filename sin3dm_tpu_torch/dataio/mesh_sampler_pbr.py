"""PBR mesh sampler (counterpart of `sin3dm_tpu/dataio/mesh_sampler_pbr.py`):
the base sampler's npz with 8 texture channels, read from the
`textures/albedo|metallicRoughness|metallic|roughness|normal` images
beside the OBJ: rgb (3), metallic (1), roughness (1), normal (3).

Usage: python -m sin3dm_tpu_torch.dataio.mesh_sampler_pbr -s model.obj \
           -d shape.npz
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from ..geometry.meshio import decode_png
from . import mesh_sampler
from .mesh_sampler import MeshSampler, sample_texture_bilinear


def _load_img(pattern: str) -> Optional[np.ndarray]:
    """The first file matching `pattern` as float32 `[H, W, C]` in [0, 1]
    (grey maps `[H, W, 1]`), or None."""
    paths = glob.glob(pattern)
    if not paths:
        return None
    arr = decode_png(paths[0]).astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr / 255.0


class PBRMeshSampler(MeshSampler):
    """The base sampler with its texture lookup over the PBR image set."""

    TEX_CHANNELS = 8

    def __init__(self, path: str):
        super().__init__(path)
        tex_dir = os.path.join(os.path.dirname(path), "textures")
        self.image_albedo = _load_img(os.path.join(tex_dir, "albedo.*"))
        if self.image_albedo is None:
            raise RuntimeError(f"PBR sampler needs {tex_dir}/albedo.*")
        mr = _load_img(os.path.join(tex_dir, "metallicRoughness.*"))
        if mr is None:
            metallic = _load_img(os.path.join(tex_dir, "metallic.*"))
            roughness = _load_img(os.path.join(tex_dir, "roughness.*"))
            base = metallic if metallic is not None else roughness
            if base is None:
                mr = np.zeros(self.image_albedo.shape[:2] + (2,), np.float32)
            else:
                m = (metallic[..., 0] if metallic is not None
                     else np.zeros(base.shape[:2], np.float32))
                r = (roughness[..., 0] if roughness is not None
                     else np.zeros(base.shape[:2], np.float32))
                mr = np.stack([m, r], axis=-1)
        else:
            mr = mr[..., :2]
        self.image_mr = mr
        self.image_normal = _load_img(os.path.join(tex_dir, "normal.*"))
        if self.image_normal is None:
            self.image_normal = np.full(
                self.image_albedo.shape[:2] + (3,), 0.5, np.float32)
            self.image_normal[..., 2] = 1.0

    def query_tex(self, points: np.ndarray) -> np.ndarray:
        _, fi, bary = self._orig_bvh().closest(points)
        uv = (self.face_uvs[fi] * bary[..., None]).sum(axis=1)
        albedo = sample_texture_bilinear(self.image_albedo, uv)[..., :3]
        mr = sample_texture_bilinear(self.image_mr, uv)[..., :2]
        normal = sample_texture_bilinear(self.image_normal, uv)[..., :3]
        return np.concatenate([albedo, mr, normal], axis=-1)  # (N, 8)


def run(src: str, dst: str, **kw) -> dict:
    """`mesh_sampler.run` with the PBR sampler's 8 channels."""
    return mesh_sampler.run(src, dst, sampler=PBRMeshSampler, **kw)


def main(argv=None) -> dict:
    args = mesh_sampler.parser().parse_args(argv)
    return run(args.src, args.dst, reso=args.reso,
               watertight_reso=args.watertight_reso, n_surf=args.n_surf,
               mult=args.mult, threshold=args.threshold,
               enlarge_scale=args.enlarge_scale, watertight=args.watertight,
               seed=args.seed)


if __name__ == "__main__":
    main()
