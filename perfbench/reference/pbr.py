"""Sin3DM's PBR-material decode (`pbr` net over `sdfpbr` data), written
plainly, and a reader of the PBR files a sample is written as.

The planes go through the `skip` net's conv blocks (`autoencoder.py`:
the geometry block, then two texture blocks, the second with an input
InstanceNorm and SiLU); three skip heads without sigmoid give rgb (3),
metallic and roughness (2) and the normal (3) side by side.  A map's
texel as written: clamp to [0, 1], times 255, truncated to uint8.

The files of a sample: `object.obj`, `object.mtl` naming
`textures/{albedo,metallic,roughness,normal}.png`, the albedo and the
normal RGB PNGs, metallic and roughness grey PNGs, each R x R.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .autoencoder import normalize, sample_planes, skip_head
from .mesh import read_obj
from .png import read_png
from .precision import fp32

# the heads, their outputs, in the order the texel's channels take them
HEADS = (("rgb_decoder", 3), ("mr_decoder", 2), ("normal_decoder", 3))
# each map: its channels of the 8 and its PNG's channels
MAPS = {"albedo": (slice(0, 3), 3), "metallic": (slice(3, 4), 1),
        "roughness": (slice(4, 5), 1), "normal": (slice(5, 8), 3)}
MTL_LINES = ("map_Kd textures/albedo.png", "map_Pm textures/metallic.png",
             "map_Pr textures/roughness.png",
             "map_Bump -bm 1.000000 textures/normal.png")


def tex_heads(P, h, q: Callable = fp32) -> torch.Tensor:
    """The three heads over texture features `[N, C]` -> `[N, 8]`."""
    return torch.cat([skip_head(P, k, h, q) for k, _ in HEADS], dim=-1)


def texel_maps(P, tex, pts, aabb, q: Callable = fp32) -> torch.Tensor:
    """uint8 `[N, 8]` texels at world points, as the maps are written."""
    c = tex_heads(P, sample_planes(tex, normalize(pts, aabb)), q)
    return (torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.uint8)


def geometry_faults(v, vt, f, ft, aabb, reso: int, n_faces: int) -> list:
    """0 < faces <= n_faces, every index in range, every vertex inside
    the AABB widened by one voxel, every uv in [0, 1]."""
    faults = []
    if not 0 < len(f) <= n_faces:
        faults.append(f"{len(f)} faces (want 1..{n_faces})")
    if len(f) and (f.min() < 0 or f.max() >= len(v) or ft.min() < 0
                   or ft.max() >= len(vt)):
        faults.append("a face index out of range")
    lo, hi = np.asarray(aabb[:3]), np.asarray(aabb[3:])
    voxel = (hi.max() - lo.min()) / reso
    if len(v) and not ((v >= lo - voxel) & (v <= hi + voxel)).all():
        faults.append("a vertex outside the AABB")
    if len(vt) and not ((vt >= 0) & (vt <= 1)).all():
        faults.append("a uv outside [0, 1]")
    return faults


def read_pbr(d: str, aabb, reso: int, n_faces: int,
             texreso: int) -> Tuple[list, Dict]:
    """The faults of one written PBR sample in `d` (empty when it is
    valid): the geometry's (`geometry_faults`), an OBJ whose first line
    is `mtllib object.mtl`, an MTL that names the four maps, and each
    map a texreso x texreso PNG of its channels.
    Returns (faults, {v, vt, f, ft, maps: {name: [R, R, k] uint8}})."""
    faults, out = [], {}
    obj = os.path.join(d, "object.obj")
    if not os.path.exists(obj):
        return [f"{obj} missing"], out
    v, vt, f, ft = read_obj(obj)
    out.update(v=v, vt=vt, f=f, ft=ft, maps={})
    faults += geometry_faults(v, vt, f, ft, aabb, reso, n_faces)
    with open(obj) as fh:
        if fh.readline().split() != ["mtllib", "object.mtl"]:
            faults.append("object.obj does not open with mtllib object.mtl")
    try:
        with open(os.path.join(d, "object.mtl")) as fh:
            mtl = fh.read().splitlines()
        faults += [f"object.mtl lacks {ln!r}" for ln in MTL_LINES
                   if ln not in mtl]
        for name, (_, k) in MAPS.items():
            img = read_png(os.path.join(d, "textures", f"{name}.png"))
            out["maps"][name] = img
            if img.shape != (texreso, texreso, k):
                faults.append(f"{name}.png {img.shape}, want "
                              f"({texreso}, {texreso}, {k})")
    except (OSError, ValueError) as e:
        faults.append(str(e))
    return faults, out
