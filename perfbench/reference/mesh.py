"""Reading a textured OBJ, judging it, and finding the 3D points of the
texels its texture holds.

A texel (r, c) of an R x R texture has its centre at uv ((c + 0.5) / R,
(r + 0.5) / R), row 0 at v = 0; the PNG holds row r as image row
R - 1 - r.  A texel strictly inside one face's uv triangle takes the 3D
point at the same barycentric coordinates.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from .png import read_png


def read_obj(path: str):
    """(v [n, 3], vt [m, 2], f [k, 3], ft [k, 3]) 0-based."""
    v, vt, f, ft = [], [], [], []
    with open(path) as fh:
        for ln in fh:
            if ln.startswith("v "):
                v.append([float(x) for x in ln.split()[1:4]])
            elif ln.startswith("vt "):
                vt.append([float(x) for x in ln.split()[1:3]])
            elif ln.startswith("f "):
                parts = [p.split("/") for p in ln.split()[1:4]]
                f.append([int(p[0]) - 1 for p in parts])
                ft.append([int(p[1]) - 1 if len(p) > 1 and p[1] else -1
                           for p in parts])
    return (np.asarray(v, np.float64).reshape(-1, 3),
            np.asarray(vt, np.float64).reshape(-1, 2),
            np.asarray(f, np.int64).reshape(-1, 3),
            np.asarray(ft, np.int64).reshape(-1, 3))


def mesh_faults(d: str, aabb, reso: int, n_faces: int,
                texreso: int) -> Tuple[list, Dict]:
    """The faults of one written sample in `d` (empty when it is valid):
    0 < faces <= n_faces, every index in range, every vertex inside the
    AABB widened by one voxel, every uv in [0, 1], `object.mtl` naming
    `object.png`, and that texture a valid texreso x texreso RGB PNG.
    Returns (faults, {v, vt, f, ft, png})."""
    faults, out = [], {}
    obj = os.path.join(d, "object.obj")
    if not os.path.exists(obj):
        return [f"{obj} missing"], out
    v, vt, f, ft = read_obj(obj)
    out.update(v=v, vt=vt, f=f, ft=ft)
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
    try:
        with open(os.path.join(d, "object.mtl")) as fh:
            if "map_Kd object.png" not in fh.read():
                faults.append("object.mtl does not name object.png")
        png = read_png(os.path.join(d, "object.png"))
        out["png"] = png
        if png.shape != (texreso, texreso, 3):
            faults.append(f"texture {png.shape}, want {texreso}^2 RGB")
    except (OSError, ValueError) as e:
        faults.append(str(e))
    return faults, out


def interior_texels(vt, v, f, ft, faces, res: int, margin: float = 0.02):
    """(rows, cols, points [n, 3]) of the texels strictly inside the uv
    triangles of `faces` (every barycentric coordinate at least
    `margin`), with their 3D points."""
    rows, cols, pts = [], [], []
    for i in faces:
        uv = vt[ft[i]] * res - 0.5            # pixel space, [3, 2]
        p = v[f[i]]
        lo = np.floor(uv.min(0)).astype(int)
        hi = np.ceil(uv.max(0)).astype(int)
        cc, rr = np.meshgrid(np.arange(max(lo[0], 0), min(hi[0], res - 1) + 1),
                             np.arange(max(lo[1], 0), min(hi[1], res - 1) + 1))
        cc, rr = cc.ravel(), rr.ravel()
        a, b = uv[1] - uv[0], uv[2] - uv[0]
        den = a[0] * b[1] - b[0] * a[1]
        if abs(den) < 1e-12 or cc.size == 0:
            continue
        dx, dy = cc - uv[0, 0], rr - uv[0, 1]
        w1 = (dx * b[1] - b[0] * dy) / den
        w2 = (a[0] * dy - dx * a[1]) / den
        w0 = 1.0 - w1 - w2
        keep = (w0 >= margin) & (w1 >= margin) & (w2 >= margin)
        if not keep.any():
            continue
        rows.append(rr[keep])
        cols.append(cc[keep])
        pts.append(w0[keep, None] * p[0] + w1[keep, None] * p[1]
                   + w2[keep, None] * p[2])
    if not rows:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros((0, 3)))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(pts)
