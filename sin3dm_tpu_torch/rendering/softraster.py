"""Software multi-view renderer (counterpart of
`sin3dm_tpu/rendering/softraster.py` and the software branch of
`rendering/mvrender_script.py`).

Renders a textured OBJ with a z-buffered perspective rasterizer and
Lambertian shading from the 8 camera poses of the Blender protocol
(azimuth 0..315 in steps of 45, elevation 45, distance 3, a 45 mm lens on
a 36 mm sensor, 512x512).  SIFID and LPIPS compare renders of generated
and reference shapes, so both sides go through this one renderer.

The library's `geo_render_view` rasterizes; texture gather and shading
run in numpy over its face-id map.  Where the library cannot be built the
renderer raises: `use_native=False` selects the numpy rasterizer, the
plain version the tests hold the library against (the same arithmetic,
bit for bit, and 10-100x slower).

Usage: python -m sin3dm_tpu_torch.rendering.softraster -s RESULTS_DIR
(renders every `**/object.obj` to `renderings/NNN.png` beside it)
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import sys

import numpy as np

from ..geometry import native
from ..geometry.meshio import encode_png
from ..geometry.meshproc import load_obj_scene


def _look_at(eye: np.ndarray, target: np.ndarray, up=(0, 0, 1)):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-8:
        right = np.array([1.0, 0, 0])
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    # world -> camera (x right, y up, z backward)
    R = np.stack([right, true_up, -fwd])
    t = -R @ eye
    return R, t


def _normalize_mesh(verts: np.ndarray) -> np.ndarray:
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    center = (lo + hi) / 2
    half = (hi - lo).max() / 2 * 1.03
    return (verts - center) / half


def _raster_numpy(px, py, z, faces, order, face_uvs, res: int):
    """The plain version of `native.render_view_raster`: the same
    (zbuf, face id, u, v) maps, in the same operation order."""
    zbuf = np.full((res, res), np.inf, np.float64)
    face_id = np.full((res, res), -1, np.int32)
    u_map = np.zeros((res, res), np.float32)
    v_map = np.zeros((res, res), np.float32)
    for fi in order:
        tri = faces[fi]
        if np.any(z[tri] <= 1e-6):
            continue
        xs, ys = px[tri], py[tri]
        xmin = max(int(np.floor(xs.min())), 0)
        xmax = min(int(np.ceil(xs.max())), res - 1)
        ymin = max(int(np.floor(ys.min())), 0)
        ymax = min(int(np.ceil(ys.max())), res - 1)
        if xmin > xmax or ymin > ymax:
            continue
        gx, gy = np.meshgrid(np.arange(xmin, xmax + 1),
                             np.arange(ymin, ymax + 1))
        d = ((xs[1] - xs[0]) * (ys[2] - ys[0])
             - (xs[2] - xs[0]) * (ys[1] - ys[0]))
        if abs(d) < 1e-12:
            continue
        w1 = ((gx - xs[0]) * (ys[2] - ys[0])
              - (xs[2] - xs[0]) * (gy - ys[0])) / d
        w2 = ((xs[1] - xs[0]) * (gy - ys[0])
              - (gx - xs[0]) * (ys[1] - ys[0])) / d
        w0 = 1.0 - w1 - w2
        cover = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not cover.any():
            continue
        # perspective-correct depth and uv: q_i = w_i * (1 / z_i), summed
        q0 = w0 * (1.0 / z[tri[0]])
        q1 = w1 * (1.0 / z[tri[1]])
        q2 = w2 * (1.0 / z[tri[2]])
        depth = 1.0 / np.maximum(q0 + q1 + q2, 1e-12)
        closer = cover & (depth < zbuf[gy, gx])
        if not closer.any():
            continue
        uv = (face_uvs[fi][0].astype(np.float64)[None, None] * q0[..., None]
              + face_uvs[fi][1].astype(np.float64)[None, None] * q1[..., None]
              + face_uvs[fi][2].astype(np.float64)[None, None] * q2[..., None])
        uv = (uv * depth[..., None]).astype(np.float32)
        yy, xx = gy[closer], gx[closer]
        zbuf[yy, xx] = depth[closer]
        face_id[yy, xx] = fi
        u_map[yy, xx] = uv[..., 0][closer]
        v_map[yy, xx] = uv[..., 1][closer]
    return zbuf, face_id, u_map, v_map


def render_view(verts, faces, face_uvs, face_mat, materials, eye,
                res: int = 512, focal_mm: float = 45.0,
                light_dir=(0.3, 0.3, 0.9), use_native: bool = True
                ) -> np.ndarray:
    """One view from `eye`, looking at the origin: RGBA uint8
    `[res, res, 4]`.  Nearest-texel lookup of each material's map (its Kd
    where it has none), shaded by 0.25 ambient + 0.55 |n . light| + 0.25
    |n . view|, both sides lit; alpha 255 where a face covers the pixel.
    `use_native=False` rasterizes with the plain numpy version."""
    R, t = _look_at(np.asarray(eye, np.float64), np.zeros(3))
    cam = verts @ R.T + t
    # perspective: 36 mm sensor width -> f_pix = focal / 36 * res
    f_pix = focal_mm / 36.0 * res
    z = -cam[:, 2]
    valid_z = np.maximum(z, 1e-6)
    px = cam[:, 0] / valid_z * f_pix + res / 2
    py = -cam[:, 1] / valid_z * f_pix + res / 2

    tri_n = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                     verts[faces[:, 2]] - verts[faces[:, 0]])
    nrm = tri_n / np.maximum(np.linalg.norm(tri_n, axis=-1, keepdims=True),
                             1e-12)
    ld = np.asarray(light_dir, np.float64)
    ld = ld / np.linalg.norm(ld)
    view_dir = np.asarray(eye) / np.linalg.norm(eye)
    shade = (0.25 + 0.55 * np.abs(nrm @ ld) + 0.25 * np.abs(nrm @ view_dir))
    shade = np.clip(shade, 0.0, 1.0)

    # paint order far to near: with a z-buffer it only breaks exact ties
    order = np.argsort(-z[faces].mean(axis=1))
    face_uvs = np.asarray(face_uvs, np.float32)
    raster = native.render_view_raster if use_native else _raster_numpy
    _, face_id, u_map, v_map = raster(px, py, z, faces, order, face_uvs,
                                      res)

    color = np.zeros((res, res, 3), np.float64)
    hit = face_id >= 0
    fid = face_id[hit]
    uu = np.mod(u_map[hit].astype(np.float64), 1.0)
    vv = np.mod(v_map[hit].astype(np.float64), 1.0)
    base = np.zeros((len(fid), 3), np.float64)
    mats = np.asarray(face_mat)[fid]
    for mi, mat in enumerate(materials):
        sel = mats == mi
        if not sel.any():
            continue
        if mat.image is not None:
            H, W = mat.image.shape[:2]
            ix = np.clip((uu[sel] * W).astype(int), 0, W - 1)
            iy = np.clip(((1 - vv[sel]) * H).astype(int), 0, H - 1)
            base[sel] = mat.image[iy, ix, :3]
        else:
            base[sel] = mat.Kd
    color[hit] = base * shade[fid][:, None]
    out = np.concatenate([color, hit.astype(np.float64)[..., None]], axis=-1)
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def camera_eyes(d: float = 3.0) -> list:
    """The 8 camera positions: azimuth 0..315 in steps of 45, elevation
    45, at distance d."""
    eyes = []
    for azimuth in range(0, 360, 45):
        phi, theta = math.radians(azimuth), math.radians(45)
        eyes.append(np.array([d * math.sin(theta) * math.cos(phi),
                              d * math.sin(theta) * math.sin(phi),
                              d * math.cos(theta)]))
    return eyes


def render_multiview(obj_path: str, out_dir: str, res: int = 512,
                     d: float = 3.0) -> None:
    """`out_dir/000.png` .. `007.png`: the OBJ, normalised to [-1, 1],
    from the 8 camera positions."""
    scene = load_obj_scene(obj_path)
    verts = _normalize_mesh(scene["verts"])
    os.makedirs(out_dir, exist_ok=True)
    for i, eye in enumerate(camera_eyes(d)):
        img = render_view(verts, scene["faces"], scene["face_uvs"],
                          scene["face_mat"], scene["materials"], eye,
                          res=res)
        with open(os.path.join(out_dir, f"{i:03d}.png"), "wb") as fh:
            fh.write(encode_png(img))


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--gen_dir", type=str, required=True)
    args = parser.parse_args(argv)
    obj_paths = sorted(glob.glob(os.path.join(args.gen_dir, "**",
                                              "object.obj"), recursive=True))
    if not obj_paths:
        print("No obj files found!")
        sys.exit(1)
    for path in obj_paths:
        out_dir = os.path.join(os.path.dirname(os.path.abspath(path)),
                               "renderings")
        print(f"Rendering {path} -> {out_dir}")
        render_multiview(path, out_dir)
    return obj_paths


if __name__ == "__main__":
    main()
