#!/usr/bin/env python3
"""Builds the `towerruins-pbr` tag: Sin3DM's PBR-material configuration
(`--data_type sdfpbr --enc_net_type pbr`) trained by the port on a PBR
asset made from the committed towerruins tag and a seed:

    python3 scripts/make_pbr_tag.py [--out checkpoints/towerruins-pbr]
        [--work build/towerruins-pbr] [--seed 0] [--enc_n_iters 5000]
        [--diff_n_iters 5000] [--device cuda] [-- extra cli.train flags]

1. The shape: the towerruins tag's `encoding/feat.npz` (its encoded
   training shape) decoded by `AETrainer.decode_texmesh` to a textured
   OBJ (`--reso` 256, `--texreso` 2048, `--n_faces` 200,000).
2. The maps, in the layout `dataio/mesh_sampler_pbr.py` reads
   (`textures/{albedo,metallic,roughness,normal}.png` beside the OBJ,
   written by `meshio.save_mesh_with_pbr`), as functions of each texel's
   3D point (the OBJ's UV atlas rasterized): the albedo is the decoded
   texture times a seeded smooth colour field in [0.15, 0.85] (the
   towerruins texture head reads white everywhere, so the decoded
   texture alone would be one constant); metallic and roughness are
   seeded smooth noise through a soft threshold, patches near 0.08 and
   0.92; the normal map is (n + 1) / 2 of n = normalize(-4 dh/dx,
   -4 dh/dy, 1), h a seeded smooth height field.
3. `mesh_sampler_pbr.run` at `--reso` with `--n_surf` surface points
   (the decoded surface is a marching-cubes surface of one component,
   closed, so it is sampled as watertight).
4. `cli.train --data_type sdfpbr --enc_net_type pbr` with every flag at
   its default except `--enc_n_iters`, `--diff_n_iters` and
   `--ema_rate 0.999` (after 5,000 steps an EMA at 0.9999 would still
   hold 0.9999^5000 = 61 % of the initial draw).
5. The sampler's files copied to `--out`: `encoding/{args.json,
   ckpt_final.pth, feat.npz}` (the checkpoint's params, step and meta;
   the optimiser state, which sampling never reads, is left out) and
   `diffusion/{args.json, ema_0.999_<step>.pt}`.

The smooth fields are sums of 32 random Fourier features of the point
(frequencies of 1 to 4 cycles across the box), drawn from `--seed`.
Prints one JSON line of what it made.  Extra flags after `--` go to
`cli.train` (a small test run: narrower widths on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_TAG = os.path.join("checkpoints", "towerruins")


def fourier_field(rng, pts: np.ndarray, n: int = 32, lo: float = 1.0,
                  hi: float = 4.0):
    """(value, gradient) of a smooth zero-mean field of unit variance at
    `pts` `[N, 3]` (world units in about [-1, 1]): n random Fourier
    features, frequencies of lo..hi cycles over the box."""
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = d * (np.pi * rng.uniform(lo, hi, (n, 1)))
    phase = rng.uniform(0.0, 2 * np.pi, n)
    amp = np.sqrt(2.0 / n)
    arg = pts @ w.T + phase
    value = amp * np.sin(arg).sum(axis=1)
    grad = amp * np.cos(arg) @ w
    return value, grad


def pbr_maps(rng, pts: np.ndarray, albedo: np.ndarray):
    """uint8 `[N, 8]` (rgb, metallic, roughness, normal) at texel points
    `pts` whose decoded colour is `albedo` `[N, 3]` in [0, 1]."""
    tint = np.stack([fourier_field(rng, pts)[0] for _ in range(3)], -1)
    rgb = albedo * (0.5 + 0.35 * np.tanh(tint))
    mr = np.stack([0.5 + 0.42 * np.tanh(2.0 * fourier_field(rng, pts)[0])
                   for _ in range(2)], -1)
    _, g = fourier_field(rng, pts, lo=2.0, hi=6.0)
    n = np.stack([-4.0 * g[:, 0] / (6 * np.pi), -4.0 * g[:, 1] / (6 * np.pi),
                  np.ones(len(pts))], -1)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    out = np.concatenate([rgb, mr, (n + 1.0) / 2.0], axis=-1)
    return (np.clip(out, 0.0, 1.0) * 255.0).astype(np.uint8)


def decode_shape(src_tag: str, shape_dir: str, device: str, reso: int,
                 texreso: int, n_faces: int) -> None:
    """The source tag's feat.npz to `shape_dir/object.{obj,mtl,png}`."""
    from sin3dm_tpu_torch.core import config as cfgmod
    from sin3dm_tpu_torch.core.triplane import load_triplane_npz
    from sin3dm_tpu_torch.training.ae import AETrainer

    args = cfgmod.sample_args(["--tag", src_tag, "--device", device])
    trainer = AETrainer(cfgmod.encoding_log_dir(src_tag),
                        cfgmod.ae_config_from_args(args), device,
                        cfgmod.ae_trainer_config_from_args(args))
    trainer.load_ckpt("final")
    feat = load_triplane_npz(cfgmod.encoding_feat_path(src_tag))
    trainer.decode_texmesh(shape_dir, feat, reso, n_faces=n_faces,
                           texture_reso=texreso, save_voxel=False)


def paint_shape(shape_dir: str, texreso: int, seed: int) -> dict:
    """Rewrite `shape_dir/object.obj` as the PBR OBJ with its four maps."""
    from sin3dm_tpu_torch.geometry import meshproc, native
    from sin3dm_tpu_torch.geometry.meshio import decode_png, \
        save_mesh_with_pbr

    obj = os.path.join(shape_dir, "object.obj")
    scene = meshproc.load_obj_scene(obj)
    v, f = scene["verts"], scene["faces"]
    uvs = scene["face_uvs"].reshape(-1, 2)
    ft = np.arange(len(uvs)).reshape(-1, 3)
    pos, mask = native.rasterize_uv(uvs.astype(np.float32),
                                    ft.astype(np.int32),
                                    v.astype(np.float32),
                                    f.astype(np.int32), texreso)
    # the decoded texture, row r of the PNG at v = 1 - (r + 0.5) / R
    tex = decode_png(os.path.join(shape_dir, "object.png"), "RGB")[::-1]
    albedo = tex.reshape(-1, 3)[mask.reshape(-1)] / 255.0
    pts = pos.reshape(-1, 3)[mask.reshape(-1)].astype(np.float64)
    maps = pbr_maps(np.random.default_rng(seed), pts, albedo)
    img = native.tex_assemble(maps, mask, texreso)
    for name in ("object.obj", "object.mtl", "object.png"):
        os.remove(os.path.join(shape_dir, name))
    save_mesh_with_pbr(obj, v, uvs, f, ft, img[..., :3], img[..., 3],
                       img[..., 4], img[..., 5:])
    return {"faces": int(len(f)), "texels": int(mask.sum()),
            "map_min": maps.min(0).tolist(), "map_max": maps.max(0).tolist(),
            "map_inside": ((maps > 0) & (maps < 255)).mean(0).tolist()}


def copy_tag(tag: str, out: str, data_path: str) -> dict:
    """The sampler's files of `tag` to `out`; returns their sizes."""
    from sin3dm_tpu_torch.core import checkpoint as ckpt

    enc, diff = os.path.join(out, "encoding"), os.path.join(out, "diffusion")
    for d in (enc, diff):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    with open(os.path.join(tag, "encoding", "args.json")) as fh:
        enc_args = json.load(fh)
    enc_args["data_path"] = data_path
    with open(os.path.join(enc, "args.json"), "w") as fh:
        json.dump(enc_args, fh, indent=4)
    tree, meta = ckpt.load_tree(os.path.join(tag, "encoding",
                                             "ckpt_final.pth"))
    ckpt.save_tree(os.path.join(enc, "ckpt_final.pth"),
                   {"params": tree["params"], "step": tree["step"]},
                   meta=meta)
    shutil.copy(os.path.join(tag, "encoding", "feat.npz"), enc)
    with open(os.path.join(tag, "diffusion", "args.json")) as fh:
        diff_args = json.load(fh)
    shutil.copy(os.path.join(tag, "diffusion", "args.json"), diff)
    ema = (f"ema_{diff_args['ema_rate']}_"
           f"{int(diff_args['diff_n_iters']):06d}.pt")
    shutil.copy(os.path.join(tag, "diffusion", ema), diff)
    sizes = {}
    for d, _, files in os.walk(out):
        for name in files:
            p = os.path.join(d, name)
            sizes[os.path.relpath(p, out)] = os.path.getsize(p)
    return sizes


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("checkpoints",
                                                  "towerruins-pbr"))
    ap.add_argument("--work", default=os.path.join("build",
                                                   "towerruins-pbr"))
    ap.add_argument("--src_tag", default=SRC_TAG)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reso", type=int, default=256)
    ap.add_argument("--texreso", type=int, default=2048)
    ap.add_argument("--n_faces", type=int, default=200_000)
    ap.add_argument("--n_surf", type=int, default=2_000_000)
    ap.add_argument("--enc_n_iters", type=int, default=5000)
    ap.add_argument("--diff_n_iters", type=int, default=5000)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from sin3dm_tpu_torch.cli import train as cli_train
    from sin3dm_tpu_torch.dataio import mesh_sampler_pbr

    secs = {}
    t = time.perf_counter()
    shape_dir = os.path.join(a.work, "shape")
    shutil.rmtree(a.work, ignore_errors=True)
    decode_shape(a.src_tag, shape_dir, a.device, a.reso, a.texreso,
                 a.n_faces)
    secs["decode"] = time.perf_counter() - t
    t = time.perf_counter()
    painted = paint_shape(shape_dir, a.texreso, a.seed)
    secs["maps"] = time.perf_counter() - t
    t = time.perf_counter()
    data = os.path.join(a.work, "shape.npz")
    mesh_sampler_pbr.run(os.path.join(shape_dir, "object.obj"), data,
                         reso=a.reso, n_surf=a.n_surf, watertight=True,
                         seed=a.seed)
    with np.load(data) as d:
        grid = list(d["sdf_grid"].shape)
    secs["sample"] = time.perf_counter() - t
    t = time.perf_counter()
    tag = os.path.join(a.work, "tag")
    cli_train.main(["--tag", tag, "--data_path", data, "--device", a.device,
                    "--data_type", "sdfpbr", "--enc_net_type", "pbr",
                    "--enc_n_iters", str(a.enc_n_iters),
                    "--diff_n_iters", str(a.diff_n_iters),
                    "--ema_rate", "0.999", *extra])
    secs["train"] = time.perf_counter() - t
    with open(os.path.join(tag, "encoding", "eval_stat.json")) as fh:
        stat = json.load(fh)
    sizes = copy_tag(tag, a.out, os.path.relpath(data, ROOT)
                     if os.path.isabs(data) else data)
    print(json.dumps({"out": a.out, "grid": grid, "seconds": secs,
                      "eval_stat": stat, **painted, "bytes": sizes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
