"""Mesh generation of a PBR-material tag (`--data_type sdfpbr
--enc_net_type pbr`): `generate.py`'s window, set-up and chain check,
with the decode checked against `reference/pbr.py`.

The window and its flags are `generate.py`'s: each sample is written as
the PBR OBJ, its MTL and four maps under `textures/`.  The check: the
chain as `generate.py` checks it (`chain_rel` and its readings); on
each written feat.npz the reference decodes the sdf at the voxel
centres (`occupancy_flips`); `mesh_faults` counts what
`reference/pbr.py` finds wrong in the written files (the geometry's
faults, the MTL's four maps, each map's PNG of its size and channels).
Per sample, `texel_faces` faces drawn from (seed, j) give the texels
strictly inside them, with their 3D points (`reference/mesh.py`); the
reference's three heads give each texel's 8 uint8 values there.
`texel_gap_albedo`, `texel_gap_mr` (metallic and roughness) and
`texel_gap_normal` are the widest sample's mean |PNG - reference| in
uint8 levels over those texels and the map's channels.  Read and not
compared: `texel_unclamped_<map>`, the least over the samples of the
share of those texels whose reference values of the map all lie
strictly inside (0, 255), where a gap sees the heads' values and not
the clamp.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from perfbench.harness import load_module
from perfbench.reference import autoencoder as RA
from perfbench.reference import diffusion as RD
from perfbench.reference import mesh, pbr, precision, tree

generate = load_module(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "generate.py"), "perfbench_driver_generate")

# the compared gaps: their maps
GAPS = {"texel_gap_albedo": ("albedo",),
        "texel_gap_mr": ("metallic", "roughness"),
        "texel_gap_normal": ("normal",)}


def png_texels(maps, r, c, R: int) -> np.ndarray:
    """The PNGs' values at texels (r, c), `[N, 8]` in the heads' order."""
    return np.concatenate([maps[n][R - 1 - r, c] for n in pbr.MAPS], -1)


def map_gaps(got, want) -> dict:
    """Each gap's mean |got - want| in uint8 levels over the texels and
    its maps' channels (`[N, 8]` each)."""
    out = {}
    for gap, names in GAPS.items():
        cols = np.concatenate([np.arange(8)[pbr.MAPS[n][0]] for n in names])
        out[gap] = float(np.abs(got[:, cols].astype(np.int64)
                                - want[:, cols].astype(np.int64)).mean())
    return out


UNCLAMPED = [f"texel_unclamped_{n}" for n in pbr.MAPS]


def unclamped(want) -> dict:
    """The share of texels whose reference values of each map all lie
    strictly inside (0, 255)."""
    return {k: float(((want[:, s] > 0) & (want[:, s] < 255)).all(-1).mean())
            for k, (s, _) in zip(UNCLAMPED, pbr.MAPS.values())}


class Driver(generate.Driver):
    def chain_readings(self, PU, C, sizes, control):
        """`generate.py`'s chain readings over the window's samples, and
        with `control` the control's."""
        dev = self.device
        steps = int(self.mix["respacing"][len("ddim"):])
        T = int(self.cfg["diffusion_steps"])
        qc = precision.rounding(control) if control else None
        chain, chain_c, med, med_c = [], [], [], []
        block = int(self.mix.get("reference_batch", 8))
        for s in range(0, self.n, block):
            idx = list(range(s, min(s + block, self.n)))
            xT = RD.initial_noise(self.seed, idx, sizes, C, dev)
            ref = RD.ddim_chain(PU, xT, T, steps)
            ctl = RD.ddim_chain(PU, xT, T, steps, qc) if qc else None
            for i, j in enumerate(idx):
                with np.load(os.path.join(self.out, f"{j:03d}",
                                          "feat.npz")) as f:
                    prog = [f[k] for k in ("feat_xy", "feat_xz", "feat_yz")]
                want = [r[i].cpu().numpy() for r in ref]
                chain.append(generate.plane_l1(prog, want))
                med.append(generate.plane_median(prog, want))
                if ctl is not None:
                    got = [c[i].cpu().numpy() for c in ctl]
                    chain_c.append(generate.plane_l1(got, want))
                    med_c.append(generate.plane_median(got, want))
        return (generate.chain_readings(chain, med),
                generate.chain_readings(chain_c, med_c) if qc else None)

    def readings(self, control: str = None) -> dict:
        dev = self.device
        (H, W, D), C = self.sizes()
        unet_flat, _ = tree.load_container(os.path.join(
            self.tag, "diffusion", self.cfg["ema_file"]))
        got, got_c = self.chain_readings(tree.to_device(unet_flat, dev), C,
                                         (H, W, D), control)
        meta, ae_flat = self.meta()
        PA = tree.to_device(ae_flat, dev)
        qc = precision.rounding(control) if control else None

        base = np.asarray(meta["featmap_size"], np.float64)
        scale = np.asarray((H, W, D), np.float64) / base
        aabb = np.asarray(meta["aabb"], np.float64) * np.concatenate(
            [scale, scale])
        aabb_d = torch.as_tensor(aabb, dtype=torch.float32, device=dev)
        res = RA.grid_resolutions(aabb, self.mix["reso"])
        R = self.mix["texreso"]
        flips, flips_c, gaps, gaps_c, inside = [], [], [], [], []
        faults, failed = [], 0
        for j in range(self.n):
            d = os.path.join(self.out, f"{j:03d}")
            with np.load(os.path.join(d, "feat.npz")) as f:
                planes = tuple(torch.as_tensor(f[k], device=dev)[None]
                               for k in ("feat_xy", "feat_xz", "feat_yz"))
            geo, tex = RA.process_planes(PA, planes,
                                         self.cfg["ae"]["fdim_geo"], True)
            occ = RA.sdf_grid(PA, geo, res) < 0
            with np.load(os.path.join(d, "voxel.npz")) as f:
                vox = torch.as_tensor(f["vox_grid"], device=dev)
            if tuple(vox.shape) != tuple(occ.shape):
                faults.append(f"{d}: voxel grid {tuple(vox.shape)}")
                failed += 1
                continue
            flips.append(float((vox != occ).float().mean()))
            if qc:
                flips_c.append(float(((RA.sdf_grid(PA, geo, res, qc) < 0)
                                      != occ).float().mean()))
            bad, m = pbr.read_pbr(d, aabb, self.mix["reso"],
                                  self.mix["n_faces"], R)
            faults += [f"{d}: {b}" for b in bad]
            failed += bool(bad)
            if bad:
                continue
            rng = np.random.default_rng([self.seed, j])
            faces = rng.choice(len(m["f"]), min(self.mix["texel_faces"],
                                                len(m["f"])), replace=False)
            r, c, pts = mesh.interior_texels(m["vt"], m["v"], m["f"],
                                             m["ft"], faces, R)
            if len(r) == 0:
                faults.append(f"{d}: no texel inside the faces drawn")
                failed += 1
                continue
            p = torch.as_tensor(pts, dtype=torch.float32, device=dev)
            want = pbr.texel_maps(PA, tex, p, aabb_d).cpu().numpy()
            gaps.append(map_gaps(png_texels(m["maps"], r, c, R), want))
            inside.append(unclamped(want))
            if qc:
                gaps_c.append(map_gaps(pbr.texel_maps(
                    PA, tex, p, aabb_d, qc).cpu().numpy(), want))
        for f in faults:
            print(f"perfbench: {f}", file=sys.stderr)
        out = {**got, "occupancy_flips": max(flips, default=1.0),
               "mesh_faults": len(faults), "failed_samples": failed}
        for k in GAPS:
            out[k] = max((g[k] for g in gaps), default=255.0)
        for k in UNCLAMPED:
            out[k] = min((g[k] for g in inside), default=0.0)
        if qc:
            out["control"] = {**got_c,
                              "occupancy_flips": max(flips_c, default=None),
                              **{k: max((g[k] for g in gaps_c),
                                        default=None) for k in GAPS}}
        return out
