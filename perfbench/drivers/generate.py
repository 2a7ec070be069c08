"""Mesh generation: `cli/sample.py:generate`, the sampler on the mesh path.

Configuration keys: `tag` (a trained tag, relative to the checkout),
`unet` and `ae` (the widths, which the reference reads from the tag's
weights), `diffusion_steps`.  Mix keys: `respacing` ("ddimN"; "ddpmN"
in `generate_ddpm.py`'s mixes),
`warm_steps` (the warm-up's DDIM steps: one short chain and one decode
at the window's shapes), `pipeline_chunk`, `reso`, `texreso`, `n_faces`,
`resize`, `nominal_s_per_sample` (the window draws ceil(seconds /
nominal) samples, so a run's work is fixed by --seconds and the seed),
`trace_samples` (the traced window's samples), `texel_faces` (faces
whose texels the check reads per sample), `reference_batch` (samples a
reference chain runs at once), `control` and `limits`.

The window is one `generate` call for samples 0..n-1 of --seed, written
under TMPDIR and removed after the check: the models' load, every
chain, the pipelined decode and the last export.  `gen_s_per_sample` is
its host-clock seconds over its samples.

The check, after the window: the reference draws each sample's x_T from
(seed, j) and runs the DDIM chain in fp32.  `chain_rel` is the median
sample's sum |program - reference| / sum |reference| over its three
planes.  Per sample, `chain_rel_max` and `chain_rel_2nd` (the widest
and the second widest sample's l1 gap) and `chain_med_max` (the widest
median element gap of any sample's plane) are read and not compared:
under bf16 rounding about one sample in fifty follows another
trajectory of the chain, the same one on every run of its seed, and
reads as far from the reference as the control's samples do.  On each
written feat.npz the reference decodes the sdf at the voxel centres;
`occupancy_flips` is the widest sample's share of voxels whose
occupancy in voxel.npz differs.  `mesh_faults` counts what
`reference/mesh.py` finds wrong in the written files.  `texel_mad`, the
widest sample's mean |PNG - reference| (uint8 levels) over the texels
strictly inside `texel_faces` faces drawn from the seed, is read and
not compared: the tag's texture head saturates its sigmoid, so every
texel reads 255 in the program, the reference and the control alike,
and the texture head's values lie outside `correct`.
"""

from __future__ import annotations

import math
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench.reference import autoencoder as RA
from perfbench.reference import compare, mesh
from perfbench.reference import diffusion as RD
from perfbench.reference import precision, tree


def chain_steps(respacing: str) -> int:
    """The chain's steps in a mix's `respacing`: the digits after its
    "ddim" (a respaced DDIM chain) or "ddpm" (the whole schedule)."""
    m = re.fullmatch(r"(ddim|ddpm)(\d+)", respacing)
    if m is None:
        raise ValueError(f"respacing {respacing!r} is neither ddimN nor "
                         "ddpmN")
    return int(m.group(2))


def chain_readings(gaps, meds) -> dict:
    """Over the window's samples: `chain_rel`, the median sample's l1
    gap, `chain_rel_max` and `chain_rel_2nd`, the widest and the second
    widest sample's; `chain_med_max`, the widest median element gap of
    any sample's plane."""
    top = sorted(gaps, reverse=True)
    return {"chain_rel": float(np.median(gaps)),
            "chain_rel_max": float(top[0]),
            "chain_rel_2nd": float(top[min(1, len(top) - 1)]),
            "chain_med_max": float(max(meds))}


def plane_l1(got, want) -> float:
    """sum |got - want| / sum |want| over a sample's three planes."""
    return compare.l1_rel(np.concatenate([g.ravel() for g in got]),
                          np.concatenate([w.ravel() for w in want]))


def plane_median(got, want) -> float:
    """The widest of a sample's three planes' median element gaps."""
    return max(compare.median_rel(g, w) for g, w in zip(got, want))


class Driver:
    def __init__(self, cell, seed: int, device: str, root: str):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg, self.mix = cell.config, cell.traffic
        self.tag = os.path.join(root, self.cfg["tag"])
        self.tmp = tempfile.mkdtemp(prefix="perfbench-generate-")
        self.n = 1
        self.info = {}

    def argv(self, n: int, respacing: str, out: str):
        m = self.mix
        return ["--tag", self.tag, "--device", self.device, "--output", out,
                "--n_samples", str(n), "--use_ddim", "true",
                "--timestep_respacing", respacing,
                "--pipeline_chunk", str(m["pipeline_chunk"]),
                "--reso", str(m["reso"]), "--texreso", str(m["texreso"]),
                "--n_faces", str(m["n_faces"]), "--file_format", "obj",
                "--copy_mtl", "false", "--seed", str(self.seed),
                "--resize", *[str(r) for r in m["resize"]]]

    def sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def setup(self):
        from sin3dm_tpu_torch.cli import sample as cli
        from sin3dm_tpu_torch.core import config as cfgmod
        self.cli, self.cfgmod = cli, cfgmod
        out = os.path.join(self.tmp, "warm")
        cli.generate(cfgmod.sample_args(
            self.argv(1, f"ddim{self.mix['warm_steps']}", out)))
        self.sync()
        shutil.rmtree(out)

    def plan(self, seconds: float, trace: bool):
        self.n = (int(self.mix["trace_samples"]) if trace else
                  max(1, math.ceil(seconds
                                   / self.mix["nominal_s_per_sample"])))

    def window(self) -> dict:
        from sin3dm_tpu_torch.ops.fused_conv import conv3x3_rollout
        from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp
        self.out = os.path.join(self.tmp, "window")
        args = self.cfgmod.sample_args(
            self.argv(self.n, self.mix["respacing"], self.out))
        k1 = conv3x3_rollout.launches
        k2 = dict(skip_mlp.shape_launches)
        self.sync()
        t0 = time.perf_counter()
        _, stages = self.cli.generate(args)
        self.sync()
        t1 = time.perf_counter()
        k2_delta = {s: c - k2.get(s, 0)
                    for s, c in skip_mlp.shape_launches.items()
                    if c != k2.get(s, 0)}
        chain = sum(e["seconds"] for e in stages if e["stage"] == "chain")
        rest = sum(e["seconds"] + e.get("dispatch", 0.0) for e in stages
                   if e["stage"] != "chain")
        print(f"perfbench: {self.n} samples in {t1 - t0:.3f} s: chain "
              f"{chain / self.n:.3f} s, decode stages {rest / self.n:.3f} s "
              "a sample", file=sys.stderr)
        self.info = {
            "t0": t0, "samples": self.n,
            "metrics": {"gen_s_per_sample": (t1 - t0) / self.n},
            "attempted": self.n, "failed": 0, "stages": stages,
            "chain_steps": chain_steps(self.mix["respacing"]),
            "batch": int(self.mix["pipeline_chunk"]),
            "plane_sizes": self.sizes()[0],
            "k1_launches": conv3x3_rollout.launches - k1,
            "k2_shapes": k2_delta,
            "grid_points": int(np.prod(RA.grid_resolutions(
                self.meta()[0]["aabb"], self.mix["reso"]))),
            "texels": sum(int(e.get("texels", 0)) for e in stages)}
        return self.info

    # -- the check ------------------------------------------------------------

    def meta(self):
        flat, meta = tree.load_container(os.path.join(
            self.tag, "encoding", "ckpt_final.pth"), "params")
        return meta, flat

    def sizes(self):
        with np.load(os.path.join(self.tag, "encoding", "feat.npz")) as f:
            C, H, W = f["feat_xy"].shape
            D = f["feat_xz"].shape[2]
        return (tuple(int(n * r) for n, r in zip((H, W, D),
                                                  self.mix["resize"])), C)

    def check(self, control: str = None) -> dict:
        """The numbers compared with their limits; every reading, and with
        `control` the control's, in `self.extra`."""
        try:
            torch.cuda.empty_cache() if self.device == "cuda" else None
            with precision.exact_fp32(), torch.no_grad():
                got = self.readings(control)
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
        self.info["failed"] = got.pop("failed_samples")
        self.extra = {"control": got.pop("control")} if control else {}
        self.extra["readings"] = got
        lim = self.mix["limits"]
        return {k: {"value": got[k], "limit": lim[k]} for k in lim}

    def readings(self, control: str = None) -> dict:
        dev = self.device
        (H, W, D), C = self.sizes()
        unet_flat, _ = tree.load_container(os.path.join(
            self.tag, "diffusion", self.cfg["ema_file"]))
        PU = tree.to_device(unet_flat, dev)
        meta, ae_flat = self.meta()
        PA = tree.to_device(ae_flat, dev)
        dirs = [os.path.join(self.out, f"{j:03d}") for j in range(self.n)]
        steps = chain_steps(self.mix["respacing"])
        T = int(self.cfg["diffusion_steps"])
        qc = precision.rounding(control) if control else None

        chain, chain_c, med, med_c = [], [], [], []
        block = int(self.mix.get("reference_batch", 8))
        for s in range(0, self.n, block):
            idx = list(range(s, min(s + block, self.n)))
            xT = RD.initial_noise(self.seed, idx, (H, W, D), C, dev)
            ref = RD.ddim_chain(PU, xT, T, steps)
            ctl = RD.ddim_chain(PU, xT, T, steps, qc) if qc else None
            for i, j in enumerate(idx):
                with np.load(os.path.join(dirs[j], "feat.npz")) as f:
                    prog = [f[k] for k in ("feat_xy", "feat_xz", "feat_yz")]
                want = [r[i].cpu().numpy() for r in ref]
                chain.append(plane_l1(prog, want))
                med.append(plane_median(prog, want))
                if ctl is not None:
                    got = [c[i].cpu().numpy() for c in ctl]
                    chain_c.append(plane_l1(got, want))
                    med_c.append(plane_median(got, want))

        base = np.asarray(meta["featmap_size"], np.float64)
        scale = np.asarray((H, W, D), np.float64) / base
        aabb = np.asarray(meta["aabb"], np.float64) * np.concatenate(
            [scale, scale])
        aabb_d = torch.as_tensor(aabb, dtype=torch.float32, device=dev)
        res = RA.grid_resolutions(aabb, self.mix["reso"])
        flips, flips_c, mads, mads_c = [], [], [], []
        faults, failed = [], 0
        ae_cfg = self.cfg["ae"]
        for j, d in enumerate(dirs):
            with np.load(os.path.join(d, "feat.npz")) as f:
                planes = tuple(torch.as_tensor(f[k], device=dev)[None]
                               for k in ("feat_xy", "feat_xz", "feat_yz"))
            geo, tex = RA.process_planes(PA, planes, ae_cfg["fdim_geo"],
                                         True)
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
            bad, m = mesh.mesh_faults(d, aabb, self.mix["reso"],
                                      self.mix["n_faces"],
                                      self.mix["texreso"])
            faults += [f"{d}: {b}" for b in bad]
            failed += bool(bad)
            if bad:
                continue
            rng = np.random.default_rng([self.seed, j])
            faces = rng.choice(len(m["f"]), min(self.mix["texel_faces"],
                                                len(m["f"])), replace=False)
            R = self.mix["texreso"]
            r, c, pts = mesh.interior_texels(m["vt"], m["v"], m["f"],
                                             m["ft"], faces, R)
            if len(r) == 0:
                faults.append(f"{d}: no texel inside the faces drawn")
                failed += 1
                continue
            p = torch.as_tensor(pts, dtype=torch.float32, device=dev)
            want = RA.texel_colours(PA, tex, p, aabb_d).cpu().numpy()
            png = m["png"][R - 1 - r, c]
            mads.append(float(np.abs(png.astype(np.int64)
                                     - want.astype(np.int64)).mean()))
            if qc:
                ctl = RA.texel_colours(PA, tex, p, aabb_d, qc)
                mads_c.append(float(np.abs(ctl.cpu().numpy().astype(np.int64)
                                           - want.astype(np.int64)).mean()))
        for f in faults:
            print(f"perfbench: {f}", file=sys.stderr)
        out = {**chain_readings(chain, med),
               "occupancy_flips": max(flips, default=1.0),
               "texel_mad": max(mads, default=255.0),
               "mesh_faults": len(faults), "failed_samples": failed}
        if qc:
            out["control"] = {**chain_readings(chain_c, med_c),
                              "occupancy_flips": max(flips_c, default=None),
                              "texel_mad": max(mads_c, default=None)}
        return out
