#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`sin3dm_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one, and outside a checkout
of this repository.  Phases, each printing its results:

1. device: name, power limit, torch/CUDA versions; TF32 off;
2. build: both kernels with nvcc from `sin3dm_tpu_torch/csrc/`, in
   parallel, and beside them the host geometry library with g++;
3. kernels against their plain versions on the card at the main path's
   shapes, in bf16 and fp32, with error, tolerance and median times of
   kernel, plain version and a library yardstick (cuDNN conv + epilogue
   for K1 and K1′, with and without cudnn.benchmark; a bf16 torch.matmul
   chain for K2) that the port never calls, each by CUDA events and, for
   kernel and yardstick, as device time from the profiler, and the K1
   wrapper's host time per launch: K1's default form and K1′ (act,
   act+stats, act+skip+stats) at every shape where a configuration runs
   them, each triplane launch (weights packed once, as the UNet passes
   them) also against its three single-plane launches, bit for bit;
4. main path: `cli.sample.main(--tag checkpoints/towerruins --vox
   --n_samples 2)` (DDPM-1000, batch 2, --reso 256) with the launch
   counters set to 0 just before and read just after, output checks and
   the chain/decode seconds;
4b. the same under `SIN3DM_STATS_CHAIN=1`, then under
   `SIN3DM_FUSED_ACT=1`, with per-form K1 launch counts;
4c. one full-width forward of the towerruins UNet at batch 2: the stats
   chain and the fused act (`SIN3DM_FUSED_ACT=1`) each against the
   default configuration;
4d. `--inpaint` under the stats chain (DDIM-100): kept cells equal the
   tag's feat.npz, regenerated cells moved;
4e. the mesh path: `cli.sample.main(--tag ... --n_samples 2
   --pipeline_chunk 2)` (DDPM-1000, one batch-2 chain,
   --reso 256, --texreso 2048, --n_faces 10000) with the launch counts
   checked (K2: the geo grids' slabs plus the texel chunks of each
   sample's texel count), each sample's voxel occupancy, object.obj
   (faces, vertices inside the AABB) and object.png (a 2048x2048 RGB PNG,
   parsed here with zlib), and the seconds of each stage per sample;
4f. sample 0's feat.npz decoded at reso 64, texture reso 256 on the card
   (K2, bf16) and on the host CPU (the plain versions, bf16 operands): the
   fp32 grids, each int8 grid against numpy's floor quantization of its
   own fp32 grid, the int8 voxels that differ (share bound
   INT8_SHARE_BOUND), sign flips, the marching-cubes face counts and the
   texels of one atlas compared; and the main path's reso-256 int8 grid
   is exactly the quantization of the card's fp32 grid, its sparse wire
   encoded on the card equal to its encoding on the CPU;
5. where a chain step's time goes, per configuration (default, stats
   chain, fused act): host-clock time per DDPM step and, from
   torch.profiler, the device's busy share, operations per step and top
   kernels;
6. training at the tag's full width: 6a one train step from the
   committed EMA at batch 2 on the card (TF32 off) against the port's
   plain code on the host CPU (loss terms, each leaf's grad, the updated
   params, EMA, mu and nu, worst leaf of each), the grads also against
   the same step in fp64 on the CPU; 6b `cli.train.main` on a
   temporary tag with `--enc_log` the committed encoding at the
   diffusion args.json's values (batch 32, steps_per_call 20, lr 5e-4,
   EMA 0.9999) for 100 steps, TF32 on as the CLI sets it: peak device
   memory, each dumped mean loss, the checkpoint files; then 80 more
   steps of the CLI's step with the launch counts set to 0 just before
   and read just after (K1 and K2: 0), ms per step and samples/s;
   6c a 5-step profile of the train step (busy share, operations,
   top device kernels); 6d `cli.sample --vox` DDIM-10 from what training
   wrote, with K1's and K2's launches counted;
8. AE training at the committed encoding args.json's width (skip heads,
   hidden 256 x 4, batch 65,536, fm_reso 128): 8a a synthetic textured
   shape (a box and a sphere, exact SDF, colour ramp) written by numpy
   as the mesh sampler's npz at the tag's 184x256x184 grid with 2M on-
   and 2M near-surface points; 8b one AE train step from the committed
   AE's params (warm AdamW) on the card with TF32 off against the host
   CPU (6a's tolerances, worst leaf of each), and each grad against the
   same step in fp64 on the CPU; 8c `cli.train.main` with
   `--data_path` that npz, 300 AE iterations and 20 diffusion steps
   (losses, mean_tsdf_acc >= 0.85, ckpt_final.pth's layout and step,
   feat.npz's planes, the rec mesh and PNG, the diffusion EMA; launches
   counted, in all and by shape); 8d K2's launches by stage and shape
   (evaluate, rec mesh; the AE train step none); 8e K2 on the trained
   weights against a fresh pack, bit for bit, the plain heads within
   the derived bound, and the fp64 head no further than the plain
   version, with a faulty head as the control; 8f the AE step's
   ms, points/s, peak memory, profile and share of its TF32 bound
   (K2's evaluate shape, the geo head over [2^20, 64], joins phase 3);
9. data preparation at full width: numpy writes a textured OBJ (a
   Kd-only box and a UV sphere with an 8-bit RGB map, 101,772 faces)
   whose grid is the tag's 184x256x184; `mesh_sampler.main` with the
   README's flags (--n_surf 5000000 --watertight, reso 256) writes the
   npz: its schema as the AE reads it, the grid and near-surface SDF
   within the sphere's chord error of the analytic SDF (signs equal
   beyond it), the box's colours exactly Kd and the sphere's within one
   texel's colour step of the map at their analytic UV, 20 AE steps on
   the card finite and falling; then reso 64 without --watertight
   through the winding-number remesh (signs equal beyond 2 of its
   cells); seconds per stage and the host's cores;
10. evaluation on the card: 10a LP (avg, percent) and Div of the 15
   committed grids 001-015 against grid 000, card and host per-patch
   arrays equal bit for bit, both within 1e-6 of JAX's values (P10_JAX);
   10b `eval_full.main --device cuda`, then `--device cpu`, over 4e's 2
   samples (their voxel.npz and 8 renders at 512 by the port's renderer)
   and the 15 grids against grid 000 and renders of phase 9's OBJ, with
   seeded weights in the 4 published layouts: every metric within
   P10_TOL, seconds per metric on both, render seconds per view;
7. a JSON line of every kernel's numbers, then as the last line
   {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TAG = os.path.join(ROOT, "checkpoints", "towerruins")

PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core rate
PEAK_TF32_FLOPS = 495e12    # H100 SXM dense TF32 tensor-core rate
PEAK_BYTES = 3.35e12        # H100 SXM HBM3

# tolerances of a kernel against its plain version on the same inputs
# bf16 out (K1): both sum in fp32 in different orders, then round once;
# allow 2 bf16 ulps of the reference value plus 2 ulps at 1% of the
# tensor's largest magnitude (cancellation near zero)
BF16_ULP = 2.0 ** -7
# fp32 (K1, K2 fp32 mode): summation order only
F32_TOL = 1e-4
# K2 with bf16 operands against its plain version at the kernel shapes:
# fp32 out; a hidden activation that rounds to the other bf16 neighbour
# moves the output by far less than one bf16 step of its largest value
K2_BF16_TOL = 2.0 ** -8
# The fp32 geo grid, K2 (bf16) on the card against the plain path on the
# host (bf16 operands too): the outputs are sums of terms W[i] h_i much
# larger than the sdf itself, so the bound scales with those terms, not
# with max |sdf|.  Both sides round every operand (x, each hidden
# activation h) to bf16 to nearest, each rounding at most 2^-8 |h| (8
# significant bits), so the two sides' operands differ by at most
# 2^-7 |h| beyond what earlier layers carried in; both sum in fp32 in
# their own orders.  Each such difference reaches the output through the
# head's Jacobian at the plain version's point, so to first order
# |card - plain| <= sum over operands of |d sdf / d h_i| 2^-7 |h_i|, plus
# the accumulation errors' and the inputs' measured difference's terms.
# For the last layer's operand that is 2^-7 sum_i |W_last[i] h_i|; the
# earlier layers add their own computed terms where a fixed margin factor
# stood.  The plain version computes it in fp32 for each voxel
# (`ops.fused_mlp.skip_mlp_bf16_bound`, through `geo_grid_bound`).
# int8 geo-grid voxels a bucket apart between K2 (bf16) and the plain
# version, as a share of the voxels at reso 64: 1.5x the largest of the
# 17 readings of scripts/torch_int8_share.py (seed 0: 1.049e-3), rounded
# up at one significant digit (PERF.md, PR 4)
INT8_SHARE_BOUND = 2e-3
# K1′ stats, fp32 sums of each side's own rounded y: against the kernel's
# own y in fp64, summation order only (k-term fp32 sums err by at most
# k * 2^-24 of the sum of |terms|; the kernel's longest run is 32 rows a
# thread, the torch sum of <= 184 block partials adds a tree), so 1e-5 of
# sum |y| (sum y^2) per channel; against the plain version's stats, also
# the per-element y differences the K1 tolerance allows, summed
STATS_TOL = 1e-5
# the UNet's configurations, as the environment selects them
CONFIGS = {
    "default": {"SIN3DM_STATS_CHAIN": "0", "SIN3DM_FUSED_ACT": "0"},
    "stats chain": {"SIN3DM_STATS_CHAIN": "1", "SIN3DM_FUSED_ACT": "0"},
    "fused act": {"SIN3DM_STATS_CHAIN": "0", "SIN3DM_FUSED_ACT": "1"},
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    by CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    times.sort()
    return times[len(times) // 2]


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def k1_groups():
    """The towerruins UNet's triplane 3x3 convs (planes 92x128 / 92x92 /
    128x92 and their halves), one K1 launch each: (planes, C, Co,
    launches per forward in the default configuration, {form: launches
    per forward under SIN3DM_STATS_CHAIN=1}).  Under SIN3DM_FUSED_ACT=1
    every launch is of the "act" form.  The stats chain chains the down
    blocks (64->64, 64->128) and the deepest up block (128->128); the
    192-channel up block stays default."""
    level0 = ((92, 128), (92, 92), (128, 92))
    level1 = ((46, 64), (46, 46), (64, 46))
    return [(level0, 64, 64, 3, {"act+stats": 1, "act+skip+stats": 1,
                                 "default": 1}),
            (level0, 192, 64, 1, {"default": 1}),
            (level1, 64, 128, 1, {"act+stats": 1}),
            (level1, 128, 128, 3, {"act+stats": 1, "act+skip+stats": 2})]


def group_inputs(g, B, planes, C, Co):
    """Seeded fp32 operands of one triplane conv, per plane: x, w, b, col3,
    row3, act, skip."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale
    out = []
    for H, W in planes:
        out.append({"x": rnd(B, H, W, C),
                    "w": rnd(3, 3, C, Co, scale=(9 * C) ** -0.5),
                    "b": rnd(Co, scale=0.1),
                    "col3": rnd(B, W, 3, Co, scale=0.3),
                    "row3": rnd(B, H, 3, Co, scale=0.3),
                    "act": (1.0 + rnd(B, C, scale=0.3), rnd(B, C, scale=0.5)),
                    "skip": rnd(B, H, W, Co)})
    return out


def plane_args(op, dt, form):
    """conv3x3_rollout's arguments for one plane in `form`, in dtype dt."""
    return (op["x"].to(dt), op["w"].to(dt), op["b"], op["col3"].to(dt),
            op["row3"].to(dt), op["act"] if "act" in form else None,
            op["skip"].to(dt) if "skip" in form else None, "stats" in form)


def triplane_args(ops, dt, form):
    per = [plane_args(op, dt, form) for op in ops]
    return [[a[k] for a in per] for k in range(7)] + [per[0][7]]


def k1_library(x, w, b, col3, row3):
    """Yardstick: cuDNN conv (channels-last) + the epilogue in torch."""
    import torch
    import torch.nn.functional as F
    H, W = x.shape[1], x.shape[2]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b.to(x.dtype),
                 padding=1).permute(0, 2, 3, 1)
    ch = torch.ones(H, dtype=torch.int64, device=x.device)
    ch[-1], ch[0] = 2, 0
    cw = torch.ones(W, dtype=torch.int64, device=x.device)
    cw[-1], cw[0] = 2, 0
    return y + col3[:, :, ch].permute(0, 2, 1, 3) + row3[:, :, cw]


def k1p_library(x, w, b, col3, row3, act, skip, emit_stats):
    """Yardstick for K1′: the activation as torch elementwise ops, cuDNN
    conv + the epilogue (`k1_library`), the skip add and torch sums."""
    import torch
    B, C = x.shape[0], x.shape[-1]
    if act is not None:
        a = (x.float() * act[0].reshape(B, 1, 1, C)
             + act[1].reshape(B, 1, 1, C))
        x = (a * torch.sigmoid(a)).to(x.dtype)
    y = k1_library(x, w, b, col3, row3)
    if skip is not None:
        y = y + skip
    if emit_stats:
        yf = y.float()
        return y, torch.stack([yf.sum((1, 2)), (yf * yf).sum((1, 2))], 1)
    return y


def library_ms(fn) -> dict:
    """The yardstick's time with cuDNN's default algorithm choice and with
    `cudnn.benchmark` (it tries the algorithms and keeps the fastest), by
    CUDA events and as device time of all its kernels."""
    import torch
    out = {}
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        key = "benchmark" if bench else "default"
        out[key] = time_ms(fn)
        out[key + "_device"] = device_ms(fn)
    torch.backends.cudnn.benchmark = False
    return out


def host_ms(fn, calls: int = 50) -> float:
    """Host time per call over `calls` calls issued back to back (the
    card's queue does not fill at these sizes), after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / calls


def device_ms(fn, name: str = "", calls: int = 10) -> float:
    """Device time per call of the kernels whose name holds `name` (all
    of them by default), from torch.profiler over `calls` calls.  The
    profiler now and then returns no device record for a whole window,
    so an empty window is profiled again, up to three times in all (nan
    if every one is empty)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if us:
            return sum(us) / 1e3 / calls
    return float("nan")


def k1_tol(ref, dt):
    """K1's per-element tolerance against its plain version."""
    import torch
    scale = ref.abs().max().item()
    if dt == torch.bfloat16:
        return 2 * BF16_ULP * (ref.abs() + 0.01 * scale)
    return torch.full_like(ref, F32_TOL * max(scale, 1.0))


def stats_errors(got_y, got_s, ref_y, ref_s, tol):
    """(error against fp64 sums of the kernel's own y, error against the
    plain version's stats), each as a multiple of its allowance (<= 1
    passes); see STATS_TOL."""
    import torch
    yk = got_y.double()
    own = torch.stack([yk.sum((1, 2)), (yk * yk).sum((1, 2))], 1)
    mass = torch.stack([yk.abs().sum((1, 2)), (yk * yk).sum((1, 2))], 1)
    allow_own = STATS_TOL * mass + 1e-30
    t = tol.double()
    ya = ref_y.double().abs()
    slack = torch.stack([t.sum((1, 2)), (2 * ya * t + t * t).sum((1, 2))], 1)
    e_own = ((got_s.double() - own).abs() / allow_own).max().item()
    e_ref = ((got_s.double() - ref_s.double()).abs()
             / (slack + allow_own)).max().item()
    return e_own, e_ref


def k1_bound_parts(B, planes, C, Co, form):
    """(operations, bytes) of one triplane launch: each input read once,
    each output written once."""
    flops = nbytes = 0.0
    for H, W in planes:
        flops += 2.0 * B * H * W * 9 * C * Co
        nbytes += (2.0 * (B * H * W * C + 9 * C * Co + B * W * 3 * Co
                          + B * H * 3 * Co + B * H * W * Co) + 4.0 * Co
                   + (4.0 * 2 * B * C if "act" in form else 0.0)
                   + (2.0 * B * H * W * Co if "skip" in form else 0.0)
                   + (4.0 * B * 2 * Co if "stats" in form else 0.0))
    return flops, nbytes


def check_k1_forms(B: int):
    """K1 and K1′ against their plain versions at every main-path plane
    shape where a form runs (default and act everywhere, the stats forms
    where the stats chain puts them), bf16 and fp32, one plane at a time;
    the triplane launch, its weights packed once as the UNet passes them,
    against the three single-plane launches, bit for bit, in every form;
    times per triplane launch in bf16 (kernel by CUDA events with
    `time_ms`, its device time from the profiler, the wrapper's host
    time, the plain version, the cuDNN yardstick without and with
    cudnn.benchmark, by events and as device time).  Returns per form
    {ms, device_ms, host_ms, plain_ms, library_ms (the faster yardstick
    by events), library_default_ms, library_benchmark_ms,
    library_device_ms (the faster by device time), flops, nbytes,
    max_abs_err, launches, and default_ms / default_device_ms: the default
    form over the same launches} per forward of its configuration."""
    import torch
    from sin3dm_tpu_torch.ops.fused_conv import (conv3x3_rollout,
                                                 conv3x3_rollout_reference,
                                                 conv3x3_rollout_triplane,
                                                 pack_conv_weights)
    g = torch.Generator(device="cuda").manual_seed(4)
    keys = ("ms", "device_ms", "host_ms", "plain_ms", "library_ms",
            "library_default_ms", "library_benchmark_ms",
            "library_device_ms", "flops", "nbytes")
    forms = {f: {**{k: 0.0 for k in keys}, "max_abs_err": 0.0,
                 "launches": 0, "default_ms": 0.0, "default_device_ms": 0.0}
             for f in ("default", "act", "act+stats", "act+skip+stats")}
    per_group = {}    # (C, Co) -> the default form's (ms, device ms)
    n_bitwise = 0
    for planes, C, Co, calls, chained in k1_groups():
        ops = group_inputs(g, B, planes, C, Co)
        packed = [pack_conv_weights(op["w"]) for op in ops]
        for form, f in forms.items():
            n = calls if form in ("default", "act") else chained.get(form, 0)
            if not n:
                continue
            stats = "stats" in form
            for dt in (torch.bfloat16, torch.float32):
                singles = []
                for (H, W), op in zip(planes, ops):
                    args = plane_args(op, dt, form)
                    got = conv3x3_rollout(*args)
                    ref = conv3x3_rollout_reference(*args)
                    torch.cuda.synchronize()
                    singles.append(got)
                    (gy, gs), (ry, rs) = (got, ref) if stats else \
                        ((got, None), (ref, None))
                    gy, ry = gy.float(), ry.float()
                    err = (gy - ry).abs()
                    tol = k1_tol(ry, dt)
                    ok = bool((err <= tol).all())
                    line = (f"K1 {form:14s} {str(dt)[6:]:8s} {H:3d}x{W:<3d} "
                            f"C={C:3d} Co={Co:3d}: max_abs_err "
                            f"{err.max().item():.3e}")
                    if stats:
                        e_own, e_ref = stats_errors(gy, gs, ry, rs, tol)
                        ok = ok and e_own <= 1.0 and e_ref <= 1.0
                        line += (f", stats err {e_own:.3f} of its own-sum "
                                 f"allowance, {e_ref:.3f} of the "
                                 "plain-version allowance")
                    print(f"{line} ({'ok' if ok else 'FAIL'})")
                    if not ok:
                        fail(f"K1 {form} {dt} {H}x{W} C={C} Co={Co} "
                             "disagrees with its plain version")
                    f["max_abs_err"] = max(f["max_abs_err"],
                                           err.max().item())
                # one triplane launch equals the three single-plane ones
                tri = conv3x3_rollout_triplane(*triplane_args(ops, dt, form),
                                               packed=packed)
                torch.cuda.synchronize()
                ty, ts = tri if stats else (tri, None)
                for i, one in enumerate(singles):
                    sy, ss = one if stats else (one, None)
                    same = torch.equal(ty[i], sy) and (
                        not stats or torch.equal(ts[i], ss))
                    n_bitwise += 1
                    if not same:
                        fail(f"K1 {form} {dt} C={C} Co={Co}: the triplane "
                             f"launch differs from plane {i}'s own launch")
            print(f"K1 {form} C={C} Co={Co} planes {list(planes)}: triplane "
                  "launch equals the three single-plane launches bit for "
                  "bit (bf16, fp32)")
            ta = triplane_args(ops, torch.bfloat16, form)
            per = [plane_args(op, torch.bfloat16, form) for op in ops]
            def launch():
                return conv3x3_rollout_triplane(*ta, packed=packed)

            ms = time_ms(launch)
            dev = device_ms(launch, "conv3x3_bf16")
            host = host_ms(launch)
            plain = time_ms(lambda: [conv3x3_rollout_reference(*a)
                                     for a in per])
            lib = library_ms(lambda: [k1p_library(*a) for a in per])
            lib_dev = min(lib["default_device"], lib["benchmark_device"])
            flops, nbytes = k1_bound_parts(B, planes, C, Co, form)
            bms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            print(f"K1 {form:14s} bf16 triplane C={C:3d} Co={Co:3d} x{n}/fwd: "
                  f"kernel {ms * 1e3:.2f} us (device {dev * 1e3:.2f} us, "
                  f"wrapper host {host * 1e3:.2f} us), plain "
                  f"{plain * 1e3:.2f} us, library {lib['default'] * 1e3:.2f}"
                  f" us (device {lib['default_device'] * 1e3:.2f} us; "
                  f"cudnn.benchmark {lib['benchmark'] * 1e3:.2f} us, device "
                  f"{lib['benchmark_device'] * 1e3:.2f} us), bound "
                  f"{bms * 1e3:.3f} us ({by})")
            if form == "default":
                per_group[(C, Co)] = (ms, dev)
            else:   # the default form over the same launches, to compare
                f["default_ms"] += n * per_group[(C, Co)][0]
                f["default_device_ms"] += n * per_group[(C, Co)][1]
            for k, v in (("ms", ms), ("device_ms", dev), ("host_ms", host),
                         ("plain_ms", plain),
                         ("library_ms", min(lib["default"],
                                            lib["benchmark"])),
                         ("library_default_ms", lib["default"]),
                         ("library_benchmark_ms", lib["benchmark"]),
                         ("library_device_ms", lib_dev),
                         ("flops", flops), ("nbytes", nbytes)):
                f[k] += n * v
            f["launches"] += n
    for form, f in forms.items():
        f["bound_ms"], f["bound_by"] = bound(f["flops"], f["nbytes"],
                                             PEAK_BF16_FLOPS)
        print(f"K1 {form} per UNet forward of its configuration (batch {B}, "
              f"{f['launches']} launches): kernel {f['ms']:.4f} ms (device "
              f"{f['device_ms']:.4f} ms, wrapper host {f['host_ms']:.4f} "
              f"ms), plain {f['plain_ms']:.4f} ms, library "
              f"{f['library_ms']:.4f} ms (default "
              f"{f['library_default_ms']:.4f}, cudnn.benchmark "
              f"{f['library_benchmark_ms']:.4f}; device "
              f"{f['library_device_ms']:.4f}), bound {f['bound_ms']:.5f} "
              f"ms ({f['bound_by']})")
    print(f"K1: {n_bitwise} triplane planes equal their single-plane "
          "launches bit for bit")
    return forms


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def k2_library(params, x):
    """Yardstick: the head as a chain of bf16 torch.matmul calls."""
    import torch
    ws = [(lp["w"].bfloat16(), lp["b"].bfloat16())
          for lp in params["first"] + params["second"]]
    xb = x.bfloat16()
    h = xb
    n_first = len(params["first"])
    for i, (w, b) in enumerate(ws):
        if i == n_first:
            h = torch.cat([xb, h], dim=-1)
        h = torch.matmul(h, w) + b
        if i != len(ws) - 1:
            h = torch.relu(h)
    return h


def k2_times(params, x) -> dict:
    """K2 (bf16) on x: times of the kernel (CUDA events, and its device
    time from the profiler), the plain version and the `torch.matmul`
    yardstick (events and device), with the call's operations, bytes and
    bound."""
    import torch
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp, skip_mlp_reference

    def kernel():
        return skip_mlp(params, x, mxu_dtype=torch.bfloat16)

    layers = params["first"] + params["second"]
    n_rows, cin = x.shape
    cout = layers[-1]["w"].shape[1]
    flops = 2.0 * n_rows * sum(lp["w"].shape[0] * lp["w"].shape[1]
                               for lp in layers)
    nbytes = (4.0 * n_rows * (cin + cout)
              + sum(2.0 * lp["w"].numel() + 4.0 * lp["b"].numel()
                    for lp in layers))
    bms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    return {"ms": time_ms(kernel, iters=5),
            "device_ms": device_ms(kernel, "mlp_bf16", calls=5),
            "plain_ms": time_ms(lambda: skip_mlp_reference(
                params, x, torch.bfloat16), iters=5),
            "library_ms": time_ms(lambda: k2_library(params, x), iters=5),
            "library_device_ms": device_ms(lambda: k2_library(params, x),
                                           calls=5),
            "flops": flops, "nbytes": nbytes, "bound_ms": bms,
            "bound_by": by}


def check_k2(ae_params, n_rows: int):
    import torch
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp, skip_mlp_reference
    g = torch.Generator(device="cuda").manual_seed(2)
    totals = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
              "library_ms": 0.0, "library_device_ms": 0.0, "bound_ms": 0.0}
    flops_all = nbytes_all = 0.0
    max_err = 0.0
    for head in ("geo_decoder", "tex_decoder"):
        params = ae_params[head]
        cin = params["first"][0]["w"].shape[0]
        x = torch.randn(n_rows, cin, generator=g, device="cuda") * 0.5
        for dt, tol_rel in ((torch.bfloat16, K2_BF16_TOL),
                            (torch.float32, F32_TOL)):
            got = skip_mlp(params, x, mxu_dtype=dt)
            ref = skip_mlp_reference(params, x, mxu_dtype=dt)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = err <= tol_rel * max(scale, 1e-6)
            print(f"K2 {str(dt)[6:]:8s} {head} N={n_rows}: max_abs_err "
                  f"{err:.3e}, max_rel_err {err / max(scale, 1e-6):.3e} of "
                  f"max |ref| {scale:.3e} (tol {tol_rel:.3e}) "
                  f"({'ok' if ok else 'FAIL'})")
            if not ok:
                fail(f"K2 {dt} {head} disagrees with its plain version")
            max_err = max(max_err, err)
        t = k2_times(params, x)
        ms, dev, plain, lib, lib_dev, flops, nbytes = (
            t[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                           "library_device_ms", "flops", "nbytes"))
        bms, by = t["bound_ms"], t["bound_by"]
        print(f"K2 bf16 {head} N={n_rows}: kernel {ms:.3f} ms (device "
              f"{dev:.3f} ms), plain {plain:.3f} ms, library {lib:.3f} ms "
              f"(device {lib_dev:.3f} ms), bound {bms:.3f} ms ({by}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s")
        for k, v in (("ms", ms), ("device_ms", dev), ("plain_ms", plain),
                     ("library_ms", lib), ("library_device_ms", lib_dev)):
            totals[k] += v
        flops_all += flops
        nbytes_all += nbytes
    totals["bound_ms"], by = bound(flops_all, nbytes_all, PEAK_BF16_FLOPS)
    print(f"K2 per slab (both heads): kernel {totals['ms']:.3f} ms (device "
          f"{totals['device_ms']:.3f}), plain {totals['plain_ms']:.3f} ms, "
          f"library {totals['library_ms']:.3f} ms (device "
          f"{totals['library_device_ms']:.3f}), bound "
          f"{totals['bound_ms']:.3f} ms ({by}): "
          f"{totals['bound_ms'] / totals['ms']:.1%} of the bound by events, "
          f"{totals['bound_ms'] / totals['device_ms']:.1%} by device time; "
          f"{totals['library_ms'] / totals['ms']:.2f}x the library's speed "
          "by events, "
          f"{totals['library_device_ms'] / totals['device_ms']:.2f}x by "
          "device time")
    return {**totals, "max_abs_err": max_err, "bound_by": by}


def check_k2_shapes(ae_params, cases):
    """K2 at the shapes the mesh path and `evaluate` give it, one head
    alone per case (key, head, rows): the geo head over a dense x-slab
    and over an on-surface chunk of 2^20 points (-> 1), the texture head
    over one texel chunk (-> 3); bf16, against the plain version and
    timed as `check_k2` times it.  Returns {key: numbers}."""
    import torch
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp, skip_mlp_reference
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for key, head, n_rows in cases:
        params = ae_params[head]
        cin = params["first"][0]["w"].shape[0]
        x = torch.randn(n_rows, cin, generator=g, device="cuda") * 0.5
        got = skip_mlp(params, x, mxu_dtype=torch.bfloat16)
        ref = skip_mlp_reference(params, x, mxu_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= K2_BF16_TOL * max(scale, 1e-6):
            fail(f"K2 bf16 {head} N={n_rows} disagrees with its plain "
                 f"version: {err:.3e} of {scale:.3e}")

        t = k2_times(params, x)
        cout = got.shape[1]
        print(f"K2 bf16 {head} alone N={n_rows} -> {cout} ({key}): "
              f"max_abs_err {err:.3e} of max |ref| {scale:.3e} (ok); kernel "
              f"{t['ms']:.3f} ms (device {t['device_ms']:.3f} ms), plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms "
              f"(device {t['library_device_ms']:.3f} ms), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}): "
              f"{t['bound_ms'] / t['device_ms']:.1%} of the bound by device "
              "time")
        out[key] = {"rows": n_rows, "cout": cout, "max_abs_err": err,
                     **{k: t[k] for k in ("ms", "device_ms", "plain_ms",
                                          "library_ms", "library_device_ms",
                                          "bound_ms", "bound_by")}}
    return out


# ---------------------------------------------------------------------------
# Where a chain step's time goes
# ---------------------------------------------------------------------------

def device_profile(run, n_steps: int, label: str, top: int = 8) -> dict:
    """`run()` (n_steps steps, ending in a sync) under torch.profiler:
    prints and returns the device's busy time per step (the union of its
    kernels' intervals), operations per step and the kernels that take
    the most device time; {} where it recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        print(f"{label}: device busy share not measured (the profiler "
              "recorded no device activity)")
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in ops)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:          # union of the device's busy intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in ops:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    tops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (n, us) in tops:
        print(f"  {us / 1e3 / n_steps:8.4f} ms/step {n / n_steps:6.1f} "
              f"launches/step  {name[:90]}")
    return {"busy_ms": busy_us / 1e3 / n_steps,
            "ops_per_step": len(ops) / n_steps,
            "top": [{"name": name[:120], "ms_per_step": us / 1e3 / n_steps,
                     "launches_per_step": n / n_steps}
                    for name, (n, us) in tops]}


def profile_chain(argv, n_steps: int = 10) -> dict:
    """The main path's reverse chain cut to its last `n_steps` DDPM steps
    (same model, batch 2): host-clock time per step, then under
    torch.profiler the device's busy time, its operations per step and
    the kernels that take the most device time."""
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core.triplane import load_triplane_npz
    from sin3dm_tpu_torch.diffusion.sampling import make_sampler

    args = cli.cfgmod.sample_args(argv)
    dev = cli.resolve_device(args.device)
    feat = load_triplane_npz(cli.cfgmod.encoding_feat_path(args.tag))
    model, tables, dcfg = cli.build_model(args, dev)
    sample = make_sampler(model, {k: v[:n_steps] for k, v in tables.items()},
                          dcfg, device=dev)

    def run():
        sample(args.seed, 0, 2, feat.channels, feat.sizes)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    print(f"chain step (batch 2, {n_steps} steps): {step_ms:.3f} ms per "
          "step, host clock")
    p = device_profile(run, n_steps, "chain step")
    if p:
        print(f"chain step: device busy {p['busy_ms']:.3f} ms per step "
              f"({p['busy_ms'] / step_ms:.1%} of the host-clock step, idle "
              f"{1 - p['busy_ms'] / step_ms:.1%}), {p['ops_per_step']:.0f} "
              "device operations per step")
    return {"step_ms": step_ms, **{k: p[k] for k in ("busy_ms",
                                                     "ops_per_step")
                                   if k in p}}


# ---------------------------------------------------------------------------

@contextlib.contextmanager
def configuration(name: str):
    """The UNet configuration `name` of CONFIGS for a `with` block; the
    environment is restored after it."""
    old = {k: os.environ.get(k) for k in CONFIGS[name]}
    os.environ.update(CONFIGS[name])
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reset_counts() -> None:
    from sin3dm_tpu_torch.ops.fused_conv import conv3x3_rollout
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp
    conv3x3_rollout.launches = 0
    conv3x3_rollout.form_launches = {}
    skip_mlp.launches = 0
    skip_mlp.shape_launches = {}


def read_counts() -> dict:
    from sin3dm_tpu_torch.ops.fused_conv import conv3x3_rollout
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp
    return {"k1": conv3x3_rollout.launches,
            "k1_forms": dict(conv3x3_rollout.form_launches),
            "k2": skip_mlp.launches,
            "k2_shapes": {shape_key(*k): v for k, v in
                          skip_mlp.shape_launches.items()}}


def shape_key(rows: int, cin: int, cout: int) -> str:
    """A K2 launch shape as the counts by shape name it."""
    return f"[{rows}, {cin}] -> {cout}"


def drive_vox(label: str, argv, want_forms: dict, want_k2: int,
              occupancy: bool = True):
    """`cli.main(argv + --output <tmp>)` with the launch counts set to 0
    just before and read just after; checks the per-form K1 and the K2
    counts, the feat.npz and voxel grids (and each grid's occupancy).
    Returns (main's result, counts, per-sample feat planes)."""
    import numpy as np
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    out_dir = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_")
    try:
        reset_counts()
        res = cli.main(argv + ["--output", out_dir])
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"{label}: K1 launches by form {counts['k1_forms']} (want "
              f"{want_forms}), K2 launches {counts['k2']} (want {want_k2})")
        if counts["k1_forms"] != want_forms or counts["k2"] != want_k2:
            fail(f"{label}: the path did not launch the kernels as "
                 "expected")
        feats = []
        n = len(res["paths"])
        reso = cli.cfgmod.sample_args(argv).reso
        for j in range(n):
            d = os.path.join(out_dir, f"{j:03d}")
            with np.load(os.path.join(d, "feat.npz")) as f:
                planes = [f[k] for k in ("feat_xy", "feat_xz", "feat_yz")]
            if not all(np.isfinite(p).all() for p in planes):
                fail(f"{label} sample {j}: non-finite feat.npz")
            feats.append(planes)
            with np.load(os.path.join(d, f"r{reso}_voxel.npz")) as v:
                grid = v["vox_grid"]
            occ = float(grid.mean())
            print(f"{label} sample {j}: feat {[p.shape for p in planes]}, "
                  f"voxel grid {tuple(grid.shape)}, occupancy {occ:.4f}")
            if occupancy and not 0.15 <= occ <= 0.19:
                fail(f"{label} sample {j}: occupancy {occ:.4f} outside "
                     "[0.15, 0.19] (committed JAX samples: 0.1667-0.1693)")
        print(f"{label}: chain {res['sample_seconds'] / n:.3f} s per sample "
              f"({res['sample_seconds']:.3f} s in all, batch {n}), decode "
              f"{res['decode_seconds']:.3f} s for {n} grids")
        return res, counts, feats
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def forward_parity(B: int = 2):
    """One full-width forward of the towerruins EMA UNet on one seeded
    input, per configuration; the stats chain and the fused act against
    the default with the bound of the JAX package's own stats-chain test
    (tests/test_fused_conv.py): |o - r| <= 0.05 + 0.05 |r|, mean < 5e-3."""
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core.triplane import Triplane, load_triplane_npz
    args = cli.cfgmod.sample_args(["--tag", TAG])
    dev = torch.device("cuda")
    model, _, _ = cli.build_model(args, dev)
    H, W, D = load_triplane_npz(cli.cfgmod.encoding_feat_path(TAG)).sizes
    g = torch.Generator(device="cuda").manual_seed(5)
    x = Triplane(*[torch.randn(B, a, b, 12, generator=g, device="cuda")
                   for a, b in ((H, W), (H, D), (W, D))])
    t = torch.tensor([500, 20], device="cuda")[:B]
    outs = {}
    for name in CONFIGS:
        with configuration(name):
            outs[name] = model(x, t)
    torch.cuda.synchronize()
    worst = 0.0
    for name in ("stats chain", "fused act"):
        for plane, o, r in zip(("xy", "xz", "yz"), outs[name],
                               outs["default"]):
            d = (o - r).abs()
            ratio = (d / (0.05 + 0.05 * r.abs())).max().item()
            mean = d.mean().item()
            ok = ratio <= 1.0 and mean < 5e-3 and bool(o.isfinite().all())
            print(f"forward parity {name} vs default, {plane}: max_abs "
                  f"{d.max().item():.3e}, mean_abs {mean:.3e}, "
                  f"{ratio:.3f} of the bound ({'ok' if ok else 'FAIL'})")
            if not ok:
                fail(f"forward parity: {name} {plane} outside the bound")
            worst = max(worst, d.max().item())
    return worst


def check_inpaint(feats, H: int) -> None:
    """As tests/test_e2e.py checks the JAX CLI: rows >= H/2 of xy and xz
    equal the tag's feat.npz to 1e-5, yz everywhere, and the regenerated
    half moved by more than 1e-3."""
    import numpy as np
    with np.load(os.path.join(TAG, "encoding", "feat.npz")) as f:
        y0 = [f[k] for k in ("feat_xy", "feat_xz", "feat_yz")]
    h2 = H // 2
    for j, (xy, xz, yz) in enumerate(feats):
        kept = max(np.abs(xy[:, h2:] - y0[0][:, h2:]).max(),
                   np.abs(xz[:, h2:] - y0[1][:, h2:]).max(),
                   np.abs(yz - y0[2]).max())
        moved = np.abs(xy[:, :h2] - y0[0][:, :h2]).max()
        ok = kept <= 1e-5 and moved > 1e-3
        print(f"inpaint sample {j}: kept cells max |feat - y0| {kept:.3e} "
              f"(<= 1e-5), regenerated half max |feat - y0| {moved:.3e} "
              f"(> 1e-3) ({'ok' if ok else 'FAIL'})")
        if not ok:
            fail(f"inpaint sample {j}: kept {kept:.3e}, moved {moved:.3e}")


# ---------------------------------------------------------------------------
# The mesh path
# ---------------------------------------------------------------------------

def texel_chunks(n: int, batch: int = 2 ** 20) -> int:
    """K2 launches of one sample's texel decode (sdftex: one head): chunks
    of a power of two rows, 2^12 to 2^20 (`_dispatch_texels_runs`)."""
    batch = min(batch, 1 << max(12, max(n - 1, 1).bit_length()))
    return len(range(0, max(n, 1), batch))


def check_png(path: str, size: int) -> None:
    """A valid 8-bit RGB PNG of size x size: signature, chunk CRCs, IHDR,
    and the inflated IDAT's length and filter bytes (no PIL here)."""
    import struct
    import zlib
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG")
    pos, idat, ihdr, tags = 8, b"", None, []
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            fail(f"{path}: bad CRC in {tag!r}")
        tags.append(tag)
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    if tags[0] != b"IHDR" or tags[-1] != b"IEND" or ihdr is None:
        fail(f"{path}: chunks {tags}")
    if ihdr != (size, size, 8, 2, 0, 0, 0):
        fail(f"{path}: IHDR {ihdr}, want {size}x{size} 8-bit RGB")
    raw = zlib.decompress(idat)
    row = 1 + 3 * size
    if len(raw) != size * row or max(raw[::row]) > 4:
        fail(f"{path}: {len(raw)} inflated bytes, want {size * row}")


def obj_mesh(path: str):
    """(vertices [n, 3], face count) of an object.obj."""
    import numpy as np
    v, nf = [], 0
    with open(path) as fh:
        for ln in fh:
            if ln.startswith("v "):
                v.append([float(x) for x in ln.split()[1:4]])
            elif ln.startswith("f "):
                nf += 1
    return np.asarray(v, np.float64).reshape(-1, 3), nf


STAGES = (("chain", ("chain",)), ("grid", ("sdf grid",)),
          ("marching cubes", ("marching cubes",)),
          ("decimation", ("decimation",)),
          ("uv atlas + raster", ("uv atlas + raster",)),
          ("texel decode", ("texel dispatch", "texel decode")),
          ("export", ("voxel.npz", "texture assembly", "export")))


def drive_mesh(argv, want_k1: dict, aabb, reso: int, texreso: int,
               n_faces: int, slabs: int):
    """`cli.main(argv + --output <dir>)`, the mesh path, with the launch
    counts set to 0 just before and read just after.  Checks K1 against
    `want_k1`, K2 against `slabs` geo launches per sample plus each
    sample's texel chunks, and each sample's outputs.  Returns (main's
    result, counts, output dir, per-sample stage seconds); the caller
    removes the directory."""
    import numpy as np
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    out_dir = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_mesh_")
    reset_counts()
    res = cli.main(argv + ["--output", out_dir])
    torch.cuda.synchronize()
    counts = read_counts()
    n = len(res["paths"])
    texels = {e["dir"]: e["texels"] for e in res["stages"]
              if e["stage"] == "texel dispatch"}
    if len(texels) != n:
        fail(f"mesh path: texel decodes for {len(texels)} of {n} samples")
    want_k2 = n * slabs + sum(texel_chunks(t) for t in texels.values())
    print(f"mesh path: K1 launches by form {counts['k1_forms']} (want "
          f"{want_k1}), K2 launches {counts['k2']} (want {want_k2}: {n} x "
          f"{slabs} geo-grid slabs + texel chunks of "
          f"{sorted(texels.values())} texels)")
    if counts["k1_forms"] != want_k1 or counts["k2"] != want_k2:
        fail("mesh path: the path did not launch the kernels as expected")
    lo, hi = np.asarray(aabb[:3]), np.asarray(aabb[3:])
    voxel = (hi.max() - lo.min()) / reso
    per_sample = {}
    for j in range(n):
        d = os.path.join(out_dir, f"{j:03d}")
        with np.load(os.path.join(d, "voxel.npz")) as f:
            grid = f["vox_grid"]
        occ = float(grid.mean())
        v, nf = obj_mesh(os.path.join(d, "object.obj"))
        inside = bool(((v >= lo - voxel) & (v <= hi + voxel)).all())
        check_png(os.path.join(d, "object.png"), texreso)
        with open(os.path.join(d, "object.mtl")) as fh:
            mtl_ok = "map_Kd object.png" in fh.read()
        print(f"mesh path sample {j}: voxel grid {tuple(grid.shape)}, "
              f"occupancy {occ:.4f}; object.obj {nf} faces, {len(v)} "
              f"vertices, inside the AABB widened by one voxel: {inside}; "
              f"object.png {texreso}x{texreso} RGB, valid; "
              f"{texels[d]} texels")
        if not 0.15 <= occ <= 0.19:
            fail(f"mesh path sample {j}: occupancy {occ:.4f} outside "
                 "[0.15, 0.19]")
        if not (0 < nf <= n_faces and inside and mtl_ok):
            fail(f"mesh path sample {j}: {nf} faces, inside {inside}, "
                 f"mtl {mtl_ok}")
        secs = {}
        for e in res["stages"]:
            if e["dir"] == d:
                secs[e["stage"]] = secs.get(e["stage"], 0.0) + e["seconds"]
                if e["stage"] == "sdf grid":
                    secs["sdf grid"] += e["dispatch"]
        per_sample[j] = {name: sum(secs.get(k, 0.0) for k in keys)
                         for name, keys in STAGES}
        print(f"mesh path sample {j} seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in per_sample[j].items()))
    print(f"mesh path: generate {res['seconds']:.3f} s for {n} samples "
          f"({res['seconds'] / n:.3f} s per sample), host clock ending in "
          "a device sync; stage seconds are host-clock spans (the export "
          "runs on a worker thread beside the next sample's geometry)")
    return res, counts, out_dir, per_sample


def floor_quant(sdf, quant: float):
    """The int8 wire's buckets of an fp32 grid, in numpy:
    floor(clip(sdf / q, -1, 1) * 127) in fp32, with a true division."""
    import numpy as np
    one = np.float32(1.0)
    return np.floor(np.clip(sdf / np.float32(quant), -one, one)
                    * np.float32(127.0)).astype(np.int8)


def geo_grid_bound(card, host, feat, res, slab: int = 8):
    """Per voxel of the dense geo grid at `res`, how far the card's K2 may
    lie from the host's plain version (`skip_mlp_bf16_bound` of the host's
    head inputs, with the card's and host's inputs' measured difference),
    in fp32 on the host.  Returns `[Nx, Ny, Nz]`."""
    import torch
    from sin3dm_tpu_torch.models import autoencoder as ae
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp_bf16_bound
    head = host.params["geo_decoder"]
    out = []
    with torch.no_grad():
        slabs = [ae.grid_slab_features(tr._planes(feat)[0], res, slab)
                 for tr in (card, host)]
        for (_, xc), (_, xh) in zip(*slabs):
            out.append(skip_mlp_bf16_bound(head, xh, (xc.cpu() - xh).abs()))
    return torch.cat(out)[:, 0].reshape(res).numpy()


def int8_vs_plain(card, host, feat, reso: int, quant: float) -> dict:
    """One triplane's geo grid at `reso` decoded by two trainers, the
    card's (K2, bf16) and the host CPU's (the plain versions, bf16
    operands), each as fp32 and as the path's int8 wire
    (`decode_grid_dense(geo_only, quant_scale=quant)`).  Returns the fp32
    grids' max abs difference, the derived bound on it (`geo_grid_bound`)
    as the largest ratio of a voxel's difference to its own bound and as
    the largest difference over the largest bound, whether each side's
    int8 grid equals numpy's floor(clip(fp32 / q, -1, 1) * 127) of its own
    fp32 grid (a true division) exactly, the int8 voxels that differ
    (count, share, largest difference in buckets), the sign flips and both
    int8 grids."""
    import numpy as np
    from sin3dm_tpu_torch.dataio.grid import grid_resolutions
    from sin3dm_tpu_torch.models import autoencoder as ae
    res = tuple(int(x) for x in grid_resolutions(card._feat_aabb(feat),
                                                 reso))
    fp32, int8 = [], []
    for tr in (card, host):
        gp, tp = tr._planes(feat)
        for out, q in ((fp32, None), (int8, quant)):
            out.append(ae.decode_grid_dense(
                tr.params, tr.acfg, gp, tp, res, geo_only=True,
                quant_scale=q)[..., 0].cpu().numpy())
    exact = [bool(np.array_equal(g, floor_quant(f, quant)))
             for f, g in zip(fp32, int8)]
    d = np.abs(int8[0].astype(np.int32) - int8[1].astype(np.int32))
    n_diff = int((d > 0).sum())
    err = np.abs(fp32[0] - fp32[1])
    tol = geo_grid_bound(card, host, feat, res)
    return {"res": res, "fp32_err": float(err.max()),
            "tol_max": float(tol.max()),
            "ratio_voxel": float((err / tol).max()),
            "ratio_max": float(err.max() / tol.max()),
            "exact": exact, "voxels": d.size, "differ": n_diff,
            "share": n_diff / d.size,
            "max_bucket": int(d.max()),
            "flips": int(((int8[0] < 0) != (int8[1] < 0)).sum()),
            "grids": int8}


def card_vs_plain(feat_path: str, reso: int = 64, texreso: int = 256):
    """Sample 0's feat.npz at `reso`/`texreso` on the card (K2, bf16) and on
    the host CPU (the plain versions, bf16 operands).  Every check runs and
    prints before any failure is raised:

    - the fp32 sdf grids within the derived bound of each voxel
      (`geo_grid_bound`);
    - each side's int8 grid exactly the floor quantization of its own fp32
      grid (`int8_vs_plain`);
    - the int8 grids: voxels that differ do so by one bucket, at most
      INT8_SHARE_BOUND of them; sign flips at most 1e-4 of the voxels, and
      equal marching-cubes face counts wherever no sign flipped;
    - the texel decode of one atlas (the card's mesh): none off by more
      than 2, fewer than 1 % by more than 1 (hidden activations may round
      to the other bf16 neighbour);
    - the main path's reso-256 int8 grid (`_dispatch_geo_grid`) exactly
      the floor quantization of the card's fp32 grid, and its sparse wire
      encoded on the card equal to its encoding on the CPU (the block
      order compared exactly)."""
    import numpy as np
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core.triplane import load_triplane_npz
    from sin3dm_tpu_torch.geometry import meshproc, uvatlas
    from sin3dm_tpu_torch.models import autoencoder as ae
    from sin3dm_tpu_torch.ops import sparse_grid
    args = cli.cfgmod.sample_args(["--tag", TAG])
    card = cli._make_trainer(args, torch.device("cuda"))
    host = cli._make_trainer(args, torch.device("cpu"))
    feat = load_triplane_npz(feat_path)
    aabb = card._feat_aabb(feat)
    quant = float(card.meta["threshold"])
    failed = []

    r = int8_vs_plain(card, host, feat, reso, quant)
    ok = r["ratio_voxel"] <= 1.0
    print(f"card vs plain, fp32 sdf grid {r['res']} at reso {reso}: "
          f"max_abs_err {r['fp32_err']:.3e}; per-voxel bound (the bf16 "
          f"roundings through the head's Jacobian), largest "
          f"{r['tol_max']:.3e}: worst voxel at {r['ratio_voxel']:.4f} of "
          f"its bound, max err / max bound {r['ratio_max']:.4f} "
          f"({'ok' if ok else 'FAIL'})")
    if not ok:
        failed.append("fp32 sdf grid")
    print(f"int8 grid = floor(clip(fp32 / q, -1, 1) * 127) of its own fp32 "
          f"grid, exactly: card {r['exact'][0]}, host {r['exact'][1]} "
          f"({'ok' if all(r['exact']) else 'FAIL'})")
    if not all(r["exact"]):
        failed.append("int8 quantization")
    gc, gh = r["grids"]
    n = gc.size
    meshes = [meshproc.sdfgrid_to_mesh((g.astype(np.float32) + 0.5)
                                       * (quant / 127.0)) for g in (gc, gh)]
    faces = [len(m[1]) for m in meshes]
    ok = (r["max_bucket"] <= 1 and r["share"] <= INT8_SHARE_BOUND
          and r["flips"] <= 1e-4 * n
          and (r["flips"] > 0 or faces[0] == faces[1]))
    print(f"card vs plain, int8 grid {gc.shape}: {r['differ']} voxels differ "
          f"({r['share']:.3e} of them, bound {INT8_SHARE_BOUND:.1e}), max "
          f"{r['max_bucket']} bucket; {r['flips']} sign flips "
          f"({r['flips'] / n:.2e}, bound 1e-4); marching cubes {faces[0]} / "
          f"{faces[1]} faces ({'ok' if ok else 'FAIL'})")
    if not ok:
        failed.append("int8 grid")

    # the texels of one atlas: the card's mesh, as the path builds it
    v, f = meshes[0]
    box = aabb[3:].max() - aabb[:3].min()
    v, f = meshproc.mesh_decimation(v / reso * box + aabb[:3], f, 10000)
    _, _, mask, runs = uvatlas.uv_unwrap_and_rasterize_runs(v, f, texreso)
    tc = card._dispatch_texels_runs(feat, runs, aabb)
    th = host._dispatch_texels_runs(feat, runs, aabb)
    n = tc[1]
    tex_c = np.concatenate(tc[0].wait())[:n].astype(np.int32)
    tex_h = np.concatenate(th[0].wait())[:n].astype(np.int32)
    dt = np.abs(tex_c - tex_h)
    ok = dt.max() <= 2 and (dt > 1).mean() < 0.01
    print(f"card vs plain, texels of one atlas ({n} texels at texture reso "
          f"{texreso}): max diff {dt.max()}, {(dt > 0).mean():.3%} differ, "
          f"{(dt > 1).mean():.3%} by more than 1 ({'ok' if ok else 'FAIL'})")
    if not ok:
        failed.append("texels")

    # the main path's reso-256 grid: its int8 buckets from the card's fp32
    # grid, and the sparse wire's block order on the card
    h = card._dispatch_geo_grid(feat, 256, aabb)
    sc = h.fetch.wait()
    gp, tp = card._planes(feat)
    f256 = ae.decode_grid_dense(card.params, card.acfg, gp, tp,
                                tuple(h.grid.shape), geo_only=True)
    exact = bool(np.array_equal(h.grid.cpu().numpy(),
                                floor_quant(f256[..., 0].cpu().numpy(),
                                            h.quant)))
    print(f"reso-256 int8 grid {tuple(h.grid.shape)} = floor(clip(fp32 / q, "
          f"-1, 1) * 127) of the card's fp32 grid, exactly: {exact}")
    if not exact:
        failed.append("reso-256 int8 quantization")
    sh = sparse_grid.encode(h.grid.cpu())
    cnt = int(sh.count)
    same = (int(sc[3]) == cnt and np.array_equal(sc[0], sh.signs.numpy())
            and np.array_equal(sc[1][:cnt], sh.block_ids.numpy()[:cnt])
            and np.array_equal(sc[2][:cnt], sh.block_vals.numpy()[:cnt]))
    print(f"sparse wire of the reso-256 grid {tuple(h.grid.shape)}: {cnt} "
          f"flagged blocks of capacity {len(sc[1])}; the card's encoding "
          f"equals the CPU's: {same}")
    if not same:
        failed.append("sparse wire")
    if failed:
        fail(f"card vs plain: {', '.join(failed)} outside the bounds")
    return {"fp32_max_abs_err": r["fp32_err"],
            "fp32_bound_ratio_voxel": r["ratio_voxel"],
            "fp32_bound_ratio_max": r["ratio_max"],
            "int8_exact": r["exact"] + [exact],
            "int8_voxels_differing": r["differ"], "int8_share": r["share"],
            "sign_flips": r["flips"], "faces": faces,
            "texel_max_diff": int(dt.max()),
            "texels_differing": float((dt > 0).mean()),
            "sparse_flagged_blocks": cnt}


# ---------------------------------------------------------------------------
# Phase 6: training
# ---------------------------------------------------------------------------

# `cli.train` at the committed diffusion args.json's values (batch 32,
# steps_per_call 20, lr 5e-4, EMA 0.9999; the rest are the defaults),
# cut to 100 steps
TRAIN_ARGV = ["--diff_batch_size", "32", "--steps_per_call", "20",
              "--diff_lr", "5e-4", "--ema_rate", "0.9999", "--diff_n_iters",
              "100", "--save_interval", "100", "--log_interval", "20"]
EMA_PATH = os.path.join(TAG, "diffusion", "ema_0.9999_025000.pt")
# the warm optimiser state of 6a: from a fresh state AdamW's first step is
# g / (|g| + eps), which turns the roundoff of near-zero grads (|g| ~ eps)
# into steps of up to lr on either side; with mu, nu of the grads' sizes
# a grad's roundoff moves its step by (1 - b1) dg / sqrt(nu_hat) of lr
WARM_COUNT = 100


@contextlib.contextmanager
def tf32(on: bool):
    """cuDNN convs and matmuls with TF32 (`on`) or full fp32 for a block."""
    import torch
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _errs(state, got, want, scale: bool) -> dict:
    """Per leaf of two flat buffers of `state`'s layout, max |got - want|,
    over the leaf's max |want| where `scale`."""
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    gl = dict(ckpt.leaves_with_paths(state.tree(got)))
    out = {}
    for p, w in ckpt.leaves_with_paths(state.tree(want)):
        e = (gl[p] - w).abs().max().item()
        out[p] = e / max(w.abs().max().item(), 1e-30) if scale else e
    return out


def _worst(state, got, want, scale: bool):
    """(worst ratio or abs error, its leaf) of `_errs`."""
    e = _errs(state, got, want, scale)
    leaf = max(e, key=e.get)
    return e[leaf], leaf


def train_step_flops(ucfg, sizes, B: int) -> dict:
    """Operations of one train step of the UNet, counted from the conv
    shapes (the training route: each 3x3 rollout conv's own-channel conv,
    its two 3-tap vector products, the 1x1 convs; linears and elementwise
    work left out): forward, and the step as 3x the forward (the
    backward's input and weight grads each cost a forward), with its
    bound at the TF32 peak."""
    H, W, D = sizes
    levels = len(ucfg.channel_mult)
    planes = [((H >> lv) * (W >> lv), (H >> lv) * (D >> lv),
               (W >> lv) * (D >> lv)) for lv in range(levels)]
    lines = [((H >> lv) + (W >> lv) + (D >> lv)) * 2 for lv in range(levels)]
    from sin3dm_tpu_torch.models.unet import _block_widths
    mc = ucfg.model_channels
    fwd = 2.0 * B * sum(planes[0]) * (ucfg.in_channels * mc
                                      + mc * ucfg.out_channels)
    n = ucfg.num_res_blocks
    for i, (cin, cout) in enumerate(_block_widths(ucfg)):
        lv = i // n if i < levels * n else levels - 1 - (i - levels * n) // n
        px = sum(planes[lv])
        for c_in in (cin, cout):                   # in conv, out conv
            fwd += 2.0 * B * px * 9 * c_in * cout
            fwd += 2.0 * B * lines[lv] * 3 * c_in * 3 * cout
        if cin != cout:
            fwd += 2.0 * B * px * cin * cout       # 1x1 skip
    step = 3.0 * fwd
    return {"forward": fwd, "step": step,
            "bound_ms": step / PEAK_TF32_FLOPS * 1e3}


def train_step_card_vs_host(B: int = 2) -> dict:
    """6a. One train step at the tag's full width from the committed EMA
    (every leaf gets a gradient), batch B of the tag's feat.npz, t and
    noise drawn by numpy, from the same warm optimiser state (WARM_COUNT),
    on the card with TF32 off and on this machine's CPU with the port's
    plain code.  Holds: the loss terms 1e-5 relative; each leaf's grad
    1e-4 of that leaf's max |g|; the updated params and EMA 1e-5
    absolute; mu 1e-4 and nu 2e-4 of the leaf's largest value (they hold
    the grad and its square).  Prints the worst leaf of each.  A second
    witness, the same gradient in fp64 on the CPU, says which side an
    error lies on: the card's grad is held to it at 1e-4 of each leaf's
    max |g| as well, and the host's distance from it is printed."""
    import dataclasses
    import numpy as np
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.compat.from_jax import unet_params_from_jax
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.core.triplane import Triplane, load_triplane_npz
    from sin3dm_tpu_torch.diffusion.gaussian import tables_to_device
    from sin3dm_tpu_torch.models.unet import unet_train_apply
    from sin3dm_tpu_torch.training import diffusion as TD

    args = cli.cfgmod.sample_args(["--tag", TAG])
    ucfg = cli.cfgmod.unet_config_from_args(args)
    dcfg = cli.cfgmod.diffusion_config_from_args(args)
    tcfg = dataclasses.replace(
        cli.cfgmod.diffusion_trainer_config_from_args(args), batch_size=B,
        steps_per_call=1)
    tables = cli.cfgmod.schedule_from_args(args, respacing="").tables_f32()
    T = tables["betas"].shape[0]
    tree, _ = ckpt.load_tree(EMA_PATH)
    feat = load_triplane_npz(cli.cfgmod.encoding_feat_path(TAG))
    rng = np.random.default_rng(6)
    t = rng.integers(0, T, B)
    noise = [rng.standard_normal((B,) + tuple(p.shape)).astype(np.float32)
             for p in feat]
    n = sum(v.size for _, v in ckpt.leaves_with_paths(tree))
    mu = (1e-3 * rng.standard_normal(n)).astype(np.float32)
    nu = ((1e-3 * (1 + np.abs(rng.standard_normal(n)))) ** 2).astype(
        np.float32)
    out = {}
    for dev in (torch.device("cuda"), torch.device("cpu")):
        st = TD.init_train_state(unet_params_from_jax(tree, dev), tcfg, T)
        st.mu.copy_(torch.from_numpy(mu))
        st.nu.copy_(torch.from_numpy(nu))
        st.count = st.sched_count = st.step = WARM_COUNT
        batch = Triplane(*[p[None].expand(B, *p.shape).contiguous()
                           for p in feat.to(dev)])
        t0 = time.perf_counter()
        with tf32(False):
            terms, _, g = TD.compute_grads(
                st, lambda p, x, tt: unet_train_apply(p, ucfg, x, tt),
                tables_to_device(tables, dev), dcfg, tcfg, batch,
                torch.from_numpy(t).to(dev),
                Triplane(*[torch.from_numpy(z).to(dev) for z in noise]))
            TD.apply_grads(st, g, tcfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out["card" if not out else "host"] = {
                         "terms": {k: v.cpu() for k, v in terms.items()},
                         "g": g.cpu(), "flat": st.flat.cpu(),
                         "ema": st.ema[0].cpu(), "mu": st.mu.cpu(),
                         "nu": st.nu.cpu(), "seconds": secs, "state": st}
    c, h = out["card"], out["host"]
    ref = h["state"]
    # the second witness: the same gradient in fp64 on this machine's CPU
    t0 = time.perf_counter()
    p32 = unet_params_from_jax(tree, "cpu")
    leaves = [v.double().requires_grad_() for _, v in
              ckpt.leaves_with_paths(p32)]
    u64 = ucfg._replace(compute_dtype=torch.float64)
    _, _, g64 = TD.compute_grads(
        dataclasses.replace(ref, params=ckpt.unflatten_like(p32, leaves)),
        lambda p, x, tt: unet_train_apply(p, u64, x, tt),
        tables_to_device(tables, "cpu"), dcfg, tcfg,
        Triplane(*[p[None].expand(B, *p.shape).double() for p in feat]),
        torch.from_numpy(t), Triplane(*[torch.from_numpy(z).double()
                                        for z in noise]))
    w64 = {side: _errs(ref, out[side]["g"].double(), g64, True)
           for side in ("card", "host")}
    secs64 = time.perf_counter() - t0
    terms_err = max(((c["terms"][k] - v).abs() / v.abs()).max().item()
                    for k, v in h["terms"].items())
    checks = {"terms": (terms_err, "loss, mse_xy/xz/yz", 1e-5),
              "grad": _worst(ref, c["g"], h["g"], True) + (1e-4,),
              "params": _worst(ref, c["flat"], h["flat"], False) + (1e-5,),
              "ema": _worst(ref, c["ema"], h["ema"], False) + (1e-5,),
              "mu": _worst(ref, c["mu"], h["mu"], True) + (1e-4,),
              "nu": _worst(ref, c["nu"], h["nu"], True) + (2e-4,)}
    print(f"train step card vs host (batch {B}, t {t.tolist()}, from the "
          f"committed EMA, warm AdamW at count {WARM_COUNT}, TF32 off): "
          f"card {c['seconds']:.3f} s, host CPU {h['seconds']:.3f} s "
          "(both with the first call's set-up)")
    failed = []
    for name, (err, leaf, tol) in checks.items():
        ok = err <= tol
        kind = "abs" if name in ("params", "ema") else "rel"
        print(f"  {name:6s}: worst {err:.3e} ({kind}; tol {tol:.0e}) at "
              f"{leaf} ({'ok' if ok else 'FAIL'})")
        if not ok:
            failed.append(name)
    leaf = checks["grad"][1]
    fp64 = {"seconds": secs64, "at_worst_card_vs_host_leaf": {
        "leaf": leaf, "card": w64["card"][leaf], "host": w64["host"][leaf]}}
    for side, e in w64.items():
        worst = max(e, key=e.get)
        fp64[side] = {"worst": e[worst], "leaf": worst}
        ok = e[worst] <= 1e-4
        print(f"  grad {side} vs fp64 (CPU, {secs64:.1f} s): worst "
              f"{e[worst]:.3e} (rel; tol 1e-04) at {worst} "
              f"({'ok' if ok else 'FAIL'})")
        if side == "card" and not ok:
            failed.append("grad vs fp64")
    print(f"  at {leaf}: card vs fp64 {w64['card'][leaf]:.3e}, host vs fp64 "
          f"{w64['host'][leaf]:.3e}")
    if failed:
        fail(f"train step card vs host: {', '.join(failed)} outside the "
             "tolerances")
    return {**{k: {"worst": v[0], "leaf": v[1], "tol": v[2]}
               for k, v in checks.items()}, "grad_vs_fp64": fp64}


def drive_train(tag_dir: str, n_calls: int = 4) -> dict:
    """6b. `cli.train.main` on a fresh tag with the committed encoding
    (TRAIN_ARGV; TF32 on, as the CLI sets it), the logger's stdout table
    off; reads the peak device memory and each dumped mean loss.  Fails
    unless every loss is finite, the last below the first, the step-100
    EMA and opt files exist and the EMA's leaf paths equal the committed
    JAX-written EMA's.  Then times `n_calls` more calls of the step the
    CLI built (`loop.step_fn`, steps_per_call steps each) by the host
    clock from a sync to a sync, with the kernels' launch counts set to 0
    just before and read just after: a train step launches neither K1 nor
    K2, and fails if it did.  Returns the numbers and the loop."""
    import json as _json
    import math
    import torch
    from sin3dm_tpu_torch.cli import train as train_cli
    from sin3dm_tpu_torch.core import checkpoint as ckpt

    old_fmt = os.environ.get("SIN3DM_LOG_FORMAT")
    os.environ["SIN3DM_LOG_FORMAT"] = "log,csv,json"
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        loop = train_cli.main(["--tag", tag_dir, "--enc_log",
                               os.path.join(TAG, "encoding")]
                              + TRAIN_ARGV).diffusion
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        if old_fmt is None:
            os.environ.pop("SIN3DM_LOG_FORMAT", None)
        else:
            os.environ["SIN3DM_LOG_FORMAT"] = old_fmt
    peak = torch.cuda.max_memory_allocated()
    diff = os.path.join(tag_dir, "diffusion")
    with open(os.path.join(diff, "progress.json")) as fh:
        dumps = [_json.loads(ln) for ln in fh if ln.strip()]
    losses = [d["loss"] for d in dumps]
    K, B = loop.tcfg.steps_per_call, loop.tcfg.batch_size
    ema = os.path.join(diff, "ema_0.9999_000100.pt")
    opt = os.path.join(diff, "opt000100.pt")
    same_paths = os.path.exists(ema) and \
        ckpt.peek_paths(ema) == ckpt.peek_paths(EMA_PATH)
    with tf32(True):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            loop.step_fn(loop.state, loop.batch, 0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (n_calls * K)
        counts = read_counts()
    first = loop.state.step - n_calls * K
    print(f"train (cli.train, batch {B}, steps_per_call {K}, 100 steps, TF32 "
          f"on): main {total:.3f} s in all; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB; mean loss per dump "
          f"{[round(x, 6) for x in losses]} at steps "
          f"{[d['step'] for d in dumps]}")
    print(f"train: the CLI's step, {n_calls} calls of {K} steps (steps "
          f"{first}-{loop.state.step}): {ms:.3f} ms per step (host clock, "
          f"sync to sync), {B * 1e3 / ms:.1f} samples/s; K1 launches "
          f"{counts['k1']}, K2 launches {counts['k2']} (want 0 and 0)")
    print(f"train: TensorBoard sample hook {'on' if loop.tb else 'off'} "
          f"(tensorboardX {'present' if loop.tb else 'absent'})")
    print(f"train: ema_0.9999_000100.pt {os.path.exists(ema)}, opt000100.pt "
          f"{os.path.exists(opt)}, EMA leaf paths equal the committed "
          f"JAX-written EMA's: {same_paths}")
    ok = (all(math.isfinite(x) for x in losses) and len(losses) >= 2
          and losses[-1] < losses[0] and os.path.exists(opt) and same_paths)
    if not ok:
        fail("train: the CLI run did not meet its checks")
    if counts["k1"] or counts["k2"]:
        fail("train: a train step launched K1 or K2")
    return {"ms_per_step": ms, "samples_per_s": B * 1e3 / ms,
            "main_s": total, "peak_bytes": peak, "losses": losses,
            "launches_train_step": {"k1": counts["k1"], "k2": counts["k2"],
                                    "steps": n_calls * K},
            "loop": loop}


def profile_train(loop, ucfg, n_steps: int = 5) -> dict:
    """6c. Where a train step's time goes: `n_steps` single steps of the
    6b loop's state and batch (TF32 on, as the CLI trains), host-clock ms
    per step against the step's operations at the TF32 peak
    (`train_step_flops`), then under torch.profiler the device's busy
    share, operations per step and the top device operations."""
    import dataclasses
    import torch
    from sin3dm_tpu_torch.training import diffusion as TD
    step = TD.make_train_step(
        loop.model_apply, loop.tables, loop.dcfg,
        dataclasses.replace(loop.tcfg, steps_per_call=1))

    def run():
        for _ in range(n_steps):
            step(loop.state, loop.batch, 1)
        torch.cuda.synchronize()

    with tf32(True):
        run()
        t0 = time.perf_counter()
        run()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        fl = train_step_flops(ucfg, loop.batch.sizes, loop.tcfg.batch_size)
        print(f"train step profile (batch {loop.tcfg.batch_size}, {n_steps} "
              f"steps): {step_ms:.3f} ms per step, host clock; "
              f"{fl['step'] / 1e12:.4f} TFLOP per step (forward "
              f"{fl['forward'] / 1e12:.4f}), {fl['step'] / step_ms / 1e9:.1f}"
              f" TFLOP/s, bound at the TF32 peak {fl['bound_ms']:.3f} ms")
        p = device_profile(run, n_steps, "train step", top=12)
    if p:
        print(f"train step: device busy {p['busy_ms']:.3f} ms per step "
              f"({p['busy_ms'] / step_ms:.1%} of the host-clock step, idle "
              f"{1 - p['busy_ms'] / step_ms:.1%}), {p['ops_per_step']:.0f} "
              "device operations per step")
    return {"step_ms": step_ms, "flops": fl["step"],
            "bound_ms": fl["bound_ms"], **p}


# ---------------------------------------------------------------------------
# Phase 8: AE training
# ---------------------------------------------------------------------------

ENC_ARGS = os.path.join(TAG, "encoding", "args.json")
AE_ITERS = 300            # 8c, the bar's iteration count (tests/test_ae.py)
AE_ACC_BAR = 0.85         # 8c, mean_tsdf_acc after AE_ITERS
AE_SURF = 2_000_000       # near- and on-surface points of the npz


def synth_shape_npz(path: str, seed: int = 0) -> dict:
    """8a. A textured analytic shape as the mesh sampler's npz, at the
    committed tag's training-grid shape inside its AABB (the committed
    ckpt_final.pth meta): a box (a tower's base) and, above it and apart
    from it, a sphere, so that min(sdf_box, sdf_sphere) is the union's
    exact SDF; the colour is a smooth ramp of position.  Grid points are
    the AABB's voxel centres; AE_SURF on-surface points spread by area
    over both surfaces, AE_SURF near-surface points 0.005 off them, the
    threshold 3 voxels.  Written with np.savez, from a numpy generator
    seeded with `seed`."""
    import numpy as np
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.dataio.grid import sample_grid_points_aabb
    _, meta = ckpt.load_tree(os.path.join(TAG, "encoding",
                                          "ckpt_final.pth"), "params")
    aabb = np.asarray(meta["aabb"], np.float32)
    lo, hi = aabb[:3], aabb[3:]
    box_c = np.array([0.0, -0.35, 0.0], np.float32)
    box_h = np.array([0.35, 0.5, 0.35], np.float32)
    sph_c = np.array([0.0, 0.5, 0.0], np.float32)
    sph_r = np.float32(0.3)

    def sdf(p):
        q = np.abs(p - box_c) - box_h
        box = (np.linalg.norm(np.maximum(q, 0.0), axis=-1)
               + np.minimum(q.max(axis=-1), 0.0))
        return np.minimum(box, np.linalg.norm(p - sph_c, axis=-1) - sph_r)

    def tex(p):
        t = (p - lo) / (hi - lo)
        return np.stack([t[..., 0], t[..., 1],
                         0.5 + 0.5 * np.sin(6.0 * t[..., 2])],
                        axis=-1).astype(np.float32)

    rng = np.random.default_rng(seed)
    grid = sample_grid_points_aabb(aabb, 256).astype(np.float32)
    areas = {"sphere": 4 * np.pi * sph_r ** 2,
             "box": 8 * (box_h[0] * box_h[1] + box_h[0] * box_h[2]
                         + box_h[1] * box_h[2])}
    n_sph = int(round(AE_SURF * areas["sphere"] / sum(areas.values())))
    d = rng.standard_normal((n_sph, 3)).astype(np.float32)
    on_sph = sph_c + sph_r * d / np.linalg.norm(d, axis=-1, keepdims=True)
    # box faces by area: axis a fixed at +-h[a], the other two uniform
    n_box = AE_SURF - n_sph
    face_area = np.array([box_h[1] * box_h[2], box_h[0] * box_h[2],
                          box_h[0] * box_h[1]], np.float64)
    axis = rng.choice(3, n_box, p=face_area / face_area.sum())
    u = rng.uniform(-1.0, 1.0, (n_box, 3)).astype(np.float32)
    u[np.arange(n_box), axis] = rng.choice([-1.0, 1.0], n_box)
    on_box = box_c + u * box_h
    on = np.concatenate([on_sph, on_box]).astype(np.float32)
    near = (on + rng.normal(0.0, 0.005, on.shape)).astype(np.float32)
    threshold = 2.0 / 256 * 3
    arrays = dict(
        pts_grid=grid, sdf_grid=sdf(grid).astype(np.float32),
        tex_grid=tex(grid), pts_on_surf=on, tex_on_surf=tex(on),
        pts_near_surf=near, sdf_near_surf=sdf(near).astype(np.float32),
        tex_near_surf=tex(near), aabb=aabb,
        threshold=np.float32(threshold), Ka=[0, 0, 0], Kd=[1, 1, 1],
        Ks=[0.4, 0.4, 0.4], Ns=10)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)
    nbytes = sum(np.asarray(v).nbytes for v in arrays.values())
    inside = float((arrays["sdf_grid"] < 0).mean())
    print(f"ae data: {path}: grid {grid.shape[:3]} "
          f"({grid.shape[0] * grid.shape[1] * grid.shape[2]} points, "
          f"{inside:.4f} inside), {AE_SURF} on- and {AE_SURF} near-surface "
          f"points, threshold {threshold:.7f}, {nbytes / 2 ** 20:.1f} MiB")
    return {"grid_shape": list(grid.shape[:3]), "nbytes": nbytes,
            "inside_share": inside}


def enc_args() -> dict:
    """The committed encoding's args.json."""
    with open(ENC_ARGS) as fh:
        return json.load(fh)


def encoding_argv() -> list:
    """The committed encoding args.json's values as cli.train flags (its
    data_path and iteration count aside)."""
    argv = []
    for k, v in enc_args().items():
        if k not in ("data_path", "enc_n_iters"):
            argv += [f"--{k}", str(v)]
    return argv


def ae_setup(npz: str, dev):
    """(acfg, tcfg, data, meta) at the encoding args.json's width, the
    data on `dev`."""
    import argparse
    from sin3dm_tpu_torch.core import config as cfgmod
    from sin3dm_tpu_torch.training import ae as TA
    args = argparse.Namespace(**enc_args())
    acfg = cfgmod.ae_config_from_args(args)
    tcfg = cfgmod.ae_trainer_config_from_args(args)
    data, meta, _ = TA.load_ae_data(npz, tcfg, dev, acfg.data_type)
    return acfg, tcfg, data, meta


def cancelled_leaf(path: str) -> bool:
    """A bias that an InstanceNorm right after it removes (the encoders'
    biases, each block's in-conv bias): its grad is 0 but for roundoff."""
    parts = path.split("/")
    return parts[-1] == "b" and (parts[0] in ("geo_encoder", "tex_encoder")
                                 or "in_conv" in parts)


def ae_step_card_vs_host(npz: str) -> dict:
    """8b. One AE train step at the encoding args.json's width from the
    committed ckpt_final.pth's params, a warm AdamW state (WARM_COUNT,
    mu and nu of the grads' sizes) and the same window offsets (drawn by
    numpy), on the card with TF32 off and on this machine's CPU with the
    port's plain code.  Holds 6a's tolerances: loss terms 1e-5 relative;
    each leaf's grad 1e-4 of that leaf's max |g| (a bias an InstanceNorm
    cancels: both sides below 1e-5 of the whole grad's max |g|); params
    1e-5 absolute; mu 1e-4 and nu 2e-4 of the leaf's largest value.
    Prints the worst leaf of each.  A second witness, the same gradient
    in fp64 on the CPU, says which side an error lies on, as in 6a: the
    card's grad is held to it at 1e-4 of each leaf's max |g| as well,
    and both sides' distances from it are printed at the worst leaf."""
    import dataclasses
    import numpy as np
    import torch
    from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.training import ae as TA
    tree, _ = ckpt.load_tree(os.path.join(TAG, "encoding",
                                          "ckpt_final.pth"), "params")
    rng = np.random.default_rng(8)
    out, offsets = {}, None
    for dev in (torch.device("cuda"), torch.device("cpu")):
        acfg, tcfg, data, meta = ae_setup(npz, dev)
        if offsets is None:
            n_grid, n_surf = TA.batch_split(tcfg)
            offsets = tuple(
                rng.integers(0, rows - max(TA.window_sizes(total)) + 1,
                             TA.N_WINDOWS).tolist()
                for total, rows in ((n_grid, data.pts_grid.shape[0]),
                                    (n_surf, data.pts_near_surf.shape[0])))
            n = sum(v.size for _, v in ckpt.leaves_with_paths(tree))
            mu = (1e-3 * rng.standard_normal(n)).astype(np.float32)
            nu = ((1e-3 * (1 + np.abs(rng.standard_normal(n)))) ** 2
                  ).astype(np.float32)
        st = TA.init_train_state(ae_params_from_jax(tree, dev), tcfg)
        st.mu.copy_(torch.from_numpy(mu))
        st.nu.copy_(torch.from_numpy(nu))
        st.count = st.sched_count = st.step = WARM_COUNT
        t0 = time.perf_counter()
        with tf32(False):
            terms, g = TA.compute_grads(st, acfg, tcfg, data,
                                        meta["threshold"], offsets)
            TA.apply_grads(st, g, tcfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["card" if not out else "host"] = {
            "terms": {k: v.cpu() for k, v in terms.items()}, "g": g.cpu(),
            "flat": st.flat.cpu(), "mu": st.mu.cpu(), "nu": st.nu.cpu(),
            "seconds": time.perf_counter() - t0, "state": st}
    c, h = out["card"], out["host"]
    ref = h["state"]
    # the second witness: the same gradient in fp64 on this machine's CPU
    t0 = time.perf_counter()
    p32 = ae_params_from_jax(tree, "cpu")
    leaves = [v.double().requires_grad_() for _, v in
              ckpt.leaves_with_paths(p32)]
    data64 = TA.AEData(*[a.double() if a is not None and a.is_floating_point()
                         else a for a in data])
    _, g64 = TA.compute_grads(
        dataclasses.replace(ref, params=ckpt.unflatten_like(p32, leaves)),
        acfg, tcfg, data64, meta["threshold"], offsets)
    del data, data64
    secs64 = time.perf_counter() - t0
    w64 = {side: {p: e for p, e in _errs(ref, out[side]["g"].double(), g64,
                                         True).items()
                  if not cancelled_leaf(p)}
           for side in ("card", "host")}
    terms_err = max(((c["terms"][k] - v).abs() / v.abs()).max().item()
                    for k, v in h["terms"].items())
    cg = dict(ckpt.leaves_with_paths(ref.tree(c["g"])))
    hg = dict(ckpt.leaves_with_paths(ref.tree(h["g"])))
    top = h["g"].abs().max().item()
    cancel = {p: max(cg[p].abs().max().item(),
                     hg[p].abs().max().item()) / top
              for p in hg if cancelled_leaf(p)}
    ge = {p: e for p, e in _errs(ref, c["g"], h["g"], True).items()
          if p not in cancel}
    g_leaf = max(ge, key=ge.get)
    c_leaf = max(cancel, key=cancel.get)
    checks = {"terms": (terms_err, ", ".join(h["terms"]), 1e-5),
              "grad": (ge[g_leaf], g_leaf, 1e-4),
              "grad, cancelled biases": (cancel[c_leaf], c_leaf, 1e-5),
              "params": _worst(ref, c["flat"], h["flat"], False) + (1e-5,),
              "mu": _worst(ref, c["mu"], h["mu"], True) + (1e-4,),
              "nu": _worst(ref, c["nu"], h["nu"], True) + (2e-4,)}
    print(f"ae train step card vs host (batch {tcfg.enc_batch_size}, the "
          f"committed AE's params, warm AdamW at count {WARM_COUNT}, TF32 "
          f"off, offsets {offsets}): card {c['seconds']:.3f} s, host CPU "
          f"{h['seconds']:.3f} s (both with the first call's set-up)")
    failed = []
    for name, (err, leaf, tol) in checks.items():
        ok = err <= tol
        kind = "abs" if name == "params" else "rel"
        print(f"  {name:22s}: worst {err:.3e} ({kind}; tol {tol:.0e}) at "
              f"{leaf} ({'ok' if ok else 'FAIL'})")
        if not ok:
            failed.append(name)
    leaf = checks["grad"][1]
    fp64 = {"seconds": secs64, "at_worst_card_vs_host_leaf": {
        "leaf": leaf, "card": w64["card"][leaf], "host": w64["host"][leaf]}}
    for side, e in w64.items():
        worst = max(e, key=e.get)
        fp64[side] = {"worst": e[worst], "leaf": worst}
        ok = e[worst] <= 1e-4
        print(f"  grad {side} vs fp64 (CPU, {secs64:.1f} s): worst "
              f"{e[worst]:.3e} (rel; tol 1e-04) at {worst} "
              f"({'ok' if ok else 'FAIL'})")
        if side == "card" and not ok:
            failed.append("grad vs fp64")
    print(f"  at {leaf}: card vs fp64 {w64['card'][leaf]:.3e}, host vs fp64 "
          f"{w64['host'][leaf]:.3e}")
    if failed:
        fail(f"ae train step card vs host: {', '.join(failed)} outside the "
             "tolerances")
    return {**{k: {"worst": v[0], "leaf": v[1], "tol": v[2]}
               for k, v in checks.items()}, "grad_vs_fp64": fp64}


def ae_step_flops(acfg, tcfg, featmap) -> dict:
    """Operations of one AE train step counted from the shapes: the
    Conv3d encoders over the feature-map volume (forward, and the weight
    grad: the volume takes no grad), the per-plane 5x5 and 1x1 convs of
    each branch and the skip heads over the batch (forward, input grad
    and weight grad: 3x); gathers, norms and elementwise work left out.
    Returns the forward, the step and the step's bound at the TF32
    peak."""
    X, Y, Z = featmap
    vox = X * Y * Z
    px = X * Y + X * Z + Y * Z
    bs = tcfg.enc_batch_size
    n_tex = acfg.tex_channels if acfg.use_tex else 0
    enc = 2.0 * vox * 64 * (1 * acfg.fdim_geo
                            + ((n_tex + 1) * acfg.fdim_tex if n_tex else 0))
    branches = [acfg.fdim_geo] + ([acfg.fdim_tex] if n_tex else [])
    up = acfg.fdim_up
    convs = sum(2.0 * px * (25 * cin * up + 25 * up * up
                            + (cin * up if cin != up else 0))
                for cin in branches)
    hid, nh = acfg.hidden_dim, acfg.n_hidden_layers
    n_first = 1 + nh // 2
    head = (up * hid + (n_first - 1) * hid * hid + (up + hid) * hid
            + (nh // 2 - 1) * hid * hid)
    heads = 2.0 * bs * sum(head + hid * cout
                           for cout in [1] + ([n_tex] if n_tex else []))
    fwd = enc + convs + heads
    step = 2.0 * enc + 3.0 * (convs + heads)
    return {"forward": fwd, "step": step, "heads_forward": heads,
            "convs_forward": convs, "encoders_forward": enc,
            "bound_ms": step / PEAK_TF32_FLOPS * 1e3}


def drive_ae_train(tag_dir: str, npz: str) -> dict:
    """8c. `cli.train.main` on a fresh tag with `--data_path` the 8a npz,
    the encoding args.json's values, AE_ITERS AE iterations logged every
    50, then the diffusion stage cut to 20 steps at batch 32 (TF32 on, as
    the CLI sets it), with the launch counts set to 0 just before and
    read just after.  Fails unless every logged AE loss is finite and the
    last below the first, eval_stat.json's mean_tsdf_acc reaches
    AE_ACC_BAR, ckpt_final.pth holds params, the chained optimiser state
    and step AE_ITERS, feat.npz's planes have the committed feat.npz's
    shapes, rec/object.obj has 0 < faces <= 10,000 inside the AABB widened
    by a voxel beside a valid rec/object.png, and the diffusion stage
    wrote its EMA.  Returns the numbers and main's result."""
    import math
    import numpy as np
    import torch
    from sin3dm_tpu_torch.cli import train as train_cli
    from sin3dm_tpu_torch.core import checkpoint as ckpt

    argv = (["--tag", tag_dir, "--data_path", npz] + encoding_argv()
            + ["--enc_n_iters", str(AE_ITERS), "--log_interval", "50",
               "--diff_batch_size", "32", "--diff_n_iters", "20",
               "--save_interval", "20"])
    old_fmt = os.environ.get("SIN3DM_LOG_FORMAT")
    os.environ["SIN3DM_LOG_FORMAT"] = "log,csv,json"
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_counts()
        t0 = time.perf_counter()
        res = train_cli.main(argv)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = read_counts()
    finally:
        if old_fmt is None:
            os.environ.pop("SIN3DM_LOG_FORMAT", None)
        else:
            os.environ["SIN3DM_LOG_FORMAT"] = old_fmt
    peak = torch.cuda.max_memory_allocated()
    enc = os.path.join(tag_dir, "encoding")
    with open(os.path.join(enc, "progress.json")) as fh:
        dumps = [json.loads(ln) for ln in fh if ln.strip()]
    losses = [d["ae/loss"] for d in dumps]
    with open(os.path.join(enc, "eval_stat.json")) as fh:
        stat = json.load(fh)
    paths = ckpt.peek_paths(os.path.join(enc, "ckpt_final.pth"))
    tree, _ = ckpt.load_tree(os.path.join(enc, "ckpt_final.pth"))
    step = int(tree["step"])
    layout_ok = (any(p.startswith("params/") for p in paths)
                 and "opt_state/0/0/.count" in paths
                 and "opt_state/0/2/.count" in paths and step == AE_ITERS)
    with np.load(os.path.join(enc, "feat.npz")) as f:
        shapes = [tuple(f[k].shape) for k in ("feat_xy", "feat_xz",
                                              "feat_yz")]
    want_shapes = [(12, 92, 128), (12, 92, 92), (12, 128, 92)]
    aabb = np.asarray(res.ae.meta["aabb"], np.float64)
    lo, hi = aabb[:3], aabb[3:]
    voxel = (hi.max() - lo.min()) / enc_args()["rec_reso"]
    v, nf = obj_mesh(os.path.join(enc, "rec", "object.obj"))
    inside = bool(len(v) and ((v >= lo - voxel) & (v <= hi + voxel)).all())
    check_png(os.path.join(enc, "rec", "object.png"), 2048)
    ema = os.path.join(tag_dir, "diffusion", "ema_0.9999_000020.pt")
    print(f"ae train (cli.train, {AE_ITERS} AE iterations at batch "
          f"{res.ae.tcfg.enc_batch_size}, then 20 diffusion steps at batch "
          f"32, TF32 on): main {total:.3f} s in all; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB; AE loss per log "
          f"{[round(x, 6) for x in losses]} at iterations "
          f"{[d['ae/iter'] for d in dumps]}")
    print(f"ae train: eval_stat mean_tsdf_acc {stat['mean_tsdf_acc']:.6f} "
          f"(bar {AE_ACC_BAR}), mean_tsdf_l1_error "
          f"{stat['mean_tsdf_l1_error']:.6e}, surf_tex_l1_error "
          f"{stat.get('surf_tex_l1_error', float('nan')):.6f}; "
          f"ckpt_final.pth params/opt_state/0/0, 0/2 and step {step}: "
          f"{layout_ok}; feat.npz planes {shapes}; rec/object.obj {nf} "
          f"faces, {len(v)} vertices, inside the AABB widened by a voxel: "
          f"{inside}; rec/object.png 2048x2048 RGB, valid; "
          f"{os.path.basename(ema)} {os.path.exists(ema)}; launches K1 "
          f"{counts['k1']}, K2 {counts['k2']}")
    ok = (len(losses) >= 2 and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] and layout_ok
          and shapes == want_shapes and 0 < nf <= 10000 and inside
          and os.path.exists(ema) and counts["k1"] == 0)
    if not ok:
        fail("ae train: the CLI run did not meet its checks")
    if not stat["mean_tsdf_acc"] >= AE_ACC_BAR:
        fail(f"ae train: mean_tsdf_acc {stat['mean_tsdf_acc']:.6f} below "
             f"{AE_ACC_BAR} after {AE_ITERS} iterations")
    return {"main_s": total, "peak_bytes": peak, "losses": losses,
            "log_iters": [d["ae/iter"] for d in dumps], "eval_stat": stat,
            "rec_faces": nf, "launches": {"k1": counts["k1"],
                                          "k2": counts["k2"]},
            "k2_shapes": counts["k2_shapes"], "result": res}


def ae_launches(trainer, main_k2: dict, tmp: str, reso: int) -> dict:
    """8d. K2 launches of `evaluate` (one per x-slab of 8 of the training
    grid, then the geo and texture heads over each on-surface chunk of
    2^20 points), counted by shape, and of the `rec` mesh at `reso` (its
    geo-grid slabs and texel chunks), each counted from 0 around a second
    call on the trained trainer; their sum, in all and by shape, must be
    what the CLI run (`main_k2`: its count and counts by shape)
    launched."""
    import numpy as np
    import torch
    from sin3dm_tpu_torch.dataio.grid import grid_resolutions
    gx, gy, gz = trainer.meta["grid_shape"]
    n_surf = trainer.data.pts_on_surf.shape[0]
    heads = [(trainer.params[h]["first"][0]["w"].shape[0],
              trainer.params[h]["second"][-1]["w"].shape[1])
             for h in ("geo_decoder", "tex_decoder")]
    cin = heads[0][0]
    want_shapes = {}
    for rows, (c_in, cout) in ([(min(8, gx - x0) * gy * gz, heads[0])
                                for x0 in range(0, gx, 8)]
                               + [(min(2 ** 20, n_surf - i), hd)
                                  for i in range(0, n_surf, 2 ** 20)
                                  for hd in heads]):
        k = shape_key(rows, c_in, cout)
        want_shapes[k] = want_shapes.get(k, 0) + 1
    want_eval = sum(want_shapes.values())
    reset_counts()
    trainer.evaluate()
    torch.cuda.synchronize()
    got_eval = read_counts()
    trainer.stage_log = []
    feat = trainer.encode()
    reset_counts()
    trainer.decode_texmesh(os.path.join(tmp, "rec"), feat, reso)
    torch.cuda.synchronize()
    got_rec = read_counts()
    texels = [e["texels"] for e in trainer.stage_log
              if e["stage"] == "texel dispatch"]
    trainer.stage_log = None
    slabs = -(-int(grid_resolutions(np.asarray(trainer.meta["aabb"]),
                                    reso)[0]) // 8)
    want_rec = slabs + sum(texel_chunks(t) for t in texels)
    both = {k: got_eval["k2_shapes"].get(k, 0) + got_rec["k2_shapes"].get(k, 0)
            for k in set(got_eval["k2_shapes"]) | set(got_rec["k2_shapes"])}
    chunk = shape_key(2 ** 20, cin, 1)
    print(f"ae launches: evaluate K1 {got_eval['k1']} K2 {got_eval['k2']} "
          f"(want 0 and {want_eval}: {-(-gx // 8)} slabs + 2 heads x "
          f"{-(-n_surf // 2 ** 20)} surface chunks), by shape "
          f"{got_eval['k2_shapes']} (want {want_shapes}); rec mesh K1 "
          f"{got_rec['k1']} K2 {got_rec['k2']} (want 0 and {want_rec}: "
          f"{slabs} slabs + the texel chunks of {texels} texels); the CLI "
          f"run's K2 {main_k2['k2']} (want {want_eval + want_rec}), by "
          f"shape {main_k2['k2_shapes']} (want the two calls' {both}); "
          f"{chunk}: {main_k2['k2_shapes'].get(chunk, 0)} in the CLI run")
    if (got_eval["k1"] or got_rec["k1"]
            or got_eval["k2_shapes"] != want_shapes
            or got_rec["k2"] != want_rec
            or main_k2["k2"] != want_eval + want_rec
            or main_k2["k2_shapes"] != both):
        fail("ae launches: evaluate or the rec mesh did not launch K2 as "
             "expected")
    return {"evaluate": got_eval["k2"], "rec": got_rec["k2"],
            "evaluate_by_shape": got_eval["k2_shapes"],
            "cli_by_shape": main_k2["k2_shapes"],
            "surface_chunk_geo": main_k2["k2_shapes"].get(chunk, 0),
            "rec_texels": texels}


# 8e's witness: K2 and the plain version round the same operands to bf16
# and differ only in the order (and, on tensor cores, the rounding) of
# their fp32 sums, so on trained weights K2 lies no further from the fp64
# value than twice the plain version's distance, each row's distance
# measured in its share of `skip_mlp_bf16_bound`, over the slab's worst
# row and its mean row alike
K2_WITNESS_FACTOR = 2.0


def head_fp64(params, x):
    """The skip head in fp64 throughout: the value both bf16 evaluations
    round toward."""
    import torch
    x = x.double()
    h = x
    for lp in params["first"]:
        h = torch.relu(h @ lp["w"].double() + lp["b"].double())
    h = torch.cat([x, h], dim=-1)
    for lp in params["second"][:-1]:
        h = torch.relu(h @ lp["w"].double() + lp["b"].double())
    last = params["second"][-1]
    return h @ last["w"].double() + last["b"].double()


def faulty_heads(params) -> dict:
    """8e's controls, faults a kernel could make: the last layer's
    weights one bf16 ulp larger in magnitude, and the first layer's
    weights rounded to fp8 (e4m3) in place of bf16."""
    import torch

    def with_layer(key, i, w):
        out = {k: [dict(lp) for lp in params[k]] for k in ("first",
                                                           "second")}
        out[key][i]["w"] = w
        return out

    w0 = params["first"][0]["w"]
    wl = params["second"][-1]["w"].to(torch.bfloat16)
    return {"last layer's weights one ulp up": with_layer(
                "second", -1,
                (wl.view(torch.int16) + 1).view(torch.bfloat16).float()),
            "first layer's weights in fp8": with_layer(
                "first", 0, w0.to(torch.float8_e4m3fn).float())}


def ae_k2_trained(trainer) -> dict:
    """8e. K2 (bf16) with the trainer's packed weights over evaluate's
    first x-slab of each head's features, against the same trained params
    (the train state's raw leaves, which must equal ckpt_final.pth's) on
    the card: the trainer's pack must equal a pack made from those leaves
    now, and its launch the launch with that pack, bit for bit (a stale
    pack fails both); against the plain heads the output is held to the
    derived per-row bound `skip_mlp_bf16_bound`.  Phase 3's 2^-8 of max
    |ref| cannot hold here (trained features give sdf values far smaller
    than the terms they sum), so a witness decides whether the gap is
    rounding: the head in fp64 on the card, from which K2 must lie no
    further than K2_WITNESS_FACTOR times the plain version's distance
    (the bf16 torch.matmul chain's, which rounds each layer's output too,
    is printed beside them).  The first control of `faulty_heads`, a
    bias of one ulp, must break the witness or the bound, else 8e could
    not see such a fault; the second, an unbiased coarser rounding of the
    first layer, is printed only: its errors average out through the
    layers after it, and it may lie within the witness."""
    import numpy as np
    import torch
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.models import autoencoder as ae
    from sin3dm_tpu_torch.ops import pack_params
    from sin3dm_tpu_torch.ops.fused_mlp import (skip_mlp,
                                                skip_mlp_bf16_bound,
                                                skip_mlp_reference)
    st = trainer.state
    raw = st.tree(st.flat)
    saved, _ = ckpt.load_tree(os.path.join(trainer.log_dir,
                                           "ckpt_final.pth"), "params")
    same = all(np.array_equal(v.cpu().numpy(), w) for (_, v), (_, w) in
               zip(ckpt.leaves_with_paths(raw),
                   ckpt.leaves_with_paths(saved)))
    if not same:
        fail("ae k2: the train state's params differ from ckpt_final.pth")
    fresh = pack_params(raw)
    out = {}
    with torch.no_grad():
        gp, tp = trainer._planes(trainer.encode())
        for head, planes in (("geo_decoder", gp), ("tex_decoder", tp)):
            _, x = next(ae.grid_slab_features(
                planes, tuple(trainer.meta["grid_shape"])))
            pk, pf = trainer.params[head]["k2"], fresh[head]["k2"]
            pack_same = pk["dims"] == pf["dims"] and all(
                torch.equal(pk[k], pf[k]) for k in ("wts", "bias", "table"))
            got = skip_mlp(trainer.params[head], x, mxu_dtype=torch.bfloat16)
            again = skip_mlp(fresh[head], x, mxu_dtype=torch.bfloat16)
            ref = skip_mlp_reference(raw[head], x, torch.bfloat16)
            bnd = skip_mlp_bf16_bound(raw[head], x)
            r64 = head_fp64(raw[head], x)
            torch.cuda.synchronize()
            launch_same = torch.equal(got, again)
            err = (got - ref).abs()
            worst = (err / bnd).max().item()
            scale = ref.abs().max().item()
            p3 = err.max().item() / (K2_BF16_TOL * max(scale, 1e-6))

            def vs64(y):
                d = (y.double() - r64).abs()
                return {"max_abs": d.max().item(),
                        "of_bound": (d / bnd).max().item(),
                        "mean_of_bound": (d / bnd).mean().item(),
                        "of_phase3_tol": d.max().item() / (
                            K2_BF16_TOL * max(scale, 1e-6))}

            def ratio_of(v):        # the witness: the larger of the two
                return max(v[k] / w["plain"][k]
                           for k in ("of_bound", "mean_of_bound"))

            w = {"k2": vs64(got), "plain": vs64(ref),
                 "library": vs64(k2_library(raw[head], x).float())}
            ratio = ratio_of(w["k2"])
            ok = (pack_same and launch_same and worst <= 1.0
                  and ratio <= K2_WITNESS_FACTOR)
            print(f"ae k2 on the trained weights, {head} over evaluate's "
                  f"slab {tuple(x.shape)}: the trainer's pack equals a "
                  f"fresh one {pack_same}, its launch the fresh pack's bit "
                  f"for bit {launch_same}; against the plain heads "
                  f"max_abs_err {err.max().item():.3e}, worst row "
                  f"{worst:.4f} of its derived bound; {p3:.3f}x phase 3's "
                  f"2^-8 of max |ref| {scale:.3e}; from fp64: " + ", ".join(
                      f"{k} max {v['max_abs']:.3e} (worst row "
                      f"{v['of_bound']:.4f}, mean row "
                      f"{v['mean_of_bound']:.5f} of the bound; "
                      f"{v['of_phase3_tol']:.3f}x phase 3's tolerance)"
                      for k, v in w.items())
                  + f"; K2 {ratio:.3f}x the plain version's distance (tol "
                  f"{K2_WITNESS_FACTOR}) ({'ok' if ok else 'FAIL'})")
            if not ok:
                fail(f"ae k2: {head} with the trainer's pack disagrees with "
                     "the trained params")
            controls = {}
            for i, (name, fp) in enumerate(faulty_heads(raw[head]).items()):
                y = skip_mlp_reference(fp, x, torch.bfloat16)
                c = {"witness_ratio": ratio_of(vs64(y)),
                     "of_bound": ((y - ref).abs() / bnd).max().item()}
                caught = (c["witness_ratio"] > K2_WITNESS_FACTOR
                          or c["of_bound"] > 1.0)
                print(f"  control, {name}: {c['witness_ratio']:.3f}x the "
                      f"plain version's distance from fp64, worst row "
                      f"{c['of_bound']:.4f} of the bound against the plain "
                      f"heads: {'caught' if caught else 'not caught'}")
                if i == 0 and not caught:
                    fail(f"ae k2: {head}: 8e cannot see the control {name}")
                controls[name] = {**c, "caught": caught}
            out[head] = {"rows": x.shape[0], "max_abs_err": err.max().item(),
                         "max_ref": scale, "worst_of_bound": worst,
                         "of_phase3_tol": p3, "from_fp64": w,
                         "witness_ratio": ratio, "controls": controls}
    return out


def ae_step_time(trainer, n_steps: int = 50, warm: int = 5,
                 prof_steps: int = 5) -> dict:
    """8d and 8f. The CLI's AE step on the trained trainer's state (TF32
    on, as the CLI trains): `warm` steps, then `n_steps` timed by the host
    clock from a sync to a sync with the launch counts set to 0 just
    before and read just after (K1 and K2: 0) and the peak device memory
    over them; points/s; the step's operations against the TF32 bound;
    then `prof_steps` steps under torch.profiler."""
    import torch
    from sin3dm_tpu_torch.training import ae as TA
    st, tcfg = trainer.state, trainer.tcfg
    step = TA.make_train_step(trainer.acfg, tcfg, trainer.meta["threshold"])

    def run(n):
        for _ in range(n):
            step(st, trainer.data, 0)
        torch.cuda.synchronize()

    with tf32(True):
        run(warm)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        run(n_steps)
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        fl = ae_step_flops(trainer.acfg, tcfg, trainer.meta["featmap_size"])
        pts = tcfg.enc_batch_size * 1e3 / ms
        print(f"ae step: {n_steps} steps at batch {tcfg.enc_batch_size}: "
              f"{ms:.3f} ms per step (host clock, sync to sync), "
              f"{pts:.1f} points/s; peak device memory {peak / 2 ** 30:.3f} "
              f"GiB; K1 launches {counts['k1']}, K2 launches {counts['k2']} "
              f"(want 0 and 0); {fl['step'] / 1e12:.4f} TFLOP per step "
              f"(forward {fl['forward'] / 1e12:.4f}: heads "
              f"{fl['heads_forward'] / 1e12:.4f}, plane convs "
              f"{fl['convs_forward'] / 1e12:.4f}, encoders "
              f"{fl['encoders_forward'] / 1e12:.4f}), "
              f"{fl['step'] / ms / 1e9:.1f} TFLOP/s, bound at the TF32 "
              f"peak {fl['bound_ms']:.3f} ms ({fl['bound_ms'] / ms:.1%} of "
              "it)")
        if counts["k1"] or counts["k2"]:
            fail("ae step: a train step launched K1 or K2")
        p = device_profile(lambda: run(prof_steps), prof_steps, "ae step",
                           top=12)
    if p:
        print(f"ae step: device busy {p['busy_ms']:.3f} ms per step "
              f"({p['busy_ms'] / ms:.1%} of the host-clock step, idle "
              f"{1 - p['busy_ms'] / ms:.1%}), {p['ops_per_step']:.0f} "
              "device operations per step")
    return {"ms_per_step": ms, "points_per_s": pts, "peak_bytes": peak,
            "launches": {"k1": counts["k1"], "k2": counts["k2"],
                         "steps": n_steps},
            "flops": fl["step"], "bound_ms": fl["bound_ms"], **p}


def phase8() -> dict:
    """8a-8f in a temporary directory."""
    import torch
    tmp = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_ae_")
    try:
        npz = os.path.join(tmp, "shape.npz")
        t0 = time.perf_counter()
        synth = synth_shape_npz(npz)
        print(f"ae data: written in {time.perf_counter() - t0:.1f} s")
        step_check = ae_step_card_vs_host(npz)
        trained = drive_ae_train(os.path.join(tmp, "tag"), npz)
        res = trained.pop("result")
        trainer = res.ae
        del res
        torch.cuda.empty_cache()
        k2 = ae_k2_trained(trainer)
        launches = ae_launches(trainer, {"k2": trained["launches"]["k2"],
                                         "k2_shapes": trained["k2_shapes"]},
                               tmp,
                               enc_args()["rec_reso"])
        timing = ae_step_time(trainer)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"data": synth, "step_card_vs_host": step_check, **trained,
           "k2_trained": k2, "launches_by_stage": launches,
           "step": timing}
    print("ae: " + json.dumps(out, default=float))
    return out


# ---------------------------------------------------------------------------
# Phase 9: data preparation at full width
# ---------------------------------------------------------------------------

P9_RESO = 256
P9_NSURF = 5_000_000      # the README's --n_surf
P9_GRID = (184, 256, 184)  # the tag's training grid
P9_AE_STEPS = 20
P9_NSURF_REMESH = 200_000  # the reso-64 run through the watertight remesh
# the shape, in OBJ units: a Kd-only box and, above it and apart from it,
# a UV sphere textured by an 8-bit RGB map; the union's extents are
# 0.9 x 1.3 x 0.9, so normalize_aabb rounds the grid to P9_GRID
P9_BOX_C, P9_BOX_H = (0.0, -0.3, 0.0), (0.45, 0.35, 0.45)
P9_SPH_C, P9_SPH_R = (0.0, 0.4, 0.0), 0.25
P9_KD = (0.25, 0.5, 0.75)
P9_SPHERE_ROWS, P9_SPHERE_COLS = 160, 320   # 101,760 sphere faces
P9_MAP = (64, 128)                           # the map's H x W


def p9_map():
    """The sphere's map: smooth in (u, v) and periodic in u, 8-bit RGB."""
    import numpy as np
    H, W = P9_MAP
    u = (np.arange(W) + 0.5) / W
    v = 1.0 - (np.arange(H) + 0.5) / H
    U, V = np.meshgrid(u, v)
    rgb = np.stack([0.5 + 0.5 * np.cos(2 * np.pi * U),
                    0.5 + 0.5 * np.cos(np.pi * V),
                    0.5 + 0.25 * np.sin(4 * np.pi * U)], axis=-1)
    return np.rint(rgb * 255).astype(np.uint8)


def p9_write_obj(dirpath: str) -> dict:
    """Write the box-and-sphere OBJ, its MTL and map (the port's
    encode_png) from numpy; coordinates in %.17g, so the OBJ holds these
    float64 values exactly.  Returns the shape's description."""
    import numpy as np
    from sin3dm_tpu_torch.geometry.meshio import encode_png
    n_th, n_ph = P9_SPHERE_ROWS, P9_SPHERE_COLS
    th = np.pi * np.arange(n_th + 1) / n_th
    ph = 2 * np.pi * np.arange(n_ph + 1) / n_ph
    T, P = np.meshgrid(th, ph, indexing="ij")
    sv = (np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                    np.cos(T)], -1).reshape(-1, 3) * P9_SPH_R
          + np.asarray(P9_SPH_C))
    suv = np.stack([P / (2 * np.pi), 1 - T / np.pi], -1).reshape(-1, 2)
    tris = []
    for i in range(n_th):
        a = i * (n_ph + 1) + np.arange(n_ph)
        b, c = a + 1, a + n_ph + 1
        d = c + 1
        if i > 0:                  # the top row's first triangle is a point
            tris.append(np.stack([a, c, b], -1))
        if i < n_th - 1:           # the bottom row's second is a point
            tris.append(np.stack([b, c, d], -1))
    sf = np.concatenate(tris)
    corners = np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                        (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], float)
    bv = np.asarray(P9_BOX_C) + (2 * corners - 1) * np.asarray(P9_BOX_H)
    bf = np.array([(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5),
                   (0, 5, 4), (2, 3, 7), (2, 7, 6), (0, 4, 7), (0, 7, 3),
                   (1, 2, 6), (1, 6, 5)])
    os.makedirs(dirpath, exist_ok=True)
    tex = p9_map()
    with open(os.path.join(dirpath, "map.png"), "wb") as fh:
        fh.write(encode_png(tex))
    with open(os.path.join(dirpath, "model.mtl"), "w") as fh:
        fh.write("newmtl sphere\nKd 1 1 1\nmap_Kd map.png\n"
                 f"newmtl box\nKd {P9_KD[0]} {P9_KD[1]} {P9_KD[2]}\n")
    obj = os.path.join(dirpath, "model.obj")
    nb = len(bv)
    with open(obj, "w") as fh:
        fh.write("mtllib model.mtl\n")
        fh.write("".join("v %.17g %.17g %.17g\n" % tuple(p)
                         for p in np.concatenate([bv, sv])))
        fh.write("".join("vt %.17g %.17g\n" % tuple(t) for t in suv))
        fh.write("usemtl box\n")
        fh.write("".join("f %d %d %d\n" % tuple(t) for t in bf + 1))
        fh.write("usemtl sphere\n")
        fh.write("".join("f %d/%d %d/%d %d/%d\n" % (
            t[0] + nb, t[0], t[1] + nb, t[1], t[2] + nb, t[2])
            for t in sf + 1))
    # the sphere's chord error: the deepest point of each flat face, at
    # most r - sqrt(r^2 - R^2) for its circumradius R
    p0, p1, p2 = sv[sf[:, 0]], sv[sf[:, 1]], sv[sf[:, 2]]
    la, lb, lc = (np.linalg.norm(p1 - p2, axis=1),
                  np.linalg.norm(p0 - p2, axis=1),
                  np.linalg.norm(p0 - p1, axis=1))
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1)
    circ = la * lb * lc / (4 * area)
    chord = float((P9_SPH_R - np.sqrt(P9_SPH_R ** 2 - circ ** 2)).max())
    verts = np.concatenate([bv, sv])
    lo, hi = verts.min(0), verts.max(0)
    return {"obj": obj, "faces": len(sf) + len(bf), "chord": chord,
            "map": tex, "center": (lo + hi) / 2,
            "scale": 2.0 / ((hi - lo).max() * 1.03)}


def p9_analytic(shape: dict, p):
    """(the union's exact SDF, on-the-box mask, sphere direction) at
    normalized points p, from the OBJ-unit shape and the sampler's
    normalization (centre, scale)."""
    import numpy as np
    s = shape["scale"]
    c = (np.asarray(P9_BOX_C) - shape["center"]) * s
    h = np.asarray(P9_BOX_H) * s
    q = np.abs(p - c) - h
    box = (np.linalg.norm(np.maximum(q, 0.0), axis=-1)
           + np.minimum(q.max(axis=-1), 0.0))
    sc = (np.asarray(P9_SPH_C) - shape["center"]) * s
    d = p - sc
    rho = np.linalg.norm(d, axis=-1)
    sph = rho - P9_SPH_R * s
    return np.minimum(box, sph), box < sph, d / np.maximum(rho, 1e-12)[
        ..., None]


def p9_colour_check(shape: dict, pts, tex, label: str) -> dict:
    """Points on the box exactly Kd; points on the sphere (away from its
    poles) within one texel's colour step of the map at their analytic
    UV (the map's largest difference between a texel and its 8
    neighbours)."""
    import numpy as np
    _, on_box, d = p9_analytic(shape, pts)
    kd_bad = int((tex[on_box] != np.asarray(P9_KD)).any(axis=1).sum())
    m = shape["map"].astype(np.float64) / 255.0
    H, W = m.shape[:2]
    step = 0.0
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        # texel (y + dy, x) against (y, x + dx); u wraps, v does not
        step = max(step, float(np.abs(
            m[dy:] - np.roll(m, -dx, axis=1)[:H - dy]).max()))
    theta = np.arccos(np.clip(d[:, 2], -1, 1))
    u = np.mod(np.arctan2(d[:, 1], d[:, 0]) / (2 * np.pi), 1.0)
    v = 1.0 - theta / np.pi
    pole = 3 * np.pi / P9_SPHERE_ROWS
    sel = ~on_box & (theta > pole) & (theta < np.pi - pole)
    ix = np.floor(u[sel] * W).astype(int) % W
    iy = np.clip(np.floor((1.0 - v[sel]) * H).astype(int), 0, H - 1)
    err = np.abs(tex[sel] - m[iy, ix]).max(axis=1)
    out = {"points": int(len(pts)), "box": int(on_box.sum()),
           "kd_mismatch": kd_bad, "sphere_checked": int(sel.sum()),
           "worst_colour_err": float(err.max()) if sel.any() else 0.0,
           "texel_step": step}
    print(f"mesh sampler {label} colours: {out}")
    # the map is float32 in the sampler: allow its rounding
    if kd_bad or not sel.any() or out["worst_colour_err"] > step + 1e-6:
        fail(f"mesh sampler: {label} colours off the material ({out})")
    return out


def p9_sdf_check(shape: dict, pts, sdf, threshold: float, label: str,
                 tol: float) -> dict:
    """|sdf - analytic| <= tol where |analytic| < threshold (sdf is clipped
    to it), and the same sign wherever |analytic| > tol."""
    import numpy as np
    ref, _, _ = p9_analytic(shape, pts)
    near = np.abs(ref) < threshold
    err = float(np.abs(sdf[near] - ref[near]).max())
    far = np.abs(ref) > tol
    flips = int((np.sign(sdf[far]) != np.sign(ref[far])).sum())
    out = {"points": int(len(pts)), "near": int(near.sum()),
           "worst_err": err, "tol": tol, "sign_flips": flips,
           "clipped_to": float(np.abs(sdf).max())}
    print(f"mesh sampler {label} sdf: {out}")
    if err > tol or flips or out["clipped_to"] > threshold:
        fail(f"mesh sampler: {label} sdf off the analytic shape ({out})")
    return out


def p9_ae_steps(npz: str) -> dict:
    """P9_AE_STEPS steps of `make_train_step` on the card at the encoding
    args.json's width from a fresh init (TF32 on, as the CLI trains):
    every loss finite, the last 5 below the first 5 on average."""
    import numpy as np
    import torch
    from sin3dm_tpu_torch.models.autoencoder import init_autoencoder
    from sin3dm_tpu_torch.training import ae as TA
    dev = torch.device("cuda")
    acfg, tcfg, data, meta = ae_setup(npz, dev)
    st = TA.init_train_state(init_autoencoder(
        torch.Generator(dev).manual_seed(0), acfg), tcfg)
    step = TA.make_train_step(acfg, tcfg, meta["threshold"])
    losses = []
    with tf32(True):
        t0 = time.perf_counter()
        while st.step < P9_AE_STEPS:
            losses.append(float(step(st, data, 0)["loss"]))
        secs = time.perf_counter() - t0
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"mesh sampler npz: {st.step} AE steps on the card in "
          f"{secs:.2f} s, grid {meta['grid_shape']}, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f} (first 5 {first:.6f}, last "
          f"5 {last:.6f})")
    if not (np.isfinite(losses).all() and last < first):
        fail(f"mesh sampler npz: AE losses not finite and falling {losses}")
    del data, st
    torch.cuda.empty_cache()
    return {"steps": P9_AE_STEPS, "losses": losses, "seconds": secs}


def phase9(tmp: str) -> dict:
    """9. The box-and-sphere OBJ through `mesh_sampler.main` with the
    README's flags (--n_surf 5000000 --watertight, reso 256): the schema
    the AE reads, the grid and near-surface SDF against the analytic
    shape, the colours against the materials, 20 AE steps on the npz;
    then reso 64 without --watertight, through the remesh."""
    import numpy as np
    from sin3dm_tpu_torch.dataio import mesh_sampler
    from sin3dm_tpu_torch.dataio.grid import grid_resolutions, \
        normalize_aabb
    from sin3dm_tpu_torch.geometry import native
    from sin3dm_tpu_torch.geometry.meshproc import load_obj_scene
    t0 = time.perf_counter()
    shape = p9_write_obj(os.path.join(tmp, "mesh"))
    scene = load_obj_scene(shape["obj"])
    aabb, _, _ = normalize_aabb(scene["verts"], P9_RESO)
    grid = tuple(int(x) for x in grid_resolutions(aabb, P9_RESO))
    cores = {"os.cpu_count": os.cpu_count(),
             "affinity": len(os.sched_getaffinity(0)),
             "library_flags": " ".join(native.build_flags())}
    print(f"mesh sampler: {shape['obj']}: {shape['faces']} faces "
          f"(written in {time.perf_counter() - t0:.2f} s), sphere chord "
          f"error {shape['chord']:.3e} (OBJ units), grid {grid} (want "
          f"{P9_GRID}); host cores {cores}")
    if grid != P9_GRID:
        fail(f"mesh sampler: the shape's grid is {grid}, not {P9_GRID}")
    npz = os.path.join(tmp, "shape.npz")
    t0 = time.perf_counter()
    secs = mesh_sampler.main(["-s", shape["obj"], "-d", npz, "--reso",
                              str(P9_RESO), "--n_surf", str(P9_NSURF),
                              "--watertight"])
    total = time.perf_counter() - t0
    print("mesh sampler seconds per stage (reso 256, 5M): " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()) + f"; main {total:.2f}")
    with np.load(npz) as f:
        d = {k: f[k] for k in f.files}
    nsurf = min(P9_NSURF, mesh_sampler.ON_SURF_CAP)
    want = {"pts_grid": (P9_GRID + (3,), np.float32),
            "sdf_grid": (P9_GRID, np.float64),
            "tex_grid": (P9_GRID + (3,), np.float64),
            "pts_on_surf": ((nsurf, 3), np.float64),
            "tex_on_surf": ((nsurf, 3), np.float64),
            "pts_near_surf": ((P9_NSURF, 3), np.float64),
            "sdf_near_surf": ((P9_NSURF,), np.float64),
            "tex_near_surf": ((P9_NSURF, 3), np.float64),
            "aabb": ((6,), np.float64), "threshold": ((), np.float64),
            "Ka": ((3,), np.float64), "Kd": ((3,), np.float64),
            "Ks": ((3,), np.float64), "Ns": ((), np.float64)}
    schema = {k: (tuple(v.shape), v.dtype) for k, v in d.items()}
    bad = {k: schema.get(k) for k, w in want.items() if schema.get(k) != w}
    mib = os.path.getsize(npz) / 2 ** 20
    print(f"mesh sampler npz: {len(d)} keys, {mib:.1f} MiB on disk; schema "
          f"{'as the AE reads it' if not bad else bad}")
    if bad or sorted(d) != sorted(want):
        fail(f"mesh sampler npz: schema {bad}, keys {sorted(d)}")
    thr = float(d["threshold"])
    tol = shape["chord"] * shape["scale"] + 2e-6
    checks = {
        "grid_sdf": p9_sdf_check(shape, d["pts_grid"].reshape(-1, 3).astype(
            np.float64), d["sdf_grid"].reshape(-1), thr, "grid", tol),
        "near_sdf": p9_sdf_check(shape, d["pts_near_surf"],
                                 d["sdf_near_surf"], thr, "near-surface",
                                 tol)}
    on, _, _ = p9_analytic(shape, d["pts_on_surf"])
    checks["on_surf_abs_sdf"] = float(np.abs(on).max())
    if checks["on_surf_abs_sdf"] > tol:
        fail(f"mesh sampler: on-surface points {checks['on_surf_abs_sdf']} "
             "off the shape")
    mask = np.abs(d["sdf_grid"].reshape(-1)) < thr
    checks["grid_tex"] = p9_colour_check(
        shape, d["pts_grid"].reshape(-1, 3)[mask].astype(np.float64),
        d["tex_grid"].reshape(-1, 3)[mask], "grid")
    checks["on_tex"] = p9_colour_check(shape, d["pts_on_surf"],
                                       d["tex_on_surf"], "on-surface")
    nmask = np.abs(d["sdf_near_surf"]) < thr
    checks["near_tex"] = p9_colour_check(shape, d["pts_near_surf"][nmask],
                                         d["tex_near_surf"][nmask],
                                         "near-surface")
    del d
    ae = p9_ae_steps(npz)
    os.remove(npz)
    # reso 64 through the watertight remesh
    npz64 = os.path.join(tmp, "shape64.npz")
    t0 = time.perf_counter()
    secs64 = mesh_sampler.main(["-s", shape["obj"], "-d", npz64, "--reso",
                                "64", "--n_surf", str(P9_NSURF_REMESH)])
    total64 = time.perf_counter() - t0
    print("mesh sampler seconds per stage (reso 64, remesh): " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs64.items()) + f"; main {total64:.2f}")
    wt = load_obj_scene(shape["obj"].replace(".obj",
                                             "_watertight_r100000.obj"))
    with np.load(npz64) as f:
        pts = f["pts_grid"].reshape(-1, 3).astype(np.float64)
        sdf = f["sdf_grid"]
    # the remesh's marching cubes lies within one cell of its winding-
    # number grid (64 points along the longest axis, padded by 3 % of it
    # on each side) of the surface; in normalized units the longest axis
    # is 2 / 1.03
    cell = 2 / 1.03 * 1.06 / 63
    ref, _, _ = p9_analytic(shape, pts)
    far = np.abs(ref) > 2 * cell
    flips = int((np.sign(sdf.reshape(-1)[far]) != np.sign(ref[far])).sum())
    remesh = {"faces": len(wt["faces"]), "grid": list(sdf.shape),
              "cell": cell, "checked": int(far.sum()), "sign_flips": flips}
    print(f"mesh sampler remesh: {remesh}")
    if flips or not far.any():
        fail(f"mesh sampler: the remeshed SDF's signs differ ({remesh})")
    return {"shape": {k: shape[k] for k in ("faces", "chord")},
            "grid": list(grid), "cores": cores, "seconds": secs,
            "main_seconds": total, "checks": checks, "ae": ae,
            "remesh_seconds": secs64, "remesh_main_seconds": total64,
            "remesh": remesh, "obj": shape["obj"]}


# ---------------------------------------------------------------------------
# Phase 10: evaluation on the card
# ---------------------------------------------------------------------------

GRIDS = os.path.join(TAG, "results_parity", "{:03d}", "r256_voxel.npz")
# JAX's LP and Div of the committed grids 001-015 against grid 000, made
# in the JAX package's environment on the CPU by
#   python -c "import numpy as np; from sin3dm_tpu.evaluation import
#   patch_metrics as pm; P = 'checkpoints/towerruins/results_parity/%03d/
#   r256_voxel.npz'; ref = pm.pool_to(np.load(P % 0)['vox_grid']); gen =
#   [pm.load_voxel_npz(P % i) for i in range(1, 16)]; r =
#   pm.eval_lp_full(gen, ref); r['Div'] = pm.eval_div(gen); print(r)"
P10_JAX = {"LP-IOU-avg": 0.9377148350079855,
           "LP-IOU-percent": 0.5679843204787483,
           "LP-F-score-avg": 0.9665491819381714,
           "LP-F-score-percent": 0.8218088515089169,
           "Div": 0.12860178770699623}
P10_JAX_TOL = 1e-6
# card against host in eval_full: LP and Div absolute, the rest relative
P10_TOL = {"LP": 1e-6, "Div": 1e-6, "SSFID": 1e-4, "mv_sifid": 1e-4,
           "mv_lpips": 1e-5}


def p10_ref_npz(path: str) -> None:
    """Grid 000 as the reference shape's SDF npz (-1 inside, +1 out)."""
    import numpy as np
    with np.load(GRIDS.format(0)) as f:
        vox = f["vox_grid"]
    with open(path, "wb") as fh:
        np.savez(fh, sdf_grid=np.where(vox, -1.0, 1.0).astype(np.float32))


def p10_lp(ref_npz: str) -> dict:
    """10a. LP (avg, percent) and Div of grids 001-015 against grid 000 on
    the card and on the host: each grid's per-patch arrays equal bit for
    bit, both within P10_JAX_TOL of JAX's values."""
    import numpy as np
    import torch
    from sin3dm_tpu_torch.evaluation import patch_metrics as pm
    out, arrays = {}, {}
    for side, dev in (("card", torch.device("cuda")),
                      ("host", torch.device("cpu"))):
        t0 = time.perf_counter()
        ref = pm.load_sdf_npz_as_voxel(ref_npz, device=dev)
        gens = [pm.load_voxel_npz(GRIDS.format(i), device=dev)
                for i in range(1, 16)]
        patches = pm.extract_patches(ref)
        arrays[side] = [pm.lp_score_arrays(g, patches) for g in gens]
        res = pm.eval_lp_full(gens, ref)
        res["Div"] = pm.eval_div(gens)
        res["seconds"] = time.perf_counter() - t0
        res["ref_patches"] = len(patches)
        out[side] = res
    same = all(np.array_equal(a, b) and a.dtype == b.dtype
               for ca, ha in zip(arrays["card"], arrays["host"])
               for a, b in zip(ca, ha))
    errs = {side: max(abs(out[side][k] - v) for k, v in P10_JAX.items())
            for side in out}
    n = [len(a[0]) for a in arrays["host"]]
    print(f"eval 10a: 15 grids against grid 000 ({out['host']['ref_patches']} "
          f"reference patches, {min(n)}-{max(n)} per grid): card "
          f"{json.dumps({k: out['card'][k] for k in P10_JAX})} in "
          f"{out['card']['seconds']:.2f} s, host in "
          f"{out['host']['seconds']:.2f} s; per-patch arrays card = host bit "
          f"for bit: {same}; from JAX's values: card {errs['card']:.3e}, "
          f"host {errs['host']:.3e} (tolerance {P10_JAX_TOL})")
    if not same or max(errs.values()) > P10_JAX_TOL:
        fail("eval 10a: LP/Div off JAX's values or card off the host")
    return {"card": out["card"], "host": out["host"],
            "per_patch_equal": same, "jax_err": errs}


def p10_weights(dirpath: str) -> list:
    """The four metric weight files in their published layouts, from the
    port's modules filled by a fixed generator (He-scaled conv and linear
    weights, small biases, randomized BatchNorm running stats), as
    eval_full flags."""
    import torch
    from sin3dm_tpu_torch.evaluation import lpips, sifid, ssfid
    g = torch.Generator().manual_seed(10)

    def fill(module):
        sd = module.state_dict()
        for k, t in sd.items():
            if k.endswith("num_batches_tracked"):
                continue
            if k.endswith("running_var") or k.endswith("bn.weight"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif k.endswith("weight") and t.dim() > 1:
                fan_in = t[0].numel()
                t.copy_(torch.randn(t.shape, generator=g)
                        * (2.0 / fan_in) ** 0.5)
            else:
                t.copy_(0.05 * torch.randn(t.shape, generator=g))
        return sd

    files = {
        "ssfid_weights": fill(ssfid.Clsshapenet()),
        "inception_weights": fill(sifid.InceptionFeatures(2048)),
        "alexnet_weights": fill(lpips.AlexNetFeatures()),
        "lpips_weights": {f"lpips_weights.{i}.main.1.weight":
                          torch.rand(1, c[1], 1, 1, generator=g)
                          for i, c in enumerate(lpips.AlexNetFeatures.CFG)},
    }
    os.makedirs(dirpath, exist_ok=True)
    flags = []
    for name, sd in files.items():
        path = os.path.join(dirpath, f"{name}.pth")
        torch.save(sd, path)
        flags.append(f"--{name}={path}")
    return flags


def p10_eval_full(tmp: str, mesh_dir: str, obj9: str) -> dict:
    """10b. `eval_full.main` over the mesh path's 2 samples (voxel.npz and
    8 renders at 512 by the port's renderer) and the 15 committed grids,
    against grid 000 and renders of phase 9's OBJ, with seeded weights:
    on the card, then on the host; every metric within P10_TOL."""
    import numpy as np
    from sin3dm_tpu_torch.evaluation import eval_full
    from sin3dm_tpu_torch.rendering import softraster
    src, ref = os.path.join(tmp, "results"), os.path.join(tmp, "ref")
    for j in range(2):
        d = os.path.join(src, f"{j:03d}")
        os.makedirs(d)
        for name in ("voxel.npz", "object.obj", "object.mtl", "object.png"):
            shutil.copy(os.path.join(mesh_dir, f"{j:03d}", name), d)
    t0 = time.perf_counter()
    softraster.main(["-s", src])
    gen_render = time.perf_counter() - t0
    for i in range(1, 16):
        d = os.path.join(src, f"{i + 1:03d}")
        os.makedirs(d)
        shutil.copy(GRIDS.format(i), d)
    os.makedirs(ref)
    p10_ref_npz(os.path.join(ref, "grid000.npz"))
    t0 = time.perf_counter()
    softraster.render_multiview(obj9, os.path.join(ref, "renderings"))
    ref_render = time.perf_counter() - t0
    views = 8 * 3
    print(f"eval 10b: renders at 512: {gen_render:.2f} s for 2 samples "
          f"(~10,000 faces), {ref_render:.2f} s for the reference "
          f"(~100,000 faces); {(gen_render + ref_render) / views:.3f} s per "
          "view")
    flags = p10_weights(os.path.join(tmp, "weights"))
    out, secs = {}, {}
    for side, dev in (("card", "cuda"), ("host", "cpu")):
        secs[side] = {}
        t0 = time.perf_counter()
        out[side] = eval_full.main(
            ["-s", src, "-r", ref, "-o", os.path.join(tmp, f"{dev}.json"),
             "--device", dev, *flags], seconds=secs[side])
        secs[side]["main"] = time.perf_counter() - t0
    errs = {}
    for k, want in out["host"].items():
        tol = next(t for p, t in P10_TOL.items() if k.startswith(p))
        err = abs(out["card"][k] - want)
        rel = not k.startswith(("LP", "Div")) and want != 0
        errs[k] = (err / abs(want) if rel else err, tol)
    print("eval 10b: card " + json.dumps(out["card"]))
    print("eval 10b: host " + json.dumps(out["host"]))
    print("eval 10b: card vs host (error, tolerance): " + json.dumps(errs))
    print("eval 10b: seconds per metric, card " + json.dumps(secs["card"])
          + ", host " + json.dumps(secs["host"]))
    keys = {"LP-IOU-avg", "LP-IOU-percent", "LP-F-score-avg",
            "LP-F-score-percent", "LP_IOU", "LP_F_score", "Div", "SSFID_avg",
            "SSFID_std", "mv_sifid_dim64", "mv_sifid_dim192", "mv_lpips"}
    if set(out["card"]) != keys or set(out["host"]) != keys:
        fail(f"eval 10b: keys {sorted(out['card'])}")
    if any(not np.isfinite(v) for v in out["card"].values()) or any(
            e > t for e, t in errs.values()):
        fail("eval 10b: card and host metrics differ")
    return {"card": out["card"], "host": out["host"], "errors": errs,
            "seconds": secs, "render_s_per_view":
            (gen_render + ref_render) / views}


def phase10(tmp: str, mesh_dir: str, obj9: str) -> dict:
    ref_npz = os.path.join(tmp, "grid000.npz")
    p10_ref_npz(ref_npz)
    lp = p10_lp(ref_npz)
    full = p10_eval_full(tmp, mesh_dir, obj9)
    return {"lp": lp, "eval_full": full}


# ---------------------------------------------------------------------------

def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.dataio.grid import grid_resolutions
    from sin3dm_tpu_torch.geometry import native
    from sin3dm_tpu_torch.models.unet import k1_launches_by_form
    from sin3dm_tpu_torch.ops import _build, pack_params

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind}")
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build: the kernels, and the geometry library beside them
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        geo = pool.submit(native.build)
        built = _build.build(["fused_conv", "fused_mlp"])
        print(f"build: {time.perf_counter() - t0:.1f} s (parallel nvcc)")
        geo_build = geo.result()
    print(f"build: geometry library (g++ {' '.join(geo_build['flags'])}) "
          f"{geo_build['seconds']:.1f} s, {geo_build['path']}")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    B = 2
    k1f = check_k1_forms(B)
    k1 = k1f["default"]
    k1p = {f: k1f[f] for f in ("act", "act+stats", "act+skip+stats")}
    tree, meta = ckpt.load_tree(os.path.join(
        TAG, "encoding", "ckpt_final.pth"), "params")
    ae_params = pack_params(ae_params_from_jax(tree, "cuda"))
    gx, gy, gz = meta["grid_shape"]
    slab_rows = 8 * gy * gz
    k2 = check_k2(ae_params, slab_rows)
    k2_shapes = check_k2_shapes(ae_params, (
        ("geo slab", "geo_decoder", slab_rows),
        ("texel chunk", "tex_decoder", 2 ** 20),
        ("evaluate surface chunk", "geo_decoder", 2 ** 20)))
    k2_mesh = {"geo_decoder": k2_shapes["geo slab"],
               "tex_decoder": k2_shapes["texel chunk"]}
    k2_surf = k2_shapes["evaluate surface chunk"]

    # 4. main path, default configuration
    vox = ["--tag", TAG, "--vox", "--n_samples", "2"]
    args = cli.cfgmod.sample_args(vox)
    ucfg = cli._unet_config(args)
    n_steps = int(args.steps)
    want_k2 = 2 * -(-gx // 8) * 2     # 2 heads x slabs of 8 x-rows, 2 grids

    def want(steps):
        return {f: n * steps for f, n in k1_launches_by_form(ucfg).items()}

    print("main path: K1 makes one launch per triplane conv, 8 per forward; "
          "the JAX kernel makes 27 (one per plane, and it splits the "
          "192-channel conv)")
    with configuration("default"):
        _, main_counts, _ = drive_vox("main path", vox, want(n_steps),
                                      want_k2)

    # 4b. the opt-in configurations
    opt_in = {}
    for name in ("stats chain", "fused act"):
        with configuration(name):
            _, opt_in[name], _ = drive_vox(name, vox, want(n_steps), want_k2)

    # 4c. forward parity of the opt-in configurations with the default
    parity_err = forward_parity(B)

    # 4d. --inpaint under the stats chain
    inpaint = vox + ["--use_ddim", "true", "--timestep_respacing", "ddim100",
                     "--inpaint", "true", "--inpaint_region", "0", "0.5",
                     "0", "1", "0", "1", "--is_mask_t0", "true"]
    with configuration("stats chain"):
        _, inpaint_counts, feats = drive_vox("inpaint", inpaint, want(100),
                                             want_k2, occupancy=False)
    check_inpaint(feats, feats[0][0].shape[1])

    # 4e. the mesh path, default configuration
    # one batch-2 chain: the chunk is min(--pipeline_chunk, the diffusion
    # args.json's diff_batch_size (32), --n_samples)
    mesh_argv = ["--tag", TAG, "--n_samples", "2", "--pipeline_chunk", "2"]
    margs = cli.cfgmod.sample_args(mesh_argv)
    aabb = np.asarray(meta["aabb"], np.float64)
    slabs = -(-int(grid_resolutions(aabb, margs.reso)[0]) // 8)
    with configuration("default"):
        mesh_res, mesh_counts, mesh_dir, mesh_secs = drive_mesh(
            mesh_argv, want(n_steps), aabb, margs.reso, margs.texreso,
            margs.n_faces, slabs)
    # its samples stay for phase 10b; the directory goes at exit
    atexit.register(shutil.rmtree, mesh_dir, ignore_errors=True)
    # 4f. the card against the plain path on sample 0's feat.npz
    parity = card_vs_plain(os.path.join(mesh_dir, "000", "feat.npz"))

    # 5. where a chain step's time goes, per configuration
    prof = {}
    for name in CONFIGS:
        print(f"profile, {name} configuration:")
        with configuration(name):
            prof[name] = profile_chain(["--tag", TAG])
    for name, p in prof.items():
        busy = (f"device busy {p['busy_ms']:.3f} ms "
                f"({p['busy_ms'] / p['step_ms']:.1%}), "
                f"{p['ops_per_step']:.0f} operations per step"
                if "busy_ms" in p else "device busy not measured")
        print(f"chain step, {name}: {p['step_ms']:.3f} ms per step (host "
              f"clock), {busy}")

    # 6. training: a step on the card against the host, the trainer
    # through its CLI, its profile, then sampling from what it wrote
    train_dir = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_train_")
    try:
        step_check = train_step_card_vs_host()
        trained = drive_train(os.path.join(train_dir, "tag"))
        loop = trained.pop("loop")
        tag6 = os.path.join(train_dir, "tag")
        args6 = cli.cfgmod.sample_args(["--tag", tag6])
        train_prof = profile_train(loop, cli.cfgmod.unet_config_from_args(
            args6))
        del loop
        torch.cuda.empty_cache()
        ucfg6 = cli._unet_config(args6)
        with configuration("default"):
            want6 = {f: n * 10 for f, n in k1_launches_by_form(ucfg6).items()}
            _, counts6, _ = drive_vox(
                "sample from the trained tag", [
                    "--tag", tag6, "--vox", "--use_ddim", "true",
                    "--timestep_respacing", "ddim10", "--n_samples", "2"],
                want6, want_k2, occupancy=False)
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    print("train: " + json.dumps({
        "step_card_vs_host": step_check, **trained,
        "profile": train_prof, "sample_launches": counts6}))

    # 8. AE training at the encoding's full width
    ae8 = phase8()

    # 9. data preparation, 10. evaluation on the card (4e's samples are
    # evaluated in 10b); neither launches K1 or K2
    ends = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_ends_")
    try:
        reset_counts()
        prep = phase9(ends)
        evals = phase10(ends, mesh_dir, prep["obj"])
        ends_counts = read_counts()
    finally:
        shutil.rmtree(ends, ignore_errors=True)
    print(f"data preparation and evaluation: K1 launches "
          f"{ends_counts['k1']}, K2 launches {ends_counts['k2']} (want 0, 0)")
    if ends_counts["k1"] or ends_counts["k2"]:
        fail("phases 9-10 launched K1 or K2")
    print("data preparation: " + json.dumps(prep, default=float))
    print("evaluation: " + json.dumps(evals, default=float))

    # 7. results
    def row(name, source, replaces, launches, r, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                **extra}

    chained = ("act+stats", "act+skip+stats")
    k1p_all = {k: sum(k1p[f][k] for f in chained)
               for k in ("ms", "device_ms", "host_ms", "plain_ms",
                         "library_ms", "library_default_ms",
                         "library_benchmark_ms", "library_device_ms",
                         "flops", "nbytes", "default_ms",
                         "default_device_ms")}
    k1p_all["max_abs_err"] = max(k1p[f]["max_abs_err"] for f in k1p)
    k1p_all["bound_ms"], k1p_all["bound_by"] = bound(
        k1p_all["flops"], k1p_all["nbytes"], PEAK_BF16_FLOPS)
    k1p_launches = {f: opt_in["stats chain"]["k1_forms"].get(f, 0)
                    for f in chained}
    k1p_launches["act"] = opt_in["fused act"]["k1_forms"].get("act", 0)
    ratios = {"act_over_default": k1p["act"]["ms"] / k1["ms"],
              "act_over_default_device": (k1p["act"]["device_ms"]
                                          / k1["device_ms"]),
              "stats_over_default_same_shapes": (k1p_all["ms"]
                                                 / k1p_all["default_ms"]),
              "stats_over_default_same_shapes_device": (
                  k1p_all["device_ms"] / k1p_all["default_device_ms"])}
    print("K1' against the default form: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ratios.items()))
    lib_keys = ("device_ms", "host_ms", "library_default_ms",
                "library_benchmark_ms", "library_device_ms")
    src = "sin3dm_tpu_torch/csrc/fused_conv.cu"
    kernels = [
        row("conv3x3_rollout", src, "sin3dm_tpu/ops/fused_conv.py:177",
            main_counts["k1"], k1, **{k: k1[k] for k in lib_keys},
            launches_train_step=trained["launches_train_step"]["k1"],
            launches_sample_after_training=counts6["k1"]),
        row("conv3x3_rollout act/skip/emit_stats (K1')", src,
            "sin3dm_tpu/ops/fused_conv.py:177",
            sum(k1p_launches[f] for f in chained), k1p_all,
            **{k: k1p_all[k] for k in lib_keys},
            forms={f: {"launches": k1p_launches[f],
                       **{k: k1p[f][k] for k in
                          ("ms", "device_ms", "host_ms", "plain_ms",
                           "library_ms", "library_default_ms",
                           "library_benchmark_ms", "library_device_ms",
                           "bound_ms", "bound_by", "max_abs_err")}}
                   for f in k1p},
            ratios=ratios, forward_parity_max_abs=parity_err,
            inpaint_launches=inpaint_counts["k1_forms"]),
        row("skip_mlp", "sin3dm_tpu_torch/csrc/fused_mlp.cu",
            "sin3dm_tpu/ops/fused_mlp.py:79",
            main_counts["k2"] + mesh_counts["k2"] + ae8["launches"]["k2"],
            k2, device_ms=k2["device_ms"],
            library_device_ms=k2["library_device_ms"],
            launches_vox=main_counts["k2"], launches_mesh=mesh_counts["k2"],
            launches_ae_train=ae8["launches"]["k2"],
            launches_ae_evaluate=ae8["launches_by_stage"]["evaluate"],
            launches_ae_rec=ae8["launches_by_stage"]["rec"],
            launches_ae_train_by_shape=ae8["launches_by_stage"][
                "cli_by_shape"],
            launches_ae_train_step=ae8["step"]["launches"]["k2"],
            mesh_shapes=k2_mesh,
            launches_train_step=trained["launches_train_step"]["k2"],
            launches_sample_after_training=counts6["k2"]),
        row("skip_mlp geo head [2^20, 64] -> 1 (evaluate's surface chunk)",
            "sin3dm_tpu_torch/csrc/fused_mlp.cu",
            "sin3dm_tpu/ops/fused_mlp.py:79",
            ae8["launches_by_stage"]["surface_chunk_geo"], k2_surf,
            device_ms=k2_surf["device_ms"],
            library_device_ms=k2_surf["library_device_ms"]),
    ]
    print("kernel times: K1 per UNet forward at batch 2 (8 triplane "
          "launches), K1' per stats-chained forward (3 act+stats + 3 "
          "act+skip+stats launches; its 'act' form per fused-act forward, 8 "
          "launches), K2 per x-slab of both heads; 'ms' by CUDA events over "
          "back-to-back calls (the wrapper's host time included where it is "
          "the longer; 'host_ms' that host time alone), 'device_ms' the "
          "kernels' own time from the profiler, 'library_ms' and "
          "'library_device_ms' the yardstick's by the same two methods; "
          "launches from each configuration's --vox run; K2's summed over "
          "the default --vox run and the mesh path's run, with its times "
          "at the mesh path's shapes under 'mesh_shapes'; "
          "'launches_train_step' counted over 80 steps of the CLI's train "
          "step (6b: cuDNN convs, so 0), 'launches_sample_after_training' "
          "in the DDIM-10 --vox sample from the trained tag; K2's "
          "'launches' also counts the AE training run of phase 8c "
          "('launches_ae_train': evaluate's and the rec mesh's), the AE "
          "train step none; the row of K2's evaluate surface chunk "
          "counts the launches of that shape in 8c's CLI run, by the "
          "wrapper's count by shape")
    print("mesh path per sample (s): " + json.dumps(
        {"generate_s_per_sample": mesh_res["seconds"] / len(
            mesh_res["paths"]), "stages": mesh_secs,
         "card_vs_plain": parity}))
    def strict(v):              # a number not measured is null, not NaN
        if isinstance(v, dict):
            return {k: strict(x) for k, x in v.items()}
        if isinstance(v, list):
            return [strict(x) for x in v]
        if isinstance(v, float) and not abs(v) < float("inf"):
            return None
        return v
    print(smi)
    print(json.dumps({"kernels": strict(kernels)}, allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
