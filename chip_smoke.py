#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`sin3dm_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one, and outside a checkout
of this repository.  Phases, each printing its results:

1. device: name, power limit, torch/CUDA versions; TF32 off;
2. build: the kernels with nvcc from `sin3dm_tpu_torch/csrc/`, in
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
   them) also against its three single-plane launches, bit for bit; at
   batch 2 (the main path's) with times, and checked once more, untimed,
   at batch 1 (serving's chains and the bpd loop, phase 11); the triplane
   norm kernel (`ops/tnorm.py`) at a forward's nine norms, batch 2 with
   times and batch 1 untimed, against fp64 statistics, the plain apply
   and torch's means, timed beside its plain version and the
   `F.group_norm` route;
4. main path: `cli.sample.main(--tag checkpoints/towerruins --vox
   --n_samples 2)` (DDPM-1000, batch 2, --reso 256) with the launch
   counters set to 0 just before and read just after (K1 8 and the norm
   kernel 9 a forward, in this and every later phase that counts K1),
   output checks and the chain/decode seconds;
4b. the same under `SIN3DM_STATS_CHAIN=1`, then under
   `SIN3DM_FUSED_ACT=1`, with per-form K1 launch counts;
4c. one full-width forward of the towerruins UNet at batch 2: the stats
   chain and the fused act (`SIN3DM_FUSED_ACT=1`) each against the
   default configuration;
4d. `--inpaint` under the stats chain (DDIM-100): kept cells equal the
   tag's feat.npz, regenerated cells moved;
4g. the kernels' opt-outs: `--vox` DDIM-100 (batch 2) with the kernels,
   then under SIN3DM_FUSED_CONV=0 SIN3DM_FUSED_HEADS=0 (cuDNN convs in
   the chain, the plain heads in the decode): no K1 and no K2 launch,
   each feat.npz within K1's bf16 forward bound (4c's) of the kernels'
   run, the voxel grids within INT8_SHARE_BOUND of its, both routes'
   chain seconds per sample;
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
   memory, each dumped mean loss, the checkpoint files; then 160 more
   steps of the CLI's step with the launch counts set to 0 just before
   and read just after (K1 and K2: 0), 80 with today's algorithms and
   80 with the deterministic ones `cli.train` trains under, in turns:
   ms per step and samples/s of each;
   6c a 5-step profile of the train step (busy share, operations,
   top device kernels); 6e two runs of one `cli.train` command (the
   committed encoding, batch 32, 40 steps) dump the same bits; 6d
   `cli.sample --vox` DDIM-10 from what training wrote, with K1's and
   K2's launches counted;
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
   ms (today's algorithms and the deterministic ones, in turns),
   points/s, peak memory, profile and share of its TF32 bound (K2's
   evaluate shape, the geo head over [2^20, 64], joins phase 3); 6e's
   AE half: two runs of `cli.train --only_enc` on 8a's npz (20
   iterations) dump the same bits; 8g the `base` net and 8h the `pbr`
   net (8a's shape with analytic metallic, roughness and normal
   channels) at the same width: a 60-iteration `cli.train --only_enc`
   (losses finite and falling, the checkpoint and feat.npz), 8b's step
   checks from the params it trained, a decode at reso 64 with K2's launches by
   shape (base: none, as in JAX; pbr: a launch a head and slab at cout
   1, 3, 2 and 3) and, for pbr, 8e's checks on its four trained heads
   and K2 at cout 2 timed over the geo slab's rows;
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
11. serving and the diffusion library, in a temporary checkpoints root
   (the committed tag linked, and its weights written in the reference's
   torch format by `cli.import_torch_ckpt --reverse`): 11a the torch
   files' transplanted UNet and AE trees equal the npz tag's bit for
   bit, the trainer loads both the same on the card, and `--vox`
   DDIM-10 from each tag gives the same feat.npz and grids; 11b
   `cli.app.build_http_server` on a thread: GET / lists both tags; a JSON
   DDIM-100 request of 2 samples, a form-encoded DDPM-1000 one, the JSON
   one against the reference tag (its sample 0 equal to the first's),
   two tags outside the root (400, nothing written), and two requests in
   parallel threads (each equal to the same request served alone), every
   GLB checked (glTF 2, one mesh of <= 10,000 faces inside the AABB, a
   2048x2048 PNG) and K1 and K2 counted around each request; 11c at full
   width on the committed EMA and feat.npz: the progressive loops' last
   snapshots equal the plain loops, a zero cond_fn equals the unguided
   chain (through condition_score and condition_mean), a pull towards
   feat.npz ends nearer it, a DDIM-10 round trip and vb_terms_bpd at
   t in {0, 1, 500, 999} in fp32 on the card against the host, a bf16
   DDIM-100 round trip, and calc_bpd_loop over T = 1000 (K1 8,000);
12. two ranks that share card 0 over gloo on any machine (the ranks and
   the bootstrapped processes see card 0 alone through
   CUDA_VISIBLE_DEVICES), started by the port's `parallel.spawn`: 12a
   the group's backend, each rank's device, an all_reduce of a CUDA
   tensor, and in bf16 and fp32 an all_reduce_many of dyadic values and
   a gather_rows, bit for bit; 12d 2 ranks x 16 of the diffusion train
   step at the tag's width against this process at batch 32 with the
   same draws, TF32 off (loss terms 1e-5 relative; each leaf's grad
   within P12_GRAD_TOL of its largest of the same step in fp64 on the
   card, this process's fp32 grad's distances printed beside; the DP
   step with TF32 on, the control, must lie beyond that limit), the
   ranks' params bit-identical after 4 steps, ms per step with TF32 on
   beside this process's at batch 32, and the gradient's all_reduce
   alone; 12e the AE step at batch 65,536 on phase 8's synthetic shape
   the same way; 12f two processes started with the SIN3DM_DIST
   variables give 12d's first step; 12b `cli.sample --sample_devices 2`
   (the mesh path, DDIM-100, 2 samples): each rank's K1 (800) and K2
   launches and outputs, its bf16 feat.npz bits against one process's
   batch-1 run, seconds against one process at batch 2 and batch 1 x2,
   and in fp32 each feat.npz within 1e-4 of each plane's largest of the
   same index's chain here; 12c `--sample_spatial 2` (DDIM-100, fp32,
   the full planes) within 1e-4 of the unsharded chain of the
   differentiable form, no K1 launch, all_reduces per forward, seconds;
13. where the machine has two cards or more, one rank a card over NCCL
   on n = min(4, cards) (on one card it prints that it did not run, and
   why): `nvidia-smi topo -m`; 13a-13f as 12a-12f on n ranks, each on
   its own card (13d at n x 32/n, 13e at n x 65,536/n, the same gates),
   13b with `--sample_devices 0` and n samples, its bf16 and fp32
   feat.npz bit for bit one process's batch-1 chains; 13f also
   `cli.train` (the committed encoding, batch 32, 2 steps) twice through
   n bootstrapped processes and through `--n_devices n` (every dumped
   array and progress line bit for bit the first run's: training runs
   under deterministic algorithms) and `cli.sample --sample_devices 0`
   through n bootstrapped processes against 13b's bits; 13h the same
   `cli.train` through n bootstrapped processes with process r on card
   n-1-r (`SIN3DM_LOCAL_RANK`): on those cards, and 13f's bits; 13c over
   2 cards, and
   `--sample_spatial 4` refused; 13g on every card but 0, from this
   process whose current device stays 0, phase 3's K1, K1′ and K2 checks
   (untimed), every card's K1 per forward and K2 per slab by events, and
   `cli.sample --gpu_id n-1 --vox` with card 0's K1 and K2 launches;
7. a JSON line of every kernel's numbers, then as the last line
   {"ok": true, "device": {...}}.

`python3 chip_smoke.py --only 12,13` (or `12`, or `13`) builds and runs
only those phases, for work on the several-rank path; without arguments
it runs every phase.  Imports nothing of JAX or of the JAX package.
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

# cuBLAS repeats its results only with a fixed workspace per stream, read
# once at the process's first cuBLAS call: set before any, for the
# deterministic training of phases 6 and 8 (`core/rng.py`'s value)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
# the triplane norm kernel's (A, B) and the plain version's, each against
# fp64 statistics: fp32 sums of up to 128 x 92 x 6 values in two orders,
# relative to |A| and to B's terms (seen ~1e-6)
TNORM_F32_TOL = 1e-5
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
    """Seeded fp32 operands of one triplane conv, per plane, on the
    generator's card: x, w, b, col3, row3, act, skip."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=g.device) * scale
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


def check_k1_forms(B: int, timed: bool = True, device: str = "cuda"):
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
    form over the same launches} per forward of its configuration.  With
    `timed` false it only checks, and each form's entry holds its
    max_abs_err.  `device`: the card the operands lie on (the caller's
    current device stays as it is)."""
    import torch
    from sin3dm_tpu_torch.ops.fused_conv import (conv3x3_rollout,
                                                 conv3x3_rollout_reference,
                                                 conv3x3_rollout_triplane,
                                                 pack_conv_weights)
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(4)
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
                    torch.cuda.synchronize(dev)
                    singles.append(got)
                    (gy, gs), (ry, rs) = (got, ref) if stats else \
                        ((got, None), (ref, None))
                    gy, ry = gy.float(), ry.float()
                    err = (gy - ry).abs()
                    tol = k1_tol(ry, dt)
                    ok = bool((err <= tol).all())
                    line = (f"K1 {dev} {form:14s} {str(dt)[6:]:8s} "
                            f"{H:3d}x{W:<3d} C={C:3d} Co={Co:3d}: "
                            f"max_abs_err {err.max().item():.3e}")
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
                torch.cuda.synchronize(dev)
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
            if not timed:
                continue
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
    print(f"K1 (batch {B}, {dev}): {n_bitwise} triplane planes equal "
          "their single-plane launches bit for bit")
    if not timed:
        return forms
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


def check_k2(ae_params, n_rows: int, timed: bool = True):
    """K2 against its plain version on both heads over `n_rows` rows, bf16
    and fp32, on the card the params lie on (the caller's current device
    stays as it is); with `timed`, the times of `k2_times` per slab."""
    import torch
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp, skip_mlp_reference
    card = ae_params["geo_decoder"]["first"][0]["w"].device
    g = torch.Generator(device=card).manual_seed(2)
    totals = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
              "library_ms": 0.0, "library_device_ms": 0.0, "bound_ms": 0.0}
    flops_all = nbytes_all = 0.0
    max_err = 0.0
    for head in ("geo_decoder", "tex_decoder"):
        params = ae_params[head]
        cin = params["first"][0]["w"].shape[0]
        x = torch.randn(n_rows, cin, generator=g, device=card) * 0.5
        for dt, tol_rel in ((torch.bfloat16, K2_BF16_TOL),
                            (torch.float32, F32_TOL)):
            got = skip_mlp(params, x, mxu_dtype=dt)
            ref = skip_mlp_reference(params, x, mxu_dtype=dt)
            torch.cuda.synchronize(card)
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = err <= tol_rel * max(scale, 1e-6)
            print(f"K2 {card} {str(dt)[6:]:8s} {head} N={n_rows}: "
                  f"max_abs_err {err:.3e}, max_rel_err "
                  f"{err / max(scale, 1e-6):.3e} of max |ref| {scale:.3e} "
                  f"(tol {tol_rel:.3e}) "
                  f"({'ok' if ok else 'FAIL'})")
            if not ok:
                fail(f"K2 {dt} {head} on {card} disagrees with its plain "
                     "version")
            max_err = max(max_err, err)
        if not timed:
            continue
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
    if not timed:
        return {"max_abs_err": max_err}
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


def tnorm_library(xs, gam, bet, film):
    """The yardstick: `F.group_norm` of each plane (channels first), the
    FiLM, `F.silu`, then the six means, in bf16."""
    import torch
    import torch.nn.functional as F
    C = xs[0].shape[-1]
    ys = []
    for x, g, b in zip(xs, gam, bet):
        y = F.group_norm(x.permute(0, 3, 1, 2), 32, g.to(x.dtype),
                         b.to(x.dtype)).permute(0, 2, 3, 1)
        if film is not None:
            y = y * (1.0 + film[:, None, None, :C]) + film[:, None, None, C:]
        ys.append(F.silu(y))
    return ys, [y.mean(dim=d) for y in ys for d in (-2, -3)]


def check_tnorm(B: int, timed: bool = True) -> dict:
    """The triplane norm kernel (`ops/tnorm.py`) at the nine norms of a
    main-path forward (the tag's planes at batch B, its widths, the FiLM
    on each out norm, the means but on the final norm): one launch each;
    (A, B) within TNORM_F32_TOL of fp64, as the plain version's; y equal
    bit for bit to the plain apply of the kernel's (A, B); the stacked
    means within one bf16 rounding of torch's means of the kernel's y;
    `max_abs_err` y's largest difference from the plain version's.
    Timed: device time and events, the plain version's and the library's
    route's device time, the bound (perfbench/counts/tnorm.py's bytes).
    Returns {norm: numbers}."""
    import torch
    from sin3dm_tpu_torch.core import nn
    from sin3dm_tpu_torch.ops import tnorm
    sys.path.insert(0, ROOT)
    from perfbench.counts.tnorm import tnorm_launch
    g = torch.Generator().manual_seed(23)
    levels = {0: ((92, 128), (92, 92), (128, 92)),
              1: ((46, 64), (46, 46), (64, 46))}
    norms = []
    for i, (lv, cin, cout) in enumerate(((0, 64, 64), (1, 64, 128),
                                         (1, 128, 128), (0, 192, 64))):
        norms += [(f"block {i} in", lv, cin, False, True),
                  (f"block {i} out", lv, cout, True, True)]
    norms.append(("final", 0, 64, False, False))
    out = {}
    for name, lv, C, film, means in norms:
        key = f"{name} (level {lv}, C {C})"
        xs = [(torch.randn(B, R, S, C, generator=g) * 1.7 + 0.4).to(
            "cuda", torch.bfloat16) for R, S in levels[lv]]
        gam = [(1.0 + 0.2 * torch.randn(C, generator=g)).cuda()
               for _ in range(3)]
        bet = [(0.2 * torch.randn(C, generator=g)).cuda() for _ in range(3)]
        fm = ((0.3 * torch.randn(B, 2 * C, generator=g)).to(
            "cuda", torch.bfloat16) if film else None)
        n0 = tnorm.tnorm_silu.launches
        ys, coef, stacks = tnorm.tnorm_silu(xs, gam, bet, fm, means)
        torch.cuda.synchronize()
        if tnorm.tnorm_silu.launches != n0 + 1:
            fail(f"tnorm {key}: {tnorm.tnorm_silu.launches - n0} launches")
        pys, pcoef, _ = tnorm.tnorm_silu_reference(xs, gam, bet, fm, means)
        worst = 0.0
        err = max((y.float() - py.float()).abs().max().item()
                  for y, py in zip(ys, pys))
        for i, x in enumerate(xs):
            xg = x.double().reshape(B, -1, 32, C // 32)
            m = xg.mean(dim=(1, 3))
            var = ((xg - m[:, None, :, None]) ** 2).mean(dim=(1, 3))
            A = torch.rsqrt(var + 1e-5).repeat_interleave(
                C // 32, -1) * gam[i].double()
            mc = m.repeat_interleave(C // 32, -1)
            Bc = bet[i].double() - mc * A
            one = torch.ones_like(A)
            if film:
                one = 1.0 + fm[:, :C].double()
                A, Bc = A * one, Bc * one + fm[:, C:].double()
            sd = var.sqrt().repeat_interleave(C // 32, -1)
            tol_b = TNORM_F32_TOL * (Bc.abs() + (mc.abs() + sd) * A.abs()
                                     + one.abs())
            for side, c in (("kernel", coef), ("plain", pcoef)):
                ea = ((c[i, 0].double() - A).abs() / A.abs()).max().item()
                eb = ((c[i, 1].double() - Bc).abs() / tol_b).max().item()
                if ea > TNORM_F32_TOL or eb > 1.0:
                    fail(f"tnorm {key} plane {i}: the {side} (A, B) off "
                         f"fp64: {ea:.2e} relative, {eb:.2f} of B's bound")
                worst = max(worst, ea)
            if not torch.equal(ys[i], nn.apply_film_coeffs(x, coef[i, 0],
                                                           coef[i, 1])):
                fail(f"tnorm {key} plane {i}: y is not the plain apply of "
                     "the kernel's (A, B)")
        for y, pair in zip(ys, stacks or []):
            for st, dim in zip(pair, (-2, -3)):
                want = tnorm.stack3(y.mean(dim=dim)).float()
                tol = BF16_ULP * want.abs() + 1e-5 * y.float().abs().mean()
                if not ((st.float() - want).abs() <= tol).all():
                    fail(f"tnorm {key}: a mean off torch's by more than "
                         "one bf16 rounding")
        row = {"coef_rel_err_vs_fp64": worst, "max_abs_err": err}
        if timed:
            nbytes = tnorm_launch(B, levels[lv], C, film, means)
            b_ms, by = bound(0.0, nbytes, PEAK_BF16_FLOPS)
            row.update(
                device_ms=device_ms(lambda: tnorm.tnorm_silu(
                    xs, gam, bet, fm, means), "sin3dm_tnorm"),
                ms=time_ms(lambda: tnorm.tnorm_silu(xs, gam, bet, fm,
                                                    means)),
                plain_device_ms=device_ms(lambda: tnorm.tnorm_silu_reference(
                    xs, gam, bet, fm, means)),
                library_device_ms=device_ms(lambda: tnorm_library(
                    xs, gam, bet, fm)),
                bound_ms=b_ms, bound_by=by)
        print(f"tnorm {key}, batch {B}: (A, B) within {worst:.2e} of fp64, "
              f"y the plain apply of the kernel's (A, B) bit for bit (within "
              f"{err:.3g} of "
              "the plain version's y), means within a bf16 rounding (ok)")
        if timed:
            print(f"tnorm {key}, batch {B}: "
                  f"device {row['device_ms'] * 1e3:.2f} us (events "
                  f"{row['ms'] * 1e3:.1f} us), plain "
                  f"{row['plain_device_ms'] * 1e3:.1f} us, library "
                  f"{row['library_device_ms'] * 1e3:.1f} us, bound "
                  f"{b_ms * 1e3:.2f} us ({by}): "
                  f"{b_ms / row['device_ms']:.1%} of the bound")
        out[key] = row
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
def environ(**kv):
    """Environment variables set for a `with` block, restored after it."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def configuration(name: str):
    """The UNet configuration `name` of CONFIGS for a `with` block; the
    environment is restored after it."""
    with environ(**CONFIGS[name]):
        yield


def reset_counts() -> None:
    from sin3dm_tpu_torch.ops.fused_conv import conv3x3_rollout
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp
    from sin3dm_tpu_torch.ops.tnorm import tnorm_silu
    conv3x3_rollout.launches = 0
    conv3x3_rollout.form_launches = {}
    skip_mlp.launches = 0
    skip_mlp.shape_launches = {}
    tnorm_silu.launches = 0


def read_counts() -> dict:
    from sin3dm_tpu_torch.ops.fused_conv import conv3x3_rollout
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp
    from sin3dm_tpu_torch.ops.tnorm import tnorm_silu
    return {"k1": conv3x3_rollout.launches,
            "k1_forms": dict(conv3x3_rollout.form_launches),
            "k2": skip_mlp.launches,
            "k2_shapes": {shape_key(*k): v for k, v in
                          skip_mlp.shape_launches.items()},
            "tnorm": tnorm_silu.launches}


def want_tnorm(ucfg, k1_forms: dict) -> int:
    """The norm kernel's launches where K1 launched `k1_forms` in the
    configuration the environment selects now: the forwards that many
    K1 launches make, times `tnorm_launches_per_forward` (9 in the
    default configuration)."""
    from sin3dm_tpu_torch.models.unet import (k1_launches_per_forward,
                                              tnorm_launches_per_forward)
    per = k1_launches_per_forward(ucfg)
    return (sum(k1_forms.values()) // per * tnorm_launches_per_forward(ucfg)
            if per else 0)


def argv_tnorm(argv, k1_forms: dict) -> int:
    """`want_tnorm` for the UNet configuration of a `cli.sample` argv."""
    from sin3dm_tpu_torch.cli import sample as cli
    return want_tnorm(cli._unet_config(cli.cfgmod.sample_args(argv)),
                      k1_forms)


def shape_key(rows: int, cin: int, cout: int) -> str:
    """A K2 launch shape as the counts by shape name it."""
    return f"[{rows}, {cin}] -> {cout}"


def drive_vox(label: str, argv, want_forms: dict, want_k2: int,
              occupancy: bool = True, grids: list = None):
    """`cli.main(argv + --output <tmp>)` with the launch counts set to 0
    just before and read just after; checks the per-form K1, the K2 and
    the norm kernel's counts (`want_tnorm`: 9 a forward by default), the
    feat.npz and voxel grids (and each grid's occupancy).
    Returns (main's result, counts, per-sample feat planes); each voxel
    grid is appended to `grids` where given."""
    import numpy as np
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    out_dir = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_")
    try:
        want_tn = argv_tnorm(argv, want_forms)
        reset_counts()
        res = cli.main(argv + ["--output", out_dir])
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"{label}: K1 launches by form {counts['k1_forms']} (want "
              f"{want_forms}), K2 launches {counts['k2']} (want {want_k2}), "
              f"norm kernel launches {counts['tnorm']} (want {want_tn})")
        if counts["k1_forms"] != want_forms or counts["k2"] != want_k2 \
                or counts["tnorm"] != want_tn:
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
            if grids is not None:
                grids.append(grid)
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


# 4g: the kernels' opt-outs, JAX's switches: the UNet's 3x3 convs through
# cuDNN (the training forward's) and the decode's heads plain
NO_KERNELS = {"SIN3DM_FUSED_CONV": "0", "SIN3DM_FUSED_HEADS": "0"}


def phase4g(want_forms: dict, want_k2: int) -> dict:
    """4g. `--vox` DDIM-100, batch 2, at the tag's width in the default
    configuration, with the kernels and then under NO_KERNELS: the second
    run launches neither K1 nor K2, each of its feat.npz planes lies
    within K1's bf16 forward bound of the first run's (4c's, the JAX
    package's stats-chain bound: |o - r| <= 0.05 + 0.05 |r|, mean <
    5e-3) and its voxel grids differ from the first run's in at most
    INT8_SHARE_BOUND of the voxels (4f's bound).  Both routes' chain
    seconds per sample: the whole-chain library yardstick."""
    import numpy as np
    argv = ["--tag", TAG, "--vox", "--n_samples", "2", "--use_ddim",
            "true", "--timestep_respacing", "ddim100"]
    runs = {}
    with configuration("default"):
        for route, env, forms, k2 in (
                ("kernels", {}, want_forms, want_k2),
                ("cuDNN convs and plain heads", NO_KERNELS, {}, 0)):
            grids = []
            with environ(**env):
                res, counts, feats = drive_vox(f"4g, {route}", argv, forms,
                                               k2, grids=grids)
            runs[route] = {"feats": feats, "grids": grids,
                           "counts": counts, "n": len(res["paths"]),
                           "chain_s": res["sample_seconds"],
                           "decode_s": res["decode_seconds"]}
    k, p = runs["kernels"], runs["cuDNN convs and plain heads"]
    worst, mean_worst, share_worst, failed = 0.0, 0.0, 0.0, []
    for j, (kf, pf) in enumerate(zip(k["feats"], p["feats"])):
        for plane, a, b in zip(("xy", "xz", "yz"), pf, kf):
            d = np.abs(a - b)
            ratio = float((d / (0.05 + 0.05 * np.abs(b))).max())
            mean = float(d.mean())
            worst, mean_worst = max(worst, ratio), max(mean_worst, mean)
            if ratio > 1.0 or mean >= 5e-3:
                failed.append(f"sample {j} {plane}")
            print(f"4g sample {j} {plane}: without the kernels max_abs "
                  f"{d.max():.3e}, mean_abs {mean:.3e}, {ratio:.3f} of "
                  "K1's bf16 forward bound")
        share = float((k["grids"][j] != p["grids"][j]).mean())
        share_worst = max(share_worst, share)
        print(f"4g sample {j}: voxels that differ {share:.4e} (bound "
              f"{INT8_SHARE_BOUND:.0e})")
        if share > INT8_SHARE_BOUND:
            failed.append(f"sample {j} grid")
    chain = {r: v["chain_s"] / v["n"] for r, v in runs.items()}
    print(f"4g chain seconds per sample (DDIM-100, batch 2): with the "
          f"kernels {chain['kernels']:.3f} s, cuDNN convs "
          f"{chain['cuDNN convs and plain heads']:.3f} s; decode of 2 grids "
          f"{k['decode_s']:.3f} s with K2, {p['decode_s']:.3f} s with the "
          "plain heads")
    if failed:
        fail(f"4g: without the kernels, {', '.join(failed)} outside the "
             "bound")
    return {"chain_s_per_sample": chain,
            "decode_s": {r: v["decode_s"] for r, v in runs.items()},
            "launches_without": {"k1": p["counts"]["k1"],
                                 "k2": p["counts"]["k2"]},
            "worst_of_bound": worst, "worst_mean_abs": mean_worst,
            "worst_voxel_share": share_worst}


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


def check_mesh_sample(label: str, d: str, j: int, aabb, reso: int,
                      texreso: int, n_faces: int, texels: int,
                      stages) -> dict:
    """One mesh-path sample's outputs in `d` (occupancy, object.obj inside
    the AABB with 0 < faces <= n_faces, object.png, object.mtl); returns
    its seconds by stage from the stage log `stages`."""
    import numpy as np
    lo, hi = np.asarray(aabb[:3]), np.asarray(aabb[3:])
    voxel = (hi.max() - lo.min()) / reso
    with np.load(os.path.join(d, "voxel.npz")) as f:
        grid = f["vox_grid"]
    occ = float(grid.mean())
    v, nf = obj_mesh(os.path.join(d, "object.obj"))
    inside = bool(((v >= lo - voxel) & (v <= hi + voxel)).all())
    check_png(os.path.join(d, "object.png"), texreso)
    with open(os.path.join(d, "object.mtl")) as fh:
        mtl_ok = "map_Kd object.png" in fh.read()
    print(f"{label} sample {j}: voxel grid {tuple(grid.shape)}, "
          f"occupancy {occ:.4f}; object.obj {nf} faces, {len(v)} "
          f"vertices, inside the AABB widened by one voxel: {inside}; "
          f"object.png {texreso}x{texreso} RGB, valid; {texels} texels")
    if not 0.15 <= occ <= 0.19:
        fail(f"{label} sample {j}: occupancy {occ:.4f} outside "
             "[0.15, 0.19]")
    if not (0 < nf <= n_faces and inside and mtl_ok):
        fail(f"{label} sample {j}: {nf} faces, inside {inside}, "
             f"mtl {mtl_ok}")
    secs = {}
    for e in stages:
        if e["dir"] == d:
            secs[e["stage"]] = secs.get(e["stage"], 0.0) + e["seconds"]
            if e["stage"] == "sdf grid":
                secs["sdf grid"] += e["dispatch"]
    out = {name: sum(secs.get(k, 0.0) for k in keys)
           for name, keys in STAGES}
    print(f"{label} sample {j} seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items()))
    return out


def drive_mesh(argv, want_k1: dict, aabb, reso: int, texreso: int,
               n_faces: int, slabs: int):
    """`cli.main(argv + --output <dir>)`, the mesh path, with the launch
    counts set to 0 just before and read just after.  Checks K1 against
    `want_k1` (and the norm kernel against `want_tnorm`), K2 against
    `slabs` geo launches per sample plus each sample's texel chunks, and
    each sample's outputs.  Returns (main's
    result, counts, output dir, per-sample stage seconds); the caller
    removes the directory."""
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    out_dir = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_mesh_")
    want_tn = argv_tnorm(argv, want_k1)
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
          f"{sorted(texels.values())} texels), norm kernel launches "
          f"{counts['tnorm']} (want {want_tn})")
    if counts["k1_forms"] != want_k1 or counts["k2"] != want_k2 \
            or counts["tnorm"] != want_tn:
        fail("mesh path: the path did not launch the kernels as expected")
    per_sample = {}
    for j in range(n):
        d = os.path.join(out_dir, f"{j:03d}")
        per_sample[j] = check_mesh_sample("mesh path", d, j, aabb, reso,
                                          texreso, n_faces, texels[d],
                                          res["stages"])
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
# cut to 100 steps, in this process on one card on any machine (the
# default --n_devices 0 takes every card; phases 12-13 run the ranks)
TRAIN_ARGV = ["--diff_batch_size", "32", "--steps_per_call", "20",
              "--diff_lr", "5e-4", "--ema_rate", "0.9999", "--diff_n_iters",
              "100", "--save_interval", "100", "--log_interval", "20",
              "--n_devices", "1"]
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
    CLI built (`loop.step_fn`, steps_per_call steps each) in each of
    MODES (`modes_seconds`) by the host clock from a sync to a sync, with
    the kernels' launch counts set to 0 just before and read just after:
    a train step launches neither K1 nor K2, and fails if it did.
    Returns the numbers and the loop."""
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
    secs = modes_seconds(lambda: loop.step_fn(loop.state, loop.batch, 0),
                         n_calls)
    ms, ms_det = (secs[m] * 1e3 / (n_calls * K) for m in MODES)
    counts = read_counts()
    first = loop.state.step - 2 * n_calls * K
    print(f"train (cli.train, batch {B}, steps_per_call {K}, 100 steps, TF32 "
          f"on): main {total:.3f} s in all; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB; mean loss per dump "
          f"{[round(x, 6) for x in losses]} at steps "
          f"{[d['step'] for d in dumps]}")
    print(f"train: the CLI's step, {n_calls} calls of {K} steps in each "
          f"mode, in turns (steps {first}-{loop.state.step}): "
          f"{ms:.3f} ms per step with today's algorithms, {ms_det:.3f} ms "
          f"with deterministic ones (host clock, sync to sync; "
          f"{ms_det / ms:.3f}x), {B * 1e3 / ms:.1f} and "
          f"{B * 1e3 / ms_det:.1f} samples/s; K1 launches {counts['k1']}, "
          f"K2 launches {counts['k2']} (want 0 and 0)")
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
            "ms_per_step_deterministic": ms_det,
            "main_s": total, "peak_bytes": peak, "losses": losses,
            "launches_train_step": {"k1": counts["k1"], "k2": counts["k2"],
                                    "steps": 2 * n_calls * K},
            "loop": loop}


# 6b and 8f time a train step with today's algorithms and with the
# deterministic ones `cli.train` trains under, in turns
MODES = ("today", "deterministic")


def modes_seconds(call, n: int) -> dict:
    """Seconds of `n` calls of `call` in each of MODES (TF32 on, as the
    CLI trains), in turns today, deterministic, deterministic, today of
    n / 2 calls each, from a sync to a sync; the launch counts are set to
    0 first."""
    import torch
    from sin3dm_tpu_torch.core.rng import deterministic_algorithms
    out = dict.fromkeys(MODES, 0.0)
    with tf32(True):
        reset_counts()
        for mode in MODES + MODES[::-1]:
            with (deterministic_algorithms() if mode == "deterministic"
                  else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n // 2):
                    call()
                torch.cuda.synchronize()
                out[mode] += time.perf_counter() - t0
    return out


# 6e: two runs of one `cli.train` command give the same bits: diffusion
# from the committed encoding at the tag's batch (2 calls of 20 steps),
# and the AE stage on 8a's shape (E6_AE_ITERS iterations, the rec mesh at
# reso 64)
E6_TRAIN_ARGV = ["--enc_log", os.path.join(TAG, "encoding"),
                 "--diff_batch_size", "32", "--steps_per_call", "20",
                 "--diff_lr", "5e-4", "--ema_rate", "0.9999",
                 "--diff_n_iters", "40", "--save_interval", "40",
                 "--log_interval", "20", "--n_devices", "1"]
E6_AE_ITERS = 20


def dumped(tag: str) -> dict:
    """Every array of every checkpoint and feat.npz under `tag`, and every
    line of each progress.json, by (file, key)."""
    import numpy as np
    out = {}
    for d, _, files in os.walk(tag):
        for name in sorted(files):
            path = os.path.join(d, name)
            rel = os.path.relpath(path, tag)
            if name.endswith((".pt", ".pth", ".npz")):
                with np.load(path) as z:
                    for k in z.files:
                        out[(rel, k)] = z[k]
            elif name == "progress.json":
                with open(path) as fh:
                    out[(rel, "lines")] = np.frombuffer(
                        fh.read().encode(), np.uint8)
    return out


def same_bits(label: str, a: dict, b: dict) -> dict:
    """Two runs' `dumped` arrays: the same keys, dtypes and bytes; prints
    how many, and where they differ the first key and its max |diff|."""
    import numpy as np
    differ = [k for k in a if k not in b or a[k].dtype != b[k].dtype
              or a[k].tobytes() != b[k].tobytes()]
    differ += [k for k in b if k not in a]
    where = ""
    if differ:
        k = differ[0]
        if k in a and k in b and a[k].shape == b[k].shape:
            d = np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))
            where = f"; first {k}, max |diff| {d.max():.3e}"
        else:
            where = f"; first {k}"
    print(f"{label}: {len(a)} arrays, {len(differ)} differ{where}")
    return {"arrays": len(a), "differ": [list(k) for k in differ]}


def train_repeats(tmp: str, argv, label: str) -> dict:
    """6e. `cli.train.main(argv)` twice on two fresh tags (TF32 on and
    deterministic algorithms, as the CLI trains): every dumped array and
    progress line equal bit for bit."""
    import torch
    from sin3dm_tpu_torch.cli import train as train_cli
    runs, secs = [], []
    for i in range(2):
        tag = os.path.join(tmp, f"{label} {i}")
        with environ(SIN3DM_LOG_FORMAT="log,csv,json"):
            t0 = time.perf_counter()
            train_cli.main(["--tag", tag, *argv])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        runs.append(dumped(tag))
        shutil.rmtree(tag, ignore_errors=True)
    res = same_bits(f"6e {label}, two runs of one command ({secs[0]:.1f} "
                    f"and {secs[1]:.1f} s)", *runs)
    if res["differ"] or res["arrays"] < 3:
        fail(f"6e: two runs of {label} training dumped other bits")
    return {**res, "seconds": secs}


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


def synth_shape_npz(path: str, seed: int = 0, pbr: bool = False) -> dict:
    """8a. A textured analytic shape as the mesh sampler's npz, at the
    committed tag's training-grid shape inside its AABB (the committed
    ckpt_final.pth meta): a box (a tower's base) and, above it and apart
    from it, a sphere, so that min(sdf_box, sdf_sphere) is the union's
    exact SDF; the colour is a smooth ramp of position.  Grid points are
    the AABB's voxel centres; AE_SURF on-surface points spread by area
    over both surfaces, AE_SURF near-surface points 0.005 off them, the
    threshold 3 voxels.  With `pbr`, the sdfpbr schema's eight texture
    channels: the ramp, then analytic metallic and roughness (ramps of
    x and z) and the unit normal (the SDF's central-difference gradient,
    normalised) stored as the normal maps store it, 0.5 + 0.5 n.  Written
    with np.savez, from a numpy generator seeded with `seed`."""
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
        ch = [t[..., 0], t[..., 1], 0.5 + 0.5 * np.sin(6.0 * t[..., 2])]
        if pbr:
            e = np.float32(1e-3)
            n = np.stack([sdf(p + e * u) - sdf(p - e * u)
                          for u in np.eye(3, dtype=np.float32)], axis=-1)
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            ch += [t[..., 0], 0.25 + 0.5 * t[..., 2],
                   *np.moveaxis(0.5 + 0.5 * n, -1, 0)]
        return np.stack(ch, axis=-1).astype(np.float32)

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
    print(f"ae data{' (sdfpbr)' if pbr else ''}: {path}: grid "
          f"{grid.shape[:3]} "
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


def ae_setup(npz: str, dev, overrides: dict = None):
    """(acfg, tcfg, data, meta) at the encoding args.json's width (its
    values replaced by `overrides`), the data on `dev`."""
    import argparse
    from sin3dm_tpu_torch.core import config as cfgmod
    from sin3dm_tpu_torch.training import ae as TA
    args = argparse.Namespace(**{**enc_args(), **(overrides or {})})
    acfg = cfgmod.ae_config_from_args(args)
    tcfg = cfgmod.ae_trainer_config_from_args(args)
    data, meta, _ = TA.load_ae_data(npz, tcfg, dev, acfg.data_type)
    return acfg, tcfg, data, meta


def cancelled_leaf(path: str, pbr: bool = False) -> bool:
    """A bias that an InstanceNorm right after it removes (the encoders'
    biases, each block's in-conv bias; in the `pbr` net's texture branch
    also block 0's out-conv and shortcut biases, which block 1's input
    norm removes): its grad is 0 but for roundoff."""
    parts = path.split("/")
    return parts[-1] == "b" and (
        parts[0] in ("geo_encoder", "tex_encoder") or "in_conv" in parts
        or (pbr and parts[:2] == ["tex_convs", "0"]
            and parts[2] in ("out_conv", "shortcut")))


@contextlib.contextmanager
def branch(taken: dict, record: bool):
    """The block's piecewise ops, `torch.relu`, `torch.sign` and
    `Tensor.abs` (the heads' ReLUs, the L1 losses), recording which side
    of 0 each call's every element took (on the host, in call order, into
    `taken`), or taking the recorded sides in that order (relu as z *
    mask, abs as x * sign, sign as the recorded sign), so that a second
    evaluation follows the first one's branch everywhere."""
    import torch
    real = {"relu": torch.relu, "sign": torch.sign,
            "abs": torch.Tensor.abs}
    for k in real:
        taken.setdefault(k, [])
    replay = {k: iter(v) for k, v in taken.items()}

    def relu(z):
        if record:
            taken["relu"].append((z > 0).cpu())
            return real["relu"](z)
        return z * next(replay["relu"]).to(device=z.device, dtype=z.dtype)

    def sign(x):
        if record:
            taken["sign"].append(real["sign"](x).to(torch.int8).cpu())
            return real["sign"](x)
        return next(replay["sign"]).to(device=x.device, dtype=x.dtype)

    def abs_(x):
        if record:
            taken["abs"].append(real["sign"](x).to(torch.int8).cpu())
            return real["abs"](x)
        return x * next(replay["abs"]).to(device=x.device, dtype=x.dtype)

    torch.relu, torch.sign, torch.Tensor.abs = relu, sign, abs_
    try:
        yield
    finally:
        torch.relu, torch.sign, torch.Tensor.abs = (
            real["relu"], real["sign"], real["abs"])


def ae_step_card_vs_host(npz: str, overrides: dict = None,
                         ckpt_path: str = None,
                         same_branch: bool = False) -> dict:
    """8b (8g, 8h: the `base` and `pbr` nets of `overrides`, from the
    params their CLI run trained, `ckpt_path`, with `same_branch`).  One
    AE train step at the encoding args.json's width from the committed
    ckpt_final.pth's params, a warm AdamW state (WARM_COUNT,
    mu and nu of the grads' sizes) and the same window offsets (drawn by
    numpy), on the card with TF32 off and on this machine's CPU with the
    port's plain code.  Holds 6a's tolerances: loss terms 1e-5 relative;
    each leaf's grad 1e-4 of that leaf's max |g| (a bias an InstanceNorm
    cancels: both sides below 1e-5 of the whole grad's max |g|); params
    1e-5 absolute; mu 1e-4 and nu 2e-4 of the leaf's largest value.
    Prints the worst leaf of each.  A second witness, the same gradient
    in fp64 on the CPU, says which side an error lies on, as in 6a: the
    card's grad is held to it at 1e-4 of each leaf's max |g| as well,
    and both sides' distances from it are printed at the worst leaf.
    With `same_branch` the host's fp32 step runs first and the card's and
    the fp64 step take its branch of every ReLU of the heads and every
    sign of the L1 losses (`branch`): a value within roundoff of 0 that
    one side rounds the other way moves a gradient by a whole row's
    share, beyond 1e-4 of its leaf's largest in fp32 on either side
    (phase 8g's first readings), so the gates then measure rounding
    alone."""
    import dataclasses
    import numpy as np
    import torch
    from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.training import ae as TA
    tree, _ = ckpt.load_tree(ckpt_path or os.path.join(
        TAG, "encoding", "ckpt_final.pth"), "params")
    rng = np.random.default_rng(8)
    out, offsets, taken = {}, None, {}
    devs = ("cuda", "cpu")
    for dev in map(torch.device, devs[::-1] if same_branch else devs):
        acfg, tcfg, data, meta = ae_setup(npz, dev, overrides)
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
        with tf32(False), (branch(taken, dev.type == "cpu")
                           if same_branch else contextlib.nullcontext()):
            terms, g = TA.compute_grads(st, acfg, tcfg, data,
                                        meta["threshold"], offsets)
            TA.apply_grads(st, g, tcfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["card" if dev.type == "cuda" else "host"] = {
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
    data64 = TA.AEData(*[None if a is None else a.cpu().double()
                         if a.is_floating_point() else a.cpu()
                         for a in data])
    with (branch(taken, False) if same_branch
          else contextlib.nullcontext()):
        _, g64 = TA.compute_grads(
            dataclasses.replace(ref, params=ckpt.unflatten_like(p32, leaves)),
            acfg, tcfg, data64, meta["threshold"], offsets)
    del data, data64
    secs64 = time.perf_counter() - t0
    pbr = acfg.enc_net_type == "pbr"
    w64 = {side: {p: e for p, e in _errs(ref, out[side]["g"].double(), g64,
                                         True).items()
                  if not cancelled_leaf(p, pbr)}
           for side in ("card", "host")}
    terms_err = max(((c["terms"][k] - v).abs() / v.abs()).max().item()
                    for k, v in h["terms"].items())
    cg = dict(ckpt.leaves_with_paths(ref.tree(c["g"])))
    hg = dict(ckpt.leaves_with_paths(ref.tree(h["g"])))
    top = h["g"].abs().max().item()
    cancel = {p: max(cg[p].abs().max().item(),
                     hg[p].abs().max().item()) / top
              for p in hg if cancelled_leaf(p, pbr)}
    ge = {p: e for p, e in _errs(ref, c["g"], h["g"], True).items()
          if p not in cancel}
    top64 = g64.abs().max().item()
    of_top = {p: v.abs().max().item() / top64
              for p, v in ckpt.leaves_with_paths(ref.tree(g64))}
    for name, e in (("card vs host", ge), ("card vs fp64", w64["card"]),
                    ("host vs fp64", w64["host"])):
        print(f"  grad {name}, the worst leaves (the leaf's largest fp64 "
              "|g| over the whole gradient's): " + ", ".join(
                  f"{p} {e[p]:.3e} ({of_top[p]:.1e})"
                  for p in sorted(e, key=e.get)[::-1][:4]))
    g_leaf = max(ge, key=ge.get)
    c_leaf = max(cancel, key=cancel.get)
    checks = {"terms": (terms_err, ", ".join(h["terms"]), 1e-5),
              "grad": (ge[g_leaf], g_leaf, 1e-4),
              "grad, cancelled biases": (cancel[c_leaf], c_leaf, 1e-5),
              "params": _worst(ref, c["flat"], h["flat"], False) + (1e-5,),
              "mu": _worst(ref, c["mu"], h["mu"], True) + (1e-4,),
              "nu": _worst(ref, c["nu"], h["nu"], True) + (2e-4,)}
    print(f"ae train step card vs host ({acfg.enc_net_type} net, batch "
          f"{tcfg.enc_batch_size}, "
          f"{'the CLI run' if ckpt_path else 'the committed AE'}'s "
          f"params, warm AdamW at count {WARM_COUNT}, TF32 "
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
               "--save_interval", "20", "--n_devices", "1"])
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


def ae_k2_trained(trainer, heads=("geo_decoder", "tex_decoder")) -> dict:
    """8e (8h: pbr's four heads). K2 (bf16) with the trainer's packed
    weights over evaluate's first x-slab of each head's features (the geo
    planes' for the geo head, the texture planes' for the others),
    against the same trained params
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
        for head in heads:
            planes = gp if head == "geo_decoder" else tp
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
    on, as the CLI trains): `warm` steps, then `n_steps` in each of MODES
    (`modes_seconds`) timed by the host clock from a sync to a sync with
    the launch counts set to 0 just before and read just after (K1 and
    K2: 0) and the peak device memory over them; points/s; the step's
    operations against the TF32 bound; then `prof_steps` steps under
    torch.profiler."""
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
    secs = modes_seconds(lambda: step(st, trainer.data, 0), n_steps)
    ms, ms_det = (secs[m] * 1e3 / n_steps for m in MODES)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    with tf32(True):
        fl = ae_step_flops(trainer.acfg, tcfg, trainer.meta["featmap_size"])
        pts = tcfg.enc_batch_size * 1e3 / ms
        print(f"ae step: {n_steps} steps at batch {tcfg.enc_batch_size} in "
              f"each mode, in turns: {ms:.3f} ms per step with today's "
              f"algorithms, {ms_det:.3f} ms with deterministic ones (host "
              f"clock, sync to sync; {ms_det / ms:.3f}x), "
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
            "ms_per_step_deterministic": ms_det,
            "launches": {"k1": counts["k1"], "k2": counts["k2"],
                         "steps": 2 * n_steps},
            "flops": fl["step"], "bound_ms": fl["bound_ms"], **p}


# 8g, 8h: the `base` and `pbr` nets at the committed encoding's width,
# on 8a's shape (pbr's with its five more channels), the CLI cut to
# AE_VARIANT_ITERS iterations and its rec mesh to reso 64
AE_VARIANTS = {"8g": {"enc_net_type": "base", "data_type": "sdftex"},
               "8h": {"enc_net_type": "pbr", "data_type": "sdfpbr"}}
AE_VARIANT_ITERS = 60
PBR_HEADS = {"geo_decoder": 1, "rgb_decoder": 3, "mr_decoder": 2,
             "normal_decoder": 3}


def ae_variant(label: str, npz: str, tmp: str) -> dict:
    """8g/8h. The net of AE_VARIANTS[label]: a short `cli.train
    --only_enc` (losses finite and falling, ckpt_final.pth and feat.npz
    written); from the params it trained, as 8b from the committed AE's,
    one AE train step card against host and fp64 at 8b's gates
    (`ae_step_card_vs_host`); its encoding decoded at reso 64 with the launch
    counts set to 0 just before and read just after: `base`'s plain MLP
    heads launch no K2, as in JAX; `pbr`'s four skip heads launch K2 once
    a head and x-slab (cout 1, 3, 2, 3), by shape, and 8e's checks hold
    on each trained head; K2 at cout 2 over the geo slab's rows, timed as
    phase 3 times it."""
    import math
    import numpy as np
    import torch
    from sin3dm_tpu_torch.cli import train as train_cli
    from sin3dm_tpu_torch.dataio.grid import grid_resolutions
    over = AE_VARIANTS[label]
    net = over["enc_net_type"]
    tag = os.path.join(tmp, f"tag {net}")
    argv = (["--tag", tag, "--data_path", npz] + encoding_argv()
            + ["--enc_net_type", net, "--data_type", over["data_type"],
               "--enc_n_iters", str(AE_VARIANT_ITERS), "--log_interval",
               "20", "--rec_reso", "64", "--only_enc", "--n_devices", "1"])
    with environ(SIN3DM_LOG_FORMAT="log,csv,json"):
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv).ae
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        cli_counts = read_counts()
    enc = os.path.join(tag, "encoding")
    with open(os.path.join(enc, "progress.json")) as fh:
        losses = [json.loads(ln)["ae/loss"] for ln in fh if ln.strip()]
    written = all(os.path.exists(os.path.join(enc, n))
                  for n in ("ckpt_final.pth", "feat.npz"))
    step = ae_step_card_vs_host(npz, over,
                                os.path.join(enc, "ckpt_final.pth"),
                                same_branch=True)
    heads = PBR_HEADS if net == "pbr" else {}
    aabb = np.asarray(trainer.meta["aabb"], np.float64)
    nx, ny, nz = (int(v) for v in grid_resolutions(aabb, 64))
    want = {}
    for x0 in range(0, nx, 8):
        for h, cout in heads.items():
            cin = trainer.params[h]["first"][0]["w"].shape[0]
            key = shape_key(min(8, nx - x0) * ny * nz, cin, cout)
            want[key] = want.get(key, 0) + 1
    with torch.no_grad():
        feat = trainer.encode()
        reset_counts()
        grid = trainer.decode_grid(feat, 64)
        torch.cuda.synchronize()
        counts = read_counts()
    inside = float((grid[..., 0] < 0).mean())
    print(f"{label} {net} net: cli.train --only_enc, {AE_VARIANT_ITERS} "
          f"iterations ({secs:.1f} s): AE loss per log "
          f"{[round(x, 6) for x in losses]}; ckpt_final.pth and feat.npz "
          f"written {written}; K2 launches in the run {cli_counts['k2']}; "
          f"decode at reso 64 {grid.shape}: inside {inside:.4f}, finite "
          f"{bool(np.isfinite(grid).all())}, K1 {counts['k1']}, K2 by "
          f"shape {counts['k2_shapes']} (want {want})")
    ok = (len(losses) >= 2 and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] and written
          and bool(np.isfinite(grid).all()) and 0.0 < inside < 1.0
          and counts["k1"] == 0 and counts["k2_shapes"] == want
          and (net == "pbr" or cli_counts["k2"] == 0))
    if not ok:
        fail(f"{label}: the {net} net did not meet its checks")
    out = {"net": net, "step_card_vs_host": step, "cli_s": secs,
           "losses": losses, "launches_cli": cli_counts["k2"],
           "launches_decode": counts["k2"], "decode_by_shape": want,
           "inside_share": inside}
    if heads:
        out["k2_trained"] = ae_k2_trained(trainer, tuple(heads))
        g = trainer.meta["grid_shape"]
        out["k2_cout2"] = check_k2_shapes(trainer.params, (
            ("pbr mr head over the geo slab", "mr_decoder",
             8 * g[1] * g[2]),))["pbr mr head over the geo slab"]
        out["launches_cout2"] = sum(
            n for c in (cli_counts, counts)
            for k, n in c["k2_shapes"].items() if k.endswith("-> 2"))
    return out


def phase8() -> dict:
    """8a-8h, and 6e's AE stage, in a temporary directory."""
    import torch
    tmp = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_ae_")
    try:
        npz = os.path.join(tmp, "shape.npz")
        t0 = time.perf_counter()
        synth = synth_shape_npz(npz)
        print(f"ae data: written in {time.perf_counter() - t0:.1f} s")
        step_check = ae_step_card_vs_host(npz)
        repeats = train_repeats(tmp, [
            "--data_path", npz, *encoding_argv(), "--enc_n_iters",
            str(E6_AE_ITERS), "--log_interval", "10", "--rec_reso", "64",
            "--only_enc", "--n_devices", "1"], "ae")
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
        del trainer
        torch.cuda.empty_cache()
        variants = {"8g": ae_variant("8g", npz, tmp)}
        torch.cuda.empty_cache()
        pbr = os.path.join(tmp, "shape_pbr.npz")
        synth_shape_npz(pbr, pbr=True)
        variants["8h"] = ae_variant("8h", pbr, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"data": synth, "step_card_vs_host": step_check, **trained,
           "k2_trained": k2, "launches_by_stage": launches,
           "step": timing, "repeats": repeats, "variants": variants}
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
# Phase 11: serving and the diffusion library
# ---------------------------------------------------------------------------

# the app's request parameters at its defaults (the page's and gradio's)
P11_REQ = {"reso": 256, "texreso": 2048, "n_faces": 10000,
           "resize_x": 1.0, "resize_y": 1.0, "resize_z": 1.0}
# 11c, card against host in fp32 with TF32 off (set before the first run
# on the card).  One forward: pred_xstart within 1e-4 of its largest
# |value| (6a's rule for one step's leaves).  The DDIM-10 round trip,
# x_T and x_0 each within 1e-4 of each plane's largest |value|, set from
# scripts/torch_roundtrip_gain.py on the CPU at a 24x32x24 crop, where a
# relative error put on every one of the 20 forwards moved them by at
# most 2.6x that error.  At the full 92x128x92 planes the same script
# reads 16-17x for x_T and 3.4-3.8x for x_0 on the card and on its host
# (PERF.md, Findings), so at full size the bound admits a forward's
# card-host difference up to ~6e-6 of its output.
P11_FORWARD_TOL = 1e-4
P11_ROUND_TRIP_TOL = 1e-4
# vb_terms_bpd's output: the bits that the model mean's allowed
# difference (posterior_mean_coef1 * P11_FORWARD_TOL * max |pred_xstart|,
# either way, the larger) moves each element's term by, averaged, plus the
# evaluation's own rounding: 1e-5 of the output, 1e-3 at t = 0, where the
# decoder NLL takes the log of cdf(x + 1/255) - cdf(x - 1/255), two close
# values that two tanh implementations round apart
# (tests/test_torch_port_guidance_bpd.py, NLL_REL)
P11_VB_REL = {0: 1e-3}
P11_VB_REL_T = 1e-5
# 11c's guidance: grad log p(feat | x) of a Gaussian around the tag's
# feat.npz, s * (feat - x)
P11_GUIDE = 0.5
# where phase 11 runs, and the --vox runs' flags (11a)
P11_DEVICE = "cuda"
P11_VOX = ["--vox", "--use_ddim", "true", "--timestep_respacing", "ddim10",
           "--n_samples", "2"]


def p11_tags(tmp: str):
    """A temporary checkpoints root holding the committed tag (its
    encoding and diffusion dirs linked) and the same weights in the
    reference's torch format (`cli.import_torch_ckpt --reverse`)."""
    from sin3dm_tpu_torch.cli import import_torch_ckpt
    root = os.path.join(tmp, "checkpoints")
    tag = os.path.join(root, "towerruins")
    os.makedirs(tag)
    for sub in ("encoding", "diffusion"):
        os.symlink(os.path.join(TAG, sub), os.path.join(tag, sub))
    ref = os.path.join(root, "towerruins_ref")
    import_torch_ckpt.main(["--reverse", "--src", TAG, "--dst", ref])
    return root, tag, ref


def p11_same_trees(label: str, got, want) -> None:
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    g, w = ckpt.leaves_with_paths(got), ckpt.leaves_with_paths(want)
    if [p for p, _ in g] != [p for p, _ in w]:
        fail(f"{label}: the trees' leaf paths differ")
    bad = [p for (p, a), (_, b) in zip(g, w)
           if not (a.dtype == b.dtype and (a == b).all())]
    print(f"{label}: {len(g)} leaves, bit for bit equal: {not bad}")
    if bad:
        fail(f"{label}: leaves differ, first {bad[:3]}")


def p11_vox(label: str, tag: str, out: str, want_forms: dict,
            want_k2: int):
    """`cli.sample --vox` DDIM-10 of 2 samples from `tag` into `out`, the
    launches counted; returns {sample: {name: array}}."""
    import numpy as np
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    want_tn = argv_tnorm(["--tag", tag] + P11_VOX, want_forms)
    reset_counts()
    res = cli.main(["--tag", tag, "--output", out] + P11_VOX)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"{label}: K1 launches by form {counts['k1_forms']} (want "
          f"{want_forms}), K2 {counts['k2']} (want {want_k2}), norm "
          f"kernel {counts['tnorm']} (want {want_tn})")
    if counts["k1_forms"] != want_forms or counts["k2"] != want_k2 \
            or counts["tnorm"] != want_tn:
        fail(f"{label}: the path did not launch the kernels as expected")
    arrays = {}
    reso = cli.cfgmod.sample_args(["--tag", tag] + P11_VOX).reso
    for j in range(len(res["paths"])):
        d = os.path.join(out, f"{j:03d}")
        arrays[j] = {}
        for name in ("feat.npz", f"r{reso}_voxel.npz"):
            with np.load(os.path.join(d, name)) as f:
                arrays[j].update({f"{name}:{k}": f[k] for k in f.files})
    return arrays


def phase11a(tmp: str, tag: str, ref: str, want_forms: dict,
             want_k2: int) -> dict:
    """The reference-format tag: torch files, its transplanted weights
    equal to the npz tag's, the loaders on the card, and the same
    `--vox` samples."""
    import numpy as np
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.compat import torch_import as ti
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    ema = os.path.join("diffusion", "ema_0.9999_025000.pt")
    pth = os.path.join("encoding", "ckpt_final.pth")
    torch_files = {f: ti.is_torch_file(os.path.join(ref, f))
                   for f in (ema, pth)}
    print(f"11a: the reference-format tag's files are torch files: "
          f"{torch_files}")
    if not all(torch_files.values()) or ti.is_torch_file(
            os.path.join(TAG, ema)):
        fail("11a: is_torch_file")
    args = cli.cfgmod.sample_args(["--tag", ref])
    p11_same_trees("11a UNet, transplanted against the npz tag's",
                   ti.unet_params_from_state_dict(
                       ti.load_torch_file(os.path.join(ref, ema)),
                       cli.cfgmod.unet_config_from_args(args)),
                   ckpt.load_tree(os.path.join(TAG, ema))[0])
    acfg = cli.cfgmod.ae_config_from_args(args)
    tree, meta = ti.ae_bundle_to_tree(
        ti.load_torch_file(os.path.join(ref, pth)), acfg)
    want, want_meta = ckpt.load_tree(os.path.join(TAG, pth), "params")
    p11_same_trees("11a AE, transplanted against the npz tag's", tree,
                   want)
    keys = ("aabb", "featmap_size", "Ka", "Kd", "Ks", "Ns", "threshold")
    if any(meta[k] != want_meta[k] for k in keys):
        fail(f"11a: the bundle's meta {meta} differs from {want_meta}")
    # the loaders, on the card: the trainer's params with their packs
    trainers = []
    for t in (tag, ref):
        tr = cli._make_trainer(cli.cfgmod.sample_args(["--tag", t]),
                               torch.device(P11_DEVICE))
        trainers.append(dict(ckpt.leaves_with_paths(tr.params)))
    def eq(a, b):
        if torch.is_tensor(a):
            return torch.is_tensor(b) and torch.equal(a, b)
        return a == b
    same = (list(trainers[0]) == list(trainers[1]) and all(
        eq(trainers[0][k], trainers[1][k]) for k in trainers[0]))
    print(f"11a: AETrainer.load_ckpt on the card, the two tags' params and "
          f"packs ({len(trainers[0])} leaves) equal: {same}")
    if not same:
        fail("11a: the loaded AE params differ")
    got = {}
    for label, t in (("npz", tag), ("reference", ref)):
        got[label] = p11_vox(f"11a --vox DDIM-10 from the {label} tag", t,
                             os.path.join(tmp, f"vox_{label}"), want_forms,
                             want_k2)
    worst = max(float(np.abs(got["npz"][j][k].astype(np.float64)
                             - got["reference"][j][k]).max())
                for j in got["npz"] for k in got["npz"][j])
    print(f"11a: the two tags' feat.npz and voxel grids, largest "
          f"difference {worst:.3e} (want 0)")
    if worst != 0:
        fail("11a: the reference-format tag samples differently")
    return {"torch_files": torch_files, "max_diff": worst}


def p11_post(base: str, body: dict, as_json: bool, timeout: int = 900):
    """(status, response bytes, host seconds) of POST /generate."""
    import urllib.error
    import urllib.parse
    import urllib.request
    if as_json:
        data, ctype = json.dumps(body).encode(), "application/json"
    else:
        data = urllib.parse.urlencode(body).encode()
        ctype = "application/x-www-form-urlencoded"
    req = urllib.request.Request(base + "/generate", data=data,
                                 headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def p11_get(base: str, path: str) -> bytes:
    import urllib.request
    with urllib.request.urlopen(base + path, timeout=120) as r:
        if r.status != 200:
            fail(f"11b: GET {path} answered {r.status}")
        return r.read()


def check_glb(data: bytes, aabb, reso: int, n_faces: int, texreso: int,
              tmp: str) -> dict:
    """A GLB as the app writes it: glTF magic and version 2, one mesh of
    at most n_faces faces, every vertex inside the AABB widened by a
    voxel, and an embedded texreso x texreso PNG (`check_png`)."""
    import struct
    import numpy as np
    magic, version, total = struct.unpack("<III", data[:12])
    if magic != 0x46546C67 or version != 2 or total != len(data):
        fail(f"GLB: magic {magic:#x}, version {version}, length {total} of "
             f"{len(data)}")
    jlen, jtype = struct.unpack("<II", data[12:20])
    gltf = json.loads(data[20:20 + jlen])
    blen, btype = struct.unpack("<II", data[20 + jlen:28 + jlen])
    blob = data[28 + jlen:28 + jlen + blen]
    if jtype != 0x4E4F534A or btype != 0x004E4942 or len(blob) != blen:
        fail("GLB: chunk types or lengths")
    if len(gltf["meshes"]) != 1 or len(gltf["meshes"][0]["primitives"]) != 1:
        fail(f"GLB: {len(gltf['meshes'])} meshes")
    prim = gltf["meshes"][0]["primitives"][0]
    acc, views = gltf["accessors"], gltf["bufferViews"]

    def view(i):
        v = views[i]
        return blob[v["byteOffset"]:v["byteOffset"] + v["byteLength"]]
    pos_acc = acc[prim["attributes"]["POSITION"]]
    pos = np.frombuffer(view(pos_acc["bufferView"]), np.float32).reshape(
        -1, 3)
    faces = acc[prim["indices"]]["count"] // 3
    lo, hi = np.asarray(aabb[:3]), np.asarray(aabb[3:])
    voxel = (hi.max() - lo.min()) / reso
    inside = bool(((pos >= lo - voxel) & (pos <= hi + voxel)).all())
    if len(pos) != pos_acc["count"] or not (0 < faces <= n_faces) \
            or not inside:
        fail(f"GLB: {faces} faces, {len(pos)} vertices, inside the AABB "
             f"{inside}")
    png = os.path.join(tmp, "glb_texture.png")
    with open(png, "wb") as fh:
        fh.write(view(gltf["images"][0]["bufferView"]))
    check_png(png, texreso)
    return {"faces": int(faces), "vertices": int(len(pos)),
            "bytes": len(data)}


def p11_stage_seconds(stages) -> dict:
    """Per sample dir, the stage seconds summed as STAGES groups them."""
    per = {}
    for e in stages:
        s = per.setdefault(e["dir"], {})
        s[e["stage"]] = s.get(e["stage"], 0.0) + e["seconds"] + (
            e.get("dispatch", 0.0) if e["stage"] == "sdf grid" else 0.0)
    return {os.path.basename(d): {name: round(sum(s.get(k, 0.0)
                                                  for k in keys), 3)
                                  for name, keys in STAGES}
            for d, s in sorted(per.items())}


def phase11b(tmp: str, root: str, tag: str, ref: str, ucfg,
             aabb, slabs: int) -> dict:
    """The stdlib server on a thread, five kinds of request in turn, the
    launches counted around each."""
    import re
    import threading
    import traceback
    import numpy as np
    import torch
    from sin3dm_tpu_torch.cli import app
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.models.unet import k1_launches_by_form
    per_form = k1_launches_by_form(ucfg)
    srv = app.build_http_server(root, "127.0.0.1", 0)
    errors = []
    srv.handle_error = lambda request, addr: errors.append(
        traceback.format_exc())
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    # each request's stage log, by (tag, seed): the app keeps only paths
    logs, log_lock, generate = {}, threading.Lock(), cli.generate

    def recording(args):
        paths, stages = generate(args)
        with log_lock:
            logs.setdefault((args.tag, args.seed), []).append(stages)
        return paths, stages

    cli.generate = recording
    out = {"requests": {}, "launches": {}}

    def served(label, body, as_json, n, steps, glbs=True):
        key = (body["tag"], int(body["seed"]))
        reset_counts()
        status, resp, secs = p11_post(base, body, as_json)
        torch.cuda.synchronize()
        counts = read_counts()
        if errors:
            fail(f"11b {label}: the server thread raised:\n{errors[0]}")
        if status != 200:
            fail(f"11b {label}: answered {status}: {resp[:300]!r}")
        stages = logs[key][-1]
        texels = [e["texels"] for e in stages
                  if e["stage"] == "texel dispatch"]
        want_k1 = {f: m * steps * n for f, m in per_form.items()}
        want_k2 = n * slabs + sum(texel_chunks(t) for t in texels)
        want_tn = want_tnorm(ucfg, want_k1)
        print(f"11b {label}: {secs:.3f} s ({secs / n:.3f} s per sample); "
              f"K1 launches by form {counts['k1_forms']} (want {want_k1}), "
              f"K2 {counts['k2']} (want {want_k2}: {n} x {slabs} geo-grid "
              f"slabs + texel chunks of {texels} texels), norm kernel "
              f"{counts['tnorm']} (want {want_tn})")
        print(f"11b {label} stage seconds per sample: "
              + json.dumps(p11_stage_seconds(stages)))
        if counts["k1_forms"] != want_k1 or counts["k2"] != want_k2 \
                or counts["tnorm"] != want_tn or len(texels) != n:
            fail(f"11b {label}: the request did not launch the kernels as "
                 "expected")
        urls = (json.loads(resp)["glbs"] if as_json else
                re.findall(r'href="(/glb/\d+)"', resp.decode()))
        if glbs:
            if urls != [f"/glb/{i}" for i in range(n)]:
                fail(f"11b {label}: GLB urls {urls}")
            checked = [check_glb(p11_get(base, u), aabb, P11_REQ["reso"],
                                 P11_REQ["n_faces"], P11_REQ["texreso"], tmp)
                       for u in urls]
            print(f"11b {label}: GLBs {checked}")
        out["requests"][label] = {"seconds": secs, "per_sample": secs / n,
                                  "stages": p11_stage_seconds(stages)}
        out["launches"][label] = {k: counts[k] for k in ("k1", "k2", "tnorm")}

    def feats(t, j=0):
        with np.load(os.path.join(t, "app_results", f"{j:03d}",
                                  "feat.npz")) as f:
            return {k: f[k] for k in f.files}

    def same(a, b):
        return max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
                   for k in a)

    ddim = dict(P11_REQ, use_ddim=True)
    try:
        # 1. the page lists both tags
        page = p11_get(base, "/").decode()
        listed = [t for t in (tag, ref) if f'value="{t}"' in page]
        print(f"11b GET /: lists {len(listed)} of the 2 tags")
        if len(listed) != 2:
            fail("11b: the page does not list both tags")
        # 2. JSON, DDIM-100, 2 samples
        served("json ddim100 x2", dict(ddim, tag=tag, n_samples=2, seed=0),
               True, 2, 100)
        first = [feats(tag, j) for j in range(2)]
        # 3. form-encoded, DDPM-1000 (the app's default), 1 sample
        served("form ddpm1000 x1",
               {**{k: str(v) for k, v in P11_REQ.items()}, "tag": tag,
                "n_samples": "1", "seed": "0"}, False, 1, 1000)
        # 4. step 2's request against the reference-format tag, 1 sample
        served("json ddim100 x1, reference tag",
               dict(ddim, tag=ref, n_samples=1, seed=0), True, 1, 100)
        d4 = same(feats(ref), first[0])
        print(f"11b: the reference tag's sample 0 against step 2's, largest "
              f"difference {d4:.3e} (want 0)")
        if d4 != 0:
            fail("11b: the reference tag's request samples differently")
        # 5. tags outside the root: 400, nothing written
        # A tag is a path: the server would resolve '../x' against its own
        # working directory, so look there as well as beside the root.
        outside = os.path.join(tmp, "outside", "x")
        where = (os.path.dirname(outside), os.path.join(root, "..", "x"),
                 os.path.join(os.getcwd(), "..", "x"))
        for bad in ("../x", outside):
            before = [os.path.exists(w) for w in where]
            reset_counts()
            status, resp, _ = p11_post(base, dict(ddim, tag=bad,
                                                  n_samples=1, seed=0), True)
            counts = read_counts()
            made = any(os.path.exists(w) and not b
                       for w, b in zip(where, before))
            print(f"11b tag {bad!r}: answered {status} (want 400), "
                  f"launches {counts['k1']}, {counts['k2']}, directories "
                  f"made: {made}")
            if status != 400 or made or counts["k1"] or counts["k2"]:
                fail(f"11b: the tag {bad!r} was not refused")
        # 6. two requests in parallel threads (one on each tag: the app
        # writes a tag's samples to <tag>/app_results/000..), each against
        # the same request served alone
        pair = {1: tag, 2: ref}
        alone = {}
        for seed, t in pair.items():
            served(f"json ddim100 x1 seed {seed}, alone",
                   dict(ddim, tag=t, n_samples=1, seed=seed), True, 1, 100,
                   glbs=False)
            alone[seed] = feats(t)
        reset_counts()
        results = {}

        def post(seed):
            results[seed] = p11_post(base, dict(ddim, tag=pair[seed],
                                                n_samples=1, seed=seed),
                                     True)

        threads = [threading.Thread(target=post, args=(s,)) for s in pair]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        secs = time.perf_counter() - t0
        if any(th.is_alive() for th in threads):
            fail("11b: a parallel request did not finish in 900 s")
        torch.cuda.synchronize()
        counts = read_counts()
        if errors:
            fail(f"11b parallel: the server thread raised:\n{errors[0]}")
        texels = [e["texels"] for s, t in pair.items()
                  for e in logs[(t, s)][-1] if e["stage"] == "texel dispatch"]
        want_k1 = {f: m * 100 * 2 for f, m in per_form.items()}
        want_k2 = 2 * slabs + sum(texel_chunks(t) for t in texels)
        want_tn = want_tnorm(ucfg, want_k1)
        diffs = {s: same(feats(pair[s]), alone[s]) for s in pair}
        print(f"11b parallel pair: {secs:.3f} s for both; answers "
              f"{[results[s][0] for s in pair]}, each request "
              f"{[round(results[s][2], 3) for s in pair]} s; K1 launches by "
              f"form {counts['k1_forms']} (want {want_k1}), K2 "
              f"{counts['k2']} (want {want_k2}), norm kernel "
              f"{counts['tnorm']} (want {want_tn}); feat.npz against the same "
              f"request alone, largest difference {diffs} (want 0)")
        for s in pair:
            print(f"11b parallel seed {s} stage seconds per sample: "
                  + json.dumps(p11_stage_seconds(logs[(pair[s], s)][-1])))
        if any(results[s][0] != 200 for s in pair) \
                or counts["k1_forms"] != want_k1 \
                or counts["k2"] != want_k2 or counts["tnorm"] != want_tn \
                or any(diffs.values()):
            fail("11b: the parallel requests")
        out["requests"]["parallel pair"] = {
            "seconds": secs, "per_request": [results[s][2] for s in pair]}
        out["launches"]["parallel pair"] = {
            k: counts[k] for k in ("k1", "k2", "tnorm")}
    finally:
        cli.generate = generate
        srv.shutdown()
        srv.server_close()
        server.join(timeout=60)
    out["total"] = {k: sum(v[k] for v in out["launches"].values())
                    for k in ("k1", "k2", "tnorm")}
    return out


def p11_l2(a, b) -> float:
    return sum(float(((p - q) ** 2).sum()) for p, q in zip(a, b)) ** 0.5


def p11_equal(label: str, a, b) -> None:
    import torch
    ok = all(torch.equal(p, q) for p, q in zip(a, b))
    print(f"11c {label}: bit for bit equal: {ok}")
    if not ok:
        fail(f"11c {label}")


def p11_finite(label: str, t) -> None:
    import torch
    if not all(bool(torch.isfinite(p).all()) for p in t):
        fail(f"11c {label}: non-finite values")


def p11_round_trip(model, tables, dcfg, x0):
    """DDIM inversion of x0 to x_T over every step of `tables`, then
    ddim_sample_loop back: (x_T, x_0)."""
    import torch
    from sin3dm_tpu_torch.diffusion import gaussian as tg
    from sin3dm_tpu_torch.diffusion import sampling as ts
    dev = x0.xy.device
    x = x0
    for t in range(tables["betas"].shape[0]):
        x = tg.ddim_reverse_step(model, tables, dcfg, x,
                                 torch.tensor([t], device=dev))
    return x, ts.ddim_sample_loop(model, tables, dcfg, None, 1, x0.channels,
                                  x0.sizes, noise=x, device=dev)


def p11_vb_bound(tables, dcfg, x0, x_t, t: int, pred, out: float) -> float:
    """The allowed card-host difference of vb_terms_bpd's output at t
    (P11_VB_REL's comment), from the host's values, in fp64."""
    import math
    import torch
    from sin3dm_tpu_torch.diffusion import gaussian as tg
    tb = torch.tensor([t])
    tab = {k: (v if k == "timestep_map" else v.double())
           for k, v in tables.items()}
    x0, x_t, pred = (v.map(lambda p: p.double()) for v in (x0, x_t, pred))
    true_mean = tg.q_posterior_mean(tab, x0, x_t, tb)
    true_logvar = tg.extract(tab, "posterior_log_variance_clipped", tb, x_t)
    mean = tg.q_posterior_mean(tab, pred, x_t, tb)
    logvar = tg.extract(tab, "fixed_large_log_variance", tb, x_t)
    delta = float(tab["posterior_mean_coef1"][t]) * P11_FORWARD_TOL * max(
        float(p.abs().max()) for p in pred)

    def term(m):
        if t == 0:
            return tg.Triplane(*[
                -tg.discretized_gaussian_log_likelihood(
                    xs, means=mm, log_scales=0.5 * lv)
                for xs, mm, lv in zip(x0, m, logvar)])
        return tg.Triplane(*[tg.normal_kl(tm, tl, mm, lv) for tm, tl, mm, lv
                             in zip(true_mean, true_logvar, m, logvar)])

    base = term(mean)
    moved = [term(mean.map(lambda p: p + s * delta)) for s in (1.0, -1.0)]
    sens = tg.Triplane(*[torch.maximum((a - b).abs(), (c - b).abs())
                         for a, c, b in zip(moved[0], moved[1], base)])
    share = float(tg._tri_mean_flat(sens)[0]) / math.log(2.0)
    return share + P11_VB_REL.get(t, P11_VB_REL_T) * abs(out)


def phase11c(ucfg) -> dict:
    """The diffusion library at full width on the committed EMA and the
    tag's feat.npz: progressive loops, guidance, DDIM inversion and
    vb_terms_bpd card against host, a bf16 round trip, calc_bpd_loop."""
    import numpy as np
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core.triplane import Triplane, load_triplane_npz
    from sin3dm_tpu_torch.diffusion import gaussian as tg
    from sin3dm_tpu_torch.diffusion import sampling as ts
    from sin3dm_tpu_torch.models.unet import k1_launches_by_form
    dev = torch.device(P11_DEVICE)
    out = {}
    args100 = cli.cfgmod.sample_args(["--tag", TAG, "--use_ddim", "true",
                                      "--timestep_respacing", "ddim100"])
    model, tables100, dcfg = cli.build_model(args100, dev)
    tables_p = tg.tables_to_device(cli.cfgmod.schedule_from_args(
        args100, respacing="100").tables_f32(), dev)
    feat_path = cli.cfgmod.encoding_feat_path(TAG)
    feat = load_triplane_npz(feat_path, dev).map(lambda p: p[None])
    C, sizes = feat.channels, feat.sizes

    def gens(seed):
        return ts.sample_generators(seed, 0, 1, dev)

    def zeros(x, t):
        return x.map(torch.zeros_like)

    def toward(x, t):
        return (feat - x).map(lambda p: P11_GUIDE * p)

    with torch.no_grad():
        # progressive loops: 100 steps, a snapshot every 30 (and the last)
        t0 = time.perf_counter()
        snaps = ts.ddim_sample_loop_progressive(
            model, tables100, dcfg, gens(3), 1, C, sizes, device=dev,
            snapshot_every=30)
        ddim = ts.ddim_sample_loop(model, tables100, dcfg, gens(3), 1, C,
                                   sizes, device=dev)
        psnaps = ts.p_sample_loop_progressive(
            model, tables_p, dcfg, gens(4), 1, C, sizes, device=dev,
            snapshot_every=30)
        ddpm = ts.p_sample_loop(model, tables_p, dcfg, gens(4), 1, C, sizes,
                                device=dev)
        torch.cuda.synchronize()
        print(f"11c progressive: DDIM-100 {snaps.xy.shape[0]} snapshots, "
              f"DDPM over a 100-step respacing {psnaps.xy.shape[0]} (want 4 "
              f"and 4), {time.perf_counter() - t0:.3f} s for the 4 chains")
        if snaps.xy.shape[0] != 4 or psnaps.xy.shape[0] != 4:
            fail("11c: snapshot counts")
        p11_equal("DDIM progressive, last snapshot against ddim_sample_loop",
                  snaps.map(lambda p: p[-1]), ddim)
        p11_equal("DDPM progressive, last snapshot against p_sample_loop",
                  psnaps.map(lambda p: p[-1]), ddpm)
        # guidance
        p11_equal("DDIM-100 with a zero cond_fn (condition_score) against "
                  "the unguided chain",
                  ts.ddim_sample_loop(model, tables100, dcfg, gens(3), 1, C,
                                      sizes, device=dev, cond_fn=zeros),
                  ddim)
        p11_equal("DDPM over a 100-step respacing with a zero cond_fn "
                  "(condition_mean) against the unguided chain",
                  ts.p_sample_loop(model, tables_p, dcfg, gens(4), 1, C,
                                   sizes, device=dev, cond_fn=zeros), ddpm)
        guided = ts.ddim_sample_loop(model, tables100, dcfg, gens(3), 1, C,
                                     sizes, device=dev, cond_fn=toward)
        l2 = {"unguided": p11_l2(ddim, feat), "guided": p11_l2(guided, feat)}
        print(f"11c guidance {P11_GUIDE} * (feat - x) on DDIM-100: L2 to the "
              f"tag's feat.npz {l2['guided']:.4f}, unguided "
              f"{l2['unguided']:.4f} (want it nearer)")
        for name, t in (("snapshots", snaps), ("psnaps", psnaps),
                        ("guided", guided)):
            p11_finite(name, t)
        if not l2["guided"] < l2["unguided"]:
            fail("11c: guidance did not bring the sample nearer feat.npz")
        out["guidance_l2"] = l2

        # DDIM inversion and the bpd terms, card against host, fp32
        old = os.environ.get("SIN3DM_SAMPLE_DTYPE")
        os.environ["SIN3DM_SAMPLE_DTYPE"] = "train"
        try:
            rt, vb = {}, {}
            rng = np.random.default_rng(11)
            noise_np = [rng.standard_normal(p.shape).astype(np.float32)
                        for p in feat]
            for side, d in (("card", P11_DEVICE), ("host", "cpu")):
                d = torch.device(d)
                t0 = time.perf_counter()
                a10 = cli.cfgmod.sample_args([
                    "--tag", TAG, "--use_ddim", "true",
                    "--timestep_respacing", "ddim10"])
                m10, tab10, _ = cli.build_model(a10, d)
                x0 = feat.to(d)
                xT, back = p11_round_trip(m10, tab10, dcfg, x0)
                m1k, tab1k, _ = cli.build_model(
                    cli.cfgmod.sample_args(["--tag", TAG]), d)
                noise = Triplane(*[torch.from_numpy(a).to(d)
                                   for a in noise_np])
                vb[side] = {}
                for t in (0, 1, 500, 999):
                    tb = torch.tensor([t], device=d)
                    x_t = tg.q_sample(tab1k, x0, tb, noise)
                    r = tg.vb_terms_bpd(m1k, tab1k, dcfg, x0, x_t, tb)
                    vb[side][t] = (float(r["output"][0]),
                                     r["pred_xstart"].to("cpu"),
                                     x_t.to("cpu"))
                rt[side] = (xT.to("cpu"), back.to("cpu"))
                if d.type == "cuda":
                    torch.cuda.synchronize()
                print(f"11c fp32 round trip and vb terms on the {side} "
                      f"({d.type}): "
                      f"{time.perf_counter() - t0:.3f} s")
        finally:
            if old is None:
                os.environ.pop("SIN3DM_SAMPLE_DTYPE", None)
            else:
                os.environ["SIN3DM_SAMPLE_DTYPE"] = old
        worst_rt = {}
        for i, name in enumerate(("x_T", "x_0")):
            card, host = rt["card"][i], rt["host"][i]
            p11_finite(name, card)
            shares = [float((c - h).abs().max() / h.abs().max())
                      for c, h in zip(card, host)]
            worst_rt[name] = max(shares)
            print(f"11c DDIM-10 round trip {name}, card against host: "
                  + ", ".join(f"{s:.3e}" for s in shares)
                  + f" of each plane's largest (tol {P11_ROUND_TRIP_TOL})")
        err = [float((b - f).abs().max()) for b, f in
               zip(rt["card"][1], feat.to("cpu"))]
        print(f"11c DDIM-10 round trip against feat.npz (card, fp32): max "
              f"|x_0 - feat| per plane {[round(e, 4) for e in err]}")
        if max(worst_rt.values()) > P11_ROUND_TRIP_TOL:
            fail("11c: the round trip's card and host differ")
        out["round_trip_card_vs_host"] = worst_rt
        out["round_trip_fp32_err"] = err
        tables_host = tg.tables_to_device(cli.cfgmod.schedule_from_args(
            cli.cfgmod.sample_args(["--tag", TAG]),
            respacing="").tables_f32(), "cpu")
        out["vb"] = {}
        for t in (0, 1, 500, 999):
            oc, pc, _ = vb["card"][t]
            oh, ph, x_t = vb["host"][t]
            pred = max(float((c - h).abs().max() / h.abs().max())
                       for c, h in zip(pc, ph))
            b = p11_vb_bound(tables_host, dcfg, feat.to("cpu"), x_t, t, ph,
                             oh)
            ok = (pred <= P11_FORWARD_TOL and abs(oc - oh) <= b
                  and np.isfinite(oc))
            print(f"11c vb_terms_bpd t={t}: card {oc:.6f}, host {oh:.6f} "
                  f"bits, |diff| {abs(oc - oh):.3e} (bound {b:.3e}); "
                  f"pred_xstart {pred:.3e} of its largest (tol "
                  f"{P11_FORWARD_TOL}) ({'ok' if ok else 'FAIL'})")
            if not ok:
                fail(f"11c: vb_terms_bpd at t={t}")
            out["vb"][t] = {"card": oc, "host": oh, "diff": abs(oc - oh),
                            "bound": b, "pred_xstart": pred}

        # the sampler's dtype: a DDIM-100 round trip, then the bpd loop
        t0 = time.perf_counter()
        _, back = p11_round_trip(model, tables100, dcfg, feat)
        torch.cuda.synchronize()
        p11_finite("bf16 round trip", back)
        err = [float((b - f).abs().max()) for b, f in zip(back, feat)]
        rms = [float(((b - f) ** 2).mean().sqrt()) for b, f in
               zip(back, feat)]
        print(f"11c DDIM-100 round trip in the sampler's dtype (bf16): "
              f"{time.perf_counter() - t0:.3f} s; max |x_0 - feat| per plane "
              f"{[round(e, 4) for e in err]}, rms "
              f"{[round(e, 4) for e in rms]}")
        out["round_trip_bf16"] = {"max": err, "rms": rms}
        m1k, tab1k, _ = cli.build_model(
            cli.cfgmod.sample_args(["--tag", TAG]), dev)
        reset_counts()
        t0 = time.perf_counter()
        bpd = tg.calc_bpd_loop(m1k, tab1k, dcfg, feat, seed=0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
    want = {f: m * 1000 for f, m in k1_launches_by_form(ucfg).items()}
    want_tn = want_tnorm(ucfg, want)
    vals = {k: bpd[k].cpu().numpy() for k in bpd}
    print(f"11c calc_bpd_loop (T 1000, batch 1, bf16): total_bpd "
          f"{float(vals['total_bpd'][0]):.6f}, prior_bpd "
          f"{float(vals['prior_bpd'][0]):.3e}, {secs:.3f} s; vb, xstart_mse, "
          f"mse {vals['vb'].shape}; K1 launches by form "
          f"{counts['k1_forms']} (want {want}), K2 {counts['k2']} (want 0), "
          f"norm kernel {counts['tnorm']} (want {want_tn})")
    if counts["k1_forms"] != want or counts["k2"] != 0 \
            or counts["tnorm"] != want_tn:
        fail("11c: calc_bpd_loop did not launch K1 as expected")
    if any(not np.isfinite(v).all() for v in vals.values()) or \
            vals["vb"].shape != (1, 1000):
        fail("11c: calc_bpd_loop's values")
    out["bpd_loop"] = {"total_bpd": float(vals["total_bpd"][0]),
                       "prior_bpd": float(vals["prior_bpd"][0]),
                       "seconds": secs, "launches": counts["k1"]}
    return out


def phase11(ucfg, want_forms: dict, want_k2: int, aabb,
            slabs: int) -> dict:
    tmp = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_serve_")
    try:
        root, tag, ref = p11_tags(tmp)
        with configuration("default"):
            a = phase11a(tmp, tag, ref, want_forms, want_k2)
            b = phase11b(tmp, root, tag, ref, ucfg, aabb, slabs)
            c = phase11c(ucfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"reference_tag": a, "serving": b, "library": c}


# ---------------------------------------------------------------------------
# Phases 12 and 13: several ranks
# ---------------------------------------------------------------------------

# 12b/13b and 12c/13c sample with DDIM-100 at the app's sizes (the sample
# CLI's defaults: reso 256, texreso 2048, 10,000 faces)
P12_DDIM = ["--use_ddim", "true", "--timestep_respacing", "ddim100"]
# 12d: the global batch (the diffusion args.json's) over P12_RANKS ranks
P12_B, P12_RANKS = 32, 2
P12_TIMED = 10         # timed steps per rank, 12d/13d and 12e/13e
# each leaf of a DP gradient from fp64, of the leaf's largest |g| (a
# leaf an InstanceNorm cancels: of the whole gradient's largest, 1e-5).
# The diffusion step (12d, 13d): eight sound runs read 0.86e-4 to 1.07e-4,
# the control (the same DP step with TF32 on) 1.43e-2, beyond 2.5e-4 at
# 138 leaves (PERF.md, section 6); the AE step (12e, 13e): 1e-4, the
# sound runs 3.06e-5, the control 5.34e-3, beyond 1e-4 at 34 leaves.
P12_GRAD_TOL = {"d": 2.5e-4, "e": 1e-4}
# phase 13: one rank a card over NCCL, on at most this many cards
P13_MAX_CARDS = 4


def p12_sha(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def p12_group(group) -> dict:
    """12a/13a, in a rank: the group's backend and device; an `all_reduce`
    of a CUDA tensor to which rank r gives r + 1; in bf16 and fp32 an
    `all_reduce_many` of dyadic values (their sums exact in either type)
    and a `gather_rows` of seeded rows, each against the sum or the
    concatenation of every rank's values made here from their seeds, bit
    for bit."""
    import torch
    from sin3dm_tpu_torch.parallel import mesh
    dev = group.device
    x = torch.full((1024,), float(group.rank + 1), device=dev)
    mesh.all_reduce(group, x)
    want = group.size * (group.size + 1) / 2

    def rows(r, dt):
        g = torch.Generator().manual_seed(100 + r)
        return torch.randn(64, 48, generator=g).to(dt)

    def dyadic(r, dt):
        g = torch.Generator().manual_seed(200 + r)
        return (torch.randint(-64, 65, (4096,), generator=g) / 16).to(dt)
    exact = {}
    for dt in (torch.bfloat16, torch.float32):
        (got,) = mesh.all_reduce_many(group, [dyadic(group.rank, dt).to(dev)])
        total = sum(dyadic(r, torch.float64)
                    for r in range(group.size)).to(dt)
        gathered = mesh.gather_rows(group, rows(group.rank, dt).to(dev))
        cat = torch.cat([rows(r, dt) for r in range(group.size)])
        exact[str(dt)[6:]] = (torch.equal(got.cpu(), total)
                              and torch.equal(gathered.cpu(), cat))
    return {"backend": group.backend, "device": str(dev),
            "sum": float(x[0]), "sum_ok": bool((x == want).all().item()),
            "exact": exact}


def p12_train_parts(dev, group=None):
    """12d's set-up at the tag's width: (state from the committed EMA,
    model, tables, diffusion config, trainer config at the global batch
    P12_B, this rank's rows of the batch, T, UNet config)."""
    import dataclasses
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.compat.from_jax import unet_params_from_jax
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.core.triplane import Triplane, load_triplane_npz
    from sin3dm_tpu_torch.diffusion.gaussian import tables_to_device
    from sin3dm_tpu_torch.models.unet import unet_train_apply
    from sin3dm_tpu_torch.training import diffusion as TD
    args = cli.cfgmod.sample_args(["--tag", TAG])
    ucfg = cli.cfgmod.unet_config_from_args(args)
    tcfg = dataclasses.replace(
        cli.cfgmod.diffusion_trainer_config_from_args(args),
        batch_size=P12_B, steps_per_call=1)
    tables = tables_to_device(cli.cfgmod.schedule_from_args(
        args, respacing="").tables_f32(), dev)
    T = int(tables["betas"].shape[0])
    tree, _ = ckpt.load_tree(EMA_PATH)
    state = TD.init_train_state(unet_params_from_jax(tree, dev), tcfg, T)
    feat = load_triplane_npz(cli.cfgmod.encoding_feat_path(TAG), dev)
    b = P12_B // (1 if group is None else group.size)
    batch = Triplane(*[p[None].expand(b, *p.shape).contiguous()
                       for p in feat])

    def model(p, x, t):
        return unet_train_apply(p, ucfg, x, t)
    return (state, model, tables, cli.cfgmod.diffusion_config_from_args(args),
            tcfg, batch, T, ucfg)


def p12_first_step(dev, group=None, exact: bool = False,
                   tf32_on: bool = False) -> dict:
    """12d's first step with TF32 off (`tf32_on`: on, the control): the
    draws of (seed 0, step 0) for the global batch, this rank's rows of
    them, `compute_grads` (with a group: the whole batch's gradient and
    terms).  `exact`: the same step in fp64 (parameters, batch, noise and
    the UNet's compute), the witness the fp32 gradients are held to."""
    import dataclasses
    import torch
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.models.unet import unet_train_apply
    from sin3dm_tpu_torch.parallel.mesh import local_rows
    from sin3dm_tpu_torch.training import diffusion as TD
    parts = p12_train_parts(dev, group)
    state, model, tables, dcfg, tcfg, batch, T, ucfg = parts
    t, noise = TD.draw_step_inputs(tcfg, state, batch, 0, 0, T, n=P12_B)
    if group is not None:
        t = local_rows(group, t)
        noise = noise.map(lambda p: local_rows(group, p))
    st = state
    if exact:
        leaves = [v.detach().double().requires_grad_()
                  for _, v in ckpt.leaves_with_paths(state.params)]
        st = dataclasses.replace(state, params=ckpt.unflatten_like(
            state.params, leaves))
        u64 = ucfg._replace(compute_dtype=torch.float64)

        def model(p, x, tt):
            return unet_train_apply(p, u64, x, tt)
        batch, noise = batch.to(torch.float64), noise.to(torch.float64)
    with tf32(tf32_on):
        terms, _, g = TD.compute_grads(st, model, tables, dcfg, tcfg,
                                       batch, t, noise, group)
    torch.cuda.synchronize()
    return {"parts": parts, "terms": terms, "g": g}


def p12_timed(step, group, n: int) -> float:
    """ms per call of `step()` over `n` calls, host clock from a sync (and
    with a group a barrier) to a sync: NCCL's collectives run on the
    stream, so a time that did not end in a sync would read their
    launch."""
    import torch
    from sin3dm_tpu_torch.parallel.mesh import barrier
    torch.cuda.synchronize()
    if group is not None:
        barrier(group)
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def p12_ae_first(dev, npz: str, group=None, exact: bool = False,
                 tf32_on: bool = False):
    """12e's first AE step with TF32 off (`tf32_on`: on, the control) from
    the committed AE's params, a fresh AdamW state and the offsets of
    (seed 0, step 0): (state, terms, g, (acfg, tcfg, data, meta));
    `exact`: in fp64, the witness."""
    import dataclasses
    import torch
    from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.training import ae as TA
    acfg, tcfg, data, meta = ae_setup(npz, dev)
    tree, _ = ckpt.load_tree(os.path.join(TAG, "encoding", "ckpt_final.pth"),
                             "params")
    state = TA.init_train_state(ae_params_from_jax(tree, dev), tcfg)
    offsets = TA.draw_offsets(tcfg, data, 0, 0)
    st = state
    if exact:
        p32 = ae_params_from_jax(tree, dev)
        leaves = [v.double().requires_grad_()
                  for _, v in ckpt.leaves_with_paths(p32)]
        st = dataclasses.replace(state, params=ckpt.unflatten_like(p32,
                                                                   leaves))
        data = TA.AEData(*[a.double() if a is not None and
                           a.is_floating_point() else a for a in data])
    with tf32(tf32_on):
        terms, g = TA.compute_grads(st, acfg, tcfg, data,
                                    meta["threshold"], offsets, group)
    torch.cuda.synchronize()
    return state, terms, g, (acfg, tcfg, data, meta)


def p12_rank(group, npz: str) -> dict:
    """12a, 12d and 12e on one rank of P12_RANKS that share the card."""
    import torch
    from sin3dm_tpu_torch.parallel import mesh
    from sin3dm_tpu_torch.training import ae as TA
    from sin3dm_tpu_torch.training import diffusion as TD
    out = {"group": p12_group(group)}
    first = p12_first_step(group.device, group)
    state, model, tables, dcfg, tcfg, batch, T, _ = first["parts"]
    out["terms"] = {k: v.cpu() for k, v in first["terms"].items()}
    out["g"] = first["g"].cpu() if group.rank == 0 else None
    g_tf32 = p12_first_step(group.device, group, tf32_on=True)["g"]
    out["g_tf32"] = g_tf32.cpu() if group.rank == 0 else None
    del g_tf32
    step = TD.make_train_step(model, tables, dcfg, tcfg, group)
    with tf32(False):
        for _ in range(4):
            step(state, batch, 0)
    out["params_sha_4"] = p12_sha(state.flat)
    with tf32(True):
        step(state, batch, 0)
        step(state, batch, 0)
        torch.cuda.reset_peak_memory_stats()
        out["ms_per_step"] = p12_timed(lambda: step(state, batch, 0), group,
                                       P12_TIMED)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    buf = torch.zeros_like(state.flat)
    out["all_reduce_ms"] = p12_timed(lambda: mesh.all_reduce(group, buf),
                                     group, P12_TIMED)
    out["n_params"] = state.flat.numel()
    del first, state, batch, buf
    torch.cuda.empty_cache()
    st, terms, g, (acfg, atcfg, data, meta) = p12_ae_first(group.device, npz,
                                                           group)
    g_tf32 = p12_ae_first(group.device, npz, group, tf32_on=True)[2]
    ae = {"terms": {k: float(v) for k, v in terms.items()},
          "g": g.cpu() if group.rank == 0 else None,
          "g_tf32": g_tf32.cpu() if group.rank == 0 else None}
    del g_tf32
    astep = TA.make_train_step(acfg, atcfg, meta["threshold"], group)
    with tf32(True):
        astep(st, data, 0)
        astep(st, data, 0)
        ae["ms_per_step"] = p12_timed(lambda: astep(st, data, 0), group,
                                      P12_TIMED)
    ae["params_sha"] = p12_sha(st.flat)
    out["ae"] = ae
    out["collectives"] = dict(mesh.COUNTS)
    return out


def p12_bootstrap_worker() -> None:
    """12f's process: joins the group through the `SIN3DM_DIST` variables
    and prints 12d's first step as one RESULT line."""
    import torch.distributed as dist
    from sin3dm_tpu_torch.parallel import maybe_initialize_distributed
    group = maybe_initialize_distributed("cuda")
    first = p12_first_step(group.device, group)
    print("RESULT " + json.dumps({
        "rank": group.rank, "backend": group.backend,
        "device": str(group.device),
        "loss": first["terms"]["loss"].cpu().tolist(),
        "g_sha": p12_sha(first["g"])}), flush=True)
    dist.destroy_process_group()


def p12_free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def p12_processes(argv, n: int, label: str, timeout: int = 300,
                  local=None, **env) -> list:
    """`argv` in n processes started by hand with the SIN3DM_DIST
    variables over a `tcp://localhost` coordinator (process r with
    SIN3DM_PROCESS_ID r, so card r where each has one, or card local[r]
    where `local` gives each its SIN3DM_LOCAL_RANK) and `env`; fails
    where one exits non-zero.  Returns their stdouts and the seconds
    from the start to the last one's exit."""
    port = p12_free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(
            os.environ, SIN3DM_DIST="1",
            SIN3DM_COORDINATOR=f"localhost:{port}",
            SIN3DM_NUM_PROCESSES=str(n), SIN3DM_PROCESS_ID=str(r),
            **({} if local is None else
               {"SIN3DM_LOCAL_RANK": str(local[r])}), **env))
        for r in range(n)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                fail(f"{label}: process {r} exited {p.returncode}:\n"
                     f"{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, time.perf_counter() - t0


def p12_bootstrap(want: dict, n: int, label: str) -> dict:
    """12f/13f. n processes started with `SIN3DM_DIST=1` each give the
    DP step's first step (per-example losses within 1e-5 relative of
    12d's/13d's, the gradient's bits printed)."""
    import numpy as np
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            "chip_smoke.p12_bootstrap_worker()")
    outs, secs = p12_processes([sys.executable, "-c", code], n, label)
    res = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        res.append(json.loads(lines[-1][len("RESULT "):]))
    want_loss = np.asarray(want["loss"])
    errs = [float(np.abs(np.asarray(r["loss"]) - want_loss).max()
                  / np.abs(want_loss).max()) for r in res]
    same_g = [r["g_sha"] == want["g_sha"] for r in res]
    print(f"{label} bootstrap: {n} processes, ranks "
          f"{[r['rank'] for r in res]}, backend "
          f"{[r['backend'] for r in res]}, devices "
          f"{[r['device'] for r in res]}, per-example losses within "
          f"{max(errs):.3e} (rel; tol 1e-05) of {label[:-1]}d's, gradient "
          f"bits equal to {label[:-1]}d's: {same_g}; {secs:.1f} s with "
          "their start")
    if sorted(r["rank"] for r in res) != list(range(n)) or max(errs) > 1e-5:
        fail(f"{label}: the bootstrapped processes did not give "
             f"{label[:-1]}d's step")
    return {"seconds": secs, "loss_rel_err": max(errs),
            "g_bits_equal": same_g,
            "backends": [r["backend"] for r in res]}


def p12_grad_errs(state, got, want, cancel=None) -> dict:
    """Per leaf, max |got - want| over the leaf's max |want|; a leaf that
    `cancel` names (a bias an InstanceNorm removes), both sides' max over
    the whole grad's max |want| instead."""
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    rel = _errs(state, got, want, True)
    top = want.abs().max().item()
    g_leaves = dict(ckpt.leaves_with_paths(state.tree(got)))
    out = {}
    for leaf, w in ckpt.leaves_with_paths(state.tree(want)):
        out[leaf] = rel[leaf] if cancel is None or not cancel(leaf) else max(
            w.abs().max().item(), g_leaves[leaf].abs().max().item()) / top
    return out


def p12_grads(label: str, state, dp, one, exact, control,
              cancel=None) -> dict:
    """The DP gradient against the step's gradient in fp64 (`exact`):
    each leaf within P12_GRAD_TOL of its largest, a cancelled leaf
    within 1e-5 of the whole gradient's largest.  Beside it, printed
    only, the one-process fp32 gradient of the same step against both:
    two fp32 gradients summed in other orders (cuDNN's weight gradient
    over batches of 16 and of 32) each err from the exact one by about
    1e-4 of the first conv's largest, so the two lie up to twice that
    apart.  The control, the DP step with TF32 on (`control`), must lie
    beyond the limit at some leaf: a limit it passes would not catch
    TF32 on, nor a rank's share lost or doubled."""
    dp, one = dp.double(), one.double()
    exact, control = exact.double(), control.double()
    errs = {name: p12_grad_errs(state, got, want, cancel)
            for name, got, want in (("dp vs fp64", dp, exact),
                                    ("dp vs one process", dp, one),
                                    ("one process vs fp64", one, exact),
                                    ("control vs fp64", control, exact))}
    tol = P12_GRAD_TOL[label[-1]]

    def beyond(e):
        return [leaf for leaf, v in e.items()
                if v > (1e-5 if cancel is not None and cancel(leaf)
                        else tol)]
    bad = beyond(errs["dp vs fp64"])
    out = {}
    for name, e in errs.items():
        leaf = max((k for k in e if cancel is None or not cancel(k)),
                   key=e.get)
        out[name] = {"worst": e[leaf], "leaf": leaf}
        print(f"{label}: grads {name}, worst {e[leaf]:.3e} of the leaf's "
              f"max |g| at {leaf}")
    n_ctl = len(beyond(errs["control vs fp64"]))
    print(f"{label}: DP grads beyond {tol:.1e} of each leaf's max |g| of "
          f"fp64: {len(bad)} leaves {bad[:5]}; the control (TF32 on) "
          f"beyond it at {n_ctl} leaves")
    if bad:
        fail(f"{label}: the DP gradient lies beyond its tolerance of the "
             f"fp64 one at {bad[:5]}")
    if not n_ctl:
        fail(f"{label}: the TF32 control passes the gradient's limit")
    out["control_leaves_beyond"] = n_ctl
    return out


def p12_refs(tmp: str) -> dict:
    """What 12d/13d and 12e/13e hold the ranks to, in this process on its
    card: the diffusion step at the global batch P12_B and the AE step at
    65,536 points (phase 8's synthetic shape, written to `tmp`), each in
    fp32 with TF32 off and in fp64; and one process's ms per diffusion
    step at the global batch with TF32 on."""
    import torch
    from sin3dm_tpu_torch.training import diffusion as TD
    npz = os.path.join(tmp, "shape.npz")
    synth_shape_npz(npz)
    dev = torch.device("cuda")
    ref = p12_first_step(dev)
    out = {"npz": npz, "state": ref["parts"][0],
           "terms": {k: v.cpu() for k, v in ref["terms"].items()},
           "g": ref["g"].cpu()}
    del ref
    out["exact_g"] = p12_first_step(dev, exact=True)["g"].cpu()
    torch.cuda.empty_cache()
    ast, aterms, ag, _ = p12_ae_first(dev, npz)
    out.update(ae_state=ast, ae_terms={k: float(v) for k, v in
                                       aterms.items()}, ae_g=ag.cpu())
    del ag
    out["ae_exact_g"] = p12_ae_first(dev, npz, exact=True)[2].cpu()
    torch.cuda.empty_cache()
    state, model, tables, dcfg, tcfg, batch, _, _ = p12_train_parts(dev)
    step = TD.make_train_step(model, tables, dcfg, tcfg)
    with tf32(True):
        step(state, batch, 0)
        step(state, batch, 0)
        out["one_ms_per_step"] = p12_timed(lambda: step(state, batch, 0),
                                           None, P12_TIMED)
    del state, batch, step
    torch.cuda.empty_cache()
    print(f"12d/13d reference: one process at batch {P12_B}, TF32 on: "
          f"{out['one_ms_per_step']:.3f} ms per step (host clock, "
          f"{P12_TIMED} steps)")
    return out


def p12_training(tmp: str, refs: dict, n: int, label: str) -> dict:
    """{label}a, d, e on n ranks started by `parallel.spawn` (phase 12: two
    that share card 0 over gloo; phase 13: one a card over NCCL), against
    `refs` (this process at the global batch, and fp64); then {label}f,
    the step through n bootstrapped processes."""
    from sin3dm_tpu_torch.parallel import spawn
    nccl = label == "13"
    t0 = time.perf_counter()
    ranks = spawn(p12_rank, n, refs["npz"], device="cuda")
    secs = time.perf_counter() - t0
    # a: the group
    for r, rk in enumerate(ranks):
        gr = rk["group"]
        want_dev = f"cuda:{r if nccl else 0}"
        print(f"{label}a rank {r}: backend {gr['backend']} on {gr['device']}"
              f" (want {want_dev}), all_reduce of a CUDA tensor "
              f"{gr['sum']} (want {n * (n + 1) / 2}): {gr['sum_ok']}; "
              f"all_reduce_many and gather_rows exact: {gr['exact']}")
        if (gr["backend"] != ("nccl" if nccl else "gloo")
                or gr["device"] != want_dev or not gr["sum_ok"]
                or not all(gr["exact"].values())):
            fail(f"{label}a: the group's backend, device or collectives "
                 "are wrong")
    # d: the diffusion step
    r0 = ranks[0]
    terms_err = max(((r0["terms"][k] - v).abs() / v.abs()).max().item()
                    for k, v in refs["terms"].items())
    print(f"{label}d: {n} ranks x {P12_B // n} against one process at "
          f"batch {P12_B}, draws of (seed 0, step 0), TF32 off: loss terms "
          f"within {terms_err:.3e} (rel; tol 1e-05)")
    if terms_err > 1e-5:
        fail(f"{label}d: loss terms outside the tolerance")
    grads = p12_grads(f"{label}d", refs["state"], r0["g"], refs["g"],
                      refs["exact_g"], r0["g_tf32"])
    shas = [rk["params_sha_4"] for rk in ranks]
    print(f"{label}d: params after 4 steps bit-identical across the ranks: "
          f"{len(set(shas)) == 1}")
    if len(set(shas)) != 1:
        fail(f"{label}d: the ranks' parameters differ")
    ms = [rk["ms_per_step"] for rk in ranks]
    ar = [rk["all_reduce_ms"] for rk in ranks]
    # the ring's bus rate: each rank sends and receives 2 (n - 1) / n of
    # the buffer (NCCL's "busbw")
    bus = 4 * r0["n_params"] * 2 * (n - 1) / n / (max(ar) * 1e-3) / 1e9
    print(f"{label}d: ms per global step (batch {P12_B}, TF32 on, host "
          f"clock, {P12_TIMED} steps) {ms} against one process's "
          f"{refs['one_ms_per_step']:.3f}; the {r0['n_params']}-parameter "
          f"fp32 gradient's all_reduce alone {ar} ms "
          f"({max(ar) / max(ms):.1%} of the step, a bus rate of "
          f"{bus:.1f} GB/s); peak device memory per rank "
          f"{[rk['peak_bytes'] / 2 ** 30 for rk in ranks]} GiB")
    # e: the AE step
    a0 = ranks[0]["ae"]
    ae_err = max(abs(a0["terms"][k] - v) / abs(v)
                 for k, v in refs["ae_terms"].items())
    print(f"{label}e: AE step, {n} ranks against one process at batch "
          f"65,536: loss terms within {ae_err:.3e} (rel; tol 1e-05)")
    if ae_err > 1e-5:
        fail(f"{label}e: AE loss terms outside the tolerance")
    ae_grads = p12_grads(f"{label}e", refs["ae_state"], a0["g"],
                         refs["ae_g"], refs["ae_exact_g"], a0["g_tf32"],
                         cancel=cancelled_leaf)
    ae_shas = [rk["ae"]["params_sha"] for rk in ranks]
    ae_ms = [rk["ae"]["ms_per_step"] for rk in ranks]
    print(f"{label}e: ms per AE step (TF32 on) {ae_ms}; params "
          f"bit-identical across the ranks: {len(set(ae_shas)) == 1}")
    if len(set(ae_shas)) != 1:
        fail(f"{label}e: the ranks' AE parameters differ")
    print(f"{label}a/{label}d/{label}e: {secs:.1f} s with the ranks' start")
    boot = p12_bootstrap({"loss": r0["terms"]["loss"].tolist(),
                          "g_sha": p12_sha(r0["g"])}, n, f"{label}f")
    if boot["backends"] != [ranks[0]["group"]["backend"]] * n:
        fail(f"{label}f: the bootstrapped group's backend differs from "
             "the spawned one's")
    return {"seconds": secs, "train": {
        "terms_rel_err": terms_err, "grads": grads, "ms_per_step": ms,
        "one_process_ms_per_step": refs["one_ms_per_step"],
        "all_reduce_ms": ar, "all_reduce_bus_gb_s": bus,
        "n_params": r0["n_params"],
        "peak_bytes": [rk["peak_bytes"] for rk in ranks]},
        "ae": {"terms_rel_err": ae_err, "grads": ae_grads,
               "ms_per_step": ae_ms},
        "collectives": [rk["collectives"] for rk in ranks],
        "bootstrap": boot}


def p12_feats(path: str):
    import numpy as np
    with np.load(path) as f:
        return [f[k] for k in ("feat_xy", "feat_xz", "feat_yz")]


def p12_plane_errs(got, want) -> list:
    """Per plane, max |got - want| over the plane's max |want|."""
    import numpy as np
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


def p12_sampling(tmp: str, want_k1: dict, aabb, slabs: int, n: int,
                 label: str) -> dict:
    """12b/13b. `cli.sample` data-parallel over n ranks (12b
    `--sample_devices 2`, two ranks on card 0; 13b `--sample_devices 0`,
    one rank a card), the mesh path, DDIM-100, n samples, bf16: each
    rank's device, K1 and K2 launches and outputs; one process at batch n
    and at batch 1 x n for the seconds (the bf16 bits of each sample
    against the batch-1 run's: printed in 12b, held in 13b); then in fp32
    (`--vox` at reso 64) each DP feat.npz against the chain of the same
    index at batch 1 in this process: 12b within 1e-4 of each plane's
    largest, 13b bit for bit."""
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    nccl = label == "13b"
    argv = ["--tag", TAG, *P12_DDIM, "--n_samples", str(n)]
    args = cli.cfgmod.sample_args(argv)
    want_tn = argv_tnorm(argv, want_k1)
    dp_flag = ["--sample_devices", "0" if nccl else str(n)]
    runs = {}
    for name, extra in (("dp", dp_flag),
                        (f"batch {n}", ["--pipeline_chunk", str(n)]),
                        (f"batch 1 x{n}", [])):
        reset_counts()
        runs[name] = cli.main(argv + extra + ["--output",
                                              os.path.join(tmp, name)])
        torch.cuda.synchronize()
        if name == "dp" and (read_counts()["k1"] or read_counts()["k2"]):
            fail(f"{label}: this process launched kernels while the ranks "
                 "ran")
    dp = runs["dp"]
    if len(dp["ranks"]) != n:
        fail(f"{label}: {len(dp['ranks'])} ranks ran, not {n}")
    launches = []
    for r, rk in enumerate(dp["ranks"]):
        texels = {e["dir"]: e["texels"] for e in rk["stages"]
                  if e["stage"] == "texel dispatch"}
        k = len(rk["paths"])
        want_k2 = k * slabs + sum(texel_chunks(t) for t in texels.values())
        want_dev = f"cuda:{r if nccl else 0}"
        got = rk["launches"]
        names = [os.path.basename(os.path.dirname(p)) for p in rk["paths"]]
        print(f"{label} rank {r} on {rk['device']} ({rk['backend']}): "
              f"samples {names}, K1 launches by form {got['k1_forms']} "
              f"(want {want_k1}), K2 {got['k2']} (want {want_k2}: {slabs} "
              f"geo slabs + the texel chunks of {sorted(texels.values())} "
              f"texels), norm kernel {got['tnorm']} (want {want_tn})")
        if rk["device"] != want_dev or rk["backend"] != (
                "nccl" if nccl else "gloo"):
            fail(f"{label} rank {r}: on {rk['device']} over "
                 f"{rk['backend']}, not on {want_dev}")
        if got["k1_forms"] != want_k1 or got["k2"] != want_k2 \
                or got["tnorm"] != want_tn:
            fail(f"{label} rank {r}: the kernels did not launch as "
                 "expected")
        for p in rk["paths"]:
            d = os.path.dirname(p)
            check_mesh_sample(f"{label} rank {r}", d,
                              int(os.path.basename(d)), aabb, args.reso,
                              args.texreso, args.n_faces, texels[d],
                              rk["stages"])
        launches.append({"k1": got["k1"], "k2": got["k2"],
                         "device": rk["device"]})
    bits = [all((a == b).all() for a, b in zip(
        p12_feats(os.path.join(tmp, "dp", f"{j:03d}", "feat.npz")),
        p12_feats(os.path.join(tmp, f"batch 1 x{n}", f"{j:03d}",
                               "feat.npz")))) for j in range(n)]
    if nccl and not all(bits):
        fail(f"{label}: the bf16 DP samples differ from the one-process "
             "batch-1 run's bits")

    def chain(res):
        return sum(e["seconds"] for e in res["stages"]
                   if e["stage"] == "chain")
    secs = {"dp": dp["seconds"], "dp_chain_by_rank": [
        chain(rk) for rk in dp["ranks"]],
        "dp_generate_by_rank": [rk["seconds"] for rk in dp["ranks"]],
        f"batch {n}": runs[f"batch {n}"]["seconds"],
        f"batch {n} chain": chain(runs[f"batch {n}"]),
        f"batch 1 x{n}": runs[f"batch 1 x{n}"]["seconds"],
        f"batch 1 x{n} chain": chain(runs[f"batch 1 x{n}"])}
    print(f"{label}: bf16 feat.npz bits equal to the one-process batch-1 "
          f"run's: {bits}; seconds (host clock): {n} ranks "
          f"{secs['dp']:.3f} with their start (per rank: generate "
          f"{secs['dp_generate_by_rank']}, chain "
          f"{secs['dp_chain_by_rank']}), one process at batch {n} "
          f"{secs[f'batch {n}']:.3f} (chain {secs[f'batch {n} chain']:.3f}),"
          f" at batch 1 x{n} {secs[f'batch 1 x{n}']:.3f} (chain "
          f"{secs[f'batch 1 x{n} chain']:.3f})")
    # fp32: the DP samples against the one-process chain of each index
    vox = argv + ["--vox", "--reso", "64"]
    with environ(SIN3DM_SAMPLE_DTYPE="train"):
        f32 = cli.main(vox + dp_flag + ["--output",
                                        os.path.join(tmp, "fp32")])
        sampler, C, sizes, _ = cli._build_sampler(cli.cfgmod.sample_args(
            vox))
        errs, f32_bits = [], []
        for j in range(n):
            x = sampler(0, j, 1, C, sizes)
            want = [p[0].permute(2, 0, 1).cpu().numpy() for p in x]
            got = p12_feats(os.path.join(tmp, "fp32", f"{j:03d}",
                                         "feat.npz"))
            errs.append(p12_plane_errs(got, want))
            f32_bits.append(all((a == b).all() for a, b in zip(got, want)))
    worst = max(max(e) for e in errs)
    print(f"{label}: fp32 DP feat.npz against this process's batch-1 chain "
          f"of the same index, per plane of max |x|: {errs} (tol "
          f"{'0, bit for bit' if nccl else '1e-04'}); bits equal: "
          f"{f32_bits}")
    if worst > 1e-4 or (nccl and not all(f32_bits)):
        fail(f"{label}: the fp32 DP samples differ from the one-process "
             "chain")
    return {"launches_by_rank": launches, "bf16_bits_equal": bits,
            "seconds": secs, "fp32_worst_rel": worst,
            "fp32_bits_equal": f32_bits, "fp32_seconds": f32["seconds"]}


def p12_spatial(tmp: str, label: str) -> dict:
    """12c/13c. `cli.sample --sample_spatial 2` (DDIM-100, fp32, the full
    planes; 12c two ranks on card 0 over gloo, 13c a card each over
    NCCL) against the unsharded chain of the differentiable form in this
    process; K1 launches (0), collectives per forward, seconds."""
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.compat.from_jax import unet_params_from_jax
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.diffusion.gaussian import tables_to_device
    from sin3dm_tpu_torch.diffusion.sampling import make_sampler
    from sin3dm_tpu_torch.models.unet import unet_train_apply
    nccl = label == "13c"
    argv = ["--tag", TAG, *P12_DDIM, "--n_samples", "1", "--vox", "--reso",
            "64"]
    with environ(SIN3DM_SAMPLE_DTYPE="train"):
        sp = cli.main(argv + ["--sample_spatial", "2", "--output",
                              os.path.join(tmp, "spatial")])
        args = cli.cfgmod.sample_args(argv)
        ucfg = cli._unet_config(args)
    params = unet_params_from_jax(ckpt.load_tree(EMA_PATH)[0], "cuda")
    tables = tables_to_device(cli.cfgmod.schedule_from_args(
        args, respacing="ddim100").tables_f32(), "cuda")
    sampler = make_sampler(
        lambda x, t: unet_train_apply(params, ucfg, x, t), tables,
        cli.cfgmod.diffusion_config_from_args(args), use_ddim=True,
        device="cuda")
    C = ucfg.in_channels
    sizes = cli._target_sizes(args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = sampler(0, 0, 1, C, sizes)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    errs = p12_plane_errs(p12_feats(os.path.join(tmp, "spatial", "000",
                                                 "feat.npz")),
                          [p[0].permute(2, 0, 1).cpu().numpy() for p in x])
    k1 = [rk["launches"]["k1"] for rk in sp["ranks"]]
    # per forward: the chain's all_reduces but the final gather's 3
    per_fwd = [(rk["collectives"]["all_reduce"] - 3) / 100
               for rk in sp["ranks"]]
    chain = [rk["sample_seconds"] for rk in sp["ranks"]]
    where = [f"{rk['device']} ({rk['backend']})" for rk in sp["ranks"]]
    print(f"{label}: spatial sampling over 2 ranks on {where}, planes "
          f"{sizes} fp32: feat.npz against the unsharded chain, per plane "
          f"of max |x|: {errs} (tol 1e-04); K1 launches {k1} (want 0); "
          f"all_reduces per forward {per_fwd}; chain seconds by rank "
          f"{chain} against {plain_s:.3f} unsharded "
          f"({max(chain) / plain_s:.2f}x); the run {sp['seconds']:.3f} s "
          "with the ranks' start")
    want = [(f"cuda:{r if nccl else 0}", "nccl" if nccl else "gloo")
            for r in range(2)]
    if [(rk["device"], rk["backend"]) for rk in sp["ranks"]] != want:
        fail(f"{label}: the spatial ranks are not on {want}")
    if max(errs) > 1e-4 or any(k1):
        fail(f"{label}: spatial sampling differs from the unsharded chain "
             "or launched K1")
    return {"worst_rel": max(errs), "launches_k1": k1,
            "launches_k2": [rk["launches"]["k2"] for rk in sp["ranks"]],
            "all_reduce_per_forward": per_fwd, "chain_seconds": chain,
            "unsharded_chain_seconds": plain_s, "seconds": sp["seconds"]}


def phase12(want_k1: dict, aabb, slabs: int, refs: dict) -> dict:
    """12a-12f: two ranks that share card 0 over gloo, on any machine: the
    ranks and the bootstrapped processes see card 0 alone
    (`CUDA_VISIBLE_DEVICES`, restored after)."""
    import torch
    torch.cuda.empty_cache()
    card0 = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    tmp = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_ranks_")
    t0 = time.perf_counter()
    try:
        with environ(CUDA_VISIBLE_DEVICES=card0 or "0"):
            out = {"training": p12_training(tmp, refs, P12_RANKS, "12")}
            with configuration("default"):
                out["sampling"] = p12_sampling(tmp, want_k1, aabb, slabs,
                                               P12_RANKS, "12b")
                out["spatial"] = p12_spatial(tmp, "12c")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 12: {out['seconds']:.1f} s")
    return out


def p13_topology(n: int) -> dict:
    """How the cards are joined, as far as this machine lets it be read:
    `nvidia-smi topo -m` and `nvidia-smi nvlink --status` (their output,
    or their exit code and error where the machine refuses them), and
    which pairs of the n cards reach each other's memory directly
    (`torch.cuda.can_device_access_peer`).  13d's all_reduce rate is the
    measured witness of the link."""
    import torch
    out = {}
    for key, cmd in (("topo", ["nvidia-smi", "topo", "-m"]),
                     ("nvlink", ["nvidia-smi", "nvlink", "--status"])):
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60, check=False)
        out[key] = (res.stdout.rstrip() if res.returncode == 0 else
                    f"not read: exit {res.returncode}: "
                    f"{(res.stdout + res.stderr).strip()[:300]}")
    out["peer_access"] = [[i == j or torch.cuda.can_device_access_peer(i, j)
                           for j in range(n)] for i in range(n)]
    return out


# 13f: `cli.train` from the committed encoding at the tag's batch, two
# single-step calls, twice through n bootstrapped processes and once
# through `--n_devices n`; 13h: once more through n bootstrapped processes
# with their ids permuted over the cards (process r on card n-1-r, by
# SIN3DM_LOCAL_RANK).  Training runs under deterministic algorithms, so
# every dumped array and progress line must equal the first run's bit
# for bit.
P13_TRAIN_ARGV = ["--enc_log", os.path.join(TAG, "encoding"),
                  "--diff_batch_size", "32", "--steps_per_call", "1",
                  "--diff_lr", "5e-4", "--ema_rate", "0.9999",
                  "--diff_n_iters", "2", "--save_interval", "2",
                  "--log_interval", "1"]


def p13_train_cli(tmp: str, n: int) -> dict:
    """13f and 13h, `cli.train`: the same command through n processes
    started by hand (`SIN3DM_DIST`) twice, through `--n_devices n` from
    this process (`parallel.spawn`), and through n processes started by
    hand with process r on card n-1-r (`SIN3DM_LOCAL_RANK`), each one rank
    a card over NCCL: every dumped array and progress line bit for bit
    the first run's, and each permuted process on the card it was
    given."""
    from sin3dm_tpu_torch.cli import train as train_cli
    fmt = {"SIN3DM_LOG_FORMAT": "log,csv,json"}
    perm = list(range(n))[::-1]
    runs, secs, printed = {}, {}, {}
    for k, local in (("boot", None), ("boot again", None),
                     ("permuted", perm)):
        tag = os.path.join(tmp, f"train {k}")
        outs, secs[k] = p12_processes(
            [sys.executable, "-m", "sin3dm_tpu_torch.cli.train", "--tag",
             tag, *P13_TRAIN_ARGV], n, f"13f cli.train ({k})", local=local,
            **fmt)
        printed[k] = [ln for o in outs for ln in o.splitlines()
                      if "data group" in ln or ln.startswith("process ")]
        runs[k] = dumped(tag)
    tag = os.path.join(tmp, "train spawn")
    with environ(**fmt):
        t0 = time.perf_counter()
        train_cli.main(["--tag", tag, *P13_TRAIN_ARGV, "--n_devices",
                        str(n)])
        secs["spawn"] = time.perf_counter() - t0
    runs["spawn"] = dumped(tag)
    res = {k: same_bits(f"13{'h' if k == 'permuted' else 'f'} cli.train, "
                        f"{k} ({secs[k]:.1f} s) against the first "
                        f"bootstrapped run ({secs['boot']:.1f} s)",
                        runs["boot"], runs[k])
           for k in ("boot again", "spawn", "permuted")}
    placed = [f"process {r} of {n}: cuda:{perm[r]} (local index {perm[r]} "
              f"($SIN3DM_LOCAL_RANK))" in printed["permuted"]
              for r in range(n)]
    nccl = {k: any("backend nccl" in ln for ln in v)
            for k, v in printed.items()}
    print(f"13h: the permuted processes on the cards they were given: "
          f"{placed}; lines {printed['permuted']}")
    print(f"13f: NCCL in each bootstrapped run: {nccl}")
    if any(r["differ"] for r in res.values()) or not all(placed) \
            or not all(nccl.values()):
        fail("13f/13h: the bootstrapped cli.train runs are not bit for bit "
             "one another's and --n_devices', or not on their cards over "
             "NCCL")
    return {"seconds": secs, "bits": res, "permuted_placed": placed}


def p13_sample_cli(tmp: str, n: int) -> dict:
    """13f, `cli.sample`: `--sample_devices 0` through n processes started
    by hand (`--vox` at reso 64), each sample's feat.npz bit for bit
    13b's (the DP run's bf16 chain of the same index)."""
    out = os.path.join(tmp, "sample boot")
    outs, secs = p12_processes(
        [sys.executable, "-m", "sin3dm_tpu_torch.cli.sample", "--tag", TAG,
         *P12_DDIM, "--n_samples", str(n), "--vox", "--reso", "64",
         "--sample_devices", "0", "--output", out], n, "13f cli.sample")
    bits = [all((a == b).all() for a, b in zip(
        p12_feats(os.path.join(out, f"{j:03d}", "feat.npz")),
        p12_feats(os.path.join(tmp, "dp", f"{j:03d}", "feat.npz"))))
        for j in range(n)]
    printed = [ln for o in outs[:1] for ln in o.splitlines()
               if "data group" in ln]
    print(f"13f cli.sample: {n} bootstrapped processes, --sample_devices 0: "
          f"feat.npz bits equal to 13b's: {bits}; {secs:.1f} s with their "
          f"start; rank 0 printed {printed}")
    if not all(bits) or not any("backend nccl" in ln for ln in printed):
        fail("13f: the bootstrapped cli.sample is not 13b's over NCCL")
    return {"bits_equal": bits, "seconds": secs}


def p13_card_times(ae_params, slab_rows: int) -> dict:
    """K1's default form per UNet forward at batch 2 (its triplane
    launches at every shape, each timed by `time_ms` times its launches
    per forward) and K2 per slab (both heads, bf16) on the card the params
    lie on, by CUDA events on that card."""
    import torch
    from sin3dm_tpu_torch.ops.fused_conv import (conv3x3_rollout_triplane,
                                                 pack_conv_weights)
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp
    card = ae_params["geo_decoder"]["first"][0]["w"].device
    g = torch.Generator(device=card).manual_seed(4)
    k1 = 0.0
    with torch.cuda.device(card):
        for planes, C, Co, calls, _ in k1_groups():
            ops = group_inputs(g, 2, planes, C, Co)
            packed = [pack_conv_weights(op["w"]) for op in ops]
            ta = triplane_args(ops, torch.bfloat16, "default")
            k1 += calls * time_ms(
                lambda: conv3x3_rollout_triplane(*ta, packed=packed))
        k2 = 0.0
        for head in ("geo_decoder", "tex_decoder"):
            p = ae_params[head]
            x = torch.randn(slab_rows, p["first"][0]["w"].shape[0],
                            generator=g, device=card) * 0.5
            k2 += time_ms(lambda: skip_mlp(p, x, mxu_dtype=torch.bfloat16),
                          iters=5)
    return {"k1_ms_per_forward": k1, "k2_ms_per_slab": k2}


def p13_cards(tmp: str, n: int, slab_rows: int) -> dict:
    """13g. On each card 1 .. n-1, from this process whose current device
    stays 0: phase 3's K1, K1′ and K2 checks against their plain versions
    at phase 3's tolerances (untimed); every card's K1 per forward and K2
    per slab by events, card 0's beside; then `cli.sample --gpu_id n-1
    --vox` (DDIM-100, reso 64) against the same run on card 0: the same
    K1 and K2 launches."""
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.ops import pack_params
    tree, _ = ckpt.load_tree(os.path.join(TAG, "encoding", "ckpt_final.pth"),
                             "params")
    out = {"times": {}}
    for d in range(n):
        card = torch.device("cuda", d)
        ae = pack_params(ae_params_from_jax(tree, card))
        if d:
            k1 = check_k1_forms(2, timed=False, device=card)
            k2 = check_k2(ae, slab_rows, timed=False)
            out[f"cuda:{d}"] = {"k1_max_abs_err": max(
                f["max_abs_err"] for f in k1.values()),
                "k2_max_abs_err": k2["max_abs_err"]}
        out["times"][f"cuda:{d}"] = p13_card_times(ae, slab_rows)
        print(f"13g cuda:{d}: K1, K1' and K2 against their plain versions "
              f"{'ok' if d else '(phase 3)'}; times by events: "
              f"{out['times'][f'cuda:{d}']}")
        if torch.cuda.current_device() != 0:
            fail("13g: the checks moved this process's current device")
        del ae
    base = ["--tag", TAG, *P12_DDIM, "--n_samples", "1", "--vox", "--reso",
            "64"]
    runs = {}
    for gpu in (0, n - 1):
        reset_counts()
        d = os.path.join(tmp, f"gpu {gpu}")
        res = cli.main(base + ["--gpu_id", str(gpu), "--output", d])
        torch.cuda.synchronize(gpu)
        runs[gpu] = {"counts": read_counts(), "paths": res["paths"],
                     "sample_seconds": res["sample_seconds"]}
    a, b = runs[0], runs[n - 1]
    same = (a["counts"]["k1_forms"] == b["counts"]["k1_forms"]
            and a["counts"]["k2"] == b["counts"]["k2"]
            and a["counts"]["k1"] > 0 and a["counts"]["k2"] > 0)
    bits = all((x == y).all() for x, y in zip(
        p12_feats(a["paths"][0]), p12_feats(b["paths"][0])))
    print(f"13g cli.sample --gpu_id {n - 1} --vox: K1 by form "
          f"{b['counts']['k1_forms']}, K2 {b['counts']['k2']} against card "
          f"0's {a['counts']['k1_forms']}, {a['counts']['k2']}: equal "
          f"{same}; feat.npz bits equal card 0's: {bits}; chain "
          f"{b['sample_seconds']:.3f} s against {a['sample_seconds']:.3f} s; "
          f"current device {torch.cuda.current_device()}")
    if not same or torch.cuda.current_device() != 0:
        fail(f"13g: --gpu_id {n - 1} did not launch the kernels as card 0")
    out["gpu_id_run"] = {"card": n - 1, "k1": b["counts"]["k1"],
                         "k2": b["counts"]["k2"], "bits_equal_card0": bits,
                         "chain_s": b["sample_seconds"],
                         "card0_chain_s": a["sample_seconds"]}
    return out


def phase13(want_k1: dict, aabb, slabs: int, slab_rows: int,
            refs: dict) -> dict:
    """13a-13g: one rank a card over NCCL on n = min(4, cards) cards.  On
    a machine of one card it runs nothing and says why."""
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    cards = torch.cuda.device_count()
    if cards < 2:
        print("phase 13: not run: this machine has one card, and NCCL "
              "takes a card a rank (phase 12 ran two ranks on it over "
              "gloo)")
        return {"ran": False, "cards": cards}
    n = min(P13_MAX_CARDS, cards)
    topo = p13_topology(n)
    print(f"phase 13: {n} ranks, one a card, of {cards} cards; peer "
          f"access {topo['peer_access']}; nvidia-smi topo -m: "
          f"{topo['topo']}\nnvidia-smi nvlink --status: {topo['nvlink']}")
    tmp = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_cards_")
    t0 = time.perf_counter()
    out = {"ran": True, "ranks": n, "cards": cards, "topology": topo}
    try:
        out["training"] = p12_training(tmp, refs, n, "13")
        out["train_cli"] = p13_train_cli(tmp, n)
        with configuration("default"):
            out["sampling"] = p12_sampling(tmp, want_k1, aabb, slabs, n,
                                           "13b")
            out["sample_cli"] = p13_sample_cli(tmp, n)
            out["spatial"] = p12_spatial(tmp, "13c")
            try:
                cli.main(["--tag", TAG, *P12_DDIM, "--vox",
                          "--sample_spatial", "4", "--output",
                          os.path.join(tmp, "spatial 4")])
            except ValueError as e:
                print(f"13c: --sample_spatial 4 refused: {e}")
                out["spatial"]["refused_4"] = str(e)
            else:
                fail("13c: --sample_spatial 4 was not refused")
            out["cards_kernels"] = p13_cards(tmp, n, slab_rows)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 13: {out['seconds']:.1f} s")
    return out


def several_ranks_only(only: set) -> None:
    """`--only`: phases 12 and/or 13 after the build, checked against the
    committed tag's main-path numbers as `main` computes them (K1
    launches by form of a DDIM-100 chain, the AABB, the geo slabs of a
    mesh sample, the rows of a slab); prints their results."""
    import numpy as np
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.dataio.grid import grid_resolutions
    from sin3dm_tpu_torch.models.unet import k1_launches_by_form
    _, meta = ckpt.load_tree(os.path.join(TAG, "encoding",
                                          "ckpt_final.pth"), "params")
    ucfg = cli._unet_config(cli.cfgmod.sample_args(["--tag", TAG, "--vox"]))
    want100 = {f: n * 100 for f, n in k1_launches_by_form(ucfg).items()}
    aabb = np.asarray(meta["aabb"], np.float64)
    reso = cli.cfgmod.sample_args(["--tag", TAG]).reso
    slabs = -(-int(grid_resolutions(aabb, reso)[0]) // 8)
    slab_rows = 8 * meta["grid_shape"][1] * meta["grid_shape"][2]
    tmp = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_refs_")
    try:
        refs = p12_refs(tmp)
        if 12 in only:
            print("several ranks: " + json.dumps(
                phase12(want100, aabb, slabs, refs), default=float))
        if 13 in only:
            print("several cards: " + json.dumps(
                phase13(want100, aabb, slabs, slab_rows, refs),
                default=float))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        phases = argv[1].split(",") if len(argv) == 2 else []
        if argv[0] != "--only" or not phases or \
                not set(phases) <= {"12", "13"}:
            print("usage: chip_smoke.py [--only 12|13|12,13]",
                  file=sys.stderr)
            return 2
        only = {int(x) for x in phases}
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
        built = _build.build(["fused_conv", "fused_mlp", "tnorm"])
        print(f"build: {time.perf_counter() - t0:.1f} s (parallel nvcc)")
        geo_build = geo.result()
    print(f"build: geometry library (g++ {' '.join(geo_build['flags'])}) "
          f"{geo_build['seconds']:.1f} s, {geo_build['path']}")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"  {name}: {line.strip()}")
    if only:
        several_ranks_only(only)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # 3. kernels against their plain versions
    B = 2
    k1f = check_k1_forms(B)
    # serving, the app's DDPM chain and the bpd loop run batch-1 chains
    k1_b1 = check_k1_forms(1, timed=False)
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
    tn = check_tnorm(B)
    # serving, the app's DDPM chain and the bpd loop run batch-1 chains
    tn_b1 = check_tnorm(1, timed=False)
    print("triplane norm kernel: " + json.dumps(tn))

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

    # 4g. the kernels' opt-out switches against the kernels
    opt_out = phase4g(want(100), want_k2)

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
        repeats6 = train_repeats(train_dir, E6_TRAIN_ARGV, "diffusion")
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
        "profile": train_prof, "sample_launches": counts6,
        "repeats": repeats6}))
    print("kernels' opt-outs (4g): " + json.dumps(opt_out))

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

    # 11. serving and the diffusion library: a reference-format tag, the
    # app's server, the library's remainder at full width
    serve = phase11(ucfg, want(10), want_k2, aabb, slabs)
    print("serving and the diffusion library: " + json.dumps(
        serve, default=float))
    served = serve["serving"]

    # 12. two ranks that share card 0: the group, DP and spatial sampling
    # through the CLI, DP training steps, the bootstrap; 13. one rank a
    # card over NCCL where there are two cards or more
    refs_dir = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_refs_")
    try:
        refs = p12_refs(refs_dir)
        ranks12 = phase12(want(100), aabb, slabs, refs)
        print("several ranks: " + json.dumps(ranks12, default=float))
        cards13 = phase13(want(100), aabb, slabs, slab_rows, refs)
        print("several cards: " + json.dumps(cards13, default=float))
        del refs
    finally:
        shutil.rmtree(refs_dir, ignore_errors=True)
    dp12 = ranks12["sampling"]["launches_by_rank"]
    dp13 = (cards13["sampling"]["launches_by_rank"] if cards13["ran"]
            else None)
    by_card = cards13["cards_kernels"] if cards13["ran"] else None

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
    # the norm kernel per forward at batch 2: its nine launches summed
    tn_all = {k: sum(r[k] for r in tn.values()) for k in (
        "ms", "device_ms", "bound_ms")}
    tn_all.update(max_abs_err=max(r["max_abs_err"] for r in tn.values()),
                  plain_ms=sum(r["plain_device_ms"] for r in tn.values()),
                  library_ms=sum(r["library_device_ms"] for r in tn.values()),
                  bound_by="bytes")
    lib_keys = ("device_ms", "host_ms", "library_default_ms",
                "library_benchmark_ms", "library_device_ms")
    src = "sin3dm_tpu_torch/csrc/fused_conv.cu"
    kernels = [
        row("conv3x3_rollout", src, "sin3dm_tpu/ops/fused_conv.py:177",
            main_counts["k1"], k1, **{k: k1[k] for k in lib_keys},
            launches_train_step=trained["launches_train_step"]["k1"],
            launches_without_kernels=opt_out["launches_without"]["k1"],
            chain_s_per_sample_ddim100=opt_out["chain_s_per_sample"],
            launches_sample_after_training=counts6["k1"],
            launches_serving=served["total"]["k1"],
            launches_serving_by_request={
                k: v["k1"] for k, v in served["launches"].items()},
            launches_bpd_loop=serve["library"]["bpd_loop"]["launches"],
            launches_dp_sampling_by_rank=[r["k1"] for r in dp12],
            launches_spatial_sampling_by_rank=ranks12["spatial"][
                "launches_k1"],
            launches_dp_sampling_by_card=dp13 and [r["k1"] for r in dp13],
            launches_gpu_id_run=by_card and by_card["gpu_id_run"]["k1"],
            ms_per_forward_by_card=by_card and {
                c: t["k1_ms_per_forward"]
                for c, t in by_card["times"].items()},
            max_abs_err_batch1=k1_b1["default"]["max_abs_err"]),
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
            max_abs_err_batch1=max(k1_b1[f]["max_abs_err"] for f in k1p),
            ratios=ratios, forward_parity_max_abs=parity_err,
            inpaint_launches=inpaint_counts["k1_forms"]),
        row("skip_mlp", "sin3dm_tpu_torch/csrc/fused_mlp.cu",
            "sin3dm_tpu/ops/fused_mlp.py:79",
            main_counts["k2"] + mesh_counts["k2"] + ae8["launches"]["k2"],
            k2, device_ms=k2["device_ms"],
            library_device_ms=k2["library_device_ms"],
            launches_vox=main_counts["k2"], launches_mesh=mesh_counts["k2"],
            launches_without_kernels=opt_out["launches_without"]["k2"],
            launches_ae_train=ae8["launches"]["k2"],
            launches_ae_evaluate=ae8["launches_by_stage"]["evaluate"],
            launches_ae_rec=ae8["launches_by_stage"]["rec"],
            launches_ae_train_by_shape=ae8["launches_by_stage"][
                "cli_by_shape"],
            launches_ae_train_step=ae8["step"]["launches"]["k2"],
            mesh_shapes=k2_mesh,
            launches_train_step=trained["launches_train_step"]["k2"],
            launches_sample_after_training=counts6["k2"],
            launches_serving=served["total"]["k2"],
            launches_serving_by_request={
                k: v["k2"] for k, v in served["launches"].items()},
            launches_dp_sampling_by_rank=[r["k2"] for r in dp12],
            launches_spatial_sampling_by_rank=ranks12["spatial"][
                "launches_k2"],
            launches_dp_sampling_by_card=dp13 and [r["k2"] for r in dp13],
            launches_gpu_id_run=by_card and by_card["gpu_id_run"]["k2"],
            ms_per_slab_by_card=by_card and {
                c: t["k2_ms_per_slab"] for c, t in by_card["times"].items()}),
        row("skip_mlp pbr mr head [376832, 64] -> 2 (phase 8h)",
            "sin3dm_tpu_torch/csrc/fused_mlp.cu",
            "sin3dm_tpu/ops/fused_mlp.py:79",
            ae8["variants"]["8h"]["launches_cout2"],
            ae8["variants"]["8h"]["k2_cout2"],
            device_ms=ae8["variants"]["8h"]["k2_cout2"]["device_ms"],
            library_device_ms=ae8["variants"]["8h"]["k2_cout2"][
                "library_device_ms"]),
        row("skip_mlp geo head [2^20, 64] -> 1 (evaluate's surface chunk)",
            "sin3dm_tpu_torch/csrc/fused_mlp.cu",
            "sin3dm_tpu/ops/fused_mlp.py:79",
            ae8["launches_by_stage"]["surface_chunk_geo"], k2_surf,
            device_ms=k2_surf["device_ms"],
            library_device_ms=k2_surf["library_device_ms"]),
        row("tnorm_silu", "sin3dm_tpu_torch/csrc/tnorm.cu",
            "none (XLA fuses sin3dm_tpu/core/nn.py:group_norm32_film_silu)",
            main_counts["tnorm"], tn_all, device_ms=tn_all["device_ms"],
            library_device_ms=tn_all["library_ms"],
            max_abs_err_batch1=max(r["max_abs_err"] for r in tn_b1.values()),
            coef_rel_err_vs_fp64=max(r["coef_rel_err_vs_fp64"]
                                     for r in tn.values()),
            launches_stats_chain=opt_in["stats chain"]["tnorm"],
            launches_fused_act=opt_in["fused act"]["tnorm"],
            launches_mesh=mesh_counts["tnorm"],
            launches_sample_after_training=counts6["tnorm"],
            launches_serving=served["total"]["tnorm"],
            launches_dp_sampling_by_rank=[r["tnorm"] for r in dp12]),
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
          "wrapper's count by shape; 'launches_serving' sums phase 11b's "
          "requests (by request under 'launches_serving_by_request'), "
          "'launches_bpd_loop' is 11c's calc_bpd_loop (T 1000); "
          "'launches_dp_sampling_by_rank' and "
          "'launches_spatial_sampling_by_rank' are each rank's own count "
          "in 12b (DDIM-100, one sample a rank, the mesh path) and 12c "
          "(spatial: no K1; rank 0's --vox decode at reso 64 launches K2); "
          "where phase 13 ran (else null): "
          "'launches_dp_sampling_by_card' each rank's count in 13b (one "
          "rank a card over NCCL, the same run as 12b's), "
          "'launches_gpu_id_run' 13g's --vox run on the last card, and "
          "'ms_per_forward_by_card' / 'ms_per_slab_by_card' 13g's times "
          "by events on each card (K1 default form at batch 2, K2 both "
          "heads); 'launches_without_kernels' 4g's --vox DDIM-100 run "
          "under SIN3DM_FUSED_CONV=0 SIN3DM_FUSED_HEADS=0 (0), and "
          "'chain_s_per_sample_ddim100' its chain seconds per sample "
          "beside the kernels' run; the row of pbr's mr head (cout 2) "
          "counts its launches in phase 8h's CLI run and reso-64 decode, "
          "by the wrapper's count by shape, and times it over the geo "
          "slab's rows; the norm kernel's row (tnorm_silu) sums the nine "
          "norms of a forward at batch 2 (each timed alone), 'plain_ms' "
          "and 'library_ms' the plain version's and the F.group_norm "
          "route's device time, its 'launches' from the main path's run")
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
