#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`sin3dm_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one, and outside a checkout
of this repository.  Phases, each printing its results:

1. device: name, power limit, torch/CUDA versions; TF32 off;
2. build: both kernels with nvcc from `sin3dm_tpu_torch/csrc/`, in
   parallel;
3. kernels against their plain versions on the card at the main path's
   shapes, in bf16 and fp32, with error, tolerance and median times of
   kernel, plain version and a library yardstick (cuDNN conv + epilogue
   for K1, a bf16 torch.matmul chain for K2) that the port never calls;
4. main path: `cli.sample.main(--tag checkpoints/towerruins --vox
   --n_samples 2)` (DDPM-1000, batch 2, --reso 256) with the launch
   counters set to 0 just before and read just after, output checks and
   the chain/decode seconds;
5. where a chain step's time goes: host-clock time per DDPM step and,
   from torch.profiler, the device's busy share and top kernels;
6. a JSON line of every kernel's numbers, then as the last line
   {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

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
PEAK_BYTES = 3.35e12        # H100 SXM HBM3

# tolerances of a kernel against its plain version on the same inputs
# bf16 out (K1): both sum in fp32 in different orders, then round once;
# allow 2 bf16 ulps of the reference value plus 2 ulps at 1% of the
# tensor's largest magnitude (cancellation near zero)
BF16_ULP = 2.0 ** -7
# fp32 (K1, K2 fp32 mode): summation order only
F32_TOL = 1e-4
# K2 with bf16 operands: fp32 out; a hidden activation that rounds to the
# other bf16 neighbour moves the output by far less than one bf16 step
K2_BF16_TOL = 2.0 ** -8


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

def k1_shapes():
    """(H, W, C, Co, calls per UNet forward) of every 3x3 conv of the
    towerruins UNet (planes 92x128 / 92x92 / 128x92 and their halves)."""
    level0 = [(92, 128), (92, 92), (128, 92)]
    level1 = [(46, 64), (46, 46), (64, 46)]
    out = []
    for H, W in level0:
        out += [(H, W, 64, 64, 3), (H, W, 192, 64, 1)]
    for H, W in level1:
        out += [(H, W, 64, 128, 1), (H, W, 128, 128, 3)]
    return out


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


def check_k1(B: int):
    import torch
    from sin3dm_tpu_torch.ops.fused_conv import (conv3x3_rollout,
                                                 conv3x3_rollout_reference)
    g = torch.Generator(device="cuda").manual_seed(1)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    flops_all = nbytes_all = 0.0
    max_err = 0.0
    for H, W, C, Co, calls in k1_shapes():
        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale
        x32 = rnd(B, H, W, C)
        w32 = rnd(3, 3, C, Co, scale=(9 * C) ** -0.5)
        b = rnd(Co, scale=0.1)
        col32 = rnd(B, W, 3, Co, scale=0.3)
        row32 = rnd(B, H, 3, Co, scale=0.3)
        for dt in (torch.bfloat16, torch.float32):
            x, w = x32.to(dt), w32.to(dt)
            col3, row3 = col32.to(dt), row32.to(dt)
            got = conv3x3_rollout(x, w, b, col3, row3).float()
            ref = conv3x3_rollout_reference(x, w, b, col3, row3).float()
            torch.cuda.synchronize()
            err = (got - ref).abs()
            scale = ref.abs().max().item()
            if dt == torch.bfloat16:
                tol = 2 * BF16_ULP * (ref.abs() + 0.01 * scale)
            else:
                tol = torch.full_like(ref, F32_TOL * max(scale, 1.0))
            ok = bool((err <= tol).all())
            rel = (err / ref.abs().clamp_min(1e-3 * scale)).max().item()
            print(f"K1 {str(dt)[6:]:8s} {H:3d}x{W:<3d} C={C:3d} Co={Co:3d}: "
                  f"max_abs_err {err.max().item():.3e} max_rel_err "
                  f"{rel:.3e} ({'ok' if ok else 'FAIL'})")
            if not ok:
                fail(f"K1 {dt} {H}x{W} C={C} Co={Co} disagrees with its "
                     "plain version")
            max_err = max(max_err, err.max().item())
        # times at the main path's dtype (bf16)
        x, w = x32.bfloat16(), w32.bfloat16()
        col3, row3 = col32.bfloat16(), row32.bfloat16()
        ms = time_ms(lambda: conv3x3_rollout(x, w, b, col3, row3))
        plain = time_ms(lambda: conv3x3_rollout_reference(x, w, b, col3,
                                                          row3))
        lib = time_ms(lambda: k1_library(x, w, b, col3, row3))
        flops = 2.0 * B * H * W * 9 * C * Co
        nbytes = 2.0 * (B * H * W * C + 9 * C * Co + B * W * 3 * Co
                        + B * H * 3 * Co + B * H * W * Co) + 4.0 * Co
        bms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        flops_all += calls * flops
        nbytes_all += calls * nbytes
        print(f"K1 bf16 {H:3d}x{W:<3d} C={C:3d} Co={Co:3d} x{calls}/fwd: "
              f"kernel {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, "
              f"library {lib * 1e3:.2f} us, bound {bms * 1e3:.3f} us "
              f"({by})")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib)):
            totals[k] += calls * v
    totals["bound_ms"], by = bound(flops_all, nbytes_all, PEAK_BF16_FLOPS)
    print(f"K1 per UNet forward (batch {B}, 24 launches): kernel "
          f"{totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, "
          f"library {totals['library_ms']:.4f} ms, bound "
          f"{totals['bound_ms']:.5f} ms")
    return {**totals, "max_abs_err": max_err, "bound_by": by}


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


def check_k2(ae_params, n_rows: int):
    import torch
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp, skip_mlp_reference
    g = torch.Generator(device="cuda").manual_seed(2)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
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
        ms = time_ms(lambda: skip_mlp(params, x, mxu_dtype=torch.bfloat16),
                     iters=5)
        plain = time_ms(lambda: skip_mlp_reference(params, x,
                                                   torch.bfloat16), iters=5)
        lib = time_ms(lambda: k2_library(params, x), iters=5)
        layers = params["first"] + params["second"]
        flops = 2.0 * n_rows * sum(lp["w"].shape[0] * lp["w"].shape[1]
                                   for lp in layers)
        cout = layers[-1]["w"].shape[1]
        nbytes = (4.0 * n_rows * (cin + cout)
                  + sum(2.0 * lp["w"].numel() + 4.0 * lp["b"].numel()
                        for lp in layers))
        bms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        print(f"K2 bf16 {head} N={n_rows}: kernel {ms:.3f} ms, plain "
              f"{plain:.3f} ms, library {lib:.3f} ms, bound {bms:.3f} ms "
              f"({by}), {flops / ms / 1e9:.1f} TFLOP/s")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib)):
            totals[k] += v
        flops_all += flops
        nbytes_all += nbytes
    totals["bound_ms"], by = bound(flops_all, nbytes_all, PEAK_BF16_FLOPS)
    print(f"K2 per slab (both heads): kernel {totals['ms']:.3f} ms, plain "
          f"{totals['plain_ms']:.3f} ms, library {totals['library_ms']:.3f} "
          f"ms, bound {totals['bound_ms']:.3f} ms")
    return {**totals, "max_abs_err": max_err, "bound_by": by}


# ---------------------------------------------------------------------------
# Where a chain step's time goes
# ---------------------------------------------------------------------------

def profile_chain(argv, n_steps: int = 10) -> None:
    """The main path's reverse chain cut to its last `n_steps` DDPM steps
    (same model, batch 2): host-clock time per step, then under
    torch.profiler the device's busy time, its operations per step and
    the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    print(f"chain step (batch 2, {n_steps} steps): {step_ms:.3f} ms per "
          "step, host clock")
    if not ops:
        print("chain step: device busy share not measured (the profiler "
              "recorded no device activity)")
        return
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
    busy_ms = busy_us / 1e3 / n_steps
    print(f"chain step: device busy {busy_ms:.3f} ms per step "
          f"({busy_ms / step_ms:.1%} of the host-clock step, idle "
          f"{1 - busy_ms / step_ms:.1%}), {len(ops) / n_steps:.0f} device "
          "operations per step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, us) in top:
        print(f"  {us / 1e3 / n_steps:8.4f} ms/step {n / n_steps:6.1f} "
              f"launches/step  {name[:90]}")


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
    from sin3dm_tpu_torch.core import checkpoint as ckpt
    from sin3dm_tpu_torch.models.unet import k1_launches_per_forward
    from sin3dm_tpu_torch.ops import _build
    from sin3dm_tpu_torch.ops.fused_conv import conv3x3_rollout
    from sin3dm_tpu_torch.ops.fused_mlp import skip_mlp
    import numpy as np

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind}")
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    built = _build.build(["fused_conv", "fused_mlp"])
    print(f"build: {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    B = 2
    k1 = check_k1(B)
    tree, meta = ckpt.load_tree(os.path.join(
        TAG, "encoding", "ckpt_final.pth"), "params")
    ae_params = ae_params_from_jax(tree, "cuda")
    gx, gy, gz = meta["grid_shape"]
    slab_rows = 8 * gy * gz
    k2 = check_k2(ae_params, slab_rows)

    # 4. main path
    out_dir = tempfile.mkdtemp(prefix="sin3dm_chip_smoke_")
    try:
        argv = ["--tag", TAG, "--vox", "--n_samples", "2",
                "--output", out_dir]
        conv3x3_rollout.launches = 0
        skip_mlp.launches = 0
        res = cli.main(argv)
        torch.cuda.synchronize()
        k1_n, k2_n = conv3x3_rollout.launches, skip_mlp.launches
        args = cli.cfgmod.sample_args(argv)
        ucfg = cli.cfgmod.unet_config_from_args(args)
        n_steps = int(args.steps)
        want_k1 = k1_launches_per_forward(ucfg) * n_steps  # one batch of 2
        n_slabs = -(-gx // 8)
        want_k2 = 2 * n_slabs * 2
        print(f"main path: K1 launches {k1_n} (want {want_k1}; the JAX "
              "kernel makes 3 more per forward, as it splits the "
              f"192-channel conv), K2 launches {k2_n} (want {want_k2})")
        if k1_n != want_k1 or k2_n != want_k2:
            fail("the main path did not launch the kernels as expected")
        for j in range(2):
            d = os.path.join(out_dir, f"{j:03d}")
            with np.load(os.path.join(d, "feat.npz")) as f:
                planes = [f[k] for k in ("feat_xy", "feat_xz", "feat_yz")]
            if not all(np.isfinite(p).all() for p in planes):
                fail(f"sample {j}: non-finite feat.npz")
            shapes = [p.shape for p in planes]
            with np.load(os.path.join(d, "r256_voxel.npz")) as v:
                grid = v["vox_grid"]
            occ = float(grid.mean())
            print(f"sample {j}: feat {shapes}, voxel grid "
                  f"{tuple(grid.shape)}, occupancy {occ:.4f}")
            if tuple(grid.shape) != (gx, gy, gz):
                fail(f"sample {j}: voxel grid shape {grid.shape}")
            if not 0.15 <= occ <= 0.19:
                fail(f"sample {j}: occupancy {occ:.4f} outside [0.15, 0.19]"
                     " (committed JAX samples: 0.1667-0.1693)")
        chain_s = res["sample_seconds"] / 2
        print(f"main path: chain {chain_s:.3f} s per sample (DDPM-{n_steps},"
              f" batch 2, {res['sample_seconds']:.3f} s in all), decode "
              f"{res['decode_seconds']:.3f} s for 2 grids")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # 5. where a chain step's time goes
    profile_chain(["--tag", TAG])

    # 6. results
    kernels = [
        {"name": "conv3x3_rollout", "route": "cuda",
         "source": "sin3dm_tpu_torch/csrc/fused_conv.cu",
         "replaces": "sin3dm_tpu/ops/fused_conv.py:177",
         "launches": k1_n, "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"]},
        {"name": "skip_mlp", "route": "cuda",
         "source": "sin3dm_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "sin3dm_tpu/ops/fused_mlp.py:79",
         "launches": k2_n, "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"]},
    ]
    print("kernel times: K1 per UNet forward at batch 2 (24 launches), K2 "
          "per x-slab of both heads")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
