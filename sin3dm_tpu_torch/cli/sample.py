"""Sampling CLI of the port (counterpart of `sin3dm_tpu/cli/sample.py`):

    python -m sin3dm_tpu_torch.cli.sample --tag T [--n_samples N] [--vox]
        [--use_ddim true --timestep_respacing ddim100] [--resize 1 1 1.5]
        [--reso 256 --texreso 2048 --n_faces 10000] [--pipeline_chunk K]
        [--inpaint true --inpaint_region x0 x1 y0 y1 z0 z1
         [--inpaint_feat F] [--is_mask_t0 true]] [--device cuda|cpu]
        [--sample_devices N | --sample_spatial N]

Draws triplane samples from the trained diffusion model and writes one
`feat.npz` per sample under `<tag>/<output>/<j:03d>/`.  By default each
sample is then decoded to a textured mesh (`object.obj`, `.mtl`, `.png`)
and `voxel.npz` (`generate`: chunks of `--pipeline_chunk` samples, each
chunk's meshes decoded after the next chunk's chain); with `--vox` to
`r{reso}_voxel.npz` only.  Runs on the card unless `--device cpu` is
given; asking for the card where there is none raises.

Numerics follow the JAX package's accelerator defaults: a bf16 UNet
torso with fp32 GroupNorm statistics (`SIN3DM_SAMPLE_DTYPE=train` keeps
the args.json dtype) and bf16 operands in the decode heads
(`SIN3DM_DECODE_BF16=0` keeps fp32).  `SIN3DM_STATS_CHAIN=1` and
`SIN3DM_FUSED_ACT=1` select the UNet's opt-in configurations
(`models/unet.py`).  The kernels' opt-outs, as in JAX:
`SIN3DM_FUSED_CONV=0` runs the UNet's 3x3 convs through cuDNN (the
training forward's convs) in place of K1, and then the opt-in
configurations do not apply; `SIN3DM_FUSED_HEADS=0` decodes with the
plain skip heads in place of K2 (`models/autoencoder.py`).  Neither is a
fallback: a kernel that fails raises.  `--inpaint` (DDIM only) keeps the
tag's own `feat.npz` (or `--inpaint_feat`) outside the box
`--inpaint_region` and regenerates inside it.

Several devices (0 = every card): `--sample_devices N` starts N ranks
(`parallel.spawn`; N at most --n_samples), rank r draws and decodes its
contiguous block of the samples, as one process would draw them.
`--sample_spatial N` shards every plane's dim 1 over N ranks
(`models/unet.py`; H and W must divide by 2N for the one down level)
and rank 0 saves and decodes.  Ranks share a card where there are fewer
cards than ranks.  The kernels and the geometry library are built before
the ranks start.  `main` returns the ranks' results beside the merged
paths.  Processes started by hand with `SIN3DM_DIST=1` and the
coordinator's variables (`parallel.maybe_initialize_distributed`) are
the ranks themselves: `--sample_devices 0` (or the group's size) samples
data-parallel over them, `--sample_spatial 0` (or its size) spatially;
another count above 1 is refused.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Optional, Tuple

import torch

from ..core import checkpoint as ckpt
from ..core import config as cfgmod
from ..core.triplane import Triplane, load_triplane_npz, save_triplane_npz
from ..parallel.mesh import shard_range


def resolve_device(name: str, index: int = 0) -> torch.device:
    """`cuda` (the default) or `cpu`.  Never falls back to the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unknown device {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return torch.device("cuda", index)


def _target_sizes(args) -> Tuple[int, int, int]:
    """(H, W, D): the tag's feat.npz planes times --resize."""
    feat = load_triplane_npz(cfgmod.encoding_feat_path(args.tag))
    return tuple(int(n * f) for n, f in zip(feat.sizes, args.resize))


def device_count(n: int, device: str) -> int:
    """A device-count flag: 0 means every card (the CPU is one device)."""
    if n:
        return n
    return torch.cuda.device_count() if device == "cuda" else 1


def multi_device(args, group_size: Optional[int] = None) -> Tuple[int, int]:
    """(data-parallel ranks, spatial ranks) from --sample_devices and
    --sample_spatial; ValueError for what JAX refuses: both at once, or
    planes whose H or W does not divide by 2^(levels - 1) x the spatial
    ranks.  In a bootstrapped group of `group_size` processes, 0 means
    the group and a count above 1 must be its size (ValueError)."""
    def count(flag: str) -> int:
        n = int(getattr(args, flag, 1))
        if group_size is None:
            return device_count(n, args.device)
        n = n or group_size
        if n > 1 and n != group_size:
            raise ValueError(
                f"--{flag} {n} in a bootstrapped group of {group_size} "
                f"processes: pass 0 or {group_size} (the group is the "
                "ranks)")
        return n

    n_dp, n_sp = count("sample_devices"), count("sample_spatial")
    if n_dp > 1 and n_sp > 1:
        raise ValueError("--sample_devices and --sample_spatial are "
                         "mutually exclusive")
    if n_sp > 1:
        H, W, _ = _target_sizes(args)
        m = 2 ** (len(cfgmod.unet_config_from_args(args).channel_mult) - 1)
        for name, dim in (("H", H), ("W", W)):
            if dim % (m * n_sp):
                raise ValueError(
                    f"--sample_spatial {n_sp} needs {name}={dim} divisible "
                    f"by {m * n_sp} (the down levels and even shards)")
    return n_dp, n_sp


def _unet_config(args, spatial_group=None):
    ucfg = cfgmod.unet_config_from_args(args)
    if spatial_group is not None:
        ucfg = ucfg._replace(spatial_group=spatial_group)
    fused = os.environ.get("SIN3DM_FUSED_CONV", "1") != "0"
    ucfg = ucfg._replace(fused_conv=fused)
    print("UNet 3x3 convs: " + ("K1" if fused else
                                "cuDNN (SIN3DM_FUSED_CONV=0)"))
    if os.environ.get("SIN3DM_SAMPLE_DTYPE", "bf16") == "bf16":
        ucfg = ucfg._replace(compute_dtype=torch.bfloat16, fast_norm=True)
        print("sampling in bfloat16 + fast_norm (set "
              "SIN3DM_SAMPLE_DTYPE=train for the args.json dtype)")
    return ucfg


def build_model(args, device: torch.device, spatial_group=None):
    """(model, tables, diffusion config): the EMA UNet as a
    `(x_t, t_model) -> Triplane` function on `device`, and the (respaced)
    schedule's tables there.  The EMA file is the npz container or a
    reference torch state dict (`compat/torch_import.py`).  With a
    `spatial_group` the model takes and gives this rank's plane shards."""
    from ..compat import torch_import as ti
    from ..compat.from_jax import unet_params_from_jax
    from ..diffusion.gaussian import tables_to_device
    from ..models.unet import unet_apply
    from ..ops import pack_params

    ucfg = _unet_config(args, spatial_group)
    model_path = cfgmod.diffusion_model_path(args.tag, args.ema_rate,
                                             args.diff_n_iters)
    if ti.is_torch_file(model_path):
        # a reference torch EMA file: --tag may name a published tag
        print(f"weight-transplanting reference torch ckpt: {model_path}")
        tree = ti.unet_params_from_state_dict(
            ti.load_torch_file(model_path), ucfg)
    else:
        tree, _ = ckpt.load_tree(model_path)
    params = pack_params(unet_params_from_jax(tree, device))

    respacing = args.timestep_respacing if args.use_ddim else ""
    sched = cfgmod.schedule_from_args(args, respacing=respacing)
    tables = tables_to_device(sched.tables_f32(), device)
    dcfg = cfgmod.diffusion_config_from_args(args)
    return (lambda x, t: unet_apply(params, ucfg, x, t)), tables, dcfg


def _inpaint_inputs(args, sizes, device):
    """(y0, mask) for --inpaint: y0 the known triplane with a batch dim
    of 1, mask 1 where it is kept (`region_keep_masks`)."""
    from ..diffusion.sampling import region_keep_masks
    if not args.use_ddim:
        raise ValueError("--inpaint requires --use_ddim")
    src = args.inpaint_feat or cfgmod.encoding_feat_path(args.tag)
    y0 = load_triplane_npz(src, device)
    if y0.sizes != sizes:
        raise ValueError(f"--inpaint y0 sizes {y0.sizes} != target {sizes}"
                         " (inpainting does not combine with --resize)")
    print(f"inpainting region {tuple(args.inpaint_region)} from {src}")
    return (y0.map(lambda p: p[None]),
            region_keep_masks(sizes, tuple(args.inpaint_region), device))


def _build_sampler(args, spatial_group=None):
    """(sampler, channels, sizes, device): the reverse chain over the EMA
    checkpoint, plane sizes from the tag's feat.npz times --resize; with
    a `spatial_group` the chain runs on this rank's rows of each plane
    and the sampler gives every rank the whole planes."""
    from ..diffusion.sampling import make_sampler

    device = resolve_device(args.device, int(getattr(args, "gpu_id", 0)))
    C = load_triplane_npz(cfgmod.encoding_feat_path(args.tag)).channels
    H, W, D = _target_sizes(args)
    print("H, W, D:", H, W, D)

    y0 = mask = None
    if getattr(args, "inpaint", False):
        y0, mask = _inpaint_inputs(args, (H, W, D), device)
    model, tables, dcfg = build_model(args, device, spatial_group)
    sampler = make_sampler(model, tables, dcfg, use_ddim=args.use_ddim,
                           device=device, y0=y0, mask=mask,
                           is_mask_t0=bool(getattr(args, "is_mask_t0",
                                                   False)),
                           spatial_group=spatial_group)
    return sampler, C, (H, W, D), device


def _save_samples(result_dir: str, samples: Triplane, start: int,
                  count: int):
    paths = []
    for j in range(count):
        path = os.path.join(result_dir, f"{start + j:03d}", "feat.npz")
        save_triplane_npz(path, samples.map(lambda p: p[j]))
        paths.append(path)
    return paths


def _block(args, group=None) -> Tuple[int, int]:
    """(first, count) of the samples this process draws: all of them, or
    with a data `group` this rank's contiguous block."""
    if group is None:
        return 0, args.n_samples
    return shard_range(args.n_samples, group.rank, group.size)


def sample_diffusion(args, group=None, spatial_group=None):
    """Draw the samples (with a data `group` this rank's block of them)
    and save one feat.npz each; returns the paths.  With a
    `spatial_group` every rank runs every chain and rank 0 saves (the
    other ranks return no path)."""
    sampler, C, sizes, _ = _build_sampler(args, spatial_group)
    result_dir = os.path.join(args.tag, args.output)
    os.makedirs(result_dir, exist_ok=True)
    seed = int(getattr(args, "seed", 0))
    first, count = _block(args, group)
    batch_size = max(1, min(args.diff_batch_size, count))
    saves = spatial_group is None or spatial_group.rank == 0
    paths = []
    for i in range(first, first + count, batch_size):
        bs = min(batch_size, first + count - i)
        samples = sampler(seed, i, bs, C, sizes)
        if saves:
            paths.extend(_save_samples(result_dir, samples, i, bs))
    return paths


def _make_trainer(args, device):
    from ..training.ae import AETrainer
    trainer = AETrainer(cfgmod.encoding_log_dir(args.tag),
                        cfgmod.ae_config_from_args(args), device,
                        cfgmod.ae_trainer_config_from_args(args))
    trainer.load_ckpt("final")
    return trainer


def _find_mtl(args):
    """The training mesh's .mtl (its scalar params go into each
    object.mtl) where `--copy_mtl` and the data path name one."""
    if not args.vox and args.copy_mtl and getattr(args, "data_path", None):
        cands = glob.glob(os.path.join(
            os.path.dirname(args.data_path), "mesh/*.mtl"))
        return cands[0] if cands else None
    return None


def decode(args, paths):
    """Decode saved feat.npz files: to voxel grids with --vox, else to
    textured meshes, several samples at once in threads (their host
    geometry overlaps; the trainer keeps their device dispatch apart)."""
    device = resolve_device(args.device, int(getattr(args, "gpu_id", 0)))
    trainer = _make_trainer(args, device)
    if args.vox:
        for p in paths:
            trainer.decode_voxel(os.path.dirname(p), load_triplane_npz(p),
                                 args.reso)
        return
    mtl_path = _find_mtl(args)
    kw = dict(n_faces=args.n_faces, texture_reso=args.texreso,
              save_highres_mesh=False, n_surf_pc=-1, mtl_path=mtl_path,
              file_format=args.file_format)
    workers = min(4, max(1, len(paths)), os.cpu_count() or 1)
    if workers == 1:
        trainer.decode_texmesh_many(
            [os.path.dirname(p) for p in paths],
            [load_triplane_npz(p) for p in paths], args.reso, **kw)
        return
    from concurrent.futures import ThreadPoolExecutor

    def decode_one(path):
        trainer.decode_texmesh(os.path.dirname(path),
                               load_triplane_npz(path), args.reso, **kw)

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(decode_one, paths))


def generate(args, group=None):
    """Sample and decode to meshes through the trainer's cross-chunk
    pipeline (`AETrainer.pipelined_generate`): chunks of --pipeline_chunk
    samples; a chunk's geo grids are queued after its chain, its meshes
    decoded after the next chunk's chain.  Sample j depends only on
    (--seed, j), whatever the chunking.  With a data `group`, this
    rank's block of the samples.  Returns (paths, the trainer's stage log, with
    each sample's share of its chunk's chain)."""
    sampler, C, sizes, device = _build_sampler(args)
    trainer = _make_trainer(args, device)
    trainer.stage_log = []
    mtl_path = _find_mtl(args)
    result_dir = os.path.join(args.tag, args.output)
    os.makedirs(result_dir, exist_ok=True)
    seed = int(getattr(args, "seed", 0))
    first, count = _block(args, group)
    end = first + count
    chunk = max(1, min(int(getattr(args, "pipeline_chunk", 1) or 1),
                       args.diff_batch_size, count))
    paths = []
    chain_seconds = {}

    def sample_chunk(i):
        t0 = time.perf_counter()
        samples = sampler(seed, i, min(chunk, end - i), C, sizes)
        _sync(device)
        chain_seconds[i] = time.perf_counter() - t0
        return samples

    def prepare_chunk(i, samples):
        bs = min(chunk, end - i)
        new = _save_samples(result_dir, samples, i, bs)
        paths.extend(new)
        dirs = [os.path.dirname(p) for p in new]
        for d in dirs:
            trainer.stage_log.append({"dir": d, "stage": "chain",
                                      "seconds": chain_seconds[i] / bs})
        return dirs, [samples.map(lambda p, j=j: p[j]) for j in range(bs)]

    trainer.pipelined_generate(
        range(first, end, chunk), sample_chunk, prepare_chunk,
        args.reso, n_faces=args.n_faces, texture_reso=args.texreso,
        save_highres_mesh=False, n_surf_pc=-1, mtl_path=mtl_path,
        file_format=args.file_format)
    return paths, trainer.stage_log


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, group=None, spatial_group=None) -> dict:
    """Sample and decode as the flags say, in this process: all samples,
    or with a data `group` this rank's block, or with a `spatial_group`
    every chain sharded and rank 0's decode.  With --vox returns
    {"paths", "sample_seconds", "decode_seconds"} (host clock, each phase
    ending in a device sync), else the mesh path's {"paths", "seconds",
    "stages"} (`generate`'s host seconds and per-sample stage log)."""
    device = resolve_device(args.device, int(getattr(args, "gpu_id", 0)))
    t0 = time.perf_counter()
    if not args.vox and spatial_group is None:
        paths, stages = generate(args, group)
        _sync(device)
        seconds = time.perf_counter() - t0
        print(f"generated {len(paths)} meshes in {seconds:.3f} s")
        return {"paths": paths, "seconds": seconds, "stages": stages}
    paths = sample_diffusion(args, group, spatial_group)
    _sync(device)
    t1 = time.perf_counter()
    if paths:
        decode(args, paths)
    _sync(device)
    t2 = time.perf_counter()
    print(f"sampled {len(paths)} in {t1 - t0:.3f} s, decoded in "
          f"{t2 - t1:.3f} s")
    if args.vox:
        return {"paths": paths, "sample_seconds": t1 - t0,
                "decode_seconds": t2 - t1}
    return {"paths": paths, "seconds": t2 - t0, "stages": [],
            "sample_seconds": t1 - t0}


def _rank(group, args, data_parallel: bool) -> dict:
    """One rank of `main`: `run` on this rank's device, with this
    process's kernel launches and collectives (all its own), its device
    and the group's backend added."""
    from ..ops.fused_conv import conv3x3_rollout
    from ..ops.fused_mlp import skip_mlp
    from ..parallel import mesh
    if group.device.type == "cuda":
        args.gpu_id = group.device.index
    out = run(args, group if data_parallel else None,
              None if data_parallel else group)
    out["launches"] = {"k1": conv3x3_rollout.launches,
                       "k1_forms": dict(conv3x3_rollout.form_launches),
                       "k2": skip_mlp.launches,
                       "k2_shapes": dict(skip_mlp.shape_launches)}
    out["collectives"] = dict(mesh.COUNTS)
    out["device"], out["backend"] = str(group.device), group.backend
    return out


def launch(args, n_dp: int, n_sp: int) -> dict:
    """Run `run` on several ranks (`parallel.spawn`), the kernels and the
    geometry library built here first.  Returns {"paths" (every rank's, in
    sample order), "seconds" (host clock around the ranks, their start
    included), "ranks" (each rank's `run` result with its "launches" and
    "collectives")}."""
    from ..parallel import spawn
    resolve_device(args.device, int(getattr(args, "gpu_id", 0)))
    n = n_dp if n_dp > 1 else n_sp
    if n_dp > 1 and n > args.n_samples:
        n = args.n_samples
        print(f"--sample_devices {n_dp}: {args.n_samples} samples take "
              f"{n} ranks")
    if args.device == "cuda":
        from ..ops import _build
        _build.build(["fused_conv", "fused_mlp"])
    if not args.vox:
        from ..geometry import native
        native.build()
    what = "data-parallel" if n_dp > 1 else "plane-spatial"
    print(f"sampling over {n} ranks ({what})")
    t0 = time.perf_counter()
    ranks = spawn(_rank, n, args, n_dp > 1, device=args.device)
    seconds = time.perf_counter() - t0
    return {"paths": [p for r in ranks for p in r["paths"]],
            "seconds": seconds, "ranks": ranks}


def main(argv=None):
    """Sample and decode as the flags say (`run`), on several ranks where
    --sample_devices or --sample_spatial asks for them (`launch`).  Under
    the `SIN3DM_DIST` bootstrap this process is one rank of the group
    (`_rank`: data-parallel or spatial over the whole group; with both
    counts at 1 it samples alone on its card, as each JAX process does)."""
    from ..parallel import maybe_initialize_distributed
    from ..parallel.mesh import close_group
    args = cfgmod.sample_args(argv)
    group = maybe_initialize_distributed(args.device)
    if group is not None:
        n_dp, n_sp = multi_device(args, group.size)
        if n_dp > 1 or n_sp > 1:
            out = _rank(group, args, n_dp > 1)
        else:
            args.gpu_id = group.device.index or 0
            out = run(args)
        close_group(group)
        return out
    n_dp, n_sp = multi_device(args)
    if n_dp > 1 or n_sp > 1:
        return launch(args, n_dp, n_sp)
    return run(args)


if __name__ == "__main__":
    main()
