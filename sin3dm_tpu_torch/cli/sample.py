"""Sampling CLI of the port (counterpart of `sin3dm_tpu/cli/sample.py`):

    python -m sin3dm_tpu_torch.cli.sample --tag T [--n_samples N] [--vox]
        [--use_ddim true --timestep_respacing ddim100] [--resize 1 1 1.5]
        [--reso 256 --texreso 2048 --n_faces 10000] [--pipeline_chunk K]
        [--inpaint true --inpaint_region x0 x1 y0 y1 z0 z1
         [--inpaint_feat F] [--is_mask_t0 true]] [--device cuda|cpu]

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
(`models/unet.py`).  `--inpaint` (DDIM only) keeps the tag's own
`feat.npz` (or `--inpaint_feat`) outside the box `--inpaint_region` and
regenerates inside it.  Data-parallel and spatial sampling are later
slices (multi-device).
"""

from __future__ import annotations

import glob
import os
import time

import torch

from ..core import checkpoint as ckpt
from ..core import config as cfgmod
from ..core.triplane import Triplane, load_triplane_npz, save_triplane_npz


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


def _check_slice(args) -> None:
    where = "not ported yet (ROADMAP.md, A: multi-device)"
    if int(getattr(args, "sample_devices", 1)) != 1:
        raise NotImplementedError(
            f"--sample_devices: data-parallel sampling is {where}")
    if int(getattr(args, "sample_spatial", 1)) != 1:
        raise NotImplementedError(
            f"--sample_spatial: plane-spatial sharding is {where}")


def _unet_config(args):
    ucfg = cfgmod.unet_config_from_args(args)
    if os.environ.get("SIN3DM_SAMPLE_DTYPE", "bf16") == "bf16":
        ucfg = ucfg._replace(compute_dtype=torch.bfloat16, fast_norm=True)
        print("sampling in bfloat16 + fast_norm (set "
              "SIN3DM_SAMPLE_DTYPE=train for the args.json dtype)")
    return ucfg


def build_model(args, device: torch.device):
    """(model, tables, diffusion config): the EMA UNet as a
    `(x_t, t_model) -> Triplane` function on `device`, and the (respaced)
    schedule's tables there.  The EMA file is the npz container or a
    reference torch state dict (`compat/torch_import.py`)."""
    from ..compat import torch_import as ti
    from ..compat.from_jax import unet_params_from_jax
    from ..diffusion.gaussian import tables_to_device
    from ..models.unet import unet_apply
    from ..ops import pack_params

    ucfg = _unet_config(args)
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


def _build_sampler(args):
    """(sampler, channels, sizes, device): the reverse chain over the EMA
    checkpoint, plane sizes from the tag's feat.npz times --resize."""
    from ..diffusion.sampling import make_sampler

    _check_slice(args)
    device = resolve_device(args.device, int(getattr(args, "gpu_id", 0)))
    feat = load_triplane_npz(cfgmod.encoding_feat_path(args.tag))
    C = feat.channels
    H, W, D = feat.sizes
    H = int(H * args.resize[0])
    W = int(W * args.resize[1])
    D = int(D * args.resize[2])
    print("H, W, D:", H, W, D)

    y0 = mask = None
    if getattr(args, "inpaint", False):
        y0, mask = _inpaint_inputs(args, (H, W, D), device)
    model, tables, dcfg = build_model(args, device)
    sampler = make_sampler(model, tables, dcfg, use_ddim=args.use_ddim,
                           device=device, y0=y0, mask=mask,
                           is_mask_t0=bool(getattr(args, "is_mask_t0",
                                                   False)))
    return sampler, C, (H, W, D), device


def _save_samples(result_dir: str, samples: Triplane, start: int,
                  count: int):
    paths = []
    for j in range(count):
        path = os.path.join(result_dir, f"{start + j:03d}", "feat.npz")
        save_triplane_npz(path, samples.map(lambda p: p[j]))
        paths.append(path)
    return paths


def sample_diffusion(args):
    """Draw all samples and save one feat.npz each; returns the paths."""
    sampler, C, sizes, _ = _build_sampler(args)
    result_dir = os.path.join(args.tag, args.output)
    os.makedirs(result_dir, exist_ok=True)
    seed = int(getattr(args, "seed", 0))
    batch_size = max(1, min(args.diff_batch_size, args.n_samples))
    paths = []
    for i in range(0, args.n_samples, batch_size):
        bs = min(batch_size, args.n_samples - i)
        samples = sampler(seed, i, bs, C, sizes)
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


def generate(args):
    """Sample and decode to meshes through the trainer's cross-chunk
    pipeline (`AETrainer.pipelined_generate`): chunks of --pipeline_chunk
    samples; a chunk's geo grids are queued after its chain, its meshes
    decoded after the next chunk's chain.  Sample j depends only on
    (--seed, j), whatever the chunking.  Returns (paths, the trainer's
    stage log, with each sample's share of its chunk's chain)."""
    sampler, C, sizes, device = _build_sampler(args)
    trainer = _make_trainer(args, device)
    trainer.stage_log = []
    mtl_path = _find_mtl(args)
    result_dir = os.path.join(args.tag, args.output)
    os.makedirs(result_dir, exist_ok=True)
    seed = int(getattr(args, "seed", 0))
    chunk = max(1, min(int(getattr(args, "pipeline_chunk", 1) or 1),
                       args.diff_batch_size, args.n_samples))
    paths = []
    chain_seconds = {}

    def sample_chunk(i):
        t0 = time.perf_counter()
        samples = sampler(seed, i, min(chunk, args.n_samples - i), C, sizes)
        _sync(device)
        chain_seconds[i] = time.perf_counter() - t0
        return samples

    def prepare_chunk(i, samples):
        bs = min(chunk, args.n_samples - i)
        new = _save_samples(result_dir, samples, i, bs)
        paths.extend(new)
        dirs = [os.path.dirname(p) for p in new]
        for d in dirs:
            trainer.stage_log.append({"dir": d, "stage": "chain",
                                      "seconds": chain_seconds[i] / bs})
        return dirs, [samples.map(lambda p, j=j: p[j]) for j in range(bs)]

    trainer.pipelined_generate(
        range(0, args.n_samples, chunk), sample_chunk, prepare_chunk,
        args.reso, n_faces=args.n_faces, texture_reso=args.texreso,
        save_highres_mesh=False, n_surf_pc=-1, mtl_path=mtl_path,
        file_format=args.file_format)
    return paths, trainer.stage_log


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """With --vox: sample, then decode to voxel grids; returns {"paths",
    "sample_seconds", "decode_seconds"} (host clock, each phase ending in a
    device sync).  Else the mesh path (`generate`); returns {"paths",
    "seconds", "stages"}: its host seconds and the per-sample stage log."""
    args = cfgmod.sample_args(argv)
    device = resolve_device(args.device, int(getattr(args, "gpu_id", 0)))
    t0 = time.perf_counter()
    if not args.vox:
        paths, stages = generate(args)
        _sync(device)
        seconds = time.perf_counter() - t0
        print(f"generated {len(paths)} meshes in {seconds:.3f} s")
        return {"paths": paths, "seconds": seconds, "stages": stages}
    paths = sample_diffusion(args)
    _sync(device)
    t1 = time.perf_counter()
    decode(args, paths)
    _sync(device)
    t2 = time.perf_counter()
    print(f"sampled {len(paths)} in {t1 - t0:.3f} s, decoded in "
          f"{t2 - t1:.3f} s")
    return {"paths": paths, "sample_seconds": t1 - t0,
            "decode_seconds": t2 - t1}


if __name__ == "__main__":
    main()
