"""Training CLI of the port (counterpart of `sin3dm_tpu/cli/train.py`):

    python -m sin3dm_tpu_torch.cli.train --tag T --enc_log E [flags]
        [--device cuda|cpu]

Trains the triplane diffusion UNet on the encoding log E's `feat.npz`
(the batch is that one triplane, repeated `--diff_batch_size` times) and
writes `T/diffusion/args.json`, `ema_{rate}_{step:06d}.pt` and
`opt{step:06d}.pt` in the JAX package's container and leaf layout; the
port's sampler and JAX's `load_pytree` both read them.  `T/encoding`
links to E.  Runs on the card unless `--device cpu` is given.  The
autoencoder stage (no `--enc_log`, or `--only_enc`) is a later slice.

Precision: `main` lets cuDNN convolutions and matmuls use TF32 for fp32
operands while it trains (and restores the flags after), the card's
counterpart of the TPU's default single-pass precision for fp32
operands, under which the committed checkpoint was trained.  The library
functions below the CLI touch no such global flag: tests and
`chip_smoke.py` choose.
"""

from __future__ import annotations

import os

import torch

from ..core import config as cfgmod
from ..core import logger
from .sample import resolve_device

_LATER = "not ported yet (ROADMAP.md, A"


def train_ae(args):
    raise NotImplementedError(
        f"autoencoder training is {_LATER}: AE training); pass --enc_log "
        "with an encoding log that holds feat.npz")


def train_diffusion(args):
    """Train the UNet on the tag's feat.npz; returns the loop."""
    from ..core.triplane import Triplane, load_triplane_npz
    from ..diffusion.gaussian import tables_to_device
    from ..models.unet import init_unet, unet_train_apply
    from ..training.diffusion import DiffusionTrainLoop

    n_dev = int(getattr(args, "n_devices", 0))
    if n_dev > 1:
        raise NotImplementedError(
            f"--n_devices {n_dev}: data-parallel training is {_LATER}: "
            "multi-device)")
    device = resolve_device(args.device, int(getattr(args, "gpu_id", 0)))
    print("[Training diffusion]")
    log_dir = cfgmod.diffusion_log_dir(args.tag)
    logger.configure(dir=log_dir)

    logger.log("creating data loader...")
    feat = load_triplane_npz(cfgmod.encoding_feat_path(args.tag), device)
    B = args.diff_batch_size
    batch = Triplane(*[p[None].expand(B, *p.shape).contiguous()
                       for p in feat])

    logger.log("creating model and diffusion...")
    ucfg = cfgmod.unet_config_from_args(args)
    params = init_unet(torch.Generator(device=device).manual_seed(0), ucfg)
    tables = tables_to_device(cfgmod.schedule_from_args(args).tables_f32(),
                              device)
    dcfg = cfgmod.diffusion_config_from_args(args)
    tcfg = cfgmod.diffusion_trainer_config_from_args(args)

    logger.log("training...")
    loop = DiffusionTrainLoop(
        lambda p, x, t: unet_train_apply(p, ucfg, x, t),
        params, tables, dcfg, tcfg, log_dir, batch,
        sample_hook=_make_sample_viz_hook(ucfg, feat.sizes),
        resume=bool(getattr(args, "resume", 0)))
    if getattr(args, "profile", 0):
        from ..core.profiling import maybe_trace
        with maybe_trace(log_dir, True):
            loop.run(1, n_steps=loop.state.step + 50)
    loop.run(1)
    return loop


def _make_sample_viz_hook(ucfg, sizes):
    """Every 5000 steps draw 2 DDPM samples from the current parameters
    and log plane-0 heatmaps to TensorBoard; inert without
    `tensorboardX`."""
    from ..core.rng import draw_scalar_field2D
    from ..diffusion.sampling import make_sampler
    from ..models.unet import unet_apply

    def hook(loop, step):
        if loop.tb is None:
            return
        params = loop.state.tree(loop.state.flat)
        sample = make_sampler(lambda x, t: unet_apply(params, ucfg, x, t),
                              loop.tables, loop.dcfg, clip_denoised=False,
                              device=loop.batch.xy.device)
        xy = sample(step + 7, 0, 2, ucfg.in_channels, sizes).xy.cpu().numpy()
        C = xy.shape[-1]
        for i in range(2):
            for c in (0, C // 2):
                loop.tb.add_figure(f"sample{i}_c{c}",
                                   draw_scalar_field2D(xy[i, :, :, c]),
                                   global_step=step)
        loop.tb.add_figure(
            "data_c0", draw_scalar_field2D(
                loop.batch.xy[0, :, :, 0].cpu().numpy()), global_step=step)
    return hook


def main(argv=None):
    """Train as the flags say, with TF32 on for the call (the flags are
    restored after it); returns the diffusion loop."""
    from ..core.rng import seed_all
    args = cfgmod.train_args(argv)
    seed_all(0)
    if args.only_enc or args.enc_log is None:
        train_ae(args)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return train_diffusion(args)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


if __name__ == "__main__":
    main()
