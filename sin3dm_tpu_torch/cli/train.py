"""Training CLI of the port (counterpart of `sin3dm_tpu/cli/train.py`):

    python -m sin3dm_tpu_torch.cli.train --tag T --data_path D.npz [flags]
        [--device cuda|cpu]

Stage 1 fits the triplane autoencoder to the mesh sampler's npz D and
writes `T/encoding/args.json`, `ckpt_latest.pth` (on the save cadence),
`ckpt_final.pth` (params, optimiser state and step), `eval_stat.json`,
`feat.npz` (the shape's triplane) and the reconstruction mesh `rec/`;
stage 2 trains the triplane diffusion UNet on that `feat.npz` (the batch
is the one triplane, repeated `--diff_batch_size` times) and writes
`T/diffusion/args.json`, `ema_{rate}_{step:06d}.pt` and
`opt{step:06d}.pt`.  Every file is in the JAX package's container and
leaf layout; the port's sampler and JAX's loaders both read them.
`--only_enc` stops after stage 1; `--enc_log E` skips it and trains on
E's `feat.npz` (`T/encoding` links to E).  Runs on the card unless
`--device cpu` is given.

Precision: `main` lets cuDNN convolutions and matmuls use TF32 for fp32
operands while it trains, both stages (and restores the flags after),
the card's counterpart of the TPU's default single-pass precision for
fp32 operands, under which the committed checkpoints were trained.  The
library functions below the CLI touch no such global flag: tests and
`chip_smoke.py` choose.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from ..core import config as cfgmod
from ..core import logger
from .sample import resolve_device

_LATER = "not ported yet (ROADMAP.md, A"


def _refuse_multi_device(args, what: str) -> None:
    n_dev = int(getattr(args, "n_devices", 0))
    if n_dev > 1:
        raise NotImplementedError(
            f"--n_devices {n_dev}: data-parallel {what} is {_LATER}: "
            "multi-device)")


def train_ae(args):
    """Fit the AE to `--data_path`, write its checkpoints, `feat.npz` and
    the `rec` mesh; returns the trainer."""
    from ..core.triplane import save_triplane_npz
    from ..training.ae import AETrainer

    _refuse_multi_device(args, "AE training")
    if args.enc_log is not None:
        raise ValueError(
            "--enc_log reuses a trained encoding: the AE stage (--only_enc) "
            "would write over it")
    if args.data_path is None:
        raise ValueError("the AE stage needs --data_path (the mesh "
                         "sampler's npz)")
    device = resolve_device(args.device, int(getattr(args, "gpu_id", 0)))
    print("[Training autoencoder]")
    log_dir = cfgmod.encoding_log_dir(args.tag)
    logger.configure(dir=log_dir)
    trainer = AETrainer(log_dir, cfgmod.ae_config_from_args(args), device,
                        cfgmod.ae_trainer_config_from_args(args))
    trainer.load_data(args.data_path)
    trainer.train(0, log_every=args.log_interval,
                  resume=bool(getattr(args, "resume", 0)))
    feat = trainer.encode()
    print("feat maps shape:", [tuple(p.shape) for p in feat])
    save_triplane_npz(cfgmod.encoding_feat_path(args.tag), feat)
    # the reconstruction's sanity mesh
    trainer.decode_texmesh(os.path.join(log_dir, "rec"), feat,
                           args.rec_reso)
    return trainer


def train_diffusion(args):
    """Train the UNet on the tag's feat.npz; returns the loop."""
    from ..core.triplane import Triplane, load_triplane_npz
    from ..diffusion.gaussian import tables_to_device
    from ..models.unet import init_unet, unet_train_apply
    from ..training.diffusion import DiffusionTrainLoop

    _refuse_multi_device(args, "training")
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


class TrainResult(NamedTuple):
    """What `main` trained: the AE trainer (None with --enc_log) and the
    diffusion loop (None with --only_enc)."""
    ae: Optional[object]
    diffusion: Optional[object]


def main(argv=None) -> TrainResult:
    """Train as the flags say, with TF32 on for the call (the flags are
    restored after it): the AE unless --enc_log names a trained one, then
    diffusion unless --only_enc."""
    from ..core.rng import seed_all
    args = cfgmod.train_args(argv)
    seed_all(0)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        trainer = loop = None
        if args.only_enc or args.enc_log is None:
            trainer = train_ae(args)
        if not args.only_enc:
            loop = train_diffusion(args)
        return TrainResult(trainer, loop)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


if __name__ == "__main__":
    main()
