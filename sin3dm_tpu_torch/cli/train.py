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

Several devices, as JAX's CLI: the AE stage runs on one device in this
process; diffusion then trains data-parallel over `--n_devices` ranks
(0, the default, is every card; `parallel.spawn` starts them, sharing a
card where there are fewer cards than ranks) where the batch divides
over them, else on this one device, which it prints.  Processes started
by hand with `SIN3DM_DIST=1` and the coordinator's variables
(`parallel.maybe_initialize_distributed`) are the ranks themselves: rank
0 runs the AE stage while the others wait, then all train diffusion.

Precision: `main` lets cuDNN convolutions and matmuls use TF32 for fp32
operands while it trains, both stages (and restores the flags after),
the card's counterpart of the TPU's default single-pass precision for
fp32 operands, under which the committed checkpoints were trained.

Determinism: `main` trains with deterministic algorithms only, both
stages and on every rank (`core.rng.deterministic_algorithms`, restored
after), so one command repeats bit for bit on the same cards, as the
JAX package does by construction and the reference's `seed_all` set
cuDNN to.  There is no switch to turn it off.  It sets
`CUBLAS_WORKSPACE_CONFIG` (":4096:8") where unset, which takes only
before the process's first cuBLAS call: a program that calls `main` after
its own matmuls sets it at its start.

The library functions below the CLI touch no such global flag: tests
and `chip_smoke.py` choose.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from ..core import config as cfgmod
from ..core import logger
from .sample import device_count, resolve_device


def train_ae(args):
    """Fit the AE to `--data_path`, write its checkpoints, `feat.npz` and
    the `rec` mesh; returns the trainer."""
    from ..core.triplane import save_triplane_npz
    from ..training.ae import AETrainer

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


def train_diffusion(args, group=None):
    """Train the UNet on the tag's feat.npz; returns the loop.  With a data
    `group` this rank holds its share of the batch (rank 0 logs and
    writes the checkpoints)."""
    from ..core.triplane import Triplane, load_triplane_npz
    from ..diffusion.gaussian import tables_to_device
    from ..models.unet import init_unet, unet_train_apply
    from ..training.diffusion import DiffusionTrainLoop

    device = (group.device if group is not None else
              resolve_device(args.device, int(getattr(args, "gpu_id", 0))))
    main_rank = group is None or group.rank == 0
    if main_rank:
        print("[Training diffusion]")
    log_dir = cfgmod.diffusion_log_dir(args.tag)
    logger.configure(dir=log_dir, format_strs=None if main_rank else [])

    logger.log("creating data loader...")
    feat = load_triplane_npz(cfgmod.encoding_feat_path(args.tag), device)
    B = args.diff_batch_size
    if group is not None:
        if B % group.size:
            raise ValueError(f"--diff_batch_size {B} does not divide over "
                             f"{group.size} ranks")
        B //= group.size
        logger.log(f"data-parallel over {group.size} ranks, {B} each")
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
        resume=bool(getattr(args, "resume", 0)), group=group)
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
    """What `main` trained: the AE trainer (None with --enc_log, and on
    the ranks other than 0 of a bootstrapped group) and the diffusion
    loop (None with --only_enc; over spawned ranks, their
    `_diffusion_rank` summaries in rank order)."""
    ae: Optional[object]
    diffusion: Optional[object]


def _tf32(on: bool):
    """Set cuDNN's and matmul's TF32 flags; returns the old pair."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    return old


def _diffusion_rank(group, args) -> dict:
    """One spawned rank of diffusion training: {"rank", "step", the
    parameters' sha256 (equal on every rank)}."""
    import hashlib
    from ..core.rng import deterministic_algorithms, seed_all
    seed_all(0)
    _tf32(True)
    with deterministic_algorithms():
        loop = train_diffusion(args, group)
    st = loop.state
    return {"rank": group.rank, "step": st.step, "params_sha256":
            hashlib.sha256(st.flat.detach().cpu().numpy().tobytes())
            .hexdigest()}


def diffusion_ranks(args) -> int:
    """How many ranks train diffusion: --n_devices (0 = every card) where
    the batch divides over them, else 1, with the reason printed."""
    n = device_count(int(getattr(args, "n_devices", 0)), args.device)
    if n > 1 and args.diff_batch_size % n:
        print(f"--n_devices {n}: --diff_batch_size {args.diff_batch_size} "
              "does not divide over the ranks; training on one device")
        return 1
    return n


def main(argv=None) -> TrainResult:
    """Train as the flags say, with TF32 on and deterministic algorithms
    only for the call (the flags are restored after it): the AE unless
    --enc_log names a trained one, then diffusion unless --only_enc, on
    several ranks as `--n_devices` or the `SIN3DM_DIST` bootstrap says
    (see the module doc)."""
    from ..core.rng import deterministic_algorithms, seed_all
    from ..parallel import maybe_initialize_distributed, spawn
    from ..parallel.mesh import barrier, close_group
    args = cfgmod.train_args(argv)
    with deterministic_algorithms():
        group = maybe_initialize_distributed(args.device)
        seed_all(0)
        flags = _tf32(True)
        try:
            trainer = loop = None
            if args.only_enc or args.enc_log is None:
                if group is None or group.rank == 0:
                    if group is not None:
                        args.gpu_id = group.device.index or 0
                    trainer = train_ae(args)
                if group is not None:
                    barrier(group)
            if not args.only_enc:
                n = 1 if group is not None else diffusion_ranks(args)
                if n > 1:
                    resolve_device(args.device,
                                   int(getattr(args, "gpu_id", 0)))
                    loop = spawn(_diffusion_rank, n, args,
                                 device=args.device)
                else:
                    loop = train_diffusion(args, group)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        if group is not None:
            close_group(group)
    return TrainResult(trainer, loop)


if __name__ == "__main__":
    main()
