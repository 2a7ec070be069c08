"""Flags and `args.json` handling of the sampling entry point
(counterpart of `sin3dm_tpu/core/config.py`): the same groups, flag
names and defaults, and the same contract that `sample` reloads both
stages' `args.json` (overriding CLI values except `timestep_respacing`).
The port adds `--device {cuda,cpu}`, `cuda` by default.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def add_base_options(parser) -> None:
    g = parser.add_argument_group("base")
    g.add_argument("--tag", type=str, required=True,
                   help="checkpoint directory")
    g.add_argument("-g", "--gpu_id", default=0, type=int,
                   help="CUDA device index")
    g.add_argument("--only_enc", action="store_true")
    g.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="run on the card (default) or, when asked, on "
                        "the CPU")


def add_sampling_options(parser) -> None:
    g = parser.add_argument_group("sampling")
    g.add_argument("--n_samples", type=int, default=1)
    g.add_argument("--input", type=str, default=None)
    g.add_argument("--output", type=str, default="results")
    g.add_argument("--resize", default=(1, 1, 1), type=float, nargs=3)
    g.add_argument("--use_ddim", type=str2bool, default=False)
    g.add_argument("--timestep_respacing", type=str, default="")
    g.add_argument("--app", type=str, default="generate")
    g.add_argument("--reso", type=int, default=256)
    g.add_argument("--n_faces", type=int, default=10000)
    g.add_argument("--texreso", type=int, default=2048)
    g.add_argument("--vox", action="store_true")
    g.add_argument("--copy_mtl", type=str2bool, default=True)
    g.add_argument("--file_format", type=str, default="obj",
                   choices=["obj", "glb"])
    g.add_argument("--seed", type=int, default=0,
                   help="sampling seed: sample j depends only on "
                        "(seed, j)")
    g.add_argument("--pipeline_chunk", type=int, default=1,
                   help="samples per sample+decode chunk (mesh path)")
    g.add_argument("--sample_devices", type=int, default=1,
                   help="data-parallel devices for the reverse chain "
                        "(1 = single device)")
    g.add_argument("--sample_spatial", type=int, default=1,
                   help="plane-spatial sharding devices (1 = off)")
    g.add_argument("--inpaint", type=str2bool, default=False,
                   help="masked generation (DDIM only)")
    g.add_argument("--inpaint_feat", type=str, default=None)
    g.add_argument("--inpaint_region", type=float, nargs=6,
                   default=(0.25, 0.75, 0.25, 0.75, 0.0, 1.0),
                   metavar=("X0", "X1", "Y0", "Y1", "Z0", "Z1"))
    g.add_argument("--is_mask_t0", type=str2bool, default=False)


# ---------------------------------------------------------------------------
# Path contracts
# ---------------------------------------------------------------------------

def encoding_log_dir(tag: str) -> str:
    return os.path.join(tag, "encoding")


def diffusion_log_dir(tag: str) -> str:
    return os.path.join(tag, "diffusion")


def encoding_feat_path(tag: str) -> str:
    return os.path.join(tag, "encoding/feat.npz")


def diffusion_model_path(tag: str, ema: float, step: int) -> str:
    return os.path.join(tag, f"diffusion/ema_{ema}_{step:06d}.pt")


def load_and_overwrite_args(args, path: str,
                            ignore_keys: Optional[List[str]] = None):
    with open(path) as f:
        saved = json.load(f)
    for k, v in saved.items():
        if not ignore_keys or k not in ignore_keys:
            setattr(args, k, v)
    return args


def sample_args(argv=None):
    parser = argparse.ArgumentParser()
    add_base_options(parser)
    add_sampling_options(parser)
    args = parser.parse_args(argv)
    if not os.path.exists(args.tag):
        raise ValueError(f"Experiment log does not exist: {args.tag}")
    load_and_overwrite_args(
        args, os.path.join(encoding_log_dir(args.tag), "args.json"))
    load_and_overwrite_args(
        args, os.path.join(diffusion_log_dir(args.tag), "args.json"),
        ignore_keys=["timestep_respacing"])
    return args


# ---------------------------------------------------------------------------
# args -> configs
# ---------------------------------------------------------------------------

def ae_config_from_args(args):
    from ..models.autoencoder import AEConfig
    return AEConfig(
        data_type=args.data_type,
        enc_net_type=args.enc_net_type,
        fdim_geo=args.fdim_geo,
        fdim_tex=args.fdim_tex,
        fdim_up=args.fdim_up,
        hidden_dim=args.hidden_dim,
        n_hidden_layers=args.n_hidden_layers,
        posenc=getattr(args, "posenc", 0))


def ae_trainer_config_from_args(args):
    """The decode's trainer settings; the texel wire stays at its default
    (SIN3DM_TEXEL_WIRE selects another)."""
    from ..training.ae import AETrainerConfig
    return AETrainerConfig(sdf_renorm=bool(args.sdf_renorm))


def unet_config_from_args(args):
    import torch
    from ..models.unet import UNetConfig
    cm = args.channel_mult
    if isinstance(cm, str):
        cm = tuple(int(x) for x in cm.split(","))
    return UNetConfig(
        in_channels=args.in_channels,
        model_channels=args.model_channels,
        out_channels=args.out_channels,
        num_res_blocks=args.num_res_blocks,
        dropout=args.dropout,
        channel_mult=tuple(cm),
        use_scale_shift_norm=args.use_scale_shift_norm,
        rollout=(args.diff_net_type != "unet_raw"),
        compute_dtype=torch.bfloat16 if args.use_fp16 else torch.float32,
        fast_norm=bool(args.use_fp16))


def diffusion_config_from_args(args):
    from ..diffusion.gaussian import DiffusionConfig, MeanType, VarType
    if args.use_kl:
        raise NotImplementedError(
            "--use_kl is not supported (dead code in the reference)")
    return DiffusionConfig(
        mean_type=(MeanType.START_X if args.predict_xstart
                   else MeanType.EPSILON),
        var_type=(VarType.LEARNED_RANGE if args.learn_sigma
                  else VarType.FIXED_LARGE),
        rescale_timesteps=args.rescale_timesteps,
        original_num_steps=args.steps)


def schedule_from_args(args, respacing: Optional[str] = None):
    from ..diffusion.schedule import make_schedule
    if respacing is None:
        respacing = getattr(args, "timestep_respacing", "")
    return make_schedule(args.noise_schedule, args.steps, respacing)
