"""Flags and `args.json` handling of the training and sampling entry
points (counterpart of `sin3dm_tpu/core/config.py`): the same groups
(base, encoding, diffusion, sampling), flag names and defaults; `train`
writes each stage's `args.json`, and `sample` reloads both (overriding
CLI values except `timestep_respacing`).  The port adds `--device
{cuda,cpu}`, `cuda` by default.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional


def diffusion_defaults() -> Dict:
    return dict(
        learn_sigma=False,
        steps=1000,
        noise_schedule="linear",
        timestep_respacing="",
        use_kl=False,
        predict_xstart=True,
        rescale_timesteps=False,
        rescale_learned_sigmas=False,
    )


def diffusion_model_defaults() -> Dict:
    return dict(
        in_channels=12,
        model_channels=64,
        out_channels=12,
        num_res_blocks=1,
        dropout=0,
        channel_mult="1,2",
        use_checkpoint=False,
        use_fp16=False,          # selects bfloat16 compute
        use_scale_shift_norm=True,
    )


def _add_dict(group, defaults: Dict) -> None:
    for k, v in defaults.items():
        t = type(v)
        if v is None:
            t = str
        elif isinstance(v, bool):
            t = str2bool
        group.add_argument(f"--{k}", default=v, type=t)


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


def add_encoding_training_options(parser) -> None:
    g = parser.add_argument_group("encoding")
    g.add_argument("--data_path", type=str)
    g.add_argument("--enc_batch_size", type=int, default=65536)
    g.add_argument("--fm_reso", type=int, default=128)
    g.add_argument("--sdf_renorm", type=int, default=0)
    g.add_argument("--data_type", type=str, default="sdftex",
                   choices=["sdf", "sdftex", "sdfpbr"])
    g.add_argument("--enc_net_type", type=str, default="skip")
    g.add_argument("-fdg", "--fdim_geo", type=int, default=4)
    g.add_argument("-fdt", "--fdim_tex", type=int, default=8)
    g.add_argument("-fdup", "--fdim_up", type=int, default=64)
    g.add_argument("-hd", "--hidden_dim", type=int, default=256)
    g.add_argument("-nh", "--n_hidden_layers", type=int, default=4)
    g.add_argument("--enc_n_iters", type=int, default=25000)
    g.add_argument("--enc_lr", type=float, default=5e-3)
    g.add_argument("--enc_lr_decay", type=float, default=0.1)
    g.add_argument("--enc_lr_split", type=float, default=0.2)
    g.add_argument("--vol_ratio", type=float, default=0.1)
    g.add_argument("--tex_threshold_ratio", type=float, default=0.999)
    g.add_argument("--tex_weight", type=float, default=1.0)
    g.add_argument("--sdf_loss", type=str, default="weightedl1",
                   choices=["l1", "weightedl1"])
    g.add_argument("--tex_loss", type=str, default="l1",
                   choices=["l1", "l2", "huber"])
    g.add_argument("--rec_reso", type=int, default=256,
                   help="resolution of the post-train reconstruction mesh")


def add_diffusion_training_options(parser) -> None:
    g = parser.add_argument_group("diffusion")
    g.add_argument("--enc_log", type=str, default=None,
                   help="reuse an existing encoding log dir")
    g.add_argument("--diff_batch_size", type=int, default=32)
    g.add_argument("--diff_net_type", type=str, default="unet_small")
    g.add_argument("--diff_lr", type=float, default=5e-4)
    g.add_argument("--diff_n_iters", type=int, default=25000)
    g.add_argument("--schedule_sampler", type=str, default="uniform")
    g.add_argument("--ema_rate", type=float, default=0.9999)
    g.add_argument("--weight_decay", type=float, default=0.0)
    g.add_argument("--log_interval", type=int, default=100)
    g.add_argument("--save_interval", type=int, default=25000)
    g.add_argument("--n_devices", type=int, default=0,
                   help="data-parallel devices (0 or 1: this one card)")
    g.add_argument("--resume", type=int, default=0,
                   help="resume diffusion training from the latest "
                        "EMA/opt pair")
    g.add_argument("--profile", type=int, default=0,
                   help="trace the first 50 diffusion steps with "
                        "torch.profiler into the log dir")
    g.add_argument("--steps_per_call", type=int, default=1,
                   help="train steps per call of the step function")
    _add_dict(g, diffusion_defaults())
    _add_dict(g, diffusion_model_defaults())


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


def _group_dict(parser, args, group_name: str) -> Dict:
    for group in parser._action_groups:
        if group.title == group_name:
            return {a.dest: getattr(args, a.dest, None)
                    for a in group._group_actions}
    raise ValueError(f"group {group_name} not found")


def train_args(argv=None):
    """Parse the training flags, write `{tag}/encoding/args.json` (or,
    with `--enc_log`, load that log's and link it as `{tag}/encoding`),
    derive in/out_channels (doubled output under learn_sigma) and write
    `{tag}/diffusion/args.json`."""
    parser = argparse.ArgumentParser()
    add_base_options(parser)
    add_encoding_training_options(parser)
    add_diffusion_training_options(parser)
    args = parser.parse_args(argv)
    os.makedirs(args.tag, exist_ok=True)
    enc_dir = encoding_log_dir(args.tag)
    diff_dir = diffusion_log_dir(args.tag)
    if args.enc_log is not None:
        load_and_overwrite_args(args, os.path.join(args.enc_log, "args.json"))
        if not os.path.exists(enc_dir):
            try:
                os.symlink(os.path.abspath(args.enc_log), enc_dir)
            except FileExistsError:     # another rank of the group made it
                pass
    else:
        os.makedirs(enc_dir, exist_ok=True)
        with open(os.path.join(enc_dir, "args.json"), "w") as f:
            json.dump(_group_dict(parser, args, "encoding"), f, indent=4)
    n_tex = 0 if args.data_type == "sdf" else args.fdim_tex
    args.in_channels = args.fdim_geo + n_tex
    args.out_channels = (args.fdim_geo + n_tex) * (2 if args.learn_sigma
                                                   else 1)
    os.makedirs(diff_dir, exist_ok=True)
    with open(os.path.join(diff_dir, "args.json"), "w") as f:
        json.dump(_group_dict(parser, args, "diffusion"), f, indent=4)
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
    """The AE trainer's settings (the sampler's args carry the encoding
    group too)."""
    from ..training.ae import AETrainerConfig
    return AETrainerConfig(
        enc_batch_size=args.enc_batch_size,
        enc_n_iters=args.enc_n_iters,
        enc_lr=args.enc_lr,
        enc_lr_decay=args.enc_lr_decay,
        enc_lr_split=args.enc_lr_split,
        vol_ratio=args.vol_ratio,
        tex_threshold_ratio=args.tex_threshold_ratio,
        tex_weight=args.tex_weight,
        sdf_loss=args.sdf_loss,
        tex_loss=args.tex_loss,
        sdf_renorm=bool(args.sdf_renorm),
        fm_reso=args.fm_reso,
        steps_per_call=getattr(args, "steps_per_call", 1))


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
        fast_norm=bool(args.use_fp16),
        use_checkpoint=bool(getattr(args, "use_checkpoint", False)))


def diffusion_config_from_args(args):
    from ..diffusion.gaussian import (DiffusionConfig, LossKind, MeanType,
                                      VarType)
    if args.use_kl:
        raise NotImplementedError(
            "--use_kl is not supported (dead code in the reference); use "
            "--learn_sigma True --rescale_learned_sigmas True for the "
            "variational-bound variance term")
    return DiffusionConfig(
        mean_type=(MeanType.START_X if args.predict_xstart
                   else MeanType.EPSILON),
        var_type=(VarType.LEARNED_RANGE if args.learn_sigma
                  else VarType.FIXED_LARGE),
        loss_kind=(LossKind.RESCALED_MSE if args.rescale_learned_sigmas
                   else LossKind.MSE),
        rescale_timesteps=args.rescale_timesteps,
        original_num_steps=args.steps)


def diffusion_trainer_config_from_args(args):
    from ..training.diffusion import DiffusionTrainerConfig
    rates = args.ema_rate
    return DiffusionTrainerConfig(
        lr=args.diff_lr,
        weight_decay=args.weight_decay,
        lr_anneal_steps=args.diff_n_iters,
        ema_rates=((rates,) if isinstance(rates, float)
                   else tuple(float(x) for x in str(rates).split(","))),
        batch_size=args.diff_batch_size,
        schedule_sampler=args.schedule_sampler,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
        steps_per_call=getattr(args, "steps_per_call", 1))


def schedule_from_args(args, respacing: Optional[str] = None):
    from ..diffusion.schedule import make_schedule
    if respacing is None:
        respacing = getattr(args, "timestep_respacing", "")
    return make_schedule(args.noise_schedule, args.steps, respacing)
