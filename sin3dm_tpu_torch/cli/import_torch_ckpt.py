"""Convert a reference (torch) Sin3DM tag into the npz container, or back
(counterpart of `scripts/import_torch_ckpt.py`):

    python -m sin3dm_tpu_torch.cli.import_torch_ckpt --src REF_TAG --dst TAG
    python -m sin3dm_tpu_torch.cli.import_torch_ckpt --reverse --src TAG \\
        --dst REF_TAG

A reference tag holds `encoding/{args.json, ckpt_final.pth, feat.npz}`
and `diffusion/{args.json, ema_{rate}_{step:06d}.pt}`.  The two torch
files become npz containers (`compat/torch_import.py`, read with
`torch.load(weights_only=True)`), which the port's CLIs and the JAX
package's `load_pytree` read; args.json and feat.npz are copied as they
are.  The port's CLIs also read a reference tag directly.

The TSDF clamp `threshold` is not in the reference bundle: it is read
from the dataset npz that encoding/args.json names where that file
exists, else `--threshold` (default 2/256*3, the mesh sampler's formula
at grid reso 256).

`--reverse` writes a tag of the npz container in the reference's torch
format: the EMA state dicts and the AE bundle (`net`, empty
`optimizer`/`scheduler`, `Ka`/`Kd`/`Ks`/`Ns`, `aabb` and `featmap_size`
as lists), which the reference's `load_state_dict` reads.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys

import numpy as np

from ..compat import torch_import as ti
from ..core import checkpoint as ckpt
from ..core import config as cfgmod


def _configs(enc_args: dict, diff_args: dict):
    """(AEConfig, UNetConfig) of a tag's two args.json files."""
    ns = argparse.Namespace(**{**_ENC_DEFAULTS, **enc_args})
    acfg = cfgmod.ae_config_from_args(ns)
    ch = acfg.fdim_geo + (acfg.fdim_tex if acfg.use_tex else 0)
    ns = argparse.Namespace(**{
        **cfgmod.diffusion_model_defaults(), "in_channels": ch,
        "out_channels": ch, "diff_net_type": "unet_small", **diff_args})
    return acfg, cfgmod.unet_config_from_args(ns)


_ENC_DEFAULTS = {"data_type": "sdftex", "enc_net_type": "skip",
                 "fdim_geo": 4, "fdim_tex": 8, "fdim_up": 64,
                 "hidden_dim": 256, "n_hidden_layers": 4}


def _read_args(tag: str):
    with open(os.path.join(cfgmod.encoding_log_dir(tag), "args.json")) as f:
        enc_args = json.load(f)
    with open(os.path.join(cfgmod.diffusion_log_dir(tag), "args.json")) as f:
        diff_args = json.load(f)
    return enc_args, diff_args


def _find_threshold(enc_args: dict, override) -> float:
    if override is not None:
        return float(override)
    data_path = enc_args.get("data_path")
    if data_path and os.path.exists(data_path):
        with np.load(data_path) as d:
            if "threshold" in d.files:
                thr = float(d["threshold"])
                print(f"threshold {thr:.6f} from dataset {data_path}")
                return thr
    thr = 2.0 / 256 * 3
    print(f"dataset npz not reachable; using default threshold {thr:.6f} "
          "(override with --threshold)")
    return thr


def _copy_plain(src: str, dst: str) -> None:
    """args.json and feat.npz of both stages, as they are."""
    for sub, names in ((cfgmod.encoding_log_dir, ("args.json", "feat.npz")),
                       (cfgmod.diffusion_log_dir, ("args.json",))):
        for name in names:
            p = os.path.join(sub(src), name)
            if os.path.exists(p):
                shutil.copy2(p, os.path.join(sub(dst), name))


def import_tag(src: str, dst: str, threshold=None) -> None:
    """A reference tag at `src` -> a tag of npz containers at `dst`."""
    enc_args, diff_args = _read_args(src)
    acfg, ucfg = _configs(enc_args, diff_args)
    for sub in (cfgmod.encoding_log_dir, cfgmod.diffusion_log_dir):
        os.makedirs(sub(dst), exist_ok=True)
    src_pth = os.path.join(cfgmod.encoding_log_dir(src), "ckpt_final.pth")
    ti.import_ae_ckpt(src_pth, os.path.join(cfgmod.encoding_log_dir(dst),
                                            "ckpt_final.pth"),
                      acfg, threshold=_find_threshold(enc_args, threshold))
    print(f"imported {src_pth}")
    emas = sorted(glob.glob(os.path.join(cfgmod.diffusion_log_dir(src),
                                         "ema_*.pt")))
    if not emas:
        raise SystemExit(f"no ema_*.pt under {cfgmod.diffusion_log_dir(src)}")
    for src_pt in emas:
        ti.import_diffusion_ema(src_pt, os.path.join(
            cfgmod.diffusion_log_dir(dst), os.path.basename(src_pt)), ucfg)
        print(f"imported {src_pt}")
    _copy_plain(src, dst)
    print(f"done: {dst} is ready for sin3dm_tpu_torch.cli.sample")


def _tensors(sd) -> dict:
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def export_tag(src: str, dst: str) -> None:
    """A tag of npz containers at `src` -> a reference-format tag at
    `dst`."""
    import torch
    enc_args, diff_args = _read_args(src)
    acfg, ucfg = _configs(enc_args, diff_args)
    for sub in (cfgmod.encoding_log_dir, cfgmod.diffusion_log_dir):
        os.makedirs(sub(dst), exist_ok=True)
    src_pth = os.path.join(cfgmod.encoding_log_dir(src), "ckpt_final.pth")
    prefix = ("params" if any(p.startswith("params/")
                              for p in ckpt.peek_paths(src_pth)) else "")
    params, meta = ckpt.load_tree(src_pth, prefix)
    meta = meta or {}
    sd = ti.ae_state_dict_from_params(params, acfg, aabb=meta.get("aabb"))
    torch.save({
        "net": _tensors(sd),
        "optimizer": {}, "scheduler": {},  # torch's own; not exported
        "Ka": meta.get("Ka", [0, 0, 0]), "Kd": meta.get("Kd", [1, 1, 1]),
        "Ks": meta.get("Ks", [0.4, 0.4, 0.4]), "Ns": meta.get("Ns", 10),
        "aabb": meta.get("aabb", [-1, -1, -1, 1, 1, 1]),
        "featmap_size": meta.get("featmap_size", []),
    }, os.path.join(cfgmod.encoding_log_dir(dst), "ckpt_final.pth"))
    print(f"exported {src_pth}")
    for src_pt in sorted(glob.glob(os.path.join(
            cfgmod.diffusion_log_dir(src), "ema_*.pt"))):
        uparams, _ = ckpt.load_tree(src_pt)
        torch.save(_tensors(ti.unet_state_dict_from_params(uparams, ucfg)),
                   os.path.join(cfgmod.diffusion_log_dir(dst),
                                os.path.basename(src_pt)))
        print(f"exported {src_pt}")
    _copy_plain(src, dst)
    print(f"done: {dst} is a reference-format tag")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True, help="the tag to convert")
    ap.add_argument("--dst", required=True, help="the tag to write")
    ap.add_argument("--threshold", type=float, default=None,
                    help="TSDF clamp where the dataset npz is not found")
    ap.add_argument("--reverse", action="store_true",
                    help="write the npz tag at --src in the reference's "
                         "torch format at --dst")
    args = ap.parse_args(argv)
    if args.reverse:
        export_tag(args.src, args.dst)
    else:
        import_tag(args.src, args.dst, args.threshold)
    return 0


if __name__ == "__main__":
    sys.exit(main())
