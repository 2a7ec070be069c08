"""Reference torch checkpoints <-> the parameter trees (counterpart of
`sin3dm_tpu/compat/torch_import.py`).

The reference stores `nn.Module.state_dict()` tensors in OIHW / OIDHW /
`[out, in]` layouts under module-path keys; the trees keep JAX's
channels-last layouts (conv HWIO / DHWIO, linear `[in, out]`).  The
mapping is a pure re-layout, numpy only, into C-contiguous arrays (the
layout a checkpoint's arrays load in: a strided view would let the
convs sum in another order), and gives the tree in the JAX package's
layout: `compat/from_jax.py` (`unet_params_from_jax`,
`ae_params_from_jax`) turns it into the port's tensors, so weights have
one way in.

Formats:

* diffusion EMA `ema_{rate}_{step:06d}.pt`: a bare state dict of
  `TriplaneUNetModelSmall` (rollout) or `...SmallRaw`;
* AE bundle `ckpt_{name}.pth`: a dict with the `net` state dict of
  `AutoEncoderGroup{V3,Skip,PBR}` and the material / aabb /
  featmap_size metadata.

Files are read with `torch.load(weights_only=True)` only: tensors, lists,
tuples, dicts, strings and Python numbers.  A file that holds anything
else (a pickled class, a numpy array or numpy scalar, e.g. an `aabb`
saved as `np.ndarray`) is refused with a ValueError naming it; save such
values as lists or tensors.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Any, Dict, List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    """A tensor or array-like as a float32 numpy array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _conv2d_in(w) -> np.ndarray:
    """torch OIHW -> HWIO."""
    return np.ascontiguousarray(_np(w).transpose(2, 3, 1, 0))


def _conv2d_out(w) -> np.ndarray:
    """HWIO -> torch OIHW."""
    return np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def _conv3d_in(w) -> np.ndarray:
    """torch OIDHW -> DHWIO."""
    return np.ascontiguousarray(_np(w).transpose(2, 3, 4, 1, 0))


def _conv3d_out(w) -> np.ndarray:
    return np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(4, 3, 0, 1, 2))


def _linear_in(w) -> np.ndarray:
    """torch [out, in] -> [in, out]."""
    return np.ascontiguousarray(_np(w).T)


def _linear_out(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


_PLANES = ("xy", "xz", "yz")


def _take(sd: Dict, key: str):
    try:
        return sd[key]
    except KeyError:
        raise KeyError(f"reference state dict is missing '{key}' (wrong "
                       "model config for this checkpoint?)") from None


# ---------------------------------------------------------------------------
# UNet (TriplaneUNetModelSmall / ...Raw)
# ---------------------------------------------------------------------------

def _unet_resblock_prefixes(cfg) -> Tuple[List[Tuple[str, Tuple]], ...]:
    """(torch prefix, (section, level, block)) of every resblock: input
    block `level` holds a parameter-free Downsample at index 0 when
    level != 0, so its resblocks start at 1; output block `j` holds its
    resblocks at 0..nrb-1 (the Upsample after them has no params)."""
    nrb = cfg.num_res_blocks
    down, up = [], []
    for level in range(len(cfg.channel_mult)):
        base = 0 if level == 0 else 1
        for i in range(nrb):
            down.append((f"input_blocks.{level}.{base + i}",
                         ("down", level, i)))
    for j in range(len(cfg.channel_mult)):
        for i in range(nrb):
            up.append((f"output_blocks.{j}.{i}", ("up", j, i)))
    return down, up


def _norm_from(sd: Dict, key: str) -> Dict:
    return {"g": _np(_take(sd, f"{key}.weight")),
            "b": _np(_take(sd, f"{key}.bias"))}


def _conv_from(sd: Dict, key: str) -> Dict:
    return {"w": _conv2d_in(_take(sd, f"{key}.weight")),
            "b": _np(_take(sd, f"{key}.bias"))}


def _linear_from(sd: Dict, key: str) -> Dict:
    return {"w": _linear_in(_take(sd, f"{key}.weight")),
            "b": _np(_take(sd, f"{key}.bias"))}


def _planes_from(read, sd: Dict, key: str) -> Dict:
    """`read` of `key` with `{pl}` each plane's name, per plane."""
    return {pl: read(sd, key.format(pl=pl)) for pl in _PLANES}


def _norm_to(p: Dict, key: str, out: Dict) -> None:
    out[f"{key}.weight"] = np.asarray(p["g"])
    out[f"{key}.bias"] = np.asarray(p["b"])


def _conv_to(p: Dict, key: str, out: Dict) -> None:
    out[f"{key}.weight"] = _conv2d_out(p["w"])
    out[f"{key}.bias"] = np.asarray(p["b"])


def _linear_to(p: Dict, key: str, out: Dict) -> None:
    out[f"{key}.weight"] = _linear_out(p["w"])
    out[f"{key}.bias"] = np.asarray(p["b"])


def _resblock_from_sd(sd: Dict, pre: str) -> Dict:
    p: Dict[str, Any] = {
        "in_norm": _planes_from(_norm_from, sd,
                                pre + ".in_layers.0.norm_{pl}"),
        "in_conv": _planes_from(_conv_from, sd,
                                pre + ".in_layers.2.conv_{pl}"),
        "emb": _linear_from(sd, f"{pre}.emb_layers.1"),
        "out_norm": _planes_from(_norm_from, sd,
                                 pre + ".out_layers.0.norm_{pl}"),
        "out_conv": _planes_from(_conv_from, sd,
                                 pre + ".out_layers.2.conv_{pl}"),
    }
    if f"{pre}.skip_connection.conv_xy.weight" in sd:
        p["skip"] = _planes_from(_conv_from, sd,
                                 pre + ".skip_connection.conv_{pl}")
    return p


def _resblock_to_sd(p: Dict, pre: str, out: Dict) -> None:
    for pl in _PLANES:
        _norm_to(p["in_norm"][pl], f"{pre}.in_layers.0.norm_{pl}", out)
        _conv_to(p["in_conv"][pl], f"{pre}.in_layers.2.conv_{pl}", out)
        _norm_to(p["out_norm"][pl], f"{pre}.out_layers.0.norm_{pl}", out)
        _conv_to(p["out_conv"][pl], f"{pre}.out_layers.2.conv_{pl}", out)
        if "skip" in p:
            _conv_to(p["skip"][pl], f"{pre}.skip_connection.conv_{pl}", out)
    _linear_to(p["emb"], f"{pre}.emb_layers.1", out)


def unet_params_from_state_dict(sd: Dict, cfg) -> Dict:
    """A reference `TriplaneUNetModelSmall[Raw]` state dict -> the UNet
    tree (`init_unet`'s layout, numpy leaves).  `cfg` is a UNetConfig
    whose channel_mult and num_res_blocks describe the checkpoint."""
    p: Dict[str, Any] = {
        "time_embed": {"l1": _linear_from(sd, "time_embed.0"),
                       "l2": _linear_from(sd, "time_embed.2")},
        "in_conv": _planes_from(_conv_from, sd, "in_conv.0.conv_{pl}"),
        "out": {"norm": _planes_from(_norm_from, sd, "out.0.norm_{pl}"),
                "conv": _planes_from(_conv_from, sd, "out.2.conv_{pl}")},
    }
    down_pre, up_pre = _unet_resblock_prefixes(cfg)
    down: List[List[Dict]] = [[] for _ in cfg.channel_mult]
    for pre, (_, level, _i) in down_pre:
        down[level].append(_resblock_from_sd(sd, pre))
    up: List[List[Dict]] = [[] for _ in cfg.channel_mult]
    for pre, (_, j, _i) in up_pre:
        up[j].append(_resblock_from_sd(sd, pre))
    p["down"] = down
    p["up"] = up
    return p


def unet_state_dict_from_params(params: Dict, cfg) -> Dict[str, np.ndarray]:
    """The UNet tree (numpy leaves) -> a reference-layout state dict of
    numpy arrays, in the reference mapping's key order."""
    out: Dict[str, np.ndarray] = {}
    _linear_to(params["time_embed"]["l1"], "time_embed.0", out)
    _linear_to(params["time_embed"]["l2"], "time_embed.2", out)
    for pl in _PLANES:
        _conv_to(params["in_conv"][pl], f"in_conv.0.conv_{pl}", out)
        _norm_to(params["out"]["norm"][pl], f"out.0.norm_{pl}", out)
        _conv_to(params["out"]["conv"][pl], f"out.2.conv_{pl}", out)
    down_pre, up_pre = _unet_resblock_prefixes(cfg)
    for pre, (_, level, i) in down_pre:
        _resblock_to_sd(params["down"][level][i], pre, out)
    for pre, (_, j, i) in up_pre:
        _resblock_to_sd(params["up"][j][i], pre, out)
    return out


# ---------------------------------------------------------------------------
# AutoEncoder (AutoEncoderGroupV3 / Skip / PBR)
# ---------------------------------------------------------------------------

def _mlp_linear_indices(sd: Dict, pre: str) -> List[int]:
    """Sorted Sequential indices of the Linear layers under `pre` (ReLUs
    take the odd slots, so weights sit at 0, 2, 4, ...)."""
    idx = []
    for k in sd:
        if k.startswith(pre + ".") and k.endswith(".weight"):
            mid = k[len(pre) + 1:-len(".weight")]
            if mid.isdigit():
                idx.append(int(mid))
    if not idx:
        raise KeyError(f"no Linear layers found under '{pre}'")
    return sorted(idx)


def _mlp_from_sd(sd: Dict, pre: str, skip: bool) -> Dict:
    """DecoderMLP (`layers`) or DecoderMLPSkipConcat (`first`, `second`)."""
    def seq(sub):
        return [{"w": _linear_in(sd[f"{pre}.{sub}.{i}.weight"]),
                 "b": _np(sd[f"{pre}.{sub}.{i}.bias"])}
                for i in _mlp_linear_indices(sd, f"{pre}.{sub}")]
    if skip:
        return {"first": seq("first_layers"), "second": seq("second_layers")}
    return {"layers": seq("layers")}


def _mlp_to_sd(p: Dict, pre: str, out: Dict) -> None:
    def emit(sub, layers):
        # a Linear at every even Sequential slot (a ReLU between)
        for i, lp in enumerate(layers):
            out[f"{pre}.{sub}.{2 * i}.weight"] = _linear_out(lp["w"])
            out[f"{pre}.{sub}.{2 * i}.bias"] = np.asarray(lp["b"])
    if "layers" in p:
        emit("layers", p["layers"])
    else:
        emit("first_layers", p["first"])
        emit("second_layers", p["second"])


def _group_block_from_sd(sd: Dict, pre: str, input_act: bool) -> Dict:
    """TriplaneGroupResnetBlock: each grouped (groups=3) conv splits into
    per-plane convs along its output-channel groups, in (xy, xz, yz)
    order."""
    in_idx = 1 if input_act else 0  # Sequential([SiLU,] Conv2d)

    def grouped(key_w, key_b):
        w = _np(_take(sd, key_w))      # [3*cout, cin_g, k, k]
        b = _np(_take(sd, key_b))      # [3*cout]
        cout = w.shape[0] // 3
        return {pl: {"w": _conv2d_in(w[g * cout:(g + 1) * cout]),
                     "b": b[g * cout:(g + 1) * cout]}
                for g, pl in enumerate(_PLANES)}

    p = {
        "in_conv": grouped(f"{pre}.in_layers.{in_idx}.weight",
                           f"{pre}.in_layers.{in_idx}.bias"),
        "norm": _planes_from(_norm_from, sd, pre + ".norm_{pl}"),
        "out_conv": grouped(f"{pre}.out_layers.1.weight",
                            f"{pre}.out_layers.1.bias"),
    }
    if f"{pre}.shortcut.weight" in sd:
        p["shortcut"] = grouped(f"{pre}.shortcut.weight",
                                f"{pre}.shortcut.bias")
    return p


def _group_block_to_sd(p: Dict, pre: str, input_act: bool, out: Dict) -> None:
    in_idx = 1 if input_act else 0

    def grouped(plane_dict):
        w = np.concatenate([_conv2d_out(plane_dict[pl]["w"])
                            for pl in _PLANES], axis=0)
        b = np.concatenate([np.asarray(plane_dict[pl]["b"])
                            for pl in _PLANES], axis=0)
        return w, b

    w, b = grouped(p["in_conv"])
    out[f"{pre}.in_layers.{in_idx}.weight"] = w
    out[f"{pre}.in_layers.{in_idx}.bias"] = b
    for pl in _PLANES:
        _norm_to(p["norm"][pl], f"{pre}.norm_{pl}", out)
    w, b = grouped(p["out_conv"])
    out[f"{pre}.out_layers.1.weight"] = w
    out[f"{pre}.out_layers.1.bias"] = b
    if "shortcut" in p:
        w, b = grouped(p["shortcut"])
        out[f"{pre}.shortcut.weight"] = w
        out[f"{pre}.shortcut.bias"] = b


def ae_params_from_state_dict(sd: Dict, cfg) -> Tuple[Dict, np.ndarray]:
    """A reference AutoEncoderGroup{V3,Skip,PBR} state dict -> the AE tree
    (`init_autoencoder`'s layout, numpy leaves) and its aabb buffer.
    `cfg.enc_net_type` selects the heads' and blocks' layout."""
    skip_mlp = cfg.enc_net_type != "base"
    p: Dict[str, Any] = {
        "geo_encoder": {"w": _conv3d_in(_take(sd, "geo_encoder.weight")),
                        "b": _np(_take(sd, "geo_encoder.bias"))},
        "geo_convs": _group_block_from_sd(sd, "geo_convs", input_act=False),
        "geo_decoder": _mlp_from_sd(sd, "geo_decoder", skip_mlp),
    }
    if cfg.use_tex:
        p["tex_encoder"] = {"w": _conv3d_in(_take(sd, "tex_encoder.weight")),
                            "b": _np(_take(sd, "tex_encoder.bias"))}
        if cfg.enc_net_type == "pbr":
            p["tex_convs"] = [
                _group_block_from_sd(sd, "tex_convs.0", input_act=False),
                _group_block_from_sd(sd, "tex_convs.1", input_act=True),
            ]
            for head in ("rgb", "mr", "normal"):
                p[f"{head}_decoder"] = _mlp_from_sd(sd, f"{head}_decoder",
                                                    skip_mlp)
        else:
            p["tex_convs"] = [
                _group_block_from_sd(sd, "tex_convs", input_act=False)]
            p["tex_decoder"] = _mlp_from_sd(sd, "tex_decoder", skip_mlp)
    aabb = _np(sd["aabb"]) if "aabb" in sd else np.array(
        [-1, -1, -1, 1, 1, 1], np.float32)
    return p, aabb


def ae_state_dict_from_params(params: Dict, cfg,
                              aabb=None) -> Dict[str, np.ndarray]:
    """The AE tree -> a reference-layout state dict of numpy arrays."""
    out: Dict[str, np.ndarray] = {
        "geo_encoder.weight": _conv3d_out(params["geo_encoder"]["w"]),
        "geo_encoder.bias": np.asarray(params["geo_encoder"]["b"]),
        "aabb": np.asarray(aabb if aabb is not None
                           else [-1, -1, -1, 1, 1, 1], np.float32),
    }
    _group_block_to_sd(params["geo_convs"], "geo_convs", False, out)
    _mlp_to_sd(params["geo_decoder"], "geo_decoder", out)
    if cfg.use_tex:
        out["tex_encoder.weight"] = _conv3d_out(params["tex_encoder"]["w"])
        out["tex_encoder.bias"] = np.asarray(params["tex_encoder"]["b"])
        if cfg.enc_net_type == "pbr":
            _group_block_to_sd(params["tex_convs"][0], "tex_convs.0",
                               False, out)
            _group_block_to_sd(params["tex_convs"][1], "tex_convs.1",
                               True, out)
            for head in ("rgb", "mr", "normal"):
                _mlp_to_sd(params[f"{head}_decoder"], f"{head}_decoder", out)
        else:
            _group_block_to_sd(params["tex_convs"][0], "tex_convs",
                               False, out)
            _mlp_to_sd(params["tex_decoder"], "tex_decoder", out)
    return out


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def is_torch_file(path: str) -> bool:
    """True when `path` is a torch.save file (a zip holding data.pkl, or
    a legacy pickle stream) rather than the npz container."""
    try:
        if zipfile.is_zipfile(path):
            with zipfile.ZipFile(path) as z:
                return any(n.endswith("data.pkl") for n in z.namelist())
        with open(path, "rb") as f:
            return f.read(2)[:1] == b"\x80"  # pickle protocol marker
    except OSError:
        return False


def load_torch_file(path: str) -> Dict:
    """`torch.load(path, map_location="cpu", weights_only=True)`; a file
    it cannot read (a pickled class, numpy objects, not a torch file)
    raises ValueError naming the file."""
    import torch
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        raise ValueError(
            f"{path}: not readable with torch.load(weights_only=True) (a "
            "pickled class or numpy object?); the port reads only tensors, "
            f"lists, dicts and numbers: {str(e).splitlines()[0]}") from e
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: holds a {type(obj).__name__}, not a "
                         "state dict or checkpoint bundle")
    return obj


def import_diffusion_ema(src_pt: str, dst_pt: str, ucfg) -> Dict:
    """Convert a reference `ema_{rate}_{step}.pt` into the npz container
    at `dst_pt` (the same file name contract).  Returns the tree."""
    from ..core import checkpoint as ckpt
    params = unet_params_from_state_dict(load_torch_file(src_pt), ucfg)
    ckpt.save_tree(dst_pt, params,
                   meta={"imported_from": os.path.abspath(src_pt)})
    return params


def _host(v) -> np.ndarray:
    """A tensor or array-like as a numpy array of its own dtype."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _floats(v) -> List[float]:
    return [float(x) for x in _host(v).reshape(-1)]


def ae_bundle_to_tree(bundle: Dict, acfg,
                      threshold: float = None) -> Tuple[Dict, Dict]:
    """A reference `ckpt_{name}.pth` bundle (already loaded) -> (tree,
    meta).  The optimizer and scheduler states are torch's own and are
    not carried over: an imported checkpoint is for inference or a fresh
    fine-tune.  The TSDF clamp `threshold` is not in the bundle; without
    one the default 2/256*3 (the mesh sampler's formula at grid reso 256)
    is recorded.  `aabb`, `Ka`, `Kd`, `Ks` may be lists, tuples or
    tensors; the bundle has no `grid_shape`."""
    sd = bundle["net"] if "net" in bundle else bundle
    params, aabb = ae_params_from_state_dict(sd, acfg)
    meta = {
        "aabb": _floats(bundle.get("aabb", aabb)),
        "featmap_size": [int(v) for v in bundle.get("featmap_size", ())],
        "Ka": _floats(bundle.get("Ka", [0, 0, 0])),
        "Kd": _floats(bundle.get("Kd", [1, 1, 1])),
        "Ks": _floats(bundle.get("Ks", [.4, .4, .4])),
        "Ns": float(_host(bundle.get("Ns", 10)).reshape(())),
        "threshold": float(threshold if threshold is not None
                           else 2.0 / 256 * 3),
    }
    return params, meta


def import_ae_ckpt(src_pth: str, dst_pth: str, acfg,
                   threshold: float = None) -> Tuple[Dict, Dict]:
    """Convert a reference `ckpt_final.pth` bundle file into the npz
    container (see `ae_bundle_to_tree`).  Returns (tree, meta)."""
    from ..core import checkpoint as ckpt
    params, meta = ae_bundle_to_tree(load_torch_file(src_pth), acfg,
                                     threshold=threshold)
    meta["imported_from"] = os.path.abspath(src_pth)
    ckpt.save_tree(dst_pth, params, meta=meta)
    return params, meta
