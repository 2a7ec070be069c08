"""SSFID, the single-shape Fréchet distance on 3D classifier activations
(counterpart of `sin3dm_tpu/evaluation/ssfid.py`).

The classifier is DECOR-GAN's shapenet tower: five Conv3d (kernel 4,
stride 2, padding 1), the first four each followed by an unaffine
InstanceNorm3d and a leaky ReLU (0.01), a spatial mean and a linear
layer.  SSFID reads the activations after layer 2, one row per voxel.
`Clsshapenet` carries the published file's state-dict keys (`conv_1` ..
`conv_5`, `linear1`), so `Clsshapenet_128.pth` loads as it is; the
weights are read with `torch.load(weights_only=True)`, and a file that
holds a pickled module instead of a state dict is refused.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import linalg
from torch import nn

from . import patch_metrics

EF_DIM = 32
Z_DIM = 512
N_CLASSES = 24


def load_state_dict(path: str) -> Mapping[str, torch.Tensor]:
    """A state dict from `path` with `torch.load(weights_only=True)`; a
    file that holds anything else (a pickled module) raises ValueError
    naming the file."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: not a plain state dict (a pickled module?); the port "
            "loads weights only with torch.load(weights_only=True)") from e
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: holds a {type(sd).__name__}, not a "
                         "state dict")
    return sd


def copy_weights(module: nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Copy `sd[key]` into each of the module's parameters and buffers
    (BatchNorm's `num_batches_tracked` aside); a missing key raises
    KeyError, a shape that differs ValueError."""
    with torch.no_grad():
        for key, t in module.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            src = sd[key]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)} in the "
                                 f"file, {tuple(t.shape)} in the model")
            t.copy_(src)


class Clsshapenet(nn.Module):
    """The shapenet classifier over `[B, 1, D, H, W]` voxels."""

    def __init__(self):
        super().__init__()
        chans = [1, EF_DIM, EF_DIM * 2, EF_DIM * 4, EF_DIM * 8, Z_DIM]
        for i in range(1, 6):
            setattr(self, f"conv_{i}", nn.Conv3d(chans[i - 1], chans[i], 4,
                                                 stride=2, padding=1))
        self.linear1 = nn.Linear(Z_DIM, N_CLASSES)

    def forward(self, voxel: torch.Tensor, out_layer: int = 2):
        """The activations after `out_layer` (1-4), `[B, C, D', H', W']`;
        after all five, (logits, the spatial mean of conv_5)."""
        h = voxel
        for i in range(1, 5):
            h = F.instance_norm(getattr(self, f"conv_{i}")(h), eps=1e-5)
            h = F.leaky_relu(h, negative_slope=0.01)
            if out_layer == i:
                return h
        z = self.conv_5(h).mean(dim=(2, 3, 4))
        return self.linear1(F.leaky_relu(z, negative_slope=0.01)), z


def load_classifier(path: str, device: torch.device) -> Clsshapenet:
    net = Clsshapenet()
    copy_weights(net, load_state_dict(path))
    return net.to(device).eval()


def activation_statistics(net: Clsshapenet, voxel: torch.Tensor,
                          out_layer: int = 2
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) over the voxels of the layer's activations: one row of
    channels per voxel, float32 on the host, `np.cov` in float64."""
    dev = next(net.parameters()).device
    with torch.no_grad(), patch_metrics.exact_fp32():
        act = net(voxel.to(dev, torch.float32)[None, None], out_layer)
    act = act[0].permute(1, 2, 3, 0).reshape(-1, act.shape[1]).cpu().numpy()
    return act.mean(axis=0), np.cov(act, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The Fréchet distance of two Gaussians (scipy's `sqrtm` on the
    host, an eps offset where the product is singular).  `sqrtm` is
    called without `disp`, which newer SciPy no longer takes: the same
    root as JAX's `disp=False` call."""
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("Imaginary component "
                             f"{np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def eval_ssfid(gen_voxel_paths: List[str], ref_sdf_path: str,
               weights_path: str, out_layer: int = 2,
               device: torch.device = torch.device("cpu")
               ) -> Dict[str, float]:
    """SSFID of each generated voxel grid against the reference shape's
    SDF grid (both pooled to at most 128 per axis): mean and std."""
    if not os.path.exists(weights_path):
        raise RuntimeError(
            f"'{weights_path}' not found. SSFID needs the pretrained "
            "Clsshapenet_128.pth (see the DECOR-GAN release).")
    net = load_classifier(weights_path, device)
    ref = patch_metrics.load_sdf_npz_as_voxel(ref_sdf_path, device=device)
    mu_r, sig_r = activation_statistics(net, ref, out_layer)
    vals = []
    for p in gen_voxel_paths:
        gen = patch_metrics.load_voxel_npz(p, device=device)
        if gen.shape != ref.shape:
            raise RuntimeError("generated and reference grids differ in size")
        mu_f, sig_f = activation_statistics(net, gen, out_layer)
        vals.append(frechet_distance(mu_r, sig_r, mu_f, sig_f))
    return {"SSFID_avg": round(float(np.mean(vals)), 6),
            "SSFID_std": round(float(np.std(vals)), 6)}
