"""Multi-view LPIPS diversity, StarGAN-v2's AlexNet LPIPS (counterpart of
`sin3dm_tpu/evaluation/lpips.py`).

AlexNet's conv features after each ReLU, unit-normalised over channels,
squared differences weighted by the learned bias-free 1x1 convs, averaged
over space and summed over the 5 layers.  The diversity of a view is the
mean LPIPS over pairs of generated renders; the metric averages views.
Weights: torchvision's `alexnet` state dict (`features.{0,3,6,8,10}`) and
`lpips_weights.ckpt` (`lpips_weights.{i}.main.1.weight`).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.meshio import decode_png
from .patch_metrics import exact_fp32
from .ssfid import copy_weights, load_state_dict

# the ImageNet normalisation, rescaled for inputs in [-1, 1]
_MU = (-0.03, -0.088, -0.188)
_SIGMA = (0.458, 0.448, 0.450)


class AlexNetFeatures(nn.Module):
    """torchvision's `alexnet().features`: the 5 post-ReLU feature maps."""

    # (in, out, kernel, stride, padding, max-pool after)
    CFG = ((3, 64, 11, 4, 2, True), (64, 192, 5, 1, 2, True),
           (192, 384, 3, 1, 1, False), (384, 256, 3, 1, 1, False),
           (256, 256, 3, 1, 1, True))
    CONV_IDS = (0, 3, 6, 8, 10)

    def __init__(self):
        super().__init__()
        layers = []
        for cin, cout, k, s, p, pool in self.CFG:
            layers += [nn.Conv2d(cin, cout, k, stride=s, padding=p),
                       nn.ReLU(inplace=False)]
            if pool:
                layers.append(nn.MaxPool2d(3, stride=2))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        fmaps = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                fmaps.append(x)
        return fmaps


class LPIPS(nn.Module):
    """LPIPS between two `[B, 3, H, W]` batches in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.alexnet = AlexNetFeatures()
        self.lin = nn.ParameterList(
            [nn.Parameter(torch.zeros(1, c[1], 1, 1))
             for c in AlexNetFeatures.CFG])
        self.register_buffer("mu", torch.tensor(_MU).view(1, 3, 1, 1))
        self.register_buffer("sigma", torch.tensor(_SIGMA).view(1, 3, 1, 1))

    def load(self, alexnet_sd, lpips_sd) -> None:
        copy_weights(self.alexnet, alexnet_sd)
        with torch.no_grad():
            for i, w in enumerate(self.lin):
                w.copy_(lpips_sd[f"lpips_weights.{i}.main.1.weight"])

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.alexnet((x - self.mu) / self.sigma)
        fy = self.alexnet((y - self.mu) / self.sigma)
        val = 0.0
        for a, b, w in zip(fx, fy, self.lin):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            val = val + torch.mean(F.conv2d(d, w))
        return val


def _unit_normalize(x, eps=1e-10):
    return x * torch.rsqrt(torch.sum(x ** 2, dim=1, keepdim=True) + eps)


def load_lpips(alexnet_weights_path: str, lpips_weights_path: str,
               device: torch.device) -> LPIPS:
    net = LPIPS()
    net.load(load_state_dict(alexnet_weights_path),
             load_state_dict(lpips_weights_path))
    return net.to(device).eval()


def calculate_lpips_given_images(net: LPIPS, images: np.ndarray) -> float:
    """Mean LPIPS over the pairs of N images `[N, H, W, 3]` in [-1, 1]."""
    dev = net.mu.device
    imgs = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    imgs = imgs.permute(0, 3, 1, 2)
    n = len(imgs)
    vals = []
    with torch.no_grad(), exact_fp32():
        for i in range(n - 1):
            for j in range(i + 1, n):
                vals.append(float(net(imgs[i:i + 1], imgs[j:j + 1])))
    return float(np.mean(vals))


def calculate_multiview_lpips(gen_render_dirs: List[str],
                              alexnet_weights_path: str,
                              lpips_weights_path: str,
                              device: torch.device = torch.device("cpu")
                              ) -> Dict[str, float]:
    for p in (alexnet_weights_path, lpips_weights_path):
        if not os.path.exists(p):
            raise RuntimeError(f"'{p}' not found; LPIPS needs torchvision "
                               "AlexNet weights + lpips_weights.ckpt")
    net = load_lpips(alexnet_weights_path, lpips_weights_path, device)
    n_views = len(os.listdir(gen_render_dirs[0]))
    vals = []
    for i in range(n_views):
        imgs = []
        for d in gen_render_dirs:
            img = decode_png(os.path.join(d, f"{i:03d}.png"),
                             "RGB").astype(np.float32) / 255.0
            imgs.append((img - 0.5) / 0.5)
        vals.append(calculate_lpips_given_images(net, np.stack(imgs)))
    return {"mv_lpips": float(np.mean(vals))}
