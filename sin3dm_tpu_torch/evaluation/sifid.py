"""Multi-view SIFID, the single-image FID at InceptionV3 features
(counterpart of `sin3dm_tpu/evaluation/sifid.py`).

The four feature blocks of the reference wrapper: dims 64 (block 0 ends
after Conv2d_2b, before the first max-pool), 192 (after Conv2d_4a,
before the second), 768 (after Mixed_6e, before the aux classifier) and
2048 (after Mixed_7c).  Activations stay spatial, one row of channels per
pixel; renders are read as floats in [0, 1] and scaled to [-1, 1], not
resized.  The modules carry torchvision's `inception_v3` state-dict keys
(`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_var`, ...),
so its file loads as it is; a stem-only file loads for dims 64 and 192.
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
from .ssfid import copy_weights, frechet_distance, load_state_dict

DIMS = (64, 192, 768, 2048)


class BasicConv2d(nn.Module):
    """A bias-free conv, BatchNorm (eps 1e-3, running stats) and ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    # torch's default count_include_pad: always divide by 9
    return F.avg_pool2d(x, 3, stride=1, padding=1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionFeatures(nn.Module):
    """InceptionV3 up to the block that ends at `dims` channels; only the
    layers that block needs exist (and load)."""

    def __init__(self, dims: int):
        super().__init__()
        if dims not in DIMS:
            raise ValueError(f"InceptionV3 feature dims must be "
                             f"64/192/768/2048, got {dims}")
        self.dims = dims
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        if dims >= 192:
            self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
            self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        if dims >= 768:
            self.Mixed_5b = InceptionA(192, 32)
            self.Mixed_5c = InceptionA(256, 64)
            self.Mixed_5d = InceptionA(288, 64)
            self.Mixed_6a = InceptionB(288)
            self.Mixed_6b = InceptionC(768, 128)
            self.Mixed_6c = InceptionC(768, 160)
            self.Mixed_6d = InceptionC(768, 160)
            self.Mixed_6e = InceptionC(768, 192)
        if dims == 2048:
            self.Mixed_7a = InceptionD(768)
            self.Mixed_7b = InceptionE(1280)
            self.Mixed_7c = InceptionE(2048)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images `[B, 3, H, W]` in [0, 1] -> `[B, dims, H', W']`."""
        x = 2.0 * images - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        if self.dims == 64:
            return x
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        if self.dims == 192:
            return x
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        if self.dims == 768:
            return x
        for name in ("Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x


def load_inception(path: str, dims: int,
                   device: torch.device) -> InceptionFeatures:
    """The feature net for `dims` with the file's weights (a key it needs
    and the file lacks raises KeyError)."""
    net = InceptionFeatures(dims)
    copy_weights(net, load_state_dict(path))
    return net.to(device).eval()


def _load_png(path: str) -> np.ndarray:
    """A render as float32 RGB in [0, 1]."""
    return (decode_png(path).astype(np.float32) / 255.0)[..., :3]


def image_statistics(net: InceptionFeatures, image: np.ndarray):
    """(mu, sigma) over the pixels of one `[H, W, 3]` image's features."""
    dev = next(net.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(image)).to(dev)
    with torch.no_grad(), exact_fp32():
        act = net(x.permute(2, 0, 1)[None])
    act = act[0].permute(1, 2, 0).reshape(-1, act.shape[1]).cpu().numpy()
    return act.mean(axis=0), np.cov(act, rowvar=False)


def calculate_multiview_sifid(gen_render_dirs: List[str],
                              ref_render_dir: str, weights_path: str,
                              dims: int = 64,
                              device: torch.device = torch.device("cpu")
                              ) -> Dict[str, float]:
    """Each view's SIFID of every generated render against the reference
    render of that view, averaged over samples, then over views."""
    if not os.path.exists(weights_path):
        raise RuntimeError(
            f"'{weights_path}' not found; SIFID needs torchvision "
            "inception_v3 weights (google/inception_v3 state dict)")
    net = load_inception(weights_path, dims, device)
    n_views = len(os.listdir(ref_render_dir))
    per_view = []
    for i in range(n_views):
        ref = _load_png(os.path.join(ref_render_dir, f"{i:03d}.png"))
        mu_r, sig_r = image_statistics(net, ref)
        vals = []
        for gdir in gen_render_dirs:
            gen = _load_png(os.path.join(gdir, f"{i:03d}.png"))
            mu_g, sig_g = image_statistics(net, gen)
            vals.append(frechet_distance(mu_r, sig_r, mu_g, sig_g))
        per_view.append(np.mean(vals))
    return {f"mv_sifid_dim{dims}": float(np.mean(per_view))}
