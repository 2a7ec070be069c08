"""Shape-autoencoder trainer, inference subset (counterpart of
`sin3dm_tpu/training/ae.py`): load the trained weights and decode
triplanes to dense grids and voxel files.  Training, evaluation, point
and texel decode and the mesh export come with later slices
(ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..compat.from_jax import ae_params_from_jax
from ..core import checkpoint as ckpt
from ..core.triplane import Triplane
from ..dataio.grid import grid_resolutions
from ..models import autoencoder as ae
from ..ops import pack_params


def _with_batch(feat: Triplane) -> Triplane:
    """Planes with a leading batch dim of 1 (decode expects [1, H, W, C])."""
    if feat.xy.dim() == 3:
        return feat.map(lambda p: p[None])
    return feat


class AETrainer:
    def __init__(self, log_dir: str, acfg: ae.AEConfig, device):
        self.log_dir = log_dir
        self.acfg = acfg
        self.device = torch.device(device)
        self.params: Optional[Dict] = None
        self.meta: Dict = {}

    def load_ckpt(self, name: str) -> None:
        """Load params and meta from `ckpt_{name}.pth`: the `params/`
        subtree of a combined params/opt_state/step checkpoint, or a
        params-only one."""
        path = os.path.join(self.log_dir, f"ckpt_{name}.pth")
        prefix = ("params" if any(p.startswith("params/")
                                  for p in ckpt.peek_paths(path)) else "")
        tree, meta = ckpt.load_tree(path, prefix)
        self.params = pack_params(ae_params_from_jax(tree, self.device))
        self.meta = meta or {}

    def decode_grid(self, feat: Triplane, reso: int,
                    aabb=None) -> np.ndarray:
        """Decode the AABB voxel-centre grid -> `[Nx, Ny, Nz, 1+Ct]` fp32
        numpy, texture channels clipped to [0, 1]."""
        if aabb is None:
            aabb = self.meta["aabb"]
        res = tuple(int(x) for x in grid_resolutions(np.asarray(aabb), reso))
        feat = _with_batch(feat).to(device=self.device, dtype=torch.float32)
        geo, tex = ae.process_planes(self.params, self.acfg, feat)
        out = ae.decode_grid_dense(self.params, self.acfg, geo, tex, res)
        preds = out.cpu().numpy()
        if preds.shape[-1] > 1:
            preds[..., 1:] = np.clip(preds[..., 1:], 0.0, 1.0)
        return preds

    def _resize_aabb(self, featmap_size) -> np.ndarray:
        """AABB scaled by how far the planes differ from the training
        featmap size (retargeted samples)."""
        base = np.asarray(self.meta["featmap_size"], np.float64)
        new = np.asarray(featmap_size, np.float64)
        aabb = np.asarray(self.meta["aabb"], np.float64)
        if not np.array_equal(base, new):
            scale = np.concatenate([new / base, new / base])
            return aabb * scale
        return aabb

    def decode_voxel(self, save_dir: str, feat: Triplane, reso: int) -> None:
        """Write `r{reso}_voxel.npz` holding `vox_grid = sdf < 0`."""
        feat = _with_batch(feat)
        H, W, D = feat.sizes
        new_aabb = self._resize_aabb((H, W, D))
        os.makedirs(save_dir, exist_ok=True)
        sdf = self.decode_grid(feat, reso, aabb=new_aabb)[..., 0]
        np.savez_compressed(os.path.join(save_dir, f"r{reso}_voxel.npz"),
                            vox_grid=sdf < 0)
