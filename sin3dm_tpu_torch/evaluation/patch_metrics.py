"""Patch-based geometry metrics: LP-IoU, LP-F-score, Div (counterpart of
`sin3dm_tpu/evaluation/patch_metrics.py`), as torch operations on the
given device.

* voxel grids are max-pooled down to at most 128 per axis;
* patches are 11^3 windows on a stride-5 lattice of the grid zero-padded
  by 5 on every side, kept where their centred 3^3 block is mixed;
* LP-IoU / LP-F-score: the mean over generated patches of the best IoU /
  F1 against any reference patch ("avg"), and the share above 0.95
  ("percent");
* Div: the mean pairwise 1 - IoU between generated grids.

The pairwise comparison is one matmul of {0,1} patch vectors.  Its
entries count at most 1331 coinciding voxels, exact in fp32 in any
summation order, so it runs in fp32 with TF32 off (`exact_fp32`): every
per-patch maximum equals the host's, bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import numpy as np
import torch

PATCH = 11
STRIDE = 5
CENTER = 3
LP_THRESHOLD = 0.95  # percent variant: the share of patches above it


@contextlib.contextmanager
def exact_fp32():
    """cuDNN and cuBLAS in true fp32 (TF32 off) for the block; the flags
    are restored after."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def pool_to(grid, target: int = 128,
            device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Max-pool a boolean grid down to at most `target` per axis (each axis
    zero-padded to a multiple of its factor): bool on `device`."""
    g = torch.as_tensor(np.asarray(grid)).to(device).bool()
    for axis in range(3):
        n = g.shape[axis]
        if n > target:
            k = -(-n // target)
            pad = (-n) % k
            if pad:
                shape = list(g.shape)
                shape[axis] = pad
                g = torch.cat([g, g.new_zeros(shape)], dim=axis)
            shape = list(g.shape)
            shape[axis] = g.shape[axis] // k
            shape.insert(axis + 1, k)
            g = g.reshape(shape).any(dim=axis + 1)
    return g


def load_voxel_npz(path: str, key: str = "vox_grid",
                   device: torch.device = torch.device("cpu")
                   ) -> torch.Tensor:
    with np.load(path) as d:
        return pool_to(d[key], device=device)


def load_sdf_npz_as_voxel(path: str, key: str = "sdf_grid",
                          device: torch.device = torch.device("cpu")
                          ) -> torch.Tensor:
    with np.load(path) as d:
        return pool_to(d[key] < 0, device=device)


def extract_patches(grid: torch.Tensor) -> torch.Tensor:
    """`[N, 11^3]` float32 {0,1} rows, on the grid's device: the
    near-surface patches in lattice order (x, then y, then z)."""
    pad = PATCH // 2
    g = torch.nn.functional.pad(grid.to(torch.uint8)[None, None],
                                (pad,) * 6)[0, 0]
    win = g.unfold(0, PATCH, STRIDE).unfold(1, PATCH, STRIDE).unfold(
        2, PATCH, STRIDE)                       # [nx, ny, nz, 11, 11, 11]
    win = win.reshape(-1, PATCH, PATCH, PATCH)
    c0 = PATCH // 2 - 1
    s = win[:, c0:c0 + CENTER, c0:c0 + CENTER, c0:c0 + CENTER].sum(
        dim=(1, 2, 3), dtype=torch.int32)
    keep = (s > 0) & (s < CENTER ** 3)
    return win[keep].reshape(-1, PATCH ** 3).float()


def _pairwise_max_scores(gen: torch.Tensor, ref: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gen `[G, P]`, ref `[R, P]` float32 in {0,1} -> (best IoU per gen
    patch `[G]`, best F-score per gen patch `[G]`)."""
    inter = gen @ ref.T                                   # [G, R]
    gsum = gen.sum(dim=1, keepdim=True)                   # [G, 1]
    rsum = ref.sum(dim=1, keepdim=True).T                 # [1, R]
    union = gsum + rsum - inter
    iou = inter / torch.clamp(union, min=1.0)
    precision = inter / torch.clamp(gsum, min=1.0)
    recall = inter / torch.clamp(rsum, min=1.0)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-8)
    return iou.amax(dim=1), f1.amax(dim=1)


def lp_score_arrays(gen_grid: torch.Tensor, ref_patches: torch.Tensor,
                    chunk: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """Per-gen-patch (best IoU, best F-score) float32 host arrays against
    the reference patches (on the grid's device)."""
    gp = extract_patches(gen_grid)
    if len(gp) == 0 or len(ref_patches) == 0:
        return np.zeros(0), np.zeros(0)
    ious, fs = [], []
    with torch.no_grad(), exact_fp32():
        for i in range(0, len(gp), chunk):
            iou, f1 = _pairwise_max_scores(gp[i:i + chunk], ref_patches)
            ious.append(iou.cpu().numpy())
            fs.append(f1.cpu().numpy())
    return np.concatenate(ious), np.concatenate(fs)


def lp_scores(gen_grid: torch.Tensor, ref_patches: torch.Tensor,
              chunk: int = 4096) -> Tuple[float, float]:
    """(LP-IoU, LP-F-score), the "avg" variant, of one generated grid."""
    ious, fs = lp_score_arrays(gen_grid, ref_patches, chunk)
    if len(ious) == 0:
        return 0.0, 0.0
    return float(ious.mean()), float(fs.mean())


def eval_lp(gen_grids: Sequence[torch.Tensor],
            ref_grid: torch.Tensor) -> Tuple[float, float]:
    """Mean LP-IoU / LP-F-score ("avg") over the generated grids."""
    ref_patches = extract_patches(ref_grid)
    ious, fs = [], []
    for g in gen_grids:
        i, f = lp_scores(g, ref_patches)
        ious.append(i)
        fs.append(f)
    return float(np.mean(ious)), float(np.mean(fs))


def eval_lp_full(gen_grids: Sequence[torch.Tensor], ref_grid: torch.Tensor
                 ) -> dict:
    """The four LP metrics: "avg" (mean of the per-patch best score) and
    "percent" (the share of patches above 0.95), for IoU and F-score,
    each the mean over the generated grids."""
    ref_patches = extract_patches(ref_grid)
    iou_avg, iou_pct, f_avg, f_pct = [], [], [], []
    for g in gen_grids:
        ious, fs = lp_score_arrays(g, ref_patches)
        if len(ious) == 0:
            iou_avg.append(0.0)
            iou_pct.append(0.0)
            f_avg.append(0.0)
            f_pct.append(0.0)
            continue
        iou_avg.append(float(ious.mean()))
        iou_pct.append(float((ious > LP_THRESHOLD).mean()))
        f_avg.append(float(fs.mean()))
        f_pct.append(float((fs > LP_THRESHOLD).mean()))
    return {"LP-IOU-avg": float(np.mean(iou_avg)),
            "LP-IOU-percent": float(np.mean(iou_pct)),
            "LP-F-score-avg": float(np.mean(f_avg)),
            "LP-F-score-percent": float(np.mean(f_pct))}


def grid_iou(a: torch.Tensor, b: torch.Tensor) -> float:
    """Whole-grid IoU of two aligned grids (the same source AABB), the
    smaller zero-padded to the larger's extent."""
    shape = [max(x, y) for x, y in zip(a.shape, b.shape)]
    pa = a.new_zeros(shape, dtype=torch.bool)
    pb = b.new_zeros(shape, dtype=torch.bool)
    pa[:a.shape[0], :a.shape[1], :a.shape[2]] = a
    pb[:b.shape[0], :b.shape[1], :b.shape[2]] = b
    inter = int(torch.logical_and(pa, pb).sum())
    union = int(torch.logical_or(pa, pb).sum())
    return float(inter) / max(float(union), 1.0)


def eval_div(gen_grids: Sequence[torch.Tensor]) -> float:
    """Mean pairwise 1 - IoU among the generated grids."""
    n = len(gen_grids)
    if n < 2:
        return 0.0
    vals = []
    for i in range(n):
        for j in range(i + 1, n):
            vals.append(1.0 - grid_iou(gen_grids[i], gen_grids[j]))
    return float(np.mean(vals))
