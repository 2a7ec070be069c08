"""Shape-autoencoder trainer (counterpart of `sin3dm_tpu/training/ae.py`):
fit the triplane AE to one shape, evaluate it, checkpoint it, and decode
triplanes to dense grids, voxel files and textured meshes.

Training.  `load_ae_data` reads the mesh sampler's npz onto the device:
the dense sdf(+texture) volume the encoder sees every step (trilinearly
resized to twice the feature-map size where it differs) and the point
tables, shuffled once on the host (`host_shuffle_permutations`).  A train
step takes 8 contiguous windows at random offsets from each shuffled
table (grid points, near-surface points), runs `models.autoencoder.
forward` (plain heads: K2 has no backward), the weighted-L1 sdf loss and
the masked texture loss, and AdamW over flat fp32 buffers
(`training.adamw`) as JAX's optax chain computes it: `optax.adamw` (b1
0.9, b2 0.999, eps 1e-8, weight decay 0.01 on every leaf) at lr(k) =
enc_lr * gamma^k in float32, gamma = enc_lr_decay^(1 / enc_n_iters), k
the schedule's count before it advances; the geometry leaves' whole
update then scaled by `enc_lr_split`.  No NaN guard and no EMA, as in
JAX.  Step k's window offsets come from a generator seeded from (seed,
k) alone (`core.rng.step_generator`), so a resumed run draws what an
unbroken one would; tests pass JAX's draws in (`offsets=`).  Checkpoints
(`ckpt_latest.pth` on the save cadence, `ckpt_final.pth` at the end) hold
params, the optimiser state in JAX's leaf layout
(`core.checkpoint.adamw_tree(chained=True)`) and the step.

Data parallel (`group=`, a `parallel.DataGroup`; JAX's `mesh=`): every
rank takes the same windows and keeps its equal, contiguous share of the
batch's rows; the encoder runs replicated.  Each loss term is this
rank's sum over the global count (the masked texture loss's over the
mask's count summed over the ranks, since a mean of per-rank masked
means is not the global one where the mask is uneven), and one
`all_reduce` sums the flat gradient and the terms.  Rank 0 alone logs
and writes checkpoints.

Decode.  Dense grids and voxel files, and the mesh path: a dense int8 sdf
grid on the device, sent to the host as the sparse near-surface wire,
marching cubes, decimation, UV atlas and raster on the host, texel
colours decoded on the device over the run-length texel wire, and the
textured mesh written by a background export worker.  The skip heads run
through K2, which reads the packed weights (`ops.pack_params`): the
trainer packs them again after every parameter update that precedes a
decode, and no checkpoint holds a pack.  `SIN3DM_FUSED_HEADS=0` (JAX's
switch, read at every decode by `models.autoencoder.fused_heads`) runs
them as the plain fp32 heads instead.

Device work is queued on the current stream; results travel to the host
by copies into pinned memory that do not block (`_Fetch`), and the host
reads them after their event.  One lock keeps the device dispatch of
concurrent decode threads apart.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compat.from_jax import ae_params_from_jax
from ..core import checkpoint as ckpt
from ..core import logger, profiling
from ..core.rng import step_generator
from ..core.triplane import Triplane
from ..dataio.grid import grid_resolutions, sample_grid_points_aabb
from ..geometry import meshio, meshproc, native, uvatlas
from ..models import autoencoder as ae
from ..ops import pack_params
from ..ops import sparse_grid as _sg
from ..parallel.mesh import all_reduce, all_reduce_many, local_rows
from . import adamw

WEIGHT_DECAY = 0.01
N_WINDOWS = 8          # contiguous windows per point table per batch


@dataclass
class AETrainerConfig:
    enc_batch_size: int = 65536
    enc_n_iters: int = 25000
    enc_lr: float = 5e-3
    enc_lr_decay: float = 0.1          # final lr ratio
    enc_lr_split: float = 0.2          # geo-params lr multiplier
    vol_ratio: float = 0.1             # fraction of grid points per batch
    tex_threshold_ratio: float = 0.999
    tex_weight: float = 1.0
    sdf_loss: str = "weightedl1"       # l1 | weightedl1
    tex_loss: str = "l1"               # l1 | l2 | huber
    # the decoder emits threshold-normalized sdf values (int8 scale 1.0)
    sdf_renorm: bool = False
    fm_reso: int = 128
    # train steps per call of the step function
    steps_per_call: int = 1
    # texture-bake point wire (SIN3DM_TEXEL_WIRE overrides):
    #   "runs" (default): per-row position spans expanded on the device,
    #       compact pack of u16 starts + f16 normalized steps, 16 B/run,
    #   "runs32": the same spans in fp32 (28 B/run, positions exact),
    #   "u16": AABB-relative uint16 points,
    #   "f32": dense fp32 points.
    texel_wire: str = "runs"


class AEData(NamedTuple):
    """The training data on the device (the mesh sampler's npz schema)."""
    input_grid: torch.Tensor     # [1, X, Y, Z, 1+Ct] (sdf first)
    pts_grid: torch.Tensor       # [Ng, 3]
    sdf_grid: torch.Tensor       # [Ng, 1] clamped to +-threshold
    pts_near_surf: torch.Tensor  # [Ns, 3]
    sdf_near_surf: torch.Tensor  # [Ns, 1]
    tex_grid: Optional[torch.Tensor]
    tex_near_surf: Optional[torch.Tensor]
    pts_on_surf: Optional[torch.Tensor]
    tex_on_surf: Optional[torch.Tensor]
    aabb: torch.Tensor           # [6]


class TexelRuns(NamedTuple):
    """Run-length texel wire payload (`geometry/native.py
    rasterize_uv_runs`): `[n, 7]` float32 rows of (start xyz, step xyz,
    length) in row-major masked order."""
    runs: np.ndarray


SHUFFLE_SEED = 12345


def host_shuffle_permutations(n_grid: int, n_near: int):
    """(grid_perm, near_perm): the one host shuffle of the point tables;
    `evaluate` reorders its grid-ordered predictions by grid_perm."""
    rng = np.random.default_rng(SHUFFLE_SEED)
    return rng.permutation(n_grid), rng.permutation(n_near)


def compute_featmap_size(grid_shape, fm_reso: int) -> Tuple[int, int, int]:
    """Per-axis feature-map size scaled by the grid's extent, floored to
    even."""
    g = np.array(grid_shape[:3], dtype=np.float64)
    fm = (g * (fm_reso / g.max())).astype(np.int64)
    return tuple(int(x // 2 * 2) for x in fm)


def load_ae_data(npz_path: str, cfg: AETrainerConfig, device,
                 data_type: str = "sdftex"):
    """Read the sampler npz onto `device`; returns (AEData, meta,
    grid_perm).  SDFs are clamped to the stored threshold (and divided
    by it under sdf_renorm), the volume is resized to 2x the feature-map
    size where it differs, on-surface points are capped at 2M (numpy's
    default_rng(0)), and the point tables are shuffled once."""
    from ..core.nn import resize_trilinear

    data = np.load(npz_path)
    aabb = np.asarray(data["aabb"], np.float32)
    threshold = float(data["threshold"])
    meta = {
        "aabb": aabb.tolist(),
        "threshold": threshold,
        "Ka": np.asarray(data["Ka"]).tolist() if "Ka" in data else [0, 0, 0],
        "Kd": np.asarray(data["Kd"]).tolist() if "Kd" in data else [1, 1, 1],
        "Ks": np.asarray(data["Ks"]).tolist() if "Ks" in data
        else [0.4, 0.4, 0.4],
        "Ns": np.asarray(data["Ns"]).tolist() if "Ns" in data else 10,
    }
    pts_grid = np.asarray(data["pts_grid"], np.float32)
    sdf_grid = np.asarray(data["sdf_grid"], np.float32)
    fm_size = compute_featmap_size(pts_grid.shape, cfg.fm_reso)
    meta["featmap_size"] = list(fm_size)
    meta["grid_shape"] = list(pts_grid.shape[:3])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    use_tex = data_type != "sdf"
    if use_tex:
        tex_grid = np.asarray(data["tex_grid"], np.float32)
        vol = np.concatenate([sdf_grid[..., None], tex_grid], axis=-1)
    else:
        vol = sdf_grid[..., None]
    vol_d = dev(vol)[None]                     # [1, X, Y, Z, C]
    required = tuple(x * 2 for x in fm_size)
    if vol.shape[:3] != required:
        vol_d = resize_trilinear(vol_d, required).contiguous()
    del vol

    def clamp(a):
        return np.clip(a, -threshold, threshold)
    sdf_grid_flat = clamp(sdf_grid.reshape(-1, 1))
    pts_near = np.asarray(data["pts_near_surf"], np.float32).reshape(-1, 3)
    sdf_near = clamp(np.asarray(data["sdf_near_surf"],
                                np.float32).reshape(-1, 1))
    if cfg.sdf_renorm:
        sdf_grid_flat = sdf_grid_flat / threshold
        sdf_near = sdf_near / threshold
    grid_perm, near_perm = host_shuffle_permutations(
        sdf_grid_flat.shape[0], pts_near.shape[0])

    tex_g = tex_n = pts_s = tex_s = None
    if use_tex:
        tc = tex_grid.shape[-1]
        tex_g = dev(tex_grid.reshape(-1, tc)[grid_perm])
        tex_n = dev(np.asarray(data["tex_near_surf"],
                               np.float32).reshape(-1, tc)[near_perm])
        pts_s_np = np.asarray(data["pts_on_surf"], np.float32).reshape(-1, 3)
        tex_s_np = np.asarray(data["tex_on_surf"],
                              np.float32).reshape(-1, tc)
        if pts_s_np.shape[0] > 2_000_000:
            idx = np.random.default_rng(0).permutation(
                pts_s_np.shape[0])[:2_000_000]
            pts_s_np, tex_s_np = pts_s_np[idx], tex_s_np[idx]
        pts_s, tex_s = dev(pts_s_np), dev(tex_s_np)

    ae_data = AEData(
        input_grid=vol_d,
        pts_grid=dev(pts_grid.reshape(-1, 3)[grid_perm]),
        sdf_grid=dev(sdf_grid_flat[grid_perm]),
        pts_near_surf=dev(pts_near[near_perm]),
        sdf_near_surf=dev(sdf_near[near_perm]),
        tex_grid=tex_g, tex_near_surf=tex_n,
        pts_on_surf=pts_s, tex_on_surf=tex_s,
        aabb=dev(aabb))
    return ae_data, meta, grid_perm


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def sdf_loss_fn(kind: str, pred: torch.Tensor, gt: torch.Tensor,
                count: Optional[int] = None) -> torch.Tensor:
    """The mean error, or its sum over `count` elements (a rank's part of
    a mean over several ranks)."""
    if kind == "l1":
        e = (pred - gt).abs()
    elif kind == "weightedl1":
        weight = 1.0 + 0.5 * torch.sign(gt) * torch.sign(gt - pred)
        e = (pred - gt).abs() * weight
    else:
        raise NotImplementedError(kind)
    return e.mean() if count is None else e.sum() / count


def masked_tex_loss_fn(kind: str, pred: torch.Tensor, gt: torch.Tensor,
                       mask: torch.Tensor,
                       n_masked: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Mean over the masked rows only; 0 where the mask is empty.  With
    `n_masked` (the masked rows of every rank), this rank's sum over
    that count instead."""
    m = mask.to(pred.dtype)[:, None]
    n = torch.clamp((m.sum() if n_masked is None else n_masked)
                    * pred.shape[-1], min=1.0)
    if kind == "l1":
        e = (pred - gt).abs()
    elif kind == "l2":
        e = (pred - gt) ** 2
    elif kind == "huber":
        delta = 0.1
        a = (pred - gt).abs()
        e = torch.where(a < delta, 0.5 * a ** 2 / delta, a - 0.5 * delta)
    else:
        raise NotImplementedError(kind)
    return (e * m).sum() / n


# ---------------------------------------------------------------------------
# The optimiser and the train step
# ---------------------------------------------------------------------------

def learning_rate(cfg: AETrainerConfig, count: int) -> np.float32:
    """The schedule at count k, in float32: enc_lr * gamma^k."""
    gamma = np.float32(cfg.enc_lr_decay ** (1.0 / cfg.enc_n_iters))
    return np.float32(cfg.enc_lr) * np.power(gamma, np.float32(count))


@dataclass
class AETrainState:
    """Parameters and AdamW moments as flat fp32 buffers in the parameter
    tree's flatten order; `params` is the tree of views of `flat` that
    the model reads (leaves that require grad); `scale` is each element's
    factor after AdamW (enc_lr_split on geometry leaves, 1 elsewhere), or
    None without a split."""
    params: Dict
    flat: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    scale: Optional[torch.Tensor]
    count: int                    # optax ScaleByAdamState.count
    sched_count: int              # ScaleByScheduleState.count
    step: int

    def tree(self, flat: torch.Tensor) -> Dict:
        """`flat` (a buffer of this state's layout) as a detached tree."""
        return adamw.views(flat.detach(), self.params)


def strip_packs(tree):
    """A parameter tree without the kernels' weight packs ("k1", "k2")."""
    if isinstance(tree, dict):
        return {k: strip_packs(v) for k, v in tree.items()
                if k not in ("k1", "k2")}
    if isinstance(tree, (list, tuple)):
        return [strip_packs(v) for v in tree]
    return tree


def init_train_state(params: Dict, cfg: AETrainerConfig) -> AETrainState:
    """A fresh state whose buffers copy `params` (a tree of tensors)."""
    params = strip_packs(params)
    device = ckpt.leaves_with_paths(params)[0][1].device
    flat = adamw.flatten(params, device).detach().clone()
    scale = None
    if cfg.enc_lr_split > 0:
        labels = ckpt.leaves_with_paths(ae.geo_param_labels(params))
        scale = torch.cat([
            torch.full((v.numel(),), float(cfg.enc_lr_split) if lab == "geo"
                       else 1.0, dtype=torch.float32, device=device)
            for (_, v), (_, lab) in zip(ckpt.leaves_with_paths(params),
                                        labels)])
    return AETrainState(params=adamw.param_views(flat, params), flat=flat,
                        mu=torch.zeros_like(flat), nu=torch.zeros_like(flat),
                        scale=scale, count=0, sched_count=0, step=0)


def opt_tree(state: AETrainState) -> Dict:
    """The optimiser state in JAX's leaf layout (numpy leaves): the chain's
    where there is a geometry split."""
    return adamw.opt_tree(state, chained=state.scale is not None)


def load_opt_tree(state: AETrainState, tree) -> None:
    """Set the state's moments and counts from JAX's leaf layout;
    ValueError where the tree does not fit."""
    adamw.load_opt_tree(state, tree, chained=state.scale is not None)


def apply_grads(state: AETrainState, g: torch.Tensor,
                tcfg: AETrainerConfig) -> None:
    """AdamW with weight decay, the lr schedule and the geometry split on
    the flat buffers, from the flat gradient `g` (see the module doc)."""
    adamw.update(state, g, learning_rate(tcfg, state.sched_count),
                 WEIGHT_DECAY, scale=state.scale)


def window_sizes(total: int) -> List[int]:
    """Rows of each of the N_WINDOWS windows that make `total` rows."""
    chunk = max(total // N_WINDOWS, 1)
    return [chunk] * (N_WINDOWS - 1) + [total - chunk * (N_WINDOWS - 1)]


def batch_split(tcfg: AETrainerConfig) -> Tuple[int, int]:
    """(grid rows, near-surface rows) of a batch."""
    n_grid = int(tcfg.enc_batch_size * tcfg.vol_ratio)
    return n_grid, tcfg.enc_batch_size - n_grid


def draw_offsets(tcfg: AETrainerConfig, data: AEData, seed: int,
                 step: int) -> Tuple[List[int], List[int]]:
    """Step `step`'s window offsets (grid, near-surface), drawn on the host
    from the generator of (seed, step): each uniform over the offsets
    where its largest window fits."""
    g = step_generator(seed, step, "cpu")
    out = []
    for total, n_rows in zip(batch_split(tcfg), (
            data.pts_grid.shape[0], data.pts_near_surf.shape[0])):
        hi = n_rows - max(window_sizes(total)) + 1
        out.append(torch.randint(0, hi, (N_WINDOWS,), generator=g).tolist())
    return out[0], out[1]


def sample_batch(tcfg: AETrainerConfig, data: AEData, use_tex: bool,
                 offsets: Tuple[Sequence[int], Sequence[int]]):
    """(points, sdf, texture or None) of a batch: the windows at `offsets`
    of the shuffled grid tables, then those of the near-surface tables."""
    def windows(arrs, total, offs):
        sizes = window_sizes(total)
        return [torch.cat([a[int(o):int(o) + n] for o, n in
                           zip(offs, sizes)]) for a in arrs]

    g_arrs = [data.pts_grid, data.sdf_grid]
    s_arrs = [data.pts_near_surf, data.sdf_near_surf]
    if use_tex:
        g_arrs.append(data.tex_grid)
        s_arrs.append(data.tex_near_surf)
    n_grid, n_surf = batch_split(tcfg)
    g_out = windows(g_arrs, n_grid, offsets[0])
    s_out = windows(s_arrs, n_surf, offsets[1])
    cat = [torch.cat([a, b]) for a, b in zip(g_out, s_out)]
    return cat[0], cat[1], (cat[2] if use_tex else None)


def ae_losses(params: Dict, acfg: ae.AEConfig, tcfg: AETrainerConfig,
              data: AEData, threshold: float, pts, gt_sdf,
              gt_tex, group=None) -> Dict[str, torch.Tensor]:
    """The loss terms of one batch and their sum under "loss".  With a
    data `group`, the rows are this rank's share and each term is its
    part of the whole batch's (see the module doc)."""
    pred = ae.forward(params, acfg, data.input_grid, pts, data.aabb)
    count = None if group is None else pts.shape[0] * group.size
    losses = {"sdf_loss": sdf_loss_fn(tcfg.sdf_loss, pred[..., :1], gt_sdf,
                                      count)}
    if acfg.use_tex:
        tex_thr = (1.0 if tcfg.sdf_renorm else threshold) \
            * tcfg.tex_threshold_ratio
        mask = gt_sdf[:, 0].abs() < tex_thr
        n_masked = None if group is None else all_reduce(
            group, mask.sum().to(pred.dtype))
        pred_tex = pred[..., 1:]
        parts = ({"rgb_loss": slice(0, 3), "mr_loss": slice(3, 5),
                  "normal_loss": slice(5, None)}
                 if acfg.data_type == "sdfpbr" else {"tex_loss": slice(None)})
        for k, sl in parts.items():
            losses[k] = masked_tex_loss_fn(
                tcfg.tex_loss, pred_tex[:, sl], gt_tex[:, sl],
                mask, n_masked) * tcfg.tex_weight
    losses["loss"] = sum(losses.values())
    return losses


def compute_grads(state: AETrainState, acfg: ae.AEConfig,
                  tcfg: AETrainerConfig, data: AEData, threshold: float,
                  offsets, group=None):
    """(detached loss terms, flat gradient of the total) at the state's
    parameters on the batch at `offsets`; with a data `group`, on this
    rank's rows, the terms and the gradient then summed over the ranks
    (one `all_reduce`)."""
    pts, sdf, tex = sample_batch(tcfg, data, acfg.use_tex, offsets)
    if group is not None:
        pts, sdf = local_rows(group, pts), local_rows(group, sdf)
        tex = None if tex is None else local_rows(group, tex)
    terms = ae_losses(state.params, acfg, tcfg, data, threshold, pts, sdf,
                      tex, group)
    leaves = [v for _, v in ckpt.leaves_with_paths(state.params)]
    grads = torch.autograd.grad(terms["loss"], leaves, allow_unused=True)
    g = torch.cat([(torch.zeros_like(v) if gr is None else gr).reshape(-1)
                   for v, gr in zip(leaves, grads)])
    terms = {k: v.detach() for k, v in terms.items()}
    if group is not None:
        keys = list(terms)
        red = all_reduce_many(group, [g] + [terms[k] for k in keys])
        g, terms = red[0], dict(zip(keys, red[1:]))
    return terms, g


def make_train_step(acfg: ae.AEConfig, tcfg: AETrainerConfig,
                    threshold: float, group=None):
    """`step_fn(state, data, seed, offsets=None) -> metrics`: K =
    steps_per_call steps, updating `state` in place; `offsets` (K pairs
    of (grid, near-surface) offset lists) replaces the draws.  Returns the
    last step's loss terms as device tensors.  With a data `group` (JAX's
    `mesh=`) the batch's rows split over the ranks (see the module doc);
    the batch must divide."""
    K = max(tcfg.steps_per_call, 1)
    if group is not None and tcfg.enc_batch_size % group.size:
        raise ValueError(f"enc_batch_size {tcfg.enc_batch_size} does not "
                         f"divide over {group.size} ranks")

    def step_fn(state: AETrainState, data: AEData, seed: int,
                offsets=None) -> Dict[str, torch.Tensor]:
        for i in range(K):
            offs = (offsets[i] if offsets is not None
                    else draw_offsets(tcfg, data, seed, state.step))
            terms, g = compute_grads(state, acfg, tcfg, data, threshold,
                                     offs, group)
            apply_grads(state, g, tcfg)
            state.step += 1
        return terms

    return step_fn


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def evaluate_tsdf_prediction(pred_sdf: np.ndarray, gt_sdf: np.ndarray,
                             sdf_threshold: float) -> Dict[str, float]:
    """Bucketed TSDF L1 / relative error / sign accuracy; rows whose
    ground truth is exactly 0 are left out of the relative means."""
    res: Dict[str, float] = {}
    l1 = np.abs(pred_sdf - gt_sdf)
    denom = np.abs(gt_sdf)
    nz = denom > 0
    rel = np.divide(l1, denom, out=np.zeros_like(l1), where=nz)
    acc = (pred_sdf * gt_sdf >= 0).astype(np.float32)
    res["mean_tsdf_l1_error"] = float(l1.mean())
    res["mean_tsdf_rel_error"] = (
        float(rel[nz].mean()) if nz.any() else float("nan"))
    res["mean_tsdf_acc"] = float(acc.mean())
    n = 4
    unit = sdf_threshold / n
    ranges = [i * unit for i in range(n + 1)] + [unit * (n + 1)]
    for i in range(len(ranges) - 1):
        m = (np.abs(gt_sdf) >= ranges[i]) & (np.abs(gt_sdf) < ranges[i + 1])
        suffix = f"{i}-{n}-{i + 1}-n"
        res[f"mean_tsdf_l1_error_{suffix}"] = (
            float(l1[m].mean()) if m.any() else float("nan"))
        mr = m & nz
        res[f"mean_tsdf_rel_error_{suffix}"] = (
            float(rel[mr].mean()) if mr.any() else float("nan"))
        res[f"mean_tsdf_acc_{suffix}"] = (
            float(acc[m].mean()) if m.any() else float("nan"))
        res[f"mean_tsdf_count_{suffix}"] = int(m.sum())
    return res


class _Fetch:
    """Device tensors on their way to pinned host memory: the copies are
    queued without blocking and `wait()` returns numpy arrays once the
    event recorded after them has passed.  CPU tensors pass through."""

    def __init__(self, tensors: List[torch.Tensor]):
        self.event = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = [t.to("cpu", non_blocking=True) for t in tensors]
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(tensors[0].device))
        else:
            self.host = list(tensors)

    def __len__(self) -> int:
        return len(self.host)

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.host]


class GeoGrid(NamedTuple):
    """A dispatched geo-grid decode: the device grid `[X, Y, Z]` (int8, or
    fp16 for the sdf data type), its int8 scale (or None), the sparse
    wire's shapes (or None), the fetch of what goes to the host (the
    sparse arrays, else the grid) and the host seconds of the dispatch."""
    grid: torch.Tensor
    quant: Optional[float]
    sparse: Optional[_sg.SparseGrid]
    fetch: _Fetch
    seconds: float


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def _with_batch(feat: Triplane) -> Triplane:
    """Planes with a leading batch dim of 1 (decode expects [1, H, W, C])."""
    if feat.xy.dim() == 3:
        return feat.map(lambda p: p[None])
    return feat


def _u16_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A uint16 host array as int32 on `device`: uploaded as its 16 bits
    (int16, which every device op takes) and widened there."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.uint16).view(np.int16))
    return t.to(device).to(torch.int32) & 0xFFFF


class AETrainer:
    def __init__(self, log_dir: str, acfg: ae.AEConfig, device,
                 tcfg: Optional[AETrainerConfig] = None, group=None):
        self.log_dir = log_dir
        # a data group trains data-parallel; rank 0 logs and saves
        self.group = group
        self.is_main = group is None or group.rank == 0
        self.acfg = acfg
        self.tcfg = tcfg or AETrainerConfig()
        self.device = torch.device(device)
        # the parameters the decode reads, with the kernels' packs
        self.params: Optional[Dict] = None
        self.meta: Dict = {}
        self.data: Optional[AEData] = None
        self.grid_perm: Optional[np.ndarray] = None
        # the last `train`'s optimiser state (flat buffers)
        self.state: Optional[AETrainState] = None
        # per-sample stage seconds of the mesh path, appended by the decode
        # and the export worker where a caller sets a list here (`generate`
        # does, for its own call): {"dir", "stage", "seconds", ...}
        self.stage_log: Optional[List[Dict]] = None
        # keeps the device dispatch of concurrent decode threads apart
        self._device_lock = threading.Lock()
        # one background writer for the export tail (texel fetch, texture
        # assembly, PNG/OBJ write): its C++ and zlib parts release the
        # interpreter lock, so it overlaps the next sample's geometry; one
        # worker keeps file outputs ordered.  SIN3DM_ASYNC_EXPORT=0 runs
        # the tail inline.
        self._export_pool = None
        self._export_futs: list = []
        self._export_lock = threading.Lock()
        os.makedirs(log_dir, exist_ok=True)

    def _ckpt_path(self, name: str) -> str:
        return os.path.join(self.log_dir, f"ckpt_{name}.pth")

    def load_ckpt(self, name: str) -> None:
        """Load params and meta from `ckpt_{name}.pth`: the `params/`
        subtree of a combined params/opt_state/step checkpoint, a
        params-only one, or a reference torch bundle, whose weights are
        transplanted (`compat/torch_import.py`; its meta has no
        `grid_shape`)."""
        from ..compat import torch_import as ti
        path = self._ckpt_path(name)
        if ti.is_torch_file(path):
            print(f"weight-transplanting reference torch ckpt: {path}")
            tree, self.meta = ti.ae_bundle_to_tree(ti.load_torch_file(path),
                                                   self.acfg)
            self.set_params(ae_params_from_jax(tree, self.device))
            return
        prefix = ("params" if any(p.startswith("params/")
                                  for p in ckpt.peek_paths(path)) else "")
        tree, meta = ckpt.load_tree(path, prefix)
        self.set_params(ae_params_from_jax(tree, self.device))
        self.meta = meta or {}

    def set_params(self, tree: Dict) -> None:
        """Take a copy of `tree` (tensors on the trainer's device) as the
        decode's parameters, with the kernels' packs made from it."""
        self.params = pack_params({k: _clone(v) for k, v in
                                   strip_packs(tree).items()})

    # -- training -----------------------------------------------------------

    def load_data(self, npz_path: str) -> None:
        self.data, self.meta, self.grid_perm = load_ae_data(
            npz_path, self.tcfg, self.device, self.acfg.data_type)

    def load_train_state(self, name: str):
        """(params tree, optimiser tree, step) of `ckpt_{name}.pth` as numpy
        trees, for resume; None where the file is absent or holds no
        optimiser state.  Sets the meta from the file."""
        path = self._ckpt_path(name)
        if not os.path.exists(path):
            return None
        if not any(p.startswith("opt_state/") for p in ckpt.peek_paths(path)):
            return None
        tree, meta = ckpt.load_tree(path)
        if meta:
            self.meta = meta
        return tree["params"], tree["opt_state"], int(tree["step"])

    def save_ckpt(self, name: str) -> None:
        """`ckpt_{name}.pth`: the train state's params, optimiser state and
        step, with the meta."""
        st = self.state
        ckpt.save_tree(self._ckpt_path(name), {
            "params": st.tree(st.flat), "opt_state": opt_tree(st),
            "step": np.asarray(st.step, np.int32)}, meta=self.meta)

    def train(self, seed: int = 0, n_iters: Optional[int] = None,
              log_every: int = 100, eval_every: Optional[int] = None,
              resume: bool = False,
              save_every: Optional[int] = None) -> Dict[str, float]:
        """Fit the AE; returns `evaluate`'s statistics, written to
        `eval_stat.json` beside `ckpt_final.pth`.  The parameters start
        from `self.params` where set, else from `init_autoencoder` on a
        generator seeded with `seed`; step k's batch from (seed, k).
        `resume` continues from `ckpt_latest.pth` (params, optimiser state,
        step), written every `save_every` steps (default the featmap
        logging cadence, n_iters / 5)."""
        assert self.data is not None, "train() needs load_data()"
        n_iters = n_iters or self.tcfg.enc_n_iters
        resumed = self.load_train_state("latest") if resume else None
        if resumed is not None:
            params = ae_params_from_jax(resumed[0], self.device)
        elif self.params is not None:
            params = self.params
        else:
            params = ae.init_autoencoder(torch.Generator(
                device=self.device).manual_seed(seed), self.acfg)
        st = self.state = init_train_state(params, self.tcfg)
        if resumed is not None:
            load_opt_tree(st, resumed[1])
            st.step = resumed[2]
            logger.log(f"AE resume from iter {st.step}")
        step_fn = make_train_step(self.acfg, self.tcfg,
                                  self.meta["threshold"], self.group)
        tb = None
        if self.is_main:
            try:
                from tensorboardX import SummaryWriter
                tb = SummaryWriter(os.path.join(self.log_dir, "tblog"))
            except ImportError:
                pass
        eval_every = eval_every or max(n_iters // 5, 1)
        save_every = save_every or eval_every
        K = max(self.tcfg.steps_per_call, 1)
        for i in range(st.step, n_iters, K):
            metrics = step_fn(st, self.data, seed)
            if i % log_every == 0 and self.is_main:
                vals = {k: float(v) for k, v in metrics.items()}
                for k, v in vals.items():
                    logger.logkv(f"ae/{k}", v)
                logger.logkv("ae/iter", i)
                logger.dumpkvs()
                if tb is not None:
                    tb.add_scalars("loss", vals, global_step=i)
            if tb is not None and (i == 0 or (i + K) % eval_every < K):
                self.set_params(st.tree(st.flat))
                self._featmap_figures(tb, i)
            if (i + K) % save_every < K and i + K < n_iters \
                    and self.is_main:
                self.save_ckpt("latest")
        if tb is not None:
            tb.close()
        self.set_params(st.tree(st.flat))
        eval_stat = self.evaluate()
        st.step = n_iters
        if self.is_main:
            with open(os.path.join(self.log_dir, "eval_stat.json"),
                      "w") as f:
                json.dump(eval_stat, f, indent=2)
            self.save_ckpt("final")
        return eval_stat

    def _featmap_figures(self, tb, step: int) -> None:
        """Channel 0 of each plane as a TensorBoard heatmap."""
        from ..core.rng import draw_scalar_field2D
        for pi, plane in enumerate(self.encode()):
            tb.add_figure(f"feat_map_{pi}", draw_scalar_field2D(
                plane[0, :, :, 0].cpu().numpy()), global_step=step)

    @torch.no_grad()
    def encode(self) -> Triplane:
        """The training volume's triplane (`[1, ., ., C]` planes)."""
        assert self.data is not None and self.params is not None
        return ae.encode(self.params, self.acfg, self.data.input_grid)

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Sign accuracy and TSDF errors of the decoded training grid and,
        with texture, the L1 error of the on-surface colours.  Where the
        meta has the grid's shape (the grid is the AABB's voxel centres)
        it decodes densely, `decode_grid_dense`, reordered by `grid_perm`
        onto the shuffled ground truth; without it (a reference bundle's
        meta) point by point over the shuffled grid points."""
        feat = self.encode()
        thr = self.meta["threshold"]
        grid_shape = self.meta.get("grid_shape")
        if grid_shape is not None:
            assert self.grid_perm is not None, \
                "evaluate() needs load_data()"
            with self._device_lock:
                gp, tp = self._planes(feat)
                pred = ae.decode_grid_dense(
                    self.params, self.acfg, gp, tp, tuple(grid_shape),
                    geo_only=True).cpu().numpy().reshape(-1, 1)
            pred = pred[self.grid_perm]
        else:
            pred = self.decode_batch(
                feat, self.data.pts_grid.cpu().numpy())[:, :1]
        gt = self.data.sdf_grid.cpu().numpy()
        if self.tcfg.sdf_renorm:
            pred, gt = pred * thr, gt * thr
        stat = evaluate_tsdf_prediction(pred, gt, thr)
        if self.acfg.use_tex and self.data.pts_on_surf is not None:
            tex_pred = self.decode_batch(
                feat, self.data.pts_on_surf.cpu().numpy(),
                batch_size=2 ** 20)[:, 1:]
            stat["surf_tex_l1_error"] = float(np.abs(
                tex_pred - self.data.tex_on_surf.cpu().numpy()).mean())
        return stat

    # -- export worker ------------------------------------------------------

    def _submit_assemble(self, **kw) -> None:
        """Run :meth:`_texmesh_assemble` on the background writer (inline
        when SIN3DM_ASYNC_EXPORT=0).  Its stages are the spans
        `export.<stage>` on the thread that runs them."""
        if os.environ.get("SIN3DM_ASYNC_EXPORT", "1") in ("0", "false", ""):
            self._texmesh_assemble(**kw)
            return
        with self._export_lock:
            if self._export_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._export_pool = ThreadPoolExecutor(
                    1, thread_name_prefix="sin3dm-export")
            self._export_futs.append(
                self._export_pool.submit(self._texmesh_assemble, **kw))

    def _drain_exports(self) -> None:
        """Wait for every submitted export; re-raise the first error."""
        with self._export_lock:
            futs, self._export_futs = self._export_futs, []
        for fut in futs:
            fut.result()

    # -- decode --------------------------------------------------------------

    def _planes(self, feat: Triplane):
        feat = _with_batch(feat).to(device=self.device, dtype=torch.float32)
        return ae.process_planes(self.params, self.acfg, feat)

    def _aabb(self, aabb) -> torch.Tensor:
        return torch.as_tensor(np.asarray(aabb, np.float32).reshape(-1),
                               device=self.device)

    @torch.no_grad()
    def decode_batch(self, feat: Triplane, points, batch_size: int = 2 ** 16,
                     aabb=None) -> np.ndarray:
        """Point decode in chunks -> `[N, 1 + Ct]` fp32 numpy, texture
        channels clipped to [0, 1]; the plane convs run once."""
        if aabb is None:
            aabb = self.meta["aabb"]
        points = np.asarray(points, np.float32)
        N = points.shape[0]
        if N == 0:
            n_out = 1 + (self.acfg.tex_channels if self.acfg.use_tex else 0)
            return np.zeros((0, n_out), np.float32)
        aabb_d = self._aabb(aabb)
        outs = []
        with self._device_lock:
            gp, tp = self._planes(feat)
            for i in range(0, N, batch_size):
                pts = torch.from_numpy(points[i:i + batch_size]).to(
                    self.device)
                outs.append(ae.decode_points(self.params, self.acfg, gp, tp,
                                             pts, aabb_d).cpu().numpy())
        preds = np.concatenate(outs, axis=0)
        if preds.shape[-1] > 1:
            preds[..., 1:] = np.clip(preds[..., 1:], 0.0, 1.0)
        return preds

    @torch.no_grad()
    def decode_texels(self, feat: Triplane, points: np.ndarray, aabb=None,
                      batch_size: int = 2 ** 20) -> np.ndarray:
        """Texture-only point decode -> uint8 `[N, tex_channels]`."""
        if aabb is None:
            aabb = self.meta["aabb"]
        points = np.asarray(points, np.float32)
        aabb_d = self._aabb(aabb)
        outs = []
        with self._device_lock:
            _, tp = self._planes(feat)
            for i in range(0, points.shape[0], batch_size):
                pts = torch.from_numpy(points[i:i + batch_size]).to(
                    self.device)
                outs.append(ae.decode_texels(self.params, self.acfg, tp, pts,
                                             aabb_d).cpu().numpy())
        if not outs:
            return np.zeros((0, self.acfg.tex_channels), np.uint8)
        return np.concatenate(outs, axis=0)

    @torch.no_grad()
    def decode_grid(self, feat: Triplane, reso: int, aabb=None,
                    batch_size: int = 2 ** 16, dense: bool = True,
                    geo_only: bool = False,
                    transfer_dtype=None) -> np.ndarray:
        """Decode the AABB voxel-centre grid -> `[Nx, Ny, Nz, 1+Ct]` fp32
        numpy, texture channels clipped to [0, 1].  `dense` decodes it as
        plane resizes (`decode_grid_dense`), else as points; `geo_only`
        keeps the sdf channel; `transfer_dtype` rounds the grid to that
        type on the device first."""
        if aabb is None:
            aabb = self.meta["aabb"]
        res = tuple(int(x) for x in grid_resolutions(np.asarray(aabb), reso))
        if not dense:
            coords = sample_grid_points_aabb(np.asarray(aabb), reso)
            preds = self.decode_batch(feat, coords.reshape(-1, 3),
                                      batch_size=batch_size, aabb=aabb)
            return preds.reshape(*res, -1)
        with self._device_lock:
            geo, tex = self._planes(feat)
            out = ae.decode_grid_dense(self.params, self.acfg, geo, tex, res,
                                       geo_only=geo_only,
                                       out_dtype=transfer_dtype)
            preds = out.float().cpu().numpy()
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

    def _feat_aabb(self, feat: Triplane) -> np.ndarray:
        return self._resize_aabb(_with_batch(feat).sizes)

    def decode_voxel(self, save_dir: str, feat: Triplane, reso: int) -> None:
        """Write `r{reso}_voxel.npz` holding `vox_grid = sdf < 0`."""
        new_aabb = self._feat_aabb(feat)
        os.makedirs(save_dir, exist_ok=True)
        sdf = self.decode_grid(feat, reso, aabb=new_aabb)[..., 0]
        np.savez_compressed(os.path.join(save_dir, f"r{reso}_voxel.npz"),
                            vox_grid=sdf < 0)

    # -- the mesh path -------------------------------------------------------

    def decode_texmesh(self, save_dir: str, feat: Triplane, reso: int,
                       n_faces: int = 10000, n_surf_pc: int = -1,
                       texture_reso: int = 2048, only_largest_cc: bool = True,
                       save_highres_mesh: bool = False,
                       save_voxel: bool = True, mtl_path=None,
                       file_format: str = "obj",
                       verbose: bool = False) -> None:
        """The mesh path for one sample (see :meth:`decode_texmesh_many`)."""
        self.decode_texmesh_many(
            [save_dir], [feat], reso, n_faces=n_faces, n_surf_pc=n_surf_pc,
            texture_reso=texture_reso, only_largest_cc=only_largest_cc,
            save_highres_mesh=save_highres_mesh, save_voxel=save_voxel,
            mtl_path=mtl_path, file_format=file_format, verbose=verbose)

    def dispatch_geo_grids(self, feats, reso: int) -> List[GeoGrid]:
        """Queue the geo-grid decodes of a batch of samples without
        waiting for them; handles for `decode_texmesh_many`."""
        return [self._dispatch_geo_grid(f, reso, self._feat_aabb(f))
                for f in feats]

    def decode_texmesh_many(self, save_dirs, feats, reso: int,
                            n_faces: int = 10000, n_surf_pc: int = -1,
                            texture_reso: int = 2048,
                            only_largest_cc: bool = True,
                            save_highres_mesh: bool = False,
                            save_voxel: bool = True, mtl_path=None,
                            file_format: str = "obj",
                            grid_handles=None,
                            pending_in=None, defer_last: bool = False,
                            verbose: bool = False):
        """The mesh path for a batch of samples, pipelined: every sample's
        geo grid is queued first (unless `grid_handles` brings them); per
        sample the host runs marching cubes, largest component,
        renormalization into the AABB, decimation, UV atlas and raster,
        then queues the texel decode, and the previous sample's assembly
        (texel fetch, seam dilation, export) goes to the export worker.

        With `defer_last` the last sample's assembly is not submitted: its
        kwargs come back, for the next call's `pending_in`
        (:meth:`pipelined_generate`).  Otherwise every export has finished
        when this returns.

        Each stage is timed once, from two `time.perf_counter_ns()`
        reads: the span `<family>.<stage>` (`decode`, or `export` for the
        export tail's stages) and, where `stage_log` is set, its entry
        (with the span's `start_ns` and `end_ns` while spans are
        recorded)."""
        def tick(save_dir, stage, t0, detail="", family="decode", **info):
            t = time.perf_counter_ns()
            rec = profiling.add(f"{family}.{stage}", t0, t, dir=save_dir)
            if self.stage_log is not None:
                self.stage_log.append({"dir": save_dir, "stage": stage,
                                       "seconds": (t - t0) / 1e9,
                                       **profiling.stamps(rec), **info})
            if verbose:
                print(f"  [decode_texmesh] {stage}{detail}: "
                      f"{(t - t0) / 1e9:.2f}s", flush=True)
            return t

        aabbs = [self._feat_aabb(f) for f in feats]
        if grid_handles is None:
            grid_handles = [self._dispatch_geo_grid(f, reso, a)
                            for f, a in zip(feats, aabbs)]
        else:
            grid_handles = list(grid_handles)

        pending = pending_in
        for idx, (save_dir, feat, new_aabb) in enumerate(
                zip(save_dirs, feats, aabbs)):
            t0 = time.perf_counter_ns()
            h = grid_handles[idx]
            grid_handles[idx] = None
            sdf_grid, sparse = self._fetch_geo_grid(h)
            t0 = tick(save_dir, "sdf grid", t0,
                      " (sparse wire)" if sparse is not None
                      else f" {sdf_grid.shape}", dispatch=h.seconds)
            cpu = self._texmesh_geometry(
                save_dir, feat, sdf_grid, new_aabb, reso, n_faces,
                n_surf_pc, texture_reso, only_largest_cc,
                save_highres_mesh, save_voxel, tick, t0,
                sparse=sparse, quant=h.quant)
            if cpu is None:   # empty surface, or sdf only: nothing to bake
                continue
            t0 = time.perf_counter_ns()
            texel_handle = self._dispatch_texels(feat, cpu["texels"],
                                                 new_aabb)
            tick(save_dir, "texel dispatch", t0,
                 f" ({texel_handle[1]} texels, {len(texel_handle[0])} "
                 "launches)", texels=texel_handle[1],
                 launches=len(texel_handle[0]))
            if pending is not None:
                self._submit_assemble(mtl_path=mtl_path,
                                      file_format=file_format, tick=tick,
                                      **pending)
            pending = dict(save_dir=save_dir, cpu=cpu,
                           texel_handle=texel_handle,
                           texture_reso=texture_reso)
        if defer_last:
            return pending
        if pending is not None:
            self._submit_assemble(mtl_path=mtl_path, file_format=file_format,
                                  tick=tick, **pending)
        self._drain_exports()
        return None

    def pipelined_generate(self, chunks, sample_chunk, prepare_chunk,
                           reso: int, **decode_kwargs) -> None:
        """Cross-chunk sample + decode schedule (the JAX package's, call
        for call): per chunk, run its reverse chain (`sample_chunk`),
        decode the previous chunk's meshes (its last assembly deferred),
        then `prepare_chunk(desc, samples) -> (save_dirs, feats)` and queue
        this chunk's geo grids.  decode_kwargs go to
        :meth:`decode_texmesh_many`."""
        pending = None
        pending_asm = None
        try:
            for desc in chunks:
                samples = sample_chunk(desc)
                if pending is not None:
                    pending_asm = self.decode_texmesh_many(
                        pending[0], pending[1], reso,
                        grid_handles=pending[2], pending_in=pending_asm,
                        defer_last=True, **decode_kwargs)
                    pending = None
                dirs, feats = prepare_chunk(desc, samples)
                pending = (dirs, feats, self.dispatch_geo_grids(feats, reso))
            if pending is not None:
                self.decode_texmesh_many(
                    pending[0], pending[1], reso, grid_handles=pending[2],
                    pending_in=pending_asm, **decode_kwargs)
                pending = None
                pending_asm = None
        except Exception:
            # export what was already sampled, then raise the first error
            try:
                if pending is not None:
                    self.decode_texmesh_many(
                        pending[0], pending[1], reso,
                        grid_handles=pending[2], pending_in=pending_asm,
                        **decode_kwargs)
                elif pending_asm is not None:
                    self._texmesh_assemble(
                        mtl_path=decode_kwargs.get("mtl_path"),
                        file_format=decode_kwargs.get("file_format", "obj"),
                        tick=lambda save_dir, stage, t0, *a, **k: t0,
                        **pending_asm)
                self._drain_exports()
            except Exception:
                pass   # the original error is what the caller must see
            raise

    @torch.no_grad()
    def _dispatch_geo_grid(self, feat: Triplane, reso: int,
                           aabb) -> GeoGrid:
        """Queue the geo-only grid decode and its copy to the host.  The
        clamped TSDF becomes int8 on the device (floor quantization keeps
        every voxel's sign), scale the threshold (1.0 under sdf_renorm),
        and travels as the sparse wire unless SIN3DM_SPARSE_GRID=0; the
        sdf data type keeps fp16, as its path writes the raw grid."""
        t0 = time.perf_counter_ns()
        res = tuple(int(x) for x in grid_resolutions(np.asarray(aabb), reso))
        quant = None
        if self.acfg.data_type != "sdf":
            thr = float(self.meta["threshold"])
            quant = 1.0 if self.tcfg.sdf_renorm else (
                thr if thr > 0 else None)
        with self._device_lock:
            gp, tp = self._planes(feat)
            grid = ae.decode_grid_dense(
                self.params, self.acfg, gp, tp, res, geo_only=True,
                out_dtype=None if quant is not None else torch.float16,
                quant_scale=quant)[..., 0]
            sparse = None
            if (quant is not None
                    and os.environ.get("SIN3DM_SPARSE_GRID", "1") != "0"):
                sparse = _sg.encode(grid)
                fetch = _Fetch([sparse.signs, sparse.block_ids,
                                sparse.block_vals, sparse.count])
            else:
                fetch = _Fetch([grid])
        t1 = time.perf_counter_ns()
        profiling.add("decode.grid dispatch", t0, t1)
        return GeoGrid(grid, quant, sparse, fetch, (t1 - t0) / 1e9)

    def _fetch_geo_grid(self, h: GeoGrid):
        """(dense fp32 sdf grid or None, host SparseGrid or None) of a
        dispatched geo grid.  Marching cubes reads the sparse wire directly
        unless SIN3DM_SPARSE_MC=0; where the flagged blocks overflowed its
        capacity, the dense grid is fetched instead."""
        if h.sparse is not None:
            signs, ids, vals, count = h.fetch.wait()
            if int(count) <= ids.shape[0]:
                sg = h.sparse._replace(signs=signs, block_ids=ids,
                                       block_vals=vals, count=int(count))
                if os.environ.get("SIN3DM_SPARSE_MC", "1") != "0":
                    return None, sg
                return _sg.decode_host(sg, h.quant), None
            arr = h.grid.cpu().numpy()
        else:
            arr = h.fetch.wait()[0]
        if h.quant is not None:
            # floor-quantized: bucket k covers [k, k+1), centre k + 0.5
            return (arr.astype(np.float32) + 0.5) * (h.quant / 127.0), None
        return arr.astype(np.float32), None

    @torch.no_grad()
    def _dispatch_texels_runs(self, feat: Triplane, runs: np.ndarray,
                              aabb, batch_size: int = 2 ** 20):
        """Queue the uint8 texel decode over the run-length wire; returns
        (chunk fetches, N).  The compact pack (default): u16 AABB-relative
        starts, f16 normalized steps, int32 offsets, 16 B/run;
        SIN3DM_TEXEL_WIRE=runs32 sends fp32 spans.  Chunks are of a power
        of two rows, 2^12 to `batch_size`."""
        aabb_np = np.asarray(aabb, np.float32).reshape(-1)
        wire = os.environ.get("SIN3DM_TEXEL_WIRE", self.tcfg.texel_wire)
        quantized = wire != "runs32"
        lens = (runs[:, 6].astype(np.int64) if len(runs)
                else np.zeros(0, np.int64))
        N = int(lens.sum())
        batch_size = min(batch_size,
                         1 << max(12, max(N - 1, 1).bit_length()))
        R = max(len(runs), 1)
        Rp = 1 << max(10, (R - 1).bit_length())
        offsets = np.full(Rp + 1, N, np.int32)
        offsets[0] = 0
        offsets[1:len(lens) + 1] = np.cumsum(lens, dtype=np.int64)
        if quantized:
            lo, span = aabb_np[:3], aabb_np[3:] - aabb_np[:3]
            starts = np.zeros((Rp, 3), np.uint16)
            steps = np.zeros((Rp, 3), np.float16)
            starts[:len(runs)] = np.clip(
                np.rint((runs[:, 0:3] - lo) / span * 65535.0),
                0.0, 65535.0).astype(np.uint16)
            steps[:len(runs)] = (runs[:, 3:6] * (2.0 / span)).astype(
                np.float16)
        else:
            starts = np.zeros((Rp, 3), np.float32)
            steps = np.zeros((Rp, 3), np.float32)
            starts[:len(runs)] = runs[:, 0:3]
            steps[:len(runs)] = runs[:, 3:6]

        chunks = []
        with self._device_lock:
            _, tp = self._planes(feat)
            off_d = torch.from_numpy(offsets).to(self.device)
            st_d = (_u16_to_device(starts, self.device) if quantized
                    else torch.from_numpy(starts).to(self.device))
            sp_d = torch.from_numpy(steps).to(self.device)
            aabb_d = self._aabb(aabb_np)
            for i in range(0, max(N, 1), batch_size):
                chunks.append(ae.decode_texels_runs(
                    self.params, self.acfg, tp, off_d, st_d, sp_d, i, aabb_d,
                    batch_size, quantized=quantized))
            fetch = _Fetch(chunks)
        return fetch, N

    @torch.no_grad()
    def _dispatch_texels(self, feat: Triplane, points, aabb,
                         batch_size: int = 2 ** 20):
        """Queue the uint8 texel decode; returns (fetch of the chunks, N).
        `points` is a TexelRuns payload (`_dispatch_texels_runs`) or
        `[N, 3]` points: uint16 AABB-relative (as given, or quantized here
        unless SIN3DM_TEXEL_WIRE=f32) or fp32."""
        if isinstance(points, TexelRuns):
            return self._dispatch_texels_runs(feat, points.runs, aabb,
                                              batch_size)
        aabb_np = np.asarray(aabb, np.float32).reshape(-1)
        wire = os.environ.get("SIN3DM_TEXEL_WIRE", self.tcfg.texel_wire)
        pre_q16 = isinstance(points, np.ndarray) and points.dtype == np.uint16
        q16 = wire != "f32" or pre_q16
        if not pre_q16:
            points = np.asarray(points, np.float32)
            if q16:
                lo, span = aabb_np[:3], aabb_np[3:] - aabb_np[:3]
                points = np.clip(np.rint((points - lo) / span * 65535.0),
                                 0.0, 65535.0).astype(np.uint16)
        N = points.shape[0]
        chunks = []
        with self._device_lock:
            _, tp = self._planes(feat)
            aabb_d = self._aabb(aabb_np)
            for i in range(0, N, batch_size):
                chunk = points[i:i + batch_size]
                n = chunk.shape[0]
                if n < batch_size:   # one shape for every chunk
                    chunk = np.pad(chunk, ((0, batch_size - n), (0, 0)))
                if q16:
                    out = ae.decode_texels_q16(
                        self.params, self.acfg, tp,
                        _u16_to_device(chunk, self.device))
                else:
                    out = ae.decode_texels(
                        self.params, self.acfg, tp,
                        torch.from_numpy(chunk).to(self.device), aabb_d)
                chunks.append(out)
            fetch = _Fetch(chunks)
        return fetch, N

    def _texmesh_geometry(self, save_dir: str, feat: Triplane,
                          sdf_grid: Optional[np.ndarray], new_aabb,
                          reso: int, n_faces: int, n_surf_pc: int,
                          texture_reso: int, only_largest_cc: bool,
                          save_highres_mesh: bool, save_voxel: bool, tick,
                          t0, sparse=None, quant=None):
        """Host geometry: voxel.npz, marching cubes (from the sparse wire
        where given), largest component, renormalization into the AABB,
        decimation, UV atlas and raster.  Returns None when there is
        nothing to bake."""
        os.makedirs(save_dir, exist_ok=True)
        if save_voxel:
            vox = (_sg.occupancy_host(sparse) if sparse is not None
                   else sdf_grid < 0)
            np.savez_compressed(os.path.join(save_dir, "voxel.npz"),
                                vox_grid=vox)
            t0 = tick(save_dir, "voxel.npz", t0)

        if sparse is not None:
            v, f = meshproc.sdfgrid_to_mesh_sparse(
                sparse, quant, only_largest_cc=only_largest_cc)
        else:
            v, f = meshproc.sdfgrid_to_mesh(
                sdf_grid, only_largest_cc=only_largest_cc)
        t0 = tick(save_dir, "marching cubes", t0, f" ({len(f)} tris)")
        if len(f) == 0:
            # no zero crossing: an empty placeholder, not a crash later
            print(f"decode_texmesh: empty surface, writing empty mesh to "
                  f"{save_dir}")
            meshio.save_mesh_vf(os.path.join(save_dir, "object.obj"),
                                np.zeros((0, 3)), np.zeros((0, 3), int))
            return None
        if save_highres_mesh:
            meshio.save_mesh_vf(
                os.path.join(save_dir, f"mesh_r{reso}.obj"), v, f)

        # index-space vertices into the AABB
        box_min = new_aabb[:3]
        box_size = new_aabb[3:].max() - new_aabb[:3].min()
        v = v / reso * box_size + box_min

        v, f = meshproc.mesh_decimation(v, f, n_faces)
        t0 = tick(save_dir, "decimation", t0, f" ({len(f)} tris)")

        if self.acfg.data_type == "sdf":
            np.savez_compressed(os.path.join(save_dir, f"sdfgrid_r{reso}.npz"),
                                sdf_grid=sdf_grid)
            meshio.save_mesh_vf(
                os.path.join(save_dir, f"mesh_r{reso}_simple.obj"), v, f)
            return None

        if n_surf_pc > 0:
            fi, bc = meshproc.sample_mesh_random(v, f, n_surf_pc)
            surf_pts = meshproc.interpolate_barycentric(f, fi, bc, v)
            preds = self.decode_batch(feat, surf_pts, aabb=new_aabb)
            meshio.save_colored_pointcloud_obj(
                os.path.join(save_dir, f"surf_pc_n{n_surf_pc}.obj"),
                surf_pts, np.clip(preds[..., 1:4], 0, 1))

        wire = os.environ.get("SIN3DM_TEXEL_WIRE", self.tcfg.texel_wire)
        if wire.startswith("runs"):
            uvs, tex_idx, mask, runs = uvatlas.uv_unwrap_and_rasterize_runs(
                v, f, texture_reso)
            t0 = tick(save_dir, "uv atlas + raster", t0,
                      f" ({int(mask.sum())} texels, {len(runs)} runs)")
            texels = TexelRuns(runs)
        else:
            uvs, tex_idx, gb_pos, mask = uvatlas.uv_unwrap_and_rasterize(
                v, f, texture_reso)
            t0 = tick(save_dir, "uv atlas + raster", t0,
                      f" ({int(mask.sum())} texels)")
            if wire != "f32":
                lo = np.asarray(new_aabb[:3], np.float32)
                span = np.asarray(new_aabb[3:], np.float32) - lo
                texels = native.mask_compact_q16(
                    gb_pos.reshape(-1, 3), mask.reshape(-1), lo, span)
            else:
                texels = gb_pos.reshape(-1, 3)[mask.reshape(-1)]
        return {"v": v, "f": f, "uvs": uvs, "tex_idx": tex_idx,
                "mask": mask, "texels": texels}

    def _texmesh_assemble(self, save_dir: str, cpu: Dict, texel_handle,
                          texture_reso: int, mtl_path, file_format: str,
                          tick) -> None:
        """The export tail: fetch the texel chunks, dilate seams, write."""
        t0 = time.perf_counter_ns()
        fetch, N = texel_handle
        preds = np.concatenate(fetch.wait(), axis=0)[:N]
        t0 = tick(save_dir, "texel decode", t0, family="export")
        mask = cpu["mask"]
        v, f, uvs, tex_idx = cpu["v"], cpu["f"], cpu["uvs"], cpu["tex_idx"]
        # scatter + 3x3 seam dilation + flip in one C++ pass
        tex_img = native.tex_assemble(preds, mask, texture_reso)
        t0 = tick(save_dir, "texture assembly", t0, family="export")

        if self.acfg.data_type == "sdftex":
            if file_format == "obj":
                mtl_str = (meshio.read_material_params_from_mtl(mtl_path)
                           if mtl_path else None)
                meshio.save_mesh_with_tex(
                    os.path.join(save_dir, "object.obj"),
                    np.asarray(v), uvs, np.asarray(f), tex_idx, tex_img,
                    mtl_str=mtl_str,
                    Kd=self.meta.get("Kd", [1, 1, 1]),
                    Ka=self.meta.get("Ka", [0, 0, 0]),
                    Ks=self.meta.get("Ks", [0.4, 0.4, 0.4]),
                    Ns=self.meta.get("Ns", 10))
            elif file_format == "glb":
                meshio.save_mesh_with_tex_to_glb(
                    os.path.join(save_dir, "object.glb"),
                    np.asarray(v), uvs, np.asarray(f), tex_idx, tex_img)
            else:
                raise NotImplementedError(file_format)
        elif self.acfg.data_type == "sdfpbr":
            meshio.save_mesh_with_pbr(
                os.path.join(save_dir, "object.obj"),
                np.asarray(v), uvs, np.asarray(f), tex_idx,
                tex_img[..., :3], tex_img[..., 3], tex_img[..., 4],
                tex_img[..., 5:])
        else:
            raise NotImplementedError(self.acfg.data_type)
        tick(save_dir, "export", t0, family="export")
