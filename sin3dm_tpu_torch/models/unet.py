"""Triplane UNet denoiser (counterpart of `sin3dm_tpu/models/unet.py`).

Functional, over a parameter dict in JAX's layout (`init_unet`, or
`compat/from_jax.py`), where each 3x3 conv may also hold "k1", its
weights packed once for the bf16 kernel (`ops.pack_params`).  Each
triplane conv is three per-plane 2D convs; with rollout every plane's
input is concatenated with the broadcast axis-means of the other two
planes.  That concat is never built: by linearity the broadcast channels'
3x3 contribution is a 3-tap 1D conv of the un-broadcast mean vectors plus
border fix-ups (`_colvar_vecs` / `_rowvar_vecs`).  Two forwards:

- `unet_apply`, the sampler's, under `torch.no_grad`: every 3x3 conv goes
  through the kernel K1 (`ops/fused_conv.py`), which adds the fix-ups in
  its epilogue, in bf16 and in fp32 alike, a triplane conv's three planes
  in one call (`conv3x3_rollout_triplane`: one launch in bf16).  The 3-tap
  products read their kernels packed once ("k1v", `ops.pack_params` with
  `rollout`) where the tree has them.  In a bf16 torso with `fast_norm`
  each triplane norm (GroupNorm32 [+ FiLM] + SiLU) is one call of
  `ops.tnorm.tnorm_silu` (one launch on the card), which also gives the
  next rollout conv its six axis means, stacked for the products.  With
  `UNetConfig.fused_conv` off (JAX's field; `SIN3DM_FUSED_CONV=0` in
  `cli/sample.py`) it runs the training forward's convs instead, and the
  opt-in configurations below do not apply, as in JAX.
- `unet_train_apply`, the differentiable one, JAX's `fused_conv=False`
  route: the self part of each 3x3 conv as `F.conv2d` (cuDNN on the
  card), plus the fix-ups as `_colvar_contrib` / `_rowvar_contrib`, plus
  the bias; `use_checkpoint` recomputes each resblock in the backward
  (`torch.utils.checkpoint`, as JAX's `jax.checkpoint`).  K1 has no
  backward and refuses a call that autograd would record.

With `UNetConfig.spatial_group` (a `parallel.DataGroup`) the sampler's
forward runs on planes whose dim 1 is sharded over the group's ranks (x
for xy and xz, y for yz), as JAX's `spatial_mesh`: the differentiable
form's convs (K1 off, as JAX turns its fused conv off there) with every
3x3 self conv a halo conv (`parallel/halo.py`), the rollout axis-means
over a sharded axis summed over the ranks and the vectors a plane needs
along its own unsharded axis gathered (one `all_reduce` per rollout
conv), GroupNorm's (sum, sum of squares) summed over the ranks before the
fold (one per triplane norm), the 2x upsampling with one neighbour row;
average pooling stays local.  GSPMD inserts these collectives in JAX.

Sampling numerics follow the JAX package's accelerator defaults: a bf16
torso with `fast_norm` (fp32 GroupNorm statistics, apply in bf16); the
chain state stays fp32.  Training takes the `args.json` dtype: fp32, or
with `use_fp16` a bf16 torso with `fast_norm` over fp32 parameters.

Two opt-in configurations of the resblocks, read from the environment at
every forward as the JAX package reads them (default "0"; fused-act wins
where both are set).  The port's conditions are JAX's with
`fused_conv=True`, since every 3x3 conv here is K1:

- `SIN3DM_FUSED_ACT=1`: each norm + FiLM + SiLU folds into per-channel
  coefficients that K1′ applies to its input (`act=`).  The rollout axis
  means still take the activation applied in the compute dtype, which
  this eager port writes out (XLA fuses it into the reductions).  JAX
  turns its kernel off for a 4-byte compute dtype and applies the
  coefficients outside; the port keeps K1′ there, so in fp32 the two
  differ by summation order only.
- `SIN3DM_STATS_CHAIN=1` (2-byte compute dtype only): a block's convs also
  emit their outputs' (sum, sum of squares) (`emit_stats`), the next
  GroupNorm's coefficients come from those, and the residual add rides
  in the out conv's epilogue (`skip=`).  The statistics reset wherever
  the tensor changes outside a chained conv (down/up-sampling, the skip
  concat).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import nn
from ..core.triplane import Triplane
from ..ops.fused_conv import (conv3x3_rollout_triplane, form_name,
                               pack_taps, rollout_taps)
from ..ops.tnorm import stack3, tnorm_silu
from ..parallel import halo
from ..parallel.mesh import all_reduce_many, gather_slot

PLANES = ("xy", "xz", "yz")


class UNetConfig(NamedTuple):
    in_channels: int = 12
    model_channels: int = 64
    out_channels: int = 12
    num_res_blocks: int = 1
    dropout: float = 0.0
    channel_mult: Tuple[int, ...] = (1, 2)
    use_scale_shift_norm: bool = True
    rollout: bool = True              # unet_small vs unet_raw
    compute_dtype: torch.dtype = torch.float32
    fast_norm: bool = False
    use_checkpoint: bool = False      # training forward only
    # JAX's field: the sampler's forward through K1 (default here: the
    # port's sampler has always taken it); off, it runs the training
    # forward's convs under no_grad (`SIN3DM_FUSED_CONV=0`, cli/sample.py)
    fused_conv: bool = True
    # a parallel.DataGroup over which dim 1 of every plane is sharded
    # (the sampler's forward only); None: whole planes
    spatial_group: Any = None

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _tconv_init(gen: torch.Generator, cin: int, cout: int, ksize: int,
                rollout: bool, zero: bool = False) -> Dict:
    """Three per-plane convs; rollout triples the input channels."""
    kshape = (ksize, ksize, cin * 3 if rollout else cin, cout)
    if zero:
        return {p: nn.zero_conv_init(kshape, gen.device) for p in PLANES}
    return {p: nn.torch_conv_init(gen, kshape) for p in PLANES}


def _tnorm_init(channels: int, device) -> Dict:
    return {p: nn.group_norm_init(channels, device) for p in PLANES}


def _resblock_init(gen: torch.Generator, cin: int, cout: int, emb_dim: int,
                   use_scale_shift: bool, rollout: bool) -> Dict:
    p = {
        "in_norm": _tnorm_init(cin, gen.device),
        "in_conv": _tconv_init(gen, cin, cout, 3, rollout),
        "emb": nn.torch_linear_init(
            gen, emb_dim, 2 * cout if use_scale_shift else cout),
        "out_norm": _tnorm_init(cout, gen.device),
        "out_conv": _tconv_init(gen, cout, cout, 3, rollout, zero=True),
    }
    if cin != cout:
        p["skip"] = _tconv_init(gen, cin, cout, 1, rollout=False)
    return p


def init_unet(gen: torch.Generator, cfg: UNetConfig) -> Dict:
    """The parameter tree of JAX's `init_unet` (the same keys, list
    positions, shapes and zero-initialised out convs), fp32 on the
    generator's device, drawn from `gen` in construction order."""
    mc = cfg.model_channels
    emb_dim = cfg.time_embed_dim
    params: Dict = {"time_embed": {
        "l1": nn.torch_linear_init(gen, mc, emb_dim),
        "l2": nn.torch_linear_init(gen, emb_dim, emb_dim)}}
    input_ch = int(cfg.channel_mult[0] * mc)
    params["in_conv"] = _tconv_init(gen, cfg.in_channels, input_ch, 1,
                                    rollout=False)
    blocks: List[Dict] = [
        _resblock_init(gen, cin, cout, emb_dim, cfg.use_scale_shift_norm,
                       cfg.rollout) for cin, cout in _block_widths(cfg)]
    n, levels = cfg.num_res_blocks, len(cfg.channel_mult)
    params["down"] = [blocks[i * n:(i + 1) * n] for i in range(levels)]
    params["up"] = [blocks[(levels + i) * n:(levels + i + 1) * n]
                    for i in range(levels)]
    params["out"] = {
        "norm": _tnorm_init(input_ch, gen.device),
        "conv": _tconv_init(gen, input_ch, cfg.out_channels, 1,
                            rollout=False, zero=True)}
    return params


# ---------------------------------------------------------------------------
# Rollout conv
# ---------------------------------------------------------------------------

def _axis_means(t: Triplane, dtype=None, sizes=None):
    """The six axis means the rollout reads, (m_yz_d, m_xz_d, m_xy_w,
    m_yz_w, m_xy_h, m_xz_h): yz, xz and xy over their dim -2, then yz, xy
    and xz over their dim -3, in `dtype` (torch.mean's) where given.
    With `sizes`, the whole planes' (H, W, D) of a t sharded on dim 1,
    the dim -3 means are this shard's sums over the whole lengths (W, H,
    H), which the ranks then add up."""
    d2 = [v.mean(dim=-2, dtype=dtype) for v in (t.yz, t.xz, t.xy)]
    if sizes is None:
        return (*d2, *[v.mean(dim=-3, dtype=dtype)
                       for v in (t.yz, t.xy, t.xz)])
    H, W, _ = sizes
    return (*d2, *[v.sum(dim=-3, dtype=dtype) / n
                   for v, n in ((t.yz, W), (t.xy, H), (t.xz, H))])


def _rollout_cat(t: Triplane) -> Triplane:
    """Each plane concatenated with broadcast axis-means of the other two
    (the materialized form; used only for planes smaller than 2)."""
    B = t.xy.shape[0]
    H, W, D = t.sizes
    C = t.channels
    m_yz_d, m_xz_d, m_xy_w, m_yz_w, m_xy_h, m_xz_h = _axis_means(t)
    xy = torch.cat([t.xy, m_yz_d[:, None].expand(B, H, W, C),
                    m_xz_d[:, :, None].expand(B, H, W, C)], dim=-1)
    xz = torch.cat([t.xz, m_xy_w[:, :, None].expand(B, H, D, C),
                    m_yz_w[:, None].expand(B, H, D, C)], dim=-1)
    yz = torch.cat([t.yz, m_xy_h[:, :, None].expand(B, W, D, C),
                    m_xz_h[:, None].expand(B, W, D, C)], dim=-1)
    return Triplane(xy, xz, yz)


def _conv1d3_packed(stack: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """Several 3-tap zero-padded 1D convs in one product: stack `[B, L, 3,
    C]` (`stack3` of the vector), kp `[3, C, V, Co]` (`pack_taps` of V
    kernels).  Returns the packed `[B, L, V, Co]` (the layout K1 takes for
    col3/row3)."""
    B, L = stack.shape[:2]
    V, Co = kp.shape[2], kp.shape[3]
    out = stack.reshape(B * L, -1) @ kp.reshape(-1, V * Co)
    return out.reshape(B, L, V, Co)


def _conv1d3_multi(vec: torch.Tensor, k3s) -> torch.Tensor:
    """`_conv1d3_packed` of vec `[B, L, C]` and V kernels each `[3, C,
    Co]`, packed now."""
    return _conv1d3_packed(stack3(vec), pack_taps(k3s, vec.dtype))


def _colvar_vecs(vec: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """(s_top, s_full, s_bot) packed `[B, W, 3, Co]`: the 3x3 contribution
    of an image constant along rows (vec `[B, W, C]` broadcast over H)."""
    return _conv1d3_multi(vec, rollout_taps(kb, rows=False))


def _rowvar_vecs(vec: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """(r_left, r_full, r_right) packed `[B, H, 3, Co]` for an image
    constant along columns (vec `[B, H, C]` broadcast over W)."""
    return _conv1d3_multi(vec, rollout_taps(kb, rows=True))


def _taps(pp: Dict, C: int, col_first: bool, dtype):
    """One plane's (col3, row3) kernels `[3, C, 3, Co]` in `dtype`: its
    "k1v" pack where the tree has one in that dtype, else packed now from
    the broadcast blocks of its weight."""
    kv = pp.get("k1v")
    if kv is not None and kv.dtype == dtype:
        return kv[0], kv[1]
    w = pp["w"]
    cs, rs = (C, 2 * C) if col_first else (2 * C, C)
    return (pack_taps(rollout_taps(w[:, :, cs:cs + C], False), dtype),
            pack_taps(rollout_taps(w[:, :, rs:rs + C], True), dtype))


def _act_triplane(t: Triplane, act: Dict) -> Triplane:
    """Per-plane `silu(x*A + B)` applied in x's dtype (the form of K1′'s
    `act=` outside the kernel)."""
    return Triplane(*[nn.apply_film_coeffs(x, *act[k])
                      for k, x in zip(PLANES, t)])


def _tconv_apply_rollout_fast(p: Dict, t: Triplane, act: Dict = None,
                              skip: Triplane = None,
                              emit_stats: bool = False, stacks=None):
    """Rollout 3x3 conv without the 3x-channel concat, through K1.

    With `act` (per-plane folded GN32[+FiLM]+SiLU coefficients) `t` is
    the raw pre-norm triplane: K1′ activates its input, while the axis
    means here are taken of the activation applied in t's dtype, as in
    the JAX package.  `stacks`: the six axis means already `stack3`ed in
    `_axis_means`' order (the norm kernel's), else taken here.  `skip` is
    added in the kernel's epilogue; with `emit_stats` the result is
    (Triplane, {plane: [B, 2, Co] stats})."""
    C = t.channels
    if stacks is None:
        ta = _act_triplane(t, act) if act is not None else t
        stacks = [stack3(m) for m in _axis_means(ta)]
    s_yz_d, s_xz_d, s_xy_w, s_yz_w, s_xy_h, s_xz_h = stacks

    def vecs(k, col, row):
        kc, kr = _taps(p[k], C, k == "xy", t.dtype)
        return _conv1d3_packed(col, kc), _conv1d3_packed(row, kr)

    # block order per plane follows _rollout_cat:
    #   xy: [self, col-varying (m_yz_d), row-varying (m_xz_d)]
    #   xz: [self, row-varying (m_xy_w), col-varying (m_yz_w)]
    #   yz: [self, row-varying (m_xy_h), col-varying (m_xz_h)]
    cr = (vecs("xy", s_yz_d, s_xz_d), vecs("xz", s_yz_w, s_xy_w),
          vecs("yz", s_xz_h, s_xy_h))
    out = conv3x3_rollout_triplane(
        list(t), [p[k]["w"][:, :, :C] for k in PLANES],
        [p[k].get("b") for k in PLANES], [c for c, _ in cr],
        [r for _, r in cr],
        [act[k] if act is not None else None for k in PLANES],
        list(skip) if skip is not None else [None] * 3, emit_stats,
        packed=[p[k].get("k1") for k in PLANES])
    if emit_stats:
        return Triplane(*out[0]), dict(zip(PLANES, out[1]))
    return Triplane(*out)


def _fast_rollout(p: Dict, t: Triplane, rollout: bool) -> bool:
    """Whether `_tconv_apply` takes t through `_tconv_apply_rollout_fast`
    (and so reads its axis means)."""
    return rollout and p["xy"]["w"].shape[0] == 3 and min(t.sizes) >= 2


def _tconv_apply(p: Dict, t: Triplane, rollout: bool,
                 act: Dict = None, stacks=None) -> Triplane:
    is3 = p["xy"]["w"].shape[0] == 3
    if rollout:
        if _fast_rollout(p, t, rollout):
            return _tconv_apply_rollout_fast(p, t, act=act, stacks=stacks)
        if act is not None:
            t = _act_triplane(t, act)
            act = None
        t = _rollout_cat(t)
    if is3:
        return Triplane(*conv3x3_rollout_triplane(
            list(t), [p[k]["w"] for k in PLANES],
            [p[k].get("b") for k in PLANES], [None] * 3, [None] * 3,
            [act[k] if act is not None else None for k in PLANES],
            packed=[p[k].get("k1") for k in PLANES]))
    if act is not None:
        t = _act_triplane(t, act)
    return Triplane(*[nn.conv2d(p[k], x) for k, x in zip(PLANES, t)])


# ---------------------------------------------------------------------------
# Rollout conv, differentiable (the training forward)
# ---------------------------------------------------------------------------

def _spread(v3: torch.Tensor, n: int) -> torch.Tensor:
    """`[B, L, 3, Co]` (first, interior, last) -> `[B, L, n, Co]`: entry 0
    at index 0, entry 2 at index n-1, entry 1 between (n >= 2)."""
    B, L, _, Co = v3.shape
    return torch.cat([v3[:, :, :1], v3[:, :, 1:2].expand(B, L, n - 2, Co),
                      v3[:, :, 2:]], dim=2)


def _colvar_contrib(vec: torch.Tensor, kb: torch.Tensor,
                    H: int) -> torch.Tensor:
    """`[B, H, W, Co]` 3x3 contribution of an image constant along rows
    (vec `[B, W, C]` broadcast over H): row 0 takes s_top, row H-1 s_bot,
    the rest s_full."""
    return _spread(_colvar_vecs(vec, kb), H).permute(0, 2, 1, 3)


def _rowvar_contrib(vec: torch.Tensor, kb: torch.Tensor,
                    W: int) -> torch.Tensor:
    """The same for an image constant along columns (vec `[B, H, C]`
    broadcast over W)."""
    return _spread(_rowvar_vecs(vec, kb), W)


def _tconv_apply_rollout_train(p: Dict, t: Triplane) -> Triplane:
    """Rollout 3x3 conv without the 3x-channel concat, differentiable:
    `F.conv2d` of each plane's own channels, then the col- and
    row-varying contributions, then the bias, in t's dtype."""
    C = t.channels
    m_yz_d, m_xz_d, m_xy_w, m_yz_w, m_xy_h, m_xz_h = _axis_means(t)

    def one(pp, x, col_vec, row_vec, col_first: bool):
        w = pp["w"]
        cs, rs = (C, 2 * C) if col_first else (2 * C, C)
        y = nn.conv2d({"w": w[:, :, :C]}, x)
        y = y + _colvar_contrib(col_vec, w[:, :, cs:cs + C], x.shape[1])
        y = y + _rowvar_contrib(row_vec, w[:, :, rs:rs + C], x.shape[2])
        if "b" in pp:
            y = y + pp["b"].to(y.dtype)
        return y

    # the block order per plane of `_tconv_apply_rollout_fast`
    return Triplane(one(p["xy"], t.xy, m_yz_d, m_xz_d, True),
                    one(p["xz"], t.xz, m_yz_w, m_xy_w, False),
                    one(p["yz"], t.yz, m_xz_h, m_xy_h, False))


def _global_sizes(t: Triplane, sg) -> Tuple[int, int, int]:
    """(H, W, D) of the whole planes of which `t` holds this rank's
    shards (dim 1 of each plane sharded over `sg`)."""
    n = 1 if sg is None else sg.size
    return t.xy.shape[1] * n, t.yz.shape[1] * n, t.xz.shape[2]


def _rows_contrib(v3: torch.Tensor, n_rows: int, first: int,
                  count: int) -> torch.Tensor:
    """`_colvar_contrib` for rows `first..first+count-1` of `n_rows`:
    `[B, L, 3, Co]` -> `[B, count, L, Co]`."""
    idx = [0 if g == 0 else 2 if g == n_rows - 1 else 1
           for g in range(first, first + count)]
    return v3[:, :, torch.tensor(idx, device=v3.device)].permute(0, 2, 1, 3)


def _tconv_apply_rollout_sharded(p: Dict, t: Triplane, sg) -> Triplane:
    """`_tconv_apply_rollout_train` of planes sharded on dim 1 over `sg`:
    the axis-means over a sharded axis are summed over the ranks, the
    means along a sharded axis gathered whole (one `all_reduce` for the
    six), so every plane gets the vectors of the unsharded conv; the self
    parts are halo convs (one more `all_reduce`); the col-varying
    contributions take the plane's global row positions, the row-varying
    ones this shard's rows of the whole vector."""
    C = t.channels
    H, W, D = _global_sizes(t, sg)
    means = _axis_means(t, torch.float32, (H, W, D))
    # the means along the sharded axes gathered whole, over it summed
    red = all_reduce_many(sg, [gather_slot(sg, m) for m in means[:3]]
                          + list(means[3:]))
    whole = [torch.cat(list(v.unbind(0)), dim=1) for v in red[:3]]
    m_yz_d, m_xz_d, m_xy_w, m_yz_w, m_xy_h, m_xz_h = [
        v.to(t.dtype) for v in whole + red[3:]]
    selfs = halo.halo_conv2d_many(
        [{"w": p[k]["w"][:, :, :C]} for k in PLANES], list(t), sg)

    def one(pp, y, col_vec, row_vec, col_first: bool, n_rows: int):
        w = pp["w"]
        cs, rs = (C, 2 * C) if col_first else (2 * C, C)
        h = y.shape[1]
        first = sg.rank * h
        y = y + _rows_contrib(_colvar_vecs(col_vec, w[:, :, cs:cs + C]),
                              n_rows, first, h)
        y = y + _spread(_rowvar_vecs(row_vec, w[:, :, rs:rs + C])[
            :, first:first + h], y.shape[2])
        if "b" in pp:
            y = y + pp["b"].to(y.dtype)
        return y

    return Triplane(one(p["xy"], selfs[0], m_yz_d, m_xz_d, True, H),
                    one(p["xz"], selfs[1], m_yz_w, m_xy_w, False, H),
                    one(p["yz"], selfs[2], m_xz_h, m_xy_h, False, W))


def _tconv_apply_train(p: Dict, t: Triplane, rollout: bool,
                       sg=None) -> Triplane:
    is3 = p["xy"]["w"].shape[0] == 3
    if rollout:
        if is3 and min(_global_sizes(t, sg)) >= 2:
            if sg is not None:
                return _tconv_apply_rollout_sharded(p, t, sg)
            return _tconv_apply_rollout_train(p, t)
        if sg is not None:
            raise ValueError("spatial sharding needs planes of at least 2 "
                             "on each side at every level")
        t = _rollout_cat(t)
    if sg is not None and is3:
        return Triplane(*halo.halo_conv2d_many([p[k] for k in PLANES],
                                               list(t), sg))
    return Triplane(*[nn.conv2d(p[k], x) for k, x in zip(PLANES, t)])


# ---------------------------------------------------------------------------
# Norms and ResBlock
# ---------------------------------------------------------------------------

def _tnorm_stats_sharded(t: Triplane, sg, eps: float = 1e-5):
    """Per-plane GroupNorm32 (mean, rstd) `[B, g]` of planes sharded over
    `sg`: each plane's (sum, sum of squares) summed over the ranks (one
    `all_reduce` for the three planes), var = E[x^2] - mean^2 clamped at
    0."""
    sums = all_reduce_many(sg, [s for x in t for s in nn.group_sums(x)])
    out = []
    for i, x in enumerate(t):
        n = x.shape[1] * sg.size * x.shape[2] * (x.shape[3] // 32)
        mean = sums[2 * i] / n
        var = sums[2 * i + 1] / n - mean * mean
        out.append((mean, torch.rsqrt(var.clamp_min(0.0) + eps)))
    return out


def _tnorm_apply(p: Dict, t: Triplane, sg=None) -> Triplane:
    if sg is not None:
        return Triplane(*[nn.group_norm32_from_stats(p[k], x, *st)
                          for k, x, st in zip(PLANES, t,
                                              _tnorm_stats_sharded(t, sg))])
    return Triplane(*[nn.group_norm32(p[k], x) for k, x in zip(PLANES, t)])


def _tnorm_silu_fast(p: Dict, t: Triplane, film=None, sg=None) -> Triplane:
    if sg is not None:
        return Triplane(*[
            nn.group_norm32_film_silu_from_stats(p[k], x, *st, film=film)
            for k, x, st in zip(PLANES, t, _tnorm_stats_sharded(t, sg))])
    return Triplane(*[nn.group_norm32_film_silu(p[k], x, film)
                      for k, x in zip(PLANES, t)])


def _tnorm_silu(p: Dict, t: Triplane, fast_norm: bool, k1: bool,
                sg=None, film: torch.Tensor = None, conv: Dict = None,
                rollout: bool = False):
    """GN32 [+ FiLM] + SiLU of a triplane: (activated triplane, stacks).
    film: `emb_out` `[B, 1, 1, 2C]` (scale then shift).  In K1's forward
    of a bf16 torso with `fast_norm` one `tnorm_silu` call (one launch on
    the card), whose stacks are the six axis means `stack3`ed in
    `_axis_means`' order where the rollout conv `conv` reads them; else
    the eager norm (over `sg`'s shards where given), and stacks None."""
    if k1 and fast_norm and t.dtype == torch.bfloat16:
        means = conv is not None and _fast_rollout(conv, t, rollout)
        ys, _, st = tnorm_silu(list(t), [p[k]["g"] for k in PLANES],
                               [p[k]["b"] for k in PLANES], film, means)
        if not means:
            return Triplane(*ys), None
        (xy_r, xy_c), (xz_r, xz_c), (yz_r, yz_c) = st
        return Triplane(*ys), (yz_r, xz_r, xy_r, yz_c, xy_c, xz_c)
    pair = None if film is None else tuple(torch.chunk(film, 2, dim=-1))
    if fast_norm:
        return _tnorm_silu_fast(p, t, film=pair, sg=sg), None
    h = _tnorm_apply(p, t, sg)
    if pair is not None:
        scale, shift = pair
        h = h.map(lambda v: v * (1.0 + scale) + shift)
    return h.map(nn.silu), None


def _use_fused_act() -> bool:
    """`SIN3DM_FUSED_ACT=1`: norm + FiLM + SiLU applied inside K1′."""
    return os.environ.get("SIN3DM_FUSED_ACT", "0") == "1"


def _use_stats_chain() -> bool:
    """`SIN3DM_STATS_CHAIN=1`: GroupNorm statistics chained through K1′'s
    epilogues (ignored where `SIN3DM_FUSED_ACT=1`)."""
    return os.environ.get("SIN3DM_STATS_CHAIN", "0") == "1"


def _tnorm_coeffs(p: Dict, t: Triplane, film=None) -> Dict:
    """Per-plane folded GN32[+FiLM]+SiLU coefficients (A, B) for K1′."""
    return {k: nn.group_norm32_film_coeffs(p[k], x, film)
            for k, x in zip(PLANES, t)}


def _tnorm_coeffs_from_stats(p: Dict, stats: Dict, sizes,
                             film=None) -> Dict:
    """The same from chained (sum, sum of squares) statistics."""
    H, W, D = sizes
    n_hw = {"xy": H * W, "xz": H * D, "yz": W * D}
    return {k: nn.group_norm32_coeffs_from_sums(p[k], stats[k], n_hw[k],
                                                film)
            for k in PLANES}


def _stats_block_ok(p: Dict, t: Triplane, rollout: bool) -> bool:
    """Whether a resblock runs stats-chained: 3x3 rollout convs on the
    fast path and both convs' input widths within 128 channels, the
    widths at which the JAX kernel emits statistics.  JAX checks only
    the in conv's width and raises where the out conv's exceeds 128
    (e.g. model_channels 96, mult (1, 2)); the port leaves that block
    unchained."""
    return (rollout and p["in_conv"]["xy"]["w"].shape[0] == 3
            and min(t.sizes) >= 2 and t.channels <= 128
            and p["out_conv"]["xy"]["w"].shape[2] // 3 <= 128)


def _resblock_apply_stats(p: Dict, t: Triplane, t_stats: Optional[Dict],
                          emb: torch.Tensor, use_scale_shift: bool):
    """Stats-chained resblock: GroupNorm coefficients from the previous
    conv's (sum, sum of squares) where given, norm + FiLM + SiLU inside
    K1′, the residual add in the out conv's epilogue.  Returns (out,
    out_stats); out_stats feed the next block's in norm (or the final
    norm).  The FiLM is split from the fp32 `emb_out`."""
    a1 = (_tnorm_coeffs_from_stats(p["in_norm"], t_stats, t.sizes)
          if t_stats is not None else _tnorm_coeffs(p["in_norm"], t))
    h, h_stats = _tconv_apply_rollout_fast(p["in_conv"], t, act=a1,
                                           emit_stats=True)
    emb_out = nn.linear(p["emb"], nn.silu(emb))[:, None, None, :]
    if use_scale_shift:
        film = tuple(torch.chunk(emb_out, 2, dim=-1))
        a2 = _tnorm_coeffs_from_stats(p["out_norm"], h_stats, h.sizes,
                                      film=film)
    else:
        # the emb add lands between conv and norm: the stats no longer
        # describe the normed tensor
        h = h.map(lambda v: v + emb_out.to(v.dtype))
        a2 = _tnorm_coeffs(p["out_norm"], h)
    skip = _tconv_apply(p["skip"], t, rollout=False) if "skip" in p else t
    return _tconv_apply_rollout_fast(p["out_conv"], h, act=a2, skip=skip,
                                     emit_stats=True)


def _resblock_apply(p: Dict, t: Triplane, emb: torch.Tensor,
                    use_scale_shift: bool, rollout: bool,
                    fast_norm: bool, k1: bool = True,
                    sg=None) -> Triplane:
    """One resblock; its 3x3 convs through K1 where `k1`, else the
    differentiable `_tconv_apply_train` (over `sg`'s shards where given),
    and then the opt-in configurations, which need K1′, do not apply."""
    if k1:
        conv = _tconv_apply
    else:
        def conv(pp, tt, ro, stacks=None):
            return _tconv_apply_train(pp, tt, ro, sg)
    if k1 and _use_fused_act():
        # norm + FiLM + SiLU as coefficients applied inside K1′
        a1 = _tnorm_coeffs(p["in_norm"], t)
        h = _tconv_apply(p["in_conv"], t, rollout, act=a1)
        emb_out = nn.linear(p["emb"], nn.silu(emb)).to(h.dtype)
        emb_out = emb_out[:, None, None, :]
        if use_scale_shift:
            a2 = _tnorm_coeffs(p["out_norm"], h,
                               film=tuple(torch.chunk(emb_out, 2, dim=-1)))
        else:
            h = h.map(lambda v: v + emb_out)
            a2 = _tnorm_coeffs(p["out_norm"], h)
        h = _tconv_apply(p["out_conv"], h, rollout, act=a2)
        skip = _tconv_apply(p["skip"], t, rollout=False) if "skip" in p \
            else t
        return h + skip

    def norm(pn, h, pc, film=None):
        return _tnorm_silu(pn, h, fast_norm, k1, sg, film, pc, rollout)

    h, st = norm(p["in_norm"], t, p["in_conv"])
    h = conv(p["in_conv"], h, rollout, stacks=st)

    emb_out = nn.linear(p["emb"], nn.silu(emb)).to(h.dtype)
    emb_out = emb_out[:, None, None, :]  # [B,1,1,C or 2C]
    if use_scale_shift:
        h, st = norm(p["out_norm"], h, p["out_conv"], film=emb_out)
    else:
        h = h.map(lambda v: v + emb_out)
        h, st = norm(p["out_norm"], h, p["out_conv"])
    h = conv(p["out_conv"], h, rollout, stacks=st)

    skip = conv(p["skip"], t, False) if "skip" in p else t
    return h + skip


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _resize_to(t: Triplane, ref: Triplane) -> Triplane:
    """Bilinear size fix-up before the skip concat."""
    return Triplane(*[cur if cur.shape[-3:-1] == tgt.shape[-3:-1]
                      else nn.resize_bilinear(cur, tgt.shape[-3:-1])
                      for cur, tgt in zip(t, ref)])


def _stats_chain_on(cfg: UNetConfig) -> bool:
    return (cfg.compute_dtype.itemsize <= 2 and not _use_fused_act()
            and _use_stats_chain())


@torch.no_grad()
def unet_apply(params: Dict, cfg: UNetConfig, x: Triplane,
               timesteps: torch.Tensor) -> Triplane:
    """The sampler's forward, through K1 where `cfg.fused_conv`, else
    through the differentiable form's convs (cuDNN on the card).  x:
    Triplane of `[B, ., ., C_in]`; timesteps `[B]`.  Returns out_channels
    planes of the input's sizes, in x's dtype.  With `cfg.spatial_group`,
    x holds this rank's shards (dim 1 of each plane) and so does the
    result; the convs are then the differentiable form's (no K1)."""
    return _forward(params, cfg, x, timesteps, train=False)


def unet_train_apply(params: Dict, cfg: UNetConfig, x: Triplane,
                     timesteps: torch.Tensor) -> Triplane:
    """The training forward: the same function as `unet_apply`,
    differentiable in `params` and `x` (no K1, no opt-in configuration;
    `cfg.use_checkpoint` recomputes each resblock in the backward).  Whole
    planes only: the spatial forward samples."""
    if cfg.spatial_group is not None:
        raise ValueError("the spatially sharded forward is the sampler's "
                         "(unet_apply); it has no backward")
    return _forward(params, cfg, x, timesteps, train=True)


def _check_spatial(cfg: UNetConfig, x: Triplane) -> None:
    """Each shard's rows must halve at every down level."""
    m = 2 ** (len(cfg.channel_mult) - 1)
    for name, v in (("xy/xz", x.xy), ("yz", x.yz)):
        if v.shape[1] % m:
            raise ValueError(
                f"spatial sharding: a {name} shard of {v.shape[1]} rows "
                f"does not halve {len(cfg.channel_mult) - 1} times")


def _forward(params: Dict, cfg: UNetConfig, x: Triplane,
             timesteps: torch.Tensor, train: bool) -> Triplane:
    te = params["time_embed"]
    # fp32, or fp64 where the parameters are (a reference run)
    emb = nn.timestep_embedding(timesteps, cfg.model_channels, dtype=(
        torch.promote_types(te["l1"]["w"].dtype, torch.float32)))
    emb = nn.linear(te["l2"], nn.silu(nn.linear(te["l1"], emb)))

    sg = cfg.spatial_group
    if sg is not None:
        _check_spatial(cfg, x)
    h = x.to(cfg.compute_dtype)
    h = _tconv_apply(params["in_conv"], h, rollout=False)   # 1x1: no K1

    # K1 in the sampler's forward, as JAX's fused_conv: not on shards
    k1 = not train and sg is None and cfg.fused_conv
    # the (sum, sum of squares) of h where a chained block made it; None
    # wherever h changed outside a chained conv
    use_stats = k1 and _stats_chain_on(cfg)
    h_stats = None

    def resblock(bp, t, e):
        return _resblock_apply(bp, t, e, cfg.use_scale_shift_norm,
                               cfg.rollout, cfg.fast_norm, k1, sg)

    def block(bp, t, t_stats):
        if use_stats and _stats_block_ok(bp, t, cfg.rollout):
            return _resblock_apply_stats(bp, t, t_stats, emb,
                                         cfg.use_scale_shift_norm)
        if train and cfg.use_checkpoint:
            return checkpoint(resblock, bp, t, emb,
                              use_reentrant=False), None
        return resblock(bp, t, emb), None

    hs = []
    for level, blocks in enumerate(params["down"]):
        if level != 0:
            h = h.map(nn.avg_pool2x)
            h_stats = None
        for bp in blocks:
            h, h_stats = block(bp, h, h_stats)
        hs.append(h)

    n_levels = len(params["up"])
    for level, blocks in enumerate(params["up"]):
        if level == 0:
            h = hs.pop()      # the same tensor: its stats carry over
        else:
            skip = hs.pop()
            h = _resize_to(h, skip)
            h = Triplane(*[torch.cat([a, s], dim=-1)
                           for a, s in zip(h, skip)])
            h_stats = None
        for bp in blocks:
            h, h_stats = block(bp, h, h_stats)
        if level < n_levels - 1:
            h = (h.map(nn.upsample2x_bilinear) if sg is None else
                 Triplane(*halo.upsample2x_bilinear(list(h), sg)))
            h_stats = None

    if h_stats is not None:
        h = _act_triplane(h, _tnorm_coeffs_from_stats(
            params["out"]["norm"], h_stats, h.sizes))
    else:
        h, _ = _tnorm_silu(params["out"]["norm"], h, cfg.fast_norm, k1, sg)
    h = _tconv_apply(params["out"]["conv"], h, rollout=False)
    return h.to(x.dtype)


def _block_widths(cfg: UNetConfig):
    """(in width, out width) of every resblock in forward order, as
    `init_unet` builds them (the first up block of each level but the
    deepest takes the skip concat)."""
    mc = cfg.model_channels
    ch = int(cfg.channel_mult[0] * mc)
    chans, out = [ch], []
    for mult in cfg.channel_mult:
        for _ in range(cfg.num_res_blocks):
            out.append((ch, int(mult * mc)))
            ch = int(mult * mc)
        chans.append(ch)
    last = len(cfg.channel_mult) - 1
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        ich_level = chans.pop()
        for i in range(cfg.num_res_blocks):
            ich = ich_level if i == 0 and level != last else 0
            out.append((ch + ich, int(mult * mc)))
            ch = int(mult * mc)
    return out


def k1_launches_by_form(cfg: UNetConfig) -> Dict[str, int]:
    """K1 calls one forward makes (`conv3x3_rollout_triplane`, one kernel
    launch each in bf16 on the card, three in fp32), by form
    (`ops.fused_conv.form_name`), in the configuration the environment
    selects now: two 3x3 triplane convs per resblock (the 1x1
    in/out/skip convs are not K1); none without `cfg.fused_conv`.
    Assumes every level's planes are at least 2 on each side (below
    that, act applies outside the kernel and no block chains)."""
    fused_act, chain = _use_fused_act(), _stats_chain_on(cfg)
    counts: Dict[str, int] = {}
    if not cfg.fused_conv:
        return counts

    def add(form, n):
        counts[form] = counts.get(form, 0) + n

    for cin, cout in _block_widths(cfg):
        if chain and cfg.rollout and cin <= 128 and cout <= 128:
            add(form_name(True, False, True), 1)
            add(form_name(True, True, True), 1)
        elif fused_act:
            add(form_name(True, False, False), 2)
        else:
            add(form_name(False, False, False), 2)
    return counts


def k1_launches_per_forward(cfg: UNetConfig) -> int:
    """How many K1 calls one forward makes, all forms together."""
    return sum(k1_launches_by_form(cfg).values())


def tnorm_launches_per_forward(cfg: UNetConfig) -> int:
    """How many `ops.tnorm.tnorm_silu` calls (one launch each on the card)
    one sampler forward makes in the configuration the environment
    selects now: where K1 runs a bf16 torso with `fast_norm`, the two
    norms of each resblock that is neither stats-chained nor fused-act
    (`k1_launches_by_form`'s test), and the final norm unless the last
    block is chained; else none.  The same assumption on plane sizes."""
    if not (cfg.fused_conv and cfg.fast_norm
            and cfg.compute_dtype == torch.bfloat16):
        return 0
    fused_act, chain = _use_fused_act(), _stats_chain_on(cfg)
    n, chained = 0, False
    for cin, cout in _block_widths(cfg):
        chained = chain and cfg.rollout and cin <= 128 and cout <= 128
        n += 0 if chained or fused_act else 2
    return n + (0 if chained else 1)
