"""Triplane UNet denoiser, inference (counterpart of
`sin3dm_tpu/models/unet.py`).

Functional: `unet_apply(params, cfg, x, timesteps)` over a parameter dict
in JAX's layout (see `compat/from_jax.py`).  Each triplane conv is three
per-plane 2D convs; with rollout every plane's input is concatenated
with the broadcast axis-means of the other two planes.  That concat is
never built: by linearity the broadcast channels' 3x3 contribution is a
3-tap 1D conv of the un-broadcast mean vectors plus border fix-ups
(`_colvar_vecs` / `_rowvar_vecs`), which the 3x3 kernel K1
(`ops/fused_conv.py`) adds in its epilogue.  Every 3x3 conv of the UNet
goes through K1, in bf16 and in fp32 alike.

Sampling numerics follow the JAX package's accelerator defaults: a bf16
torso with `fast_norm` (fp32 GroupNorm statistics, apply in bf16); the
chain state stays fp32.  Training arrives in a later slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..core import nn
from ..core.triplane import Triplane
from ..ops.fused_conv import conv3x3_rollout


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


# ---------------------------------------------------------------------------
# Rollout conv
# ---------------------------------------------------------------------------

def _rollout_cat(t: Triplane) -> Triplane:
    """Each plane concatenated with broadcast axis-means of the other two
    (the materialized form; used only for planes smaller than 2)."""
    B = t.xy.shape[0]
    H, W, D = t.sizes
    C = t.channels
    m_yz_d = t.yz.mean(dim=-2)
    m_xz_d = t.xz.mean(dim=-2)
    m_xy_w = t.xy.mean(dim=-2)
    m_yz_w = t.yz.mean(dim=-3)
    m_xy_h = t.xy.mean(dim=-3)
    m_xz_h = t.xz.mean(dim=-3)
    xy = torch.cat([t.xy, m_yz_d[:, None].expand(B, H, W, C),
                    m_xz_d[:, :, None].expand(B, H, W, C)], dim=-1)
    xz = torch.cat([t.xz, m_xy_w[:, :, None].expand(B, H, D, C),
                    m_yz_w[:, None].expand(B, H, D, C)], dim=-1)
    yz = torch.cat([t.yz, m_xy_h[:, :, None].expand(B, W, D, C),
                    m_xz_h[:, None].expand(B, W, D, C)], dim=-1)
    return Triplane(xy, xz, yz)


def _conv1d3_multi(vec: torch.Tensor, k3s) -> torch.Tensor:
    """Several 3-tap zero-padded 1D convs of one vector in one product.

    vec `[B, L, C]`; k3s: V kernels each `[3, C, Co]`.  Returns the packed
    `[B, L, V, Co]` (the layout K1 takes for col3/row3)."""
    B, L, C = vec.shape
    z = vec.new_zeros((B, 1, C))
    stack = torch.stack([torch.cat([z, vec[:, :-1]], dim=1), vec,
                         torch.cat([vec[:, 1:], z], dim=1)], dim=2)
    kp = torch.stack([k.to(vec.dtype) for k in k3s], dim=2)  # [3,C,V,Co]
    V, Co = kp.shape[2], kp.shape[3]
    out = stack.reshape(B * L, 3 * C) @ kp.reshape(3 * C, V * Co)
    return out.reshape(B, L, V, Co)


def _colvar_vecs(vec: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """(s_top, s_full, s_bot) packed `[B, W, 3, Co]`: the 3x3 contribution
    of an image constant along rows (vec `[B, W, C]` broadcast over H)."""
    return _conv1d3_multi(vec, (kb[1:].sum(0), kb.sum(0), kb[:2].sum(0)))


def _rowvar_vecs(vec: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """(r_left, r_full, r_right) packed `[B, H, 3, Co]` for an image
    constant along columns (vec `[B, H, C]` broadcast over W)."""
    return _conv1d3_multi(vec, (kb[:, 1:].sum(1), kb.sum(1),
                                kb[:, :2].sum(1)))


def _tconv_apply_rollout_fast(p: Dict, t: Triplane) -> Triplane:
    """Rollout 3x3 conv without the 3x-channel concat, through K1."""
    C = t.channels
    m_yz_d = t.yz.mean(dim=-2)   # [B, W, C]
    m_xz_d = t.xz.mean(dim=-2)   # [B, H, C]
    m_xy_w = t.xy.mean(dim=-2)   # [B, H, C]
    m_yz_w = t.yz.mean(dim=-3)   # [B, D, C]
    m_xy_h = t.xy.mean(dim=-3)   # [B, W, C]
    m_xz_h = t.xz.mean(dim=-3)   # [B, D, C]

    def one(pp, x, col_vec, row_vec, col_first: bool):
        w = pp["w"]
        col_slot, row_slot = (1, 2) if col_first else (2, 1)
        col3 = _colvar_vecs(col_vec, w[:, :, col_slot * C:(col_slot + 1) * C])
        row3 = _rowvar_vecs(row_vec, w[:, :, row_slot * C:(row_slot + 1) * C])
        return conv3x3_rollout(x, w[:, :, :C], pp.get("b"), col3, row3)

    # block order per plane follows _rollout_cat:
    #   xy: [self, col-varying (m_yz_d), row-varying (m_xz_d)]
    #   xz: [self, row-varying (m_xy_w), col-varying (m_yz_w)]
    #   yz: [self, row-varying (m_xy_h), col-varying (m_xz_h)]
    return Triplane(one(p["xy"], t.xy, m_yz_d, m_xz_d, True),
                    one(p["xz"], t.xz, m_yz_w, m_xy_w, False),
                    one(p["yz"], t.yz, m_xz_h, m_xy_h, False))


def _tconv_apply(p: Dict, t: Triplane, rollout: bool) -> Triplane:
    is3 = p["xy"]["w"].shape[0] == 3
    if rollout:
        if is3 and min(t.sizes) >= 2:
            return _tconv_apply_rollout_fast(p, t)
        t = _rollout_cat(t)
    if is3:
        return Triplane(*[conv3x3_rollout(x, pp["w"], pp.get("b"))
                          for pp, x in zip((p["xy"], p["xz"], p["yz"]), t)])
    return Triplane(*[nn.conv2d(pp, x)
                      for pp, x in zip((p["xy"], p["xz"], p["yz"]), t)])


# ---------------------------------------------------------------------------
# Norms and ResBlock
# ---------------------------------------------------------------------------

def _tnorm_apply(p: Dict, t: Triplane) -> Triplane:
    return Triplane(*[nn.group_norm32(p[k], x)
                      for k, x in zip(("xy", "xz", "yz"), t)])


def _tnorm_silu_fast(p: Dict, t: Triplane, film=None) -> Triplane:
    return Triplane(*[nn.group_norm32_film_silu(p[k], x, film)
                      for k, x in zip(("xy", "xz", "yz"), t)])


def _resblock_apply(p: Dict, t: Triplane, emb: torch.Tensor,
                    use_scale_shift: bool, rollout: bool,
                    fast_norm: bool) -> Triplane:
    if fast_norm:
        h = _tnorm_silu_fast(p["in_norm"], t)
    else:
        h = _tnorm_apply(p["in_norm"], t).map(nn.silu)
    h = _tconv_apply(p["in_conv"], h, rollout)

    emb_out = nn.linear(p["emb"], nn.silu(emb)).to(h.dtype)
    emb_out = emb_out[:, None, None, :]  # [B,1,1,C or 2C]
    if use_scale_shift:
        scale, shift = torch.chunk(emb_out, 2, dim=-1)
        if fast_norm:
            h = _tnorm_silu_fast(p["out_norm"], h, film=(scale, shift))
        else:
            h = _tnorm_apply(p["out_norm"], h)
            h = h.map(lambda v: v * (1.0 + scale) + shift).map(nn.silu)
    else:
        h = h.map(lambda v: v + emb_out)
        if fast_norm:
            h = _tnorm_silu_fast(p["out_norm"], h)
        else:
            h = _tnorm_apply(p["out_norm"], h).map(nn.silu)
    h = _tconv_apply(p["out_conv"], h, rollout)

    skip = _tconv_apply(p["skip"], t, rollout=False) if "skip" in p else t
    return h + skip


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _resize_to(t: Triplane, ref: Triplane) -> Triplane:
    """Bilinear size fix-up before the skip concat."""
    return Triplane(*[cur if cur.shape[-3:-1] == tgt.shape[-3:-1]
                      else nn.resize_bilinear(cur, tgt.shape[-3:-1])
                      for cur, tgt in zip(t, ref)])


@torch.no_grad()
def unet_apply(params: Dict, cfg: UNetConfig, x: Triplane,
               timesteps: torch.Tensor) -> Triplane:
    """Forward pass.  x: Triplane of `[B, ., ., C_in]`; timesteps `[B]`.
    Returns out_channels planes of the input's sizes, in x's dtype."""
    te = params["time_embed"]
    emb = nn.timestep_embedding(timesteps, cfg.model_channels)
    emb = nn.linear(te["l2"], nn.silu(nn.linear(te["l1"], emb)))

    h = x.to(cfg.compute_dtype)
    h = _tconv_apply(params["in_conv"], h, rollout=False)

    def block(bp, t):
        return _resblock_apply(bp, t, emb, cfg.use_scale_shift_norm,
                               cfg.rollout, cfg.fast_norm)

    hs = []
    for level, blocks in enumerate(params["down"]):
        if level != 0:
            h = h.map(nn.avg_pool2x)
        for bp in blocks:
            h = block(bp, h)
        hs.append(h)

    n_levels = len(params["up"])
    for level, blocks in enumerate(params["up"]):
        if level == 0:
            h = hs.pop()
        else:
            skip = hs.pop()
            h = _resize_to(h, skip)
            h = Triplane(*[torch.cat([a, s], dim=-1)
                           for a, s in zip(h, skip)])
        for bp in blocks:
            h = block(bp, h)
        if level < n_levels - 1:
            h = h.map(nn.upsample2x_bilinear)

    if cfg.fast_norm:
        h = _tnorm_silu_fast(params["out"]["norm"], h)
    else:
        h = _tnorm_apply(params["out"]["norm"], h).map(nn.silu)
    h = _tconv_apply(params["out"]["conv"], h, rollout=False)
    return h.to(x.dtype)


def k1_launches_per_forward(cfg: UNetConfig) -> int:
    """How many K1 launches one forward makes: two 3x3 triplane convs per
    resblock, three planes each, over the down and the up path (the 1x1
    in/out/skip convs are not K1)."""
    return 2 * 3 * cfg.num_res_blocks * 2 * len(cfg.channel_mult)
