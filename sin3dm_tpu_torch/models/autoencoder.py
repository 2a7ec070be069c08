"""Triplane shape autoencoder, inference decode (counterpart of
`sin3dm_tpu/models/autoencoder.py`).

`process_planes` runs the per-branch conv blocks once per triplane;
`decode_grid_dense` decodes the whole AABB voxel-centre grid without
gathers: voxel centres are exactly the half-pixel sample positions of
`grid_sample(align_corners=False)`, so sampling a plane over the grid is
a bilinear resize of the plane, and the MLP heads then run over x-slabs
of the broadcast sum of the three resized planes.  Skip heads go through
the kernel K2 (`ops/fused_mlp.py`) with bf16 operands by default
(`SIN3DM_DECODE_BF16=0` keeps them fp32).  The encoder, point decode and
texel decode come with later slices (ROADMAP.md).
"""

from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple, Tuple

import torch

from ..core import nn
from ..core.triplane import Triplane
from ..ops.fused_mlp import skip_mlp


class AEConfig(NamedTuple):
    data_type: str = "sdftex"          # sdf | sdftex | sdfpbr
    enc_net_type: str = "skip"         # base | skip | pbr
    fdim_geo: int = 4
    fdim_tex: int = 8
    fdim_up: int = 64
    hidden_dim: int = 256
    n_hidden_layers: int = 4
    posenc: int = 0

    @property
    def use_tex(self) -> bool:
        return self.data_type != "sdf"

    @property
    def tex_channels(self) -> int:
        return 8 if self.data_type == "sdfpbr" else 3


# ---------------------------------------------------------------------------
# MLP heads
# ---------------------------------------------------------------------------

def sinusoidal_encode(x: torch.Tensor, max_deg: int,
                      use_identity: bool = True) -> torch.Tensor:
    """NeRF positional encoding: [x, sin(2^i x), cos(2^i x)]."""
    if max_deg == 0:
        return x
    scales = torch.tensor([2.0 ** i for i in range(max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(
        x.shape[:-1] + (max_deg * x.shape[-1],))
    latent = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if use_identity:
        latent = torch.cat([x, latent], dim=-1)
    return latent


def _mlp_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = x
    for lp in p["layers"][:-1]:
        h = torch.relu(nn.linear(lp, h))
    return nn.linear(p["layers"][-1], h)


def decode_mxu_dtype() -> torch.dtype:
    """Operand dtype of the decode MLP products: bf16 (the accelerator
    default of the JAX package) unless SIN3DM_DECODE_BF16=0."""
    env = os.environ.get("SIN3DM_DECODE_BF16")
    if env is not None and env in ("0", "false", ""):
        return torch.float32
    return torch.bfloat16


def _head_apply(cfg: AEConfig, head: Dict, x: torch.Tensor) -> torch.Tensor:
    """A decoder head: skip heads through K2, the 'base' plain MLP as
    plain linears."""
    if cfg.enc_net_type == "base":
        return _mlp_apply(head, x)
    return skip_mlp(head, x, mxu_dtype=decode_mxu_dtype())


# ---------------------------------------------------------------------------
# TriplaneGroupResnetBlock, per-plane form
# ---------------------------------------------------------------------------

def _tconv(p: Dict, t: Triplane) -> Triplane:
    return Triplane(*[nn.conv2d(p[k], x)
                      for k, x in zip(("xy", "xz", "yz"), t)])


def _tinorm(p: Dict, t: Triplane) -> Triplane:
    return Triplane(*[nn.instance_norm(x, eps=1e-6, gamma=p[k]["g"],
                                       beta=p[k]["b"])
                      for k, x in zip(("xy", "xz", "yz"), t)])


def _group_block_apply(p: Dict, t: Triplane, input_act: bool,
                       input_norm: bool = False) -> Triplane:
    """Per-plane conv -> InstanceNorm(eps 1e-6, affine) -> SiLU -> conv,
    plus shortcut.  The same norm params serve the optional input norm
    and the mid norm, as in the reference."""
    x = _tinorm(p["norm"], t) if input_norm else t
    h = x.map(nn.silu) if input_act else x
    h = _tconv(p["in_conv"], h)
    h = _tinorm(p["norm"], h).map(nn.silu)
    h = _tconv(p["out_conv"], h)
    sc = _tconv(p["shortcut"], x) if "shortcut" in p else x
    return h + sc


@torch.no_grad()
def process_planes(params: Dict, cfg: AEConfig,
                   feat: Triplane) -> Tuple[Triplane, Triplane]:
    """Run the geometry and texture conv blocks once per triplane
    (`[1, ., ., C]` planes, fp32)."""
    geo = feat.map(lambda a: a[..., :cfg.fdim_geo])
    geo = _group_block_apply(params["geo_convs"], geo, input_act=False)
    tex = None
    if cfg.use_tex:
        tex = feat.map(lambda a: a[..., cfg.fdim_geo:])
        blocks = params["tex_convs"]
        tex = _group_block_apply(blocks[0], tex, input_act=False)
        for bp in blocks[1:]:
            tex = _group_block_apply(bp, tex, input_act=True,
                                     input_norm=True)
    return geo, tex


@torch.no_grad()
def decode_grid_dense(params: Dict, cfg: AEConfig, geo_planes: Triplane,
                      tex_planes, grid_res: Tuple[int, int, int],
                      slab: int = 8) -> torch.Tensor:
    """Dense AABB-grid decode -> `[Nx, Ny, Nz, 1 + tex_channels]` fp32 on
    the planes' device.  The heads run over x-slabs of `slab` rows (the
    last slab may be shorter; the JAX side pads it, same values)."""
    Nx, Ny, Nz = grid_res

    def plane_grids(planes: Triplane):
        return (nn.resize_bilinear(planes.xy[0], (Nx, Ny)),
                nn.resize_bilinear(planes.xz[0], (Nx, Nz)),
                nn.resize_bilinear(planes.yz[0], (Ny, Nz)))

    g_xy, g_xz, g_yz = plane_grids(geo_planes)
    if cfg.use_tex:
        t_xy, t_xz, t_yz = plane_grids(tex_planes)
    n_out = 1 + (cfg.tex_channels if cfg.use_tex else 0)
    out = torch.empty((Nx, Ny, Nz, n_out), dtype=torch.float32,
                      device=g_xy.device)
    for x0 in range(0, Nx, slab):
        sl = slice(x0, min(x0 + slab, Nx))
        h_geo = (g_xy[sl][:, :, None, :] + g_xz[sl][:, None, :, :]
                 + g_yz[None, :, :, :])                  # [s, Ny, Nz, C]
        s = h_geo.shape[0]
        sdf = _head_apply(cfg, params["geo_decoder"],
                          h_geo.reshape(-1, h_geo.shape[-1]))
        out[sl, ..., :1] = sdf.reshape(s, Ny, Nz, 1)
        if not cfg.use_tex:
            continue
        h_tex = (t_xy[sl][:, :, None, :] + t_xz[sl][:, None, :, :]
                 + t_yz[None, :, :, :])
        ht = h_tex.reshape(-1, h_tex.shape[-1])
        if cfg.posenc > 0:
            ht = sinusoidal_encode(ht, cfg.posenc)
        if cfg.enc_net_type == "pbr":
            tex = torch.cat([_head_apply(cfg, params[k], ht)
                             for k in ("rgb_decoder", "mr_decoder",
                                       "normal_decoder")], dim=-1)
        else:
            tex = torch.sigmoid(_head_apply(cfg, params["tex_decoder"], ht))
        out[sl, ..., 1:] = tex.reshape(s, Ny, Nz, -1)
    return out
