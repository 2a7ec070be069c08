"""Triplane shape autoencoder (counterpart of
`sin3dm_tpu/models/autoencoder.py`).

`init_autoencoder` builds the parameters (torch's default inits, drawn
from an explicit generator); `encode` turns the dense sdf(+texture)
volume into a triplane (two strided Conv3d, three axis means, a shared
unaffine InstanceNorm, tanh(x/2)); `forward` is the training forward,
encode then decode at points with the plain fp32 heads, differentiable
end to end.  `process_planes` runs the per-branch conv blocks once per triplane;
`decode_grid_dense` decodes the whole AABB voxel-centre grid without
gathers: voxel centres are exactly the half-pixel sample positions of
`grid_sample(align_corners=False)`, so sampling a plane over the grid is
a bilinear resize of the plane, and the MLP heads then run over x-slabs
of the broadcast sum of the three resized planes; `geo_only` with
`quant_scale` gives the int8 sdf grid of the mesh path.  `decode_points`
samples the planes at world points, `decode_texels*` gives uint8 texel
colours, over points or over the run-length texel wire.  Skip heads go
through the kernel K2 (`ops/fused_mlp.py`) with bf16 operands by default
(`SIN3DM_DECODE_BF16=0` keeps them fp32); K2 has no backward, so only
the decode entry points take it, and `SIN3DM_FUSED_HEADS=0` (JAX's
switch) sends them through the plain fp32 heads as well.
"""

from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple, Tuple

import torch

from ..core import nn
from ..core.gridsample import sample_triplane_features
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


def posenc_dim(cin: int, max_deg: int) -> int:
    return cin if max_deg == 0 else cin * (1 + 2 * max_deg)


def _mlp_init(gen: torch.Generator, cin: int, cout: int, hidden: int,
              n_hidden: int) -> Dict:
    """Plain MLP: Linear+ReLU x (1 + n_hidden), Linear."""
    layers = [nn.torch_linear_init(gen, cin, hidden)]
    layers += [nn.torch_linear_init(gen, hidden, hidden)
               for _ in range(n_hidden)]
    layers.append(nn.torch_linear_init(gen, hidden, cout))
    return {"layers": layers}


def _mlp_skip_init(gen: torch.Generator, cin: int, cout: int, hidden: int,
                   n_hidden: int) -> Dict:
    """Two MLP halves with the input concatenated at the midpoint."""
    first = [nn.torch_linear_init(gen, cin, hidden)]
    first += [nn.torch_linear_init(gen, hidden, hidden)
              for _ in range(n_hidden // 2)]
    second = [nn.torch_linear_init(gen, cin + hidden, hidden)]
    second += [nn.torch_linear_init(gen, hidden, hidden)
               for _ in range(n_hidden // 2 - 1)]
    second.append(nn.torch_linear_init(gen, hidden, cout))
    return {"first": first, "second": second}


def _mlp_skip_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """The skip head as plain linears (the training form)."""
    h = x
    for lp in p["first"]:
        h = torch.relu(nn.linear(lp, h))
    h = torch.cat([x, h], dim=-1)
    for lp in p["second"][:-1]:
        h = torch.relu(nn.linear(lp, h))
    return nn.linear(p["second"][-1], h)


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


def fused_heads() -> bool:
    """JAX's `SIN3DM_FUSED_HEADS` switch: the decode's skip heads through
    K2 unless it is "0", "false" or empty (unset: K2)."""
    env = os.environ.get("SIN3DM_FUSED_HEADS")
    return env is None or env not in ("0", "false", "")


def _head_apply(cfg: AEConfig, head: Dict, x: torch.Tensor,
                fused: bool = True) -> torch.Tensor:
    """A decoder head: skip heads through K2 where `fused` (inference)
    and `fused_heads()`, else as plain linears (training: they read the
    raw "first"/"second" leaves, never the "k2" pack); the 'base' plain
    MLP as plain linears."""
    if cfg.enc_net_type == "base":
        return _mlp_apply(head, x)
    if fused and fused_heads():
        return skip_mlp(head, x, mxu_dtype=decode_mxu_dtype())
    return _mlp_skip_apply(head, x)


# ---------------------------------------------------------------------------
# TriplaneGroupResnetBlock, per-plane form
# ---------------------------------------------------------------------------

_PLANES = ("xy", "xz", "yz")


def _group_block_init(gen: torch.Generator, cin: int, cout: int,
                      ks: int) -> Dict:
    """Per-plane ks x ks in conv, affine InstanceNorm, zero out conv, and
    a 1x1 shortcut where the width changes."""
    kshape = (ks, ks, cin, cout)
    dev = gen.device
    p = {"in_conv": {k: nn.torch_conv_init(gen, kshape) for k in _PLANES},
         "norm": {k: nn.group_norm_init(cout, dev) for k in _PLANES},
         "out_conv": {k: nn.zero_conv_init((ks, ks, cout, cout), dev)
                      for k in _PLANES}}
    if cin != cout:
        p["shortcut"] = {k: nn.torch_conv_init(gen, (1, 1, cin, cout))
                         for k in _PLANES}
    return p


def _tconv(p: Dict, t: Triplane) -> Triplane:
    return Triplane(*[nn.conv2d(p[k], x)
                      for k, x in zip(_PLANES, t)])


def _tinorm(p: Dict, t: Triplane) -> Triplane:
    return Triplane(*[nn.instance_norm(x, eps=1e-6, gamma=p[k]["g"],
                                       beta=p[k]["b"])
                      for k, x in zip(_PLANES, t)])


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


def init_autoencoder(gen: torch.Generator, cfg: AEConfig) -> Dict:
    """The AE's parameters on `gen`'s device, in the JAX package's tree
    layout (`init_autoencoder`: the same keys, list positions and
    shapes; the values are torch's draws)."""
    p: Dict = {
        "geo_encoder": nn.torch_conv_init(gen, (4, 4, 4, 1, cfg.fdim_geo)),
        "geo_convs": _group_block_init(gen, cfg.fdim_geo, cfg.fdim_up, 5),
    }
    mlp_init = _mlp_init if cfg.enc_net_type == "base" else _mlp_skip_init
    p["geo_decoder"] = mlp_init(gen, cfg.fdim_up, 1, cfg.hidden_dim,
                                cfg.n_hidden_layers)
    if cfg.use_tex:
        p["tex_encoder"] = nn.torch_conv_init(
            gen, (4, 4, 4, cfg.tex_channels + 1, cfg.fdim_tex))
        tex_in = posenc_dim(cfg.fdim_up, cfg.posenc)
        if cfg.enc_net_type == "pbr":
            p["tex_convs"] = [
                _group_block_init(gen, cfg.fdim_tex, cfg.fdim_up, 3),
                _group_block_init(gen, cfg.fdim_up, cfg.fdim_up, 3)]
            for k, c in (("rgb_decoder", 3), ("mr_decoder", 2),
                         ("normal_decoder", 3)):
                p[k] = mlp_init(gen, tex_in, c, cfg.hidden_dim,
                                cfg.n_hidden_layers)
        else:
            p["tex_convs"] = [
                _group_block_init(gen, cfg.fdim_tex, cfg.fdim_up, 5)]
            p["tex_decoder"] = mlp_init(gen, tex_in, cfg.tex_channels,
                                        cfg.hidden_dim, cfg.n_hidden_layers)
    return p


GEO_KEYS = ("geo_encoder", "geo_convs", "geo_decoder")


def geo_param_labels(params: Dict) -> Dict:
    """'geo' or 'tex' for every leaf (the split-lr optimiser's groups)."""
    def label(node, lab):
        if isinstance(node, dict):
            return {k: label(v, lab) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [label(v, lab) for v in node]
        return lab
    return {k: label(v, "geo" if k in GEO_KEYS else "tex")
            for k, v in params.items()}


def encode(params: Dict, cfg: AEConfig, vol: torch.Tensor) -> Triplane:
    """vol `[B, X, Y, Z, 1 + tex_channels]` (sdf first) -> triplane of
    `[B, ., ., feat_channels]`: the geometry encoder sees the sdf channel,
    the texture encoder every channel; the means over z, y and x give the
    xy, xz and yz planes, each squashed by tanh(InstanceNorm(., 1e-5) /
    2)."""
    vol = vol.float()
    feat = nn.conv3d(params["geo_encoder"], vol[..., :1])
    if cfg.use_tex:
        feat = torch.cat([feat, nn.conv3d(params["tex_encoder"], vol)],
                         dim=-1)

    def squash(a):
        return torch.tanh(nn.instance_norm(a, eps=1e-5) * 0.5)

    return Triplane(squash(feat.mean(dim=3)), squash(feat.mean(dim=2)),
                    squash(feat.mean(dim=1)))


def forward(params: Dict, cfg: AEConfig, vol: torch.Tensor,
            pts: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """The training forward: encode the volume, decode world points
    `[N, 3]` with the plain heads -> `[N, 1 + tex_channels]`."""
    geo, tex = process_planes(params, cfg, encode(params, cfg, vol))
    return decode_points(params, cfg, geo, tex, pts, aabb, fused=False)


def process_planes(params: Dict, cfg: AEConfig,
                   feat: Triplane) -> Tuple[Triplane, Triplane]:
    """Run the geometry and texture conv blocks once per triplane
    (`[1, ., ., C]` planes, fp32); differentiable."""
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


def normalize_points(pts: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Map points from the AABB `[6]` (lo, hi) to [-1, 1]^3."""
    lo, hi = aabb[:3], aabb[3:]
    return 2.0 * (pts - lo) / (hi - lo) - 1.0


def _tex_heads(params: Dict, cfg: AEConfig, h: torch.Tensor,
               fused: bool = True) -> torch.Tensor:
    """Texture heads over texture features `[N, C]`: PBR's rgb/mr/normal
    heads side by side (no sigmoid), else sigmoid of the tex head."""
    if cfg.posenc > 0:
        h = sinusoidal_encode(h, cfg.posenc)
    if cfg.enc_net_type == "pbr":
        return torch.cat([_head_apply(cfg, params[k], h, fused)
                          for k in ("rgb_decoder", "mr_decoder",
                                    "normal_decoder")], dim=-1)
    return torch.sigmoid(_head_apply(cfg, params["tex_decoder"], h, fused))


def decode_points(params: Dict, cfg: AEConfig, geo_planes: Triplane,
                  tex_planes, pts: torch.Tensor, aabb: torch.Tensor,
                  fused: bool = True) -> torch.Tensor:
    """World points `[N, 3]` -> `[N, 1 + tex_channels]` (sdf first); the
    planes are `process_planes`' outputs with a batch dim of 1.  Skip
    heads through K2 where `fused` (callers run it under no_grad), else
    plain and differentiable."""
    x = normalize_points(pts, aabb)
    sdf = _head_apply(cfg, params["geo_decoder"], sample_triplane_features(
        geo_planes.map(lambda a: a[0]), x), fused)
    if not cfg.use_tex:
        return sdf
    h_tex = sample_triplane_features(tex_planes.map(lambda a: a[0]), x)
    return torch.cat([sdf, _tex_heads(params, cfg, h_tex, fused)], dim=-1)


def grid_slab_features(planes: Triplane, grid_res: Tuple[int, int, int],
                       slab: int = 8):
    """Yields (x-slice, `[rows, C]` features) per x-slab of `slab` rows of
    the dense grid: the three planes (`[1, ., ., C]`) resized to the grid
    and summed at each point, the heads' input in `decode_grid_dense`."""
    Nx, Ny, Nz = grid_res
    g_xy = nn.resize_bilinear(planes.xy[0], (Nx, Ny))
    g_xz = nn.resize_bilinear(planes.xz[0], (Nx, Nz))
    g_yz = nn.resize_bilinear(planes.yz[0], (Ny, Nz))
    for x0 in range(0, Nx, slab):
        sl = slice(x0, min(x0 + slab, Nx))
        h = (g_xy[sl][:, :, None, :] + g_xz[sl][:, None, :, :]
             + g_yz[None, :, :, :])                      # [s, Ny, Nz, C]
        yield sl, h.reshape(-1, h.shape[-1])


@torch.no_grad()
def decode_grid_dense(params: Dict, cfg: AEConfig, geo_planes: Triplane,
                      tex_planes, grid_res: Tuple[int, int, int],
                      slab: int = 8, geo_only: bool = False,
                      out_dtype=None, quant_scale=None) -> torch.Tensor:
    """Dense AABB-grid decode -> `[Nx, Ny, Nz, 1 + tex_channels]` (only the
    sdf channel with `geo_only`) on the planes' device.  The heads run
    over x-slabs of `slab` rows (the last may be shorter; the JAX side pads
    it, same values).

    `quant_scale` q: the int8 wire, floor(clip(out / q, -1, 1) * 127): a
    floor keeps the sign of every voxel, and the division is a true one
    (a 0-dim tensor divisor: torch's CUDA division by a host scalar
    multiplies by its reciprocal).  Else `out_dtype` (fp16 for the sdf data
    type), else fp32."""
    Nx, Ny, Nz = grid_res
    use_tex = cfg.use_tex and not geo_only
    n_out = 1 + (cfg.tex_channels if use_tex else 0)
    dev = geo_planes.xy.device
    if quant_scale is not None:
        dtype = torch.int8
        q = torch.full((), float(quant_scale), dtype=torch.float32,
                       device=dev)
    else:
        dtype = out_dtype or torch.float32
    out = torch.empty((Nx, Ny, Nz, n_out), dtype=dtype, device=dev)
    tex_slabs = (grid_slab_features(tex_planes, grid_res, slab) if use_tex
                 else None)
    for sl, h_geo in grid_slab_features(geo_planes, grid_res, slab):
        res = _head_apply(cfg, params["geo_decoder"], h_geo)
        if use_tex:
            res = torch.cat([res, _tex_heads(params, cfg,
                                             next(tex_slabs)[1])], dim=-1)
        res = res.reshape(sl.stop - sl.start, Ny, Nz, n_out)
        if quant_scale is not None:
            res = torch.floor(torch.clamp(res / q, -1.0, 1.0) * 127.0)
        out[sl] = res.to(dtype)
    return out


def decode_texels(params: Dict, cfg: AEConfig, tex_planes: Triplane,
                  pts: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Texture-only decode of world points `[N, 3]` -> uint8
    `[N, tex_channels]` (the geo head skipped, colours quantized on the
    device)."""
    return _decode_texels_normalized(params, cfg, tex_planes,
                                     normalize_points(pts, aabb))


def decode_texels_q16(params: Dict, cfg: AEConfig, tex_planes: Triplane,
                      q: torch.Tensor) -> torch.Tensor:
    """`decode_texels` over AABB-relative 16-bit coordinates
    q = round((p - lo) / (hi - lo) * 65535), given widened to int32."""
    x = q.float() * (2.0 / 65535.0) - 1.0
    return _decode_texels_normalized(params, cfg, tex_planes, x)


def decode_texels_runs(params: Dict, cfg: AEConfig, tex_planes: Triplane,
                       offsets: torch.Tensor, starts: torch.Tensor,
                       steps: torch.Tensor, i0: int, aabb: torch.Tensor,
                       batch: int, quantized: bool = False) -> torch.Tensor:
    """`decode_texels` over the run-length texel wire: texel positions are
    affine along each rasterized UV row, so the host sends per-run
    (start, step) and cumulative counts, and the positions of global texel
    indices [i0, i0 + batch) are expanded here.  Rows past the real texel
    count decode values the caller trims.

    offsets `[Rp+1]` int32 cumulative texel counts (padding repeats the
    total); starts/steps `[Rp, 3]`.  `quantized` (the compact wire):
    starts are AABB-relative 16-bit values widened to int32, steps fp16 in
    normalized units, expanded in fp32 in the JAX package's order; else
    both are fp32 world units."""
    dev = offsets.device
    i = i0 + torch.arange(batch, dtype=torch.int32, device=dev)
    j = torch.searchsorted(offsets, i, right=True) - 1
    j = torch.clamp(j, 0, starts.shape[0] - 1)
    o = (i - offsets[j]).float()
    if quantized:
        x = (starts[j].float() * (2.0 / 65535.0) - 1.0
             + steps[j].float() * o[:, None])
    else:
        x = normalize_points(starts[j] + steps[j] * o[:, None], aabb)
    return _decode_texels_normalized(params, cfg, tex_planes, x)


@torch.no_grad()
def _decode_texels_normalized(params: Dict, cfg: AEConfig,
                              tex_planes: Triplane,
                              x: torch.Tensor) -> torch.Tensor:
    h_tex = sample_triplane_features(tex_planes.map(lambda a: a[0]), x)
    tex = _tex_heads(params, cfg, h_tex)
    # truncating cast, as the host's (clip(tex, 0, 1) * 255).astype(u8)
    return (torch.clamp(tex, 0.0, 1.0) * 255.0).to(torch.uint8)
