"""Core NN primitives on channels-last tensors (counterpart of
`sin3dm_tpu/core/nn.py`).

Parameters keep JAX's layouts: conv weights `[kh, kw, Cin, Co]` (3-D:
`[kd, kh, kw, Cin, Co]`), linear weights `[in, out]`.  Semantics follow
the JAX functions line for line: GroupNorm32 statistics in float32, the
sinusoidal embedding cos-first, bilinear and trilinear resizes with
half-pixel centres and no antialias, 2x average pooling VALID (an odd
size drops its last row/column).  Every op is differentiable (no
in-place write into a tensor autograd saved), so the UNet's and the
AE's training forwards run through them.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initialisers (torch's default Conv/Linear init: U(+-1/sqrt(fan_in)) for
# weight and bias), each drawn from an explicit generator
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch.float32,
                       device=gen.device).uniform_(-bound, bound,
                                                   generator=gen)


def torch_conv_init(gen: torch.Generator, kshape: Sequence[int],
                    with_bias: bool = True) -> Dict:
    """kshape HWIO (spatial..., in, out); fan_in = in * prod(spatial)."""
    *spatial, cin, cout = kshape
    bound = 1.0 / math.sqrt(cin * int(math.prod(spatial)))
    w = _uniform(gen, kshape, bound)
    if not with_bias:
        return {"w": w}
    return {"w": w, "b": _uniform(gen, (cout,), bound)}


def torch_linear_init(gen: torch.Generator, cin: int, cout: int) -> Dict:
    """Weight `[cin, cout]` (y = x @ w + b), both U(+-1/sqrt(cin))."""
    bound = 1.0 / math.sqrt(cin)
    return {"w": _uniform(gen, (cin, cout), bound),
            "b": _uniform(gen, (cout,), bound)}


def zero_conv_init(kshape: Sequence[int], device="cpu") -> Dict:
    """A zero-initialised conv (the reference's `zero_module`)."""
    return {"w": torch.zeros(tuple(kshape), device=device),
            "b": torch.zeros((kshape[-1],), device=device)}


def group_norm_init(channels: int, device="cpu") -> Dict:
    return {"g": torch.ones((channels,), device=device),
            "b": torch.zeros((channels,), device=device)}


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dims."""
    return x.mean(dim=tuple(range(1, x.dim())))


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv2d(p: Dict, x: torch.Tensor, padding="SAME") -> torch.Tensor:
    """Stride-1 conv of `[B, H, W, C]` with an HWIO weight.  1x1 convs
    are a dot over the channel axis, as on the JAX side; other sizes go
    to `F.conv2d` (the 5x5 AE convs and the UNet's training forward; the
    sampler's 3x3 convs take the hand-written kernel in
    `ops/fused_conv.py` instead)."""
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[0], w.shape[1]
    if kh == 1 and kw == 1:
        y = x @ w[0, 0]
    else:
        if padding != "SAME":
            raise ValueError(f"unsupported padding {padding!r}")
        y = F.conv2d(_nchw(x), w.permute(3, 2, 0, 1),
                     padding=(kh // 2, kw // 2))
        y = _nhwc(y)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def conv3d(p: Dict, x: torch.Tensor, stride: int = 2,
           padding: int = 1) -> torch.Tensor:
    """Conv of `[B, X, Y, Z, C]` with a DHWIO weight `[kd, kh, kw, Cin,
    Co]`; the default is the AE encoder's k4/s2/p1 (`F.conv3d`)."""
    w = p["w"].to(x.dtype).permute(4, 3, 0, 1, 2)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, stride=stride,
                 padding=padding).permute(0, 2, 3, 4, 1)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def instance_norm(x: torch.Tensor, eps: float = 1e-5, gamma=None,
                  beta=None) -> torch.Tensor:
    """Per-sample, per-channel normalisation over the spatial dims of
    `[..., H, W, C]` with biased variance (torch `InstanceNorm2d`)."""
    mean = x.mean(dim=(-3, -2), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(-3, -2), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.to(y.dtype) + beta.to(y.dtype)
    return y


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """The norms' statistics dtype: fp32, or fp64 for an fp64 x."""
    return torch.promote_types(x.dtype, torch.float32)


def _group_stats(x: torch.Tensor, num_groups: int, eps: float):
    """Per-group (mean, rstd) of `[B, H, W, C]`, each `[B, g]`, in
    `_stats_dtype(x)`."""
    *lead, H, W, C = x.shape
    if C % num_groups != 0:
        raise ValueError(f"GroupNorm32 needs channels divisible by "
                         f"{num_groups}, got {C}")
    xg = x.reshape(*lead, H, W, num_groups, C // num_groups).to(
        _stats_dtype(x))
    dims = (-4, -3, -1)
    mean = xg.mean(dim=dims)
    var = ((xg - mean[..., None, None, :, None]) ** 2).mean(dim=dims)
    return mean, torch.rsqrt(var + eps)


def group_norm32(p: Dict, x: torch.Tensor, num_groups: int = 32,
                 eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(32, C) computed in float32 (float64 for an fp64 x), cast
    back to x.dtype."""
    return group_norm32_from_stats(p, x, *_group_stats(x, num_groups, eps))


def group_sums(x: torch.Tensor, num_groups: int = 32):
    """Per-group (sum, sum of squares) `[B, g]` of `[B, H, W, C]` in
    `_stats_dtype(x)`: the statistics a plane sharded over several ranks
    adds up across them (`models/unet.py`)."""
    *lead, H, W, C = x.shape
    if C % num_groups != 0:
        raise ValueError(f"GroupNorm32 needs channels divisible by "
                         f"{num_groups}, got {C}")
    xg = x.reshape(*lead, H, W, num_groups, C // num_groups).to(
        _stats_dtype(x))
    dims = (-4, -3, -1)
    return xg.sum(dim=dims), (xg * xg).sum(dim=dims)


def group_norm32_from_stats(p: Dict, x: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor) -> torch.Tensor:
    """`group_norm32`'s apply from given per-group (mean, rstd) `[B, g]`."""
    *lead, H, W, C = x.shape
    num_groups = mean.shape[-1]
    xg = x.reshape(*lead, H, W, num_groups, C // num_groups).to(
        _stats_dtype(x))
    xg = (xg - mean[..., None, None, :, None]) * rstd[..., None, None, :,
                                                      None]
    y = xg.reshape(*lead, H, W, C) * p["g"] + p["b"]
    return y.to(x.dtype)


def group_norm32_film_silu(p: Dict, x: torch.Tensor, film=None,
                           num_groups: int = 32,
                           eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm32 -> optional FiLM (scale, shift) -> SiLU with float32
    statistics folded into per-channel (A, B), applied in x.dtype.

    x: `[B, H, W, C]`; film: optional (scale, shift) each `[B, 1, 1, C]`.
    """
    return apply_film_coeffs(x, *group_norm32_film_coeffs(
        p, x, film, num_groups, eps))


def _fold_coeffs(p: Dict, mean: torch.Tensor, rstd: torch.Tensor, C: int,
                 film):
    """Per-group (mean, rstd) `[B, g]` and gamma/beta [+ FiLM] folded into
    per-channel (A, B) each `[B, C]` fp32."""
    rep = C // mean.shape[-1]
    A = rstd.repeat_interleave(rep, dim=-1) * p["g"]
    B = p["b"] - mean.repeat_interleave(rep, dim=-1) * A
    if film is not None:
        scale, shift = film                          # [B, 1, 1, C]
        one_p = 1.0 + scale.to(A.dtype).reshape(A.shape)
        A = A * one_p
        B = B * one_p + shift.to(A.dtype).reshape(A.shape)
    return A, B


def group_norm32_film_silu_from_stats(p: Dict, x: torch.Tensor,
                                      mean: torch.Tensor, rstd: torch.Tensor,
                                      film=None) -> torch.Tensor:
    """`group_norm32_film_silu` from given per-group (mean, rstd)."""
    return apply_film_coeffs(x, *_fold_coeffs(p, mean, rstd, x.shape[-1],
                                              film))


def group_norm32_film_coeffs(p: Dict, x: torch.Tensor, film=None,
                             num_groups: int = 32, eps: float = 1e-5):
    """(A, B) each `[B, C]` fp32 with `silu(x*A + B)` ==
    `group_norm32_film_silu(p, x, film)`: the coefficients that the 3x3
    kernel's `act=` applies to its input (`ops/fused_conv.py`)."""
    mean, rstd = _group_stats(x, num_groups, eps)
    return _fold_coeffs(p, mean, rstd, x.shape[-1], film)


def group_norm32_coeffs_from_sums(p: Dict, stats: torch.Tensor, n_hw: int,
                                  film=None, num_groups: int = 32,
                                  eps: float = 1e-5):
    """`group_norm32_film_coeffs` from per-channel (sum, sum of squares)
    `stats` `[B, 2, C]` fp32 over `n_hw` positions, as the 3x3 kernel's
    `emit_stats` returns them: var = E[x^2] - mean^2, clamped at 0."""
    B_, _, C = stats.shape
    g = num_groups
    if C % g != 0:
        raise ValueError(f"GroupNorm32 needs channels divisible by {g}, "
                         f"got {C}")
    n = float(n_hw * (C // g))
    s1 = stats[:, 0].reshape(B_, g, C // g).sum(-1)
    s2 = stats[:, 1].reshape(B_, g, C // g).sum(-1)
    mean = s1 / n
    var = s2 / n - mean * mean
    rstd = torch.rsqrt(var.clamp_min(0.0) + eps)
    return _fold_coeffs(p, mean, rstd, C, film)


def apply_film_coeffs(x: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor) -> torch.Tensor:
    """`silu(x*A + B)` with A, B `[B, C]` cast to x.dtype and the apply in
    x.dtype (the form outside the kernel, as in the JAX package)."""
    shape = x.shape[:-3] + (1, 1, x.shape[-1])
    return silu(x * A.reshape(shape).to(x.dtype)
                + B.reshape(shape).to(x.dtype))


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """2x average pool of `[B, H, W, C]`, VALID."""
    return _nhwc(F.avg_pool2d(_nchw(x), 2, 2))


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or in its own dtype where that is wider (a resize's
    arithmetic, as `F.interpolate`'s accumulator type)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _resize_axis(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """Linear resize of one axis as `F.interpolate` computes it (half-pixel
    centres, no antialias): output j reads i0 = floor(s) and i0 + 1
    (clamped to the axis) of the source index s = max(r (j + 1/2) - 1/2,
    0), r = n_in / n_out in fp32, with weights (1 - l, l), l = s - i0."""
    n_in = x.shape[dim]
    r = np.float32(n_in / n_out)
    s = np.maximum(r * (np.arange(n_out, dtype=np.float32)
                        + np.float32(0.5)) - np.float32(0.5),
                   np.float32(0.0))
    i0 = s.astype(np.int64)
    l1 = s - i0.astype(np.float32)
    shape = [1] * x.dim()
    shape[dim] = n_out

    def take(i):
        return x.index_select(dim, torch.as_tensor(i, device=x.device))

    def weight(w):
        return torch.as_tensor(w, device=x.device).to(x.dtype).reshape(shape)

    return (weight(np.float32(1.0) - l1) * take(i0)
            + weight(l1) * take(np.minimum(i0 + 1, n_in - 1)))


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of `[B, H, W, C]` or `[H, W, C]`: half-pixel
    centres (align_corners=False), no antialias, either direction; W
    then H, each as `_resize_axis`, in fp32 (x's dtype where wider)
    rounded once to x's dtype.  Gathers and sums, so its backward is
    deterministic on the card (`F.interpolate`'s bilinear backward is
    not)."""
    y = _resize_axis(_wide(x), x.dim() - 2, int(out_hw[1]))
    return _resize_axis(y, x.dim() - 3, int(out_hw[0])).to(x.dtype)


def resize_trilinear(x: torch.Tensor,
                     out_dhw: Tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resize of `[B, D, H, W, C]`: half-pixel centres
    (align_corners=False), no antialias, either direction."""
    y = F.interpolate(x.permute(0, 4, 1, 2, 3),
                      size=tuple(int(s) for s in out_dhw), mode="trilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 4, 1)


def _upsample2x_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`_resize_axis` to twice the length, as fixed-weight sums of shifted
    slices: output 2i is 0.25 x[i-1] + 0.75 x[i] (x[0] at i = 0), output
    2i+1 is 0.75 x[i] + 0.25 x[i+1] (x[i+1] clamped to the last)."""
    n = x.shape[dim]
    a, b = 0.75 * x, 0.25 * x
    even = torch.cat([x.narrow(dim, 0, 1),
                      b.narrow(dim, 0, n - 1) + a.narrow(dim, 1, n - 1)],
                     dim=dim)
    odd = a + torch.cat([b.narrow(dim, 1, n - 1), b.narrow(dim, n - 1, 1)],
                        dim=dim)
    out = torch.stack([even, odd], dim=dim + 1)
    return out.reshape(*x.shape[:dim], 2 * n, *x.shape[dim + 1:])


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """`resize_bilinear(x, (2H, 2W))` of `[B, H, W, C]`, the same numbers
    (W then H in fp32, rounded once), without gathers."""
    y = _upsample2x_axis(_wide(x), x.dim() - 2)
    return _upsample2x_axis(y, x.dim() - 3).to(x.dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal embeddings, cos first.  timesteps `[N]` -> `[N, dim]`
    in `dtype`."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=dtype,
                                     device=timesteps.device) / half)
    args = timesteps.to(dtype)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
