"""Fused 3x3 rollout conv — the sampling chain's hot op (kernel K1, and
its act/skip/emit_stats forms K1′).

Counterpart of `sin3dm_tpu/ops/fused_conv.py:conv3x3_rollout_fused`, all
forms.  For a channels-last plane

    y = conv3x3_SAME(act(x)) + b + colvar + rowvar [+ skip]

with fp32 accumulation and one rounding to x's dtype.  `col3` is
`[B, W, 3, Co]` holding (s_top, s_full, s_bot) along dim 2: row 0 takes
s_top, row H-1 s_bot, the rest s_full.  `row3` is `[B, H, 3, Co]` holding
(r_left, r_full, r_right) for column 0, the interior and column W-1.  Top
and left win ties.  Both None: a plain 3x3 conv plus bias.

- `act=(A, B)`, each `[B, C]` fp32 (a folded GroupNorm32 [+ FiLM]): the
  input is `silu(float(x)*A + B)` in fp32, rounded to x's dtype, before
  the conv; the zero halo stays zero (it is padded after the activation).
- `skip` `[B, H, W, Co]`: cast to x's dtype and added in fp32 before the
  one rounding.
- `emit_stats`: also return `[B, 2, Co]` fp32 (sum, sum of squares) over
  H x W of the ROUNDED y, as the Pallas body reduces the written tile.

On a CUDA tensor `conv3x3_rollout` launches the hand-written kernel in
`csrc/fused_conv.cu` (bf16 on the tensor cores, fp32 with fp32 FMAs) and
raises if it cannot; on a CPU tensor it computes the plain version
`conv3x3_rollout_reference`.  Unlike the TPU kernel it takes C = 192 in
one call, in every form (the JAX package splits C > 128 into partial
convs, rounds each to bf16 before summing, and cannot emit stats there).

`conv3x3_rollout.launches` counts every launch and
`conv3x3_rollout.form_launches` counts them by form (`form_name`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Act = Optional[Tuple[torch.Tensor, torch.Tensor]]


def form_name(act: bool, skip: bool, emit_stats: bool) -> str:
    """"default", or the '+'-joined epilogue features, e.g.
    "act+skip+stats"."""
    parts = [n for n, on in (("act", act), ("skip", skip),
                             ("stats", emit_stats)) if on]
    return "+".join(parts) or "default"


def _border_class(n: int, device) -> torch.Tensor:
    """0 at index 0, 2 at index n-1, 1 elsewhere (index 0 wins ties)."""
    cls = torch.ones(n, dtype=torch.int64, device=device)
    cls[-1] = 2
    cls[0] = 0
    return cls


def _stats(y: torch.Tensor) -> torch.Tensor:
    """(sum, sum of squares) over H x W of `[B, H, W, Co]`, fp32
    `[B, 2, Co]`."""
    yf = y.float()
    return torch.stack([yf.sum(dim=(1, 2)), (yf * yf).sum(dim=(1, 2))],
                       dim=1)


def conv3x3_rollout_reference(x: torch.Tensor, w: torch.Tensor,
                              b: Optional[torch.Tensor] = None,
                              col3: Optional[torch.Tensor] = None,
                              row3: Optional[torch.Tensor] = None,
                              act: Act = None,
                              skip: Optional[torch.Tensor] = None,
                              emit_stats: bool = False):
    """Plain PyTorch version of K1/K1′: upcast to fp32 (w, the activated
    input and skip rounded to x's dtype first, as the kernel sees them),
    F.conv2d, epilogue, one rounding; stats from the rounded output.
    Callers on the card turn TF32 off for it to be an fp32 reference."""
    dt = x.dtype
    B, H, W, C = x.shape
    xin = x.float()
    if act is not None:
        a = xin * act[0].float().reshape(B, 1, 1, C) \
            + act[1].float().reshape(B, 1, 1, C)
        xin = (a * torch.sigmoid(a)).to(dt).float()
    y = F.conv2d(xin.permute(0, 3, 1, 2),
                 w.to(dt).float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    if col3 is not None:
        colvar = col3.float()[:, :, _border_class(H, x.device)]  # [B,W,H,Co]
        y = y + colvar.permute(0, 2, 1, 3)
        y = y + row3.float()[:, :, _border_class(W, x.device)]   # [B,H,W,Co]
    if skip is not None:
        y = y + skip.to(dt).float()
    y = y.to(dt)
    return (y, _stats(y)) if emit_stats else y


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"conv3x3_rollout: {name} must be a contiguous "
                         f"{dtype} tensor of shape {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def conv3x3_rollout(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None,
                    col3: Optional[torch.Tensor] = None,
                    row3: Optional[torch.Tensor] = None,
                    act: Act = None,
                    skip: Optional[torch.Tensor] = None,
                    emit_stats: bool = False):
    """K1/K1′.  x `[B, H, W, C]` bf16 or fp32; w `[3, 3, C, Co]` (cast to
    x's dtype); b `[Co]` (fp32) or None; col3/row3 as in the module doc,
    in x's dtype; act (A, B) each `[B, C]` (fp32); skip `[B, H, W, Co]`
    (cast to x's dtype).  Returns `[B, H, W, Co]` in x's dtype, and with
    `emit_stats` also its `[B, 2, Co]` fp32 (sum, sum of squares)."""
    if (col3 is None) != (row3 is None):
        raise ValueError("conv3x3_rollout: pass both col3 and row3 or "
                         "neither")
    if x.device.type == "cpu":
        return conv3x3_rollout_reference(x, w, b, col3, row3, act, skip,
                                         emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_rollout: unsupported device {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError("conv3x3_rollout: x must be a 4-D bf16 or fp32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    B, H, W, C = x.shape
    Co = w.shape[-1]
    dev = x.device
    if B * H * W == 0 or Co == 0:
        raise ValueError("conv3x3_rollout: empty input")
    w = w.to(x.dtype).contiguous()
    _check("x", x, (B, H, W, C), x.dtype, dev)
    _check("w", w, (3, 3, C, Co), x.dtype, dev)
    if b is not None:
        b = b.float().contiguous()
        _check("b", b, (Co,), torch.float32, dev)
    if col3 is not None:
        _check("col3", col3, (B, W, 3, Co), x.dtype, dev)
        _check("row3", row3, (B, H, 3, Co), x.dtype, dev)
    act_a = act_b = None
    if act is not None:
        act_a, act_b = (a.float().reshape(B, C).contiguous() for a in act)
        _check("act[0]", act_a, (B, C), torch.float32, dev)
        _check("act[1]", act_b, (B, C), torch.float32, dev)
    if skip is not None:
        skip = skip.to(x.dtype).contiguous()
        _check("skip", skip, (B, H, W, Co), x.dtype, dev)
    lib = _build.load("fused_conv")
    y = torch.empty((B, H, W, Co), dtype=x.dtype, device=dev)
    partial = None
    if emit_stats:
        # one (sum, sum of squares) row per block of rows of each plane,
        # summed below in a fixed order: no atomics, the same every run
        rows = lib.sin3dm_conv3x3_rows_per_block
        rows.argtypes, rows.restype = [], ctypes.c_int
        n_blk = -(-H * W // rows())
        partial = torch.empty((B, n_blk, 2, Co), dtype=torch.float32,
                              device=dev)
    fn = lib.sin3dm_conv3x3_rollout
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_ptr(x), _ptr(w), _ptr(b), _ptr(col3), _ptr(row3),
             _ptr(act_a), _ptr(act_b), _ptr(skip), _ptr(y), _ptr(partial),
             B, H, W, C, Co, _DTYPES[x.dtype],
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"conv3x3_rollout: CUDA error {err} at launch")
    conv3x3_rollout.launches += 1
    form = form_name(act is not None, skip is not None, emit_stats)
    conv3x3_rollout.form_launches[form] = \
        conv3x3_rollout.form_launches.get(form, 0) + 1
    return (y, partial.sum(dim=1)) if emit_stats else y


conv3x3_rollout.launches = 0
conv3x3_rollout.form_launches = {}
