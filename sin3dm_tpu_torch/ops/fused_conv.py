"""Fused 3x3 rollout conv — the sampling chain's hot op (kernel K1).

Counterpart of `sin3dm_tpu/ops/fused_conv.py:conv3x3_rollout_fused`
(default form: no act/skip/emit_stats).  For a channels-last plane

    y = conv3x3_SAME(x) + b + colvar + rowvar

with fp32 accumulation and one rounding to x's dtype.  `col3` is
`[B, W, 3, Co]` holding (s_top, s_full, s_bot) along dim 2: row 0 takes
s_top, row H-1 s_bot, the rest s_full.  `row3` is `[B, H, 3, Co]` holding
(r_left, r_full, r_right) for column 0, the interior and column W-1.  Top
and left win ties.  Both None: a plain 3x3 conv plus bias.

On a CUDA tensor `conv3x3_rollout` launches the hand-written kernel in
`csrc/fused_conv.cu` (bf16 on the tensor cores, fp32 with fp32 FMAs) and
raises if it cannot; on a CPU tensor it computes the plain version
`conv3x3_rollout_reference`.  Unlike the TPU kernel it takes C = 192 in
one call: the JAX package splits C > 128 into partial convs and rounds
each to bf16 before summing, so on that shape the two differ by that
extra rounding.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _border_class(n: int, device) -> torch.Tensor:
    """0 at index 0, 2 at index n-1, 1 elsewhere (index 0 wins ties)."""
    cls = torch.ones(n, dtype=torch.int64, device=device)
    cls[-1] = 2
    cls[0] = 0
    return cls


def conv3x3_rollout_reference(x: torch.Tensor, w: torch.Tensor,
                              b: Optional[torch.Tensor] = None,
                              col3: Optional[torch.Tensor] = None,
                              row3: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of K1: upcast to fp32 (w rounded to x's dtype
    first, as the kernel sees it), F.conv2d, epilogue, one rounding.
    Callers on the card turn TF32 off for it to be an fp32 reference."""
    dt = x.dtype
    B, H, W, C = x.shape
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.to(dt).float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    if col3 is not None:
        colvar = col3.float()[:, :, _border_class(H, x.device)]  # [B,W,H,Co]
        y = y + colvar.permute(0, 2, 1, 3)
        y = y + row3.float()[:, :, _border_class(W, x.device)]   # [B,H,W,Co]
    return y.to(dt)


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
                    row3: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1.  x `[B, H, W, C]` bf16 or fp32; w `[3, 3, C, Co]` (cast to x's
    dtype); b `[Co]` (fp32) or None; col3/row3 as in the module doc, in
    x's dtype.  Returns `[B, H, W, Co]` in x's dtype."""
    if (col3 is None) != (row3 is None):
        raise ValueError("conv3x3_rollout: pass both col3 and row3 or "
                         "neither")
    if x.device.type == "cpu":
        return conv3x3_rollout_reference(x, w, b, col3, row3)
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
    y = torch.empty((B, H, W, Co), dtype=x.dtype, device=dev)
    lib = _build.load("fused_conv")
    fn = lib.sin3dm_conv3x3_rollout
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_ptr(x), _ptr(w), _ptr(b), _ptr(col3), _ptr(row3), _ptr(y),
             B, H, W, C, Co, _DTYPES[x.dtype],
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"conv3x3_rollout: CUDA error {err} at launch")
    conv3x3_rollout.launches += 1
    return y


conv3x3_rollout.launches = 0
