"""Fused skip-concat MLP head over a stream of points (kernel K2).

Counterpart of `sin3dm_tpu/ops/fused_mlp.py:skip_mlp_fused`.  Per row of
x `[N, cin]` (fp32): the `first` ReLU linears, `concat[x, h]`, the
`second` linears with ReLU on all but the last.  Operands are cast to
`mxu_dtype` before every product; bias, accumulation and output are fp32.

On a CUDA tensor `skip_mlp` launches the hand-written kernel in
`csrc/fused_mlp.cu` and raises if it cannot; on a CPU tensor it computes
the plain version `skip_mlp_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build


def skip_mlp_reference(params: Dict, x: torch.Tensor,
                       mxu_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K2: every product takes operands rounded
    to `mxu_dtype`, multiplied and summed in fp32 (callers on the card
    turn TF32 off)."""
    def layer(lp, h, relu=True):
        y = (h.to(mxu_dtype).float() @ lp["w"].to(mxu_dtype).float()
             + lp["b"].float())
        return torch.relu(y) if relu else y

    x = x.float()
    h = x
    for lp in params["first"]:
        h = layer(lp, h)
    h = torch.cat([x, h], dim=-1)
    for lp in params["second"][:-1]:
        h = layer(lp, h)
    return layer(params["second"][-1], h, relu=False)


def _layers(params: Dict):
    return list(params["first"]) + list(params["second"])


def pack_weights(params: Dict, mxu_dtype):
    """(weights, biases, (cin, hidden, cout, n_first, n_second)): every
    layer's [K, N] weight flattened in layer order in `mxu_dtype`, every
    bias in fp32 — the kernel's operand layout.  Raises on a head the
    kernel does not take."""
    first, second = params["first"], params["second"]
    if not first or not second:
        raise ValueError("skip_mlp: needs at least one first and one "
                         "second layer")
    cin, hid = first[0]["w"].shape
    cout = second[-1]["w"].shape[1]
    n_first, n_second = len(first), len(second)
    shapes = ([(cin, hid)] + [(hid, hid)] * (n_first - 1)
              + [(cin + hid, hid if n_second > 1 else cout)]
              + [(hid, hid)] * max(n_second - 2, 0)
              + ([(hid, cout)] if n_second > 1 else []))
    got = [tuple(lp["w"].shape) for lp in _layers(params)]
    if got != shapes:
        raise ValueError(f"skip_mlp: layer shapes {got} are not a skip "
                         f"head {shapes}")
    if cin % 16 or hid % 16 or not (0 < cin <= 256 and 0 < hid <= 256
                                     and 0 < cout <= 256):
        raise ValueError("skip_mlp: the kernel takes cin and hidden that "
                         "are multiples of 16, and every width <= 256; got "
                         f"cin={cin} hidden={hid} cout={cout}")
    wts = torch.cat([lp["w"].to(mxu_dtype).reshape(-1)
                     for lp in _layers(params)])
    bias = torch.cat([lp["b"].float().reshape(-1) for lp in _layers(params)])
    return wts, bias, (cin, hid, cout, n_first, n_second)


def skip_mlp(params: Dict, x: torch.Tensor,
             mxu_dtype=torch.float32) -> torch.Tensor:
    """K2.  x `[N, cin]` fp32 -> `[N, cout]` fp32."""
    if x.device.type == "cpu":
        return skip_mlp_reference(params, x, mxu_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"skip_mlp: unsupported device {x.device}")
    if mxu_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"skip_mlp: mxu_dtype must be fp32 or bf16, got "
                         f"{mxu_dtype}")
    wts, bias, (cin, hid, cout, n_first, n_second) = pack_weights(
        params, mxu_dtype)
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != cin \
            or not x.is_contiguous() or x.shape[0] == 0:
        raise ValueError(f"skip_mlp: x must be a contiguous non-empty fp32 "
                         f"[N, {cin}] tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if wts.device != x.device or bias.device != x.device:
        raise ValueError("skip_mlp: params and x must be on one device")
    N = x.shape[0]
    out = torch.empty((N, cout), dtype=torch.float32, device=x.device)
    lib = _build.load("fused_mlp")
    fn = lib.sin3dm_skip_mlp
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(wts.data_ptr()),
             ctypes.c_void_p(bias.data_ptr()),
             ctypes.c_void_p(out.data_ptr()), N, cin, hid, cout, n_first,
             n_second, int(mxu_dtype == torch.bfloat16),
             ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"skip_mlp: CUDA error {err} at launch")
    skip_mlp.launches += 1
    return out


skip_mlp.launches = 0
