"""Fused skip-concat MLP head over a stream of points (kernel K2).

Counterpart of `sin3dm_tpu/ops/fused_mlp.py:skip_mlp_fused`.  Per row of
x `[N, cin]` (fp32): the `first` ReLU linears, `concat[x, h]`, the
`second` linears with ReLU on all but the last.  Operands are cast to
`mxu_dtype` before every product; bias, accumulation and output are fp32.

On a CUDA tensor `skip_mlp` launches the hand-written kernel in
`csrc/fused_mlp.cu` (bf16: wgmma with a bulk-copy weight ring, fp32: FMAs)
and raises if it cannot; on a CPU tensor it computes the plain version
`skip_mlp_reference`.  The bf16 kernel reads its weights in the layout
of `pack_mlp_weights`: from the head's "k2" entry where the head was
packed once (`ops.pack_params`, where the model is built), else packed
per call.  Each launch runs with the input's card as the current device
(the kernel's attributes, SM count, launch and stream are that card's).

`skip_mlp.launches` counts every kernel launch, and
`skip_mlp.shape_launches` counts them by shape, `(rows, cin, cout)`,
under one lock: launches from concurrent threads each count once.
`core.profiling.counters()` reads them as "k2.launches" and "k2.shapes".
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional

import torch

from ..core import profiling
from . import _build


def skip_mlp_reference(params: Dict, x: torch.Tensor,
                       mxu_dtype=torch.float32,
                       hidden: Optional[List[torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version of K2: every product takes operands rounded
    to `mxu_dtype`, multiplied and summed in fp32 (callers on the card
    turn TF32 off).  A `hidden` list receives x and every hidden layer's
    fp32 output, in order."""
    def layer(lp, h, relu=True):
        y = (h.to(mxu_dtype).float() @ lp["w"].to(mxu_dtype).float()
             + lp["b"].float())
        if not relu:
            return y
        y = torch.relu(y)
        if hidden is not None:
            hidden.append(y)
        return y

    x = x.float()
    if hidden is not None:
        hidden.append(x)
    h = x
    for lp in params["first"]:
        h = layer(lp, h)
    h = torch.cat([x, h], dim=-1)
    for lp in params["second"][:-1]:
        h = layer(lp, h)
    return layer(params["second"][-1], h, relu=False)


BF16_SPACING = 2.0 ** -7    # of |a|, at most, where a rounds to bf16
ACC_UNIT = 2.0 ** -23       # fp32 accumulation, per term, per side


def skip_mlp_bf16_bound(params: Dict, x: torch.Tensor,
                        dx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`[N, cout]`: per row, how far two bf16-operand evaluations of the
    head (K2 and `skip_mlp_reference`, or either on another device) can
    lie apart, to first order in their roundings, when their fp32 inputs
    are x and x + e with |e| <= dx (default 0).  Both round every operand
    to bf16 to nearest and sum in fp32 in their own orders, so:

    - each operand a (x, every hidden activation) differs between the two
      by its own two roundings, at most 2^-8 |a| each (8 significant
      bits), plus what the earlier layers carried in;
    - each layer's pre-activation z differs by both sides' fp32
      accumulation errors, each at most K 2^-23 (|u|^T |W| + |b|) over its
      K terms, u the rounded operand (the products of bf16 operands are
      exact in fp32; twice IEEE's K 2^-24, for an accumulator that
      truncates);
    - every such difference reaches the output through the head's
      Jacobian at the plain version's point (signed, through the ReLU
      masks), so the bound is the sum over operands and pre-activations
      of |d out / d a| times its difference: for the last layer's operand
      h that is 2^-7 sum_i |W_last[i] h_i|, the earlier layers add their
      own terms in place of a fitted margin.

    The Jacobian is taken in fp32 with the bf16-rounded weights."""
    bf = torch.bfloat16
    rw = {k: [{"w": lp["w"].to(bf).float(), "b": lp["b"].float()}
              for lp in params[k]] for k in ("first", "second")}
    layers = _layers(rw)
    n_first = len(rw["first"])
    with torch.enable_grad():
        x = x.detach().float().requires_grad_(True)
        acts: List[torch.Tensor] = []
        out = skip_mlp_reference(rw, x, torch.float32, hidden=acts)
        cols = []
        for c in range(out.shape[1]):
            jac = torch.autograd.grad(out[:, c].sum(), acts,
                                      retain_graph=c + 1 < out.shape[1])
            b = (BF16_SPACING * acts[0].abs()
                 + (0.0 if dx is None else dx.float())) * jac[0].abs()
            b = b.sum(-1)
            for l, lp in enumerate(layers):
                a = acts[l].detach()
                if l == n_first:
                    a = torch.cat([acts[0].detach(), a], dim=-1)
                u = a.to(bf).float().abs()
                acc = 2 * lp["w"].shape[0] * ACC_UNIT * (
                    u @ lp["w"].abs() + lp["b"].abs())
                if l + 1 < len(layers):
                    h, jh = acts[l + 1].detach(), jac[l + 1].abs()
                    b = b + ((BF16_SPACING * h + acc * (h > 0)) * jh).sum(-1)
                else:
                    b = b + acc[:, c]
            cols.append(b)
    return torch.stack(cols, dim=-1).detach()


def _layers(params: Dict):
    return list(params["first"]) + list(params["second"])


def _dims(params: Dict):
    """(cin, hidden, cout, n_first, n_second) of a skip head; raises on a
    head the kernels do not take."""
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
    return cin, hid, cout, n_first, n_second


def pack_weights(params: Dict, mxu_dtype):
    """(weights, biases, dims): every layer's [K, N] weight flattened in
    layer order in `mxu_dtype`, every bias in fp32 — the fp32 kernel's
    operand layout; dims as `_dims`."""
    dims = _dims(params)
    wts = torch.cat([lp["w"].to(mxu_dtype).reshape(-1)
                     for lp in _layers(params)])
    bias = torch.cat([lp["b"].float().reshape(-1) for lp in _layers(params)])
    return wts, bias, dims


NH = 256   # columns of every layer but a last one of at most 8 (zero-padded)
KC = 64    # K rows per weight chunk (at most)
TAB_COLS = 8


def _segments(l: int, K: int, cin: int, n_first: int):
    """(src, k offset into the layer's K, length) runs of layer l: the skip
    layer reads x (src 0) then h (src 1), layer 0 reads x, the rest h."""
    if l == n_first:
        return [(0, 0, cin), (1, cin, K - cin)]
    return [(0 if l == 0 else 1, 0, K)]


def pack_mlp_weights(params: Dict) -> Dict:
    """The bf16 kernel's operands, a plain torch function (any device):

    - "wts": uint8 bytes of every weight chunk in order.  A chunk is up to
      64 K rows of one layer and one source, its [K, N] block transposed
      and zero-padded to npad columns (256, or 8 for a last layer of at
      most 8), stored as [npad/8][kc/8][8][8] bf16 core matrices: element
      (k, n) at ((n//8)(kc//8) + k//8) 64 + (n%8) 8 + k%8 — the K-major
      no-swizzle layout of a wgmma B operand, so one bulk copy moves it;
    - "bias": fp32 [layers, 256], zero-padded;
    - "table": int32 [chunks, 8] rows (layer, src, k0, kc, byte offset/16,
      npad, flags, 0), flags 1 first chunk of its layer, 2 last, 4 last
      layer, 8 last chunk of the skip layer (see csrc/fused_mlp.cu);
    - "dims": (cin, hidden, cout, n_first, n_second)."""
    cin, hid, cout, n_first, n_second = dims = _dims(params)
    layers = _layers(params)
    chunks, rows, off = [], [], 0
    for l, lp in enumerate(layers):
        w = lp["w"].to(torch.bfloat16)
        K, N = w.shape
        last = l == len(layers) - 1
        npad = 8 if last and N <= 8 else NH
        runs = [(src, k0 + k, min(KC, n - k))
                for src, k0, n in _segments(l, K, cin, n_first)
                for k in range(0, n, KC)]
        for i, (src, k, kc) in enumerate(runs):
            blk = w.new_zeros((npad, kc))
            blk[:N] = w[k:k + kc].t()
            blk = blk.reshape(npad // 8, 8, kc // 8, 8).permute(0, 2, 1, 3)
            chunks.append(blk.reshape(-1))
            k_src = k if src == 0 else k - (cin if l == n_first else 0)
            flags = (1 if i == 0 else 0) | (2 if i == len(runs) - 1 else 0) \
                | (4 if last else 0) \
                | (8 if l == n_first and i == len(runs) - 1 else 0)
            rows.append([l, src, k_src, kc, off // 16, npad, flags, 0])
            off += npad * kc * 2
    bias = torch.zeros((len(layers), NH), dtype=torch.float32,
                       device=layers[0]["w"].device)
    for l, lp in enumerate(layers):
        bias[l, :lp["b"].numel()] = lp["b"].float().reshape(-1)
    return {"wts": torch.cat(chunks).view(torch.uint8), "bias": bias,
            "table": torch.tensor(rows, dtype=torch.int32,
                                  device=bias.device),
            "dims": dims}


def _launch_bf16(params: Dict, x: torch.Tensor, out: torch.Tensor) -> None:
    pk = params.get("k2") or pack_mlp_weights(params)
    cin, _, cout, _, _ = pk["dims"]
    if pk["wts"].device != x.device:
        raise ValueError("skip_mlp: params and x must be on one device")
    if x.data_ptr() % 16:
        raise ValueError("skip_mlp: x must be 16-byte aligned")
    lib = _build.load("fused_mlp")
    fn = lib.sin3dm_skip_mlp_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(ctypes.c_void_p(x.data_ptr()),
                 ctypes.c_void_p(pk["wts"].data_ptr()),
                 ctypes.c_void_p(pk["bias"].data_ptr()),
                 ctypes.c_void_p(pk["table"].data_ptr()),
                 pk["table"].shape[0], pk["bias"].shape[0],
                 ctypes.c_void_p(out.data_ptr()), x.shape[0], cin, cout,
                 ctypes.c_void_p(
                     torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"skip_mlp: CUDA error {err} at launch")


def _launch_f32(params: Dict, x: torch.Tensor, out: torch.Tensor) -> None:
    wts, bias, (cin, hid, cout, n_first, n_second) = pack_weights(
        params, torch.float32)
    if wts.device != x.device or bias.device != x.device:
        raise ValueError("skip_mlp: params and x must be on one device")
    lib = _build.load("fused_mlp")
    fn = lib.sin3dm_skip_mlp_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(ctypes.c_void_p(x.data_ptr()),
                 ctypes.c_void_p(wts.data_ptr()),
                 ctypes.c_void_p(bias.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), x.shape[0], cin, hid, cout,
                 n_first, n_second, ctypes.c_void_p(
                     torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"skip_mlp: CUDA error {err} at launch")


def _refuse_grad(params: Dict, x: torch.Tensor) -> None:
    """Raise where autograd would record a K2 call: grad mode on and x or
    a weight of the head requiring grad."""
    if not torch.is_grad_enabled():
        return
    layers = params["first"] + params["second"]
    if x.requires_grad or any(v.requires_grad for lp in layers
                              for v in lp.values()):
        raise RuntimeError(
            "skip_mlp: K2 has no backward; call it under torch.no_grad "
            "(the AE's training forward takes the plain heads)")


def skip_mlp(params: Dict, x: torch.Tensor,
             mxu_dtype=torch.float32) -> torch.Tensor:
    """K2.  x `[N, cin]` fp32 -> `[N, cout]` fp32.  `params` is a skip
    head ("first", "second" lists of {"w" [K, N], "b" [N]}), with "k2",
    its `pack_mlp_weights`, where it was packed once.  K2 has no
    backward: the call raises where autograd would record it, on either
    device (the training forward takes the plain heads instead)."""
    _refuse_grad(params, x)
    if x.device.type == "cpu":
        return skip_mlp_reference(params, x, mxu_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"skip_mlp: unsupported device {x.device}")
    if mxu_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"skip_mlp: mxu_dtype must be fp32 or bf16, got "
                         f"{mxu_dtype}")
    cin, _, cout, _, _ = _dims(params)
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != cin \
            or not x.is_contiguous() or x.shape[0] == 0:
        raise ValueError(f"skip_mlp: x must be a contiguous non-empty fp32 "
                         f"[N, {cin}] tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    out = torch.empty((x.shape[0], cout), dtype=torch.float32,
                      device=x.device)
    if mxu_dtype == torch.bfloat16:
        _launch_bf16(params, x, out)
    else:
        _launch_f32(params, x, out)
    _count((x.shape[0], cin, cout))
    return out


# concurrent requests launch from several threads: one lock keeps each
# count's read-modify-write whole
_count_lock = threading.Lock()


def _count(shape) -> None:
    with _count_lock:
        skip_mlp.launches += 1
        skip_mlp.shape_launches[shape] = \
            skip_mlp.shape_launches.get(shape, 0) + 1


skip_mlp.launches = 0
skip_mlp.shape_launches = {}
profiling.counter("k2.launches", lambda: skip_mlp.launches)
profiling.counter("k2.shapes", lambda: dict(skip_mlp.shape_launches))
