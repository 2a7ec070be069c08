"""Triplane GroupNorm32 [+ FiLM] + SiLU with the rollout axis means of
its output — the sampler's norm in one launch (kernel "tnorm").

For a triplane's three channels-last planes x_i `[B, R_i, S_i, C]` with
their GroupNorm parameters (gamma_i, beta_i) `[C]` and an optional FiLM
`film` `[B, 2C]` (scale then shift, the resblock's `emb_out`):

- (A_i, B_i) `[B, C]` fp32: the fp32 GroupNorm32 statistics of x_i
  (two-pass) with gamma/beta and the FiLM folded in
  (`core/nn.py:group_norm32_film_coeffs`);
- y_i = silu(x_i A_i + B_i) applied in x's dtype
  (`core/nn.py:apply_film_coeffs`);
- with `means`, y_i's means over S (one per row, `[B, R_i, C]`) and over
  R (one per column, `[B, S_i, C]`) in x's dtype, each in the stacked
  layout `stack3` makes for the rollout conv's 3-tap products.

On a CUDA tensor `tnorm_silu` launches the hand-written kernel in
`csrc/tnorm.cu` (bf16 only; it raises on anything else it does not take:
the UNet calls it for its bf16 torso alone), one launch a triplane; on a
CPU tensor it computes the plain version `tnorm_silu_reference`, the
eager functions the UNet ran before.  The kernel's statistics and means
sum in another order than the plain version's (fp32 both); given the same
(A, B) its apply is the plain version's bit for bit.

`tnorm_silu.launches` counts the launches; a launch captured into a CUDA
graph counts at each replay (`tallied`, `count_launches`), as K1's do.
`core.profiling.counters()` reads it as "tnorm.launches".
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import struct
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from ..core import nn, profiling
from . import _build

EPS = 1e-5


def stack3(v: torch.Tensor) -> torch.Tensor:
    """`[B, L, C]` -> `[B, L, 3, C]`: line l holds (v[l-1], v[l], v[l+1]),
    zeros past the ends (the operand of the rollout conv's 3-tap
    products, `models/unet.py:_conv1d3_packed`)."""
    B, _, C = v.shape
    z = v.new_zeros((B, 1, C))
    return torch.stack([torch.cat([z, v[:, :-1]], dim=1), v,
                        torch.cat([v[:, 1:], z], dim=1)], dim=2)


def _film(film: Optional[torch.Tensor], B: int, C: int):
    """(scale, shift) each `[B, 1, 1, C]` of a `[B, 2C]`-sized film."""
    if film is None:
        return None
    return tuple(torch.chunk(film.reshape(B, 1, 1, 2 * C), 2, dim=-1))


def tnorm_silu_reference(xs: Sequence[torch.Tensor],
                         gammas: Sequence[torch.Tensor],
                         betas: Sequence[torch.Tensor],
                         film: Optional[torch.Tensor] = None,
                         means: bool = True):
    """Plain PyTorch version: per plane `group_norm32_film_coeffs` and
    `apply_film_coeffs`, then `stack3` of y's means over dim -2 (rows)
    and dim -3 (columns).  Returns (ys, coef `[3, 2, B, C]` fp32, stacks:
    per plane (rows, cols), or None)."""
    B, C = xs[0].shape[0], xs[0].shape[-1]
    fm = _film(film, B, C)
    ys, coefs = [], []
    for x, g, b in zip(xs, gammas, betas):
        A, Bc = nn.group_norm32_film_coeffs({"g": g, "b": b}, x, fm,
                                            eps=EPS)
        ys.append(nn.apply_film_coeffs(x, A, Bc))
        coefs.append(torch.stack([A, Bc]))
    stacks = ([(stack3(y.mean(dim=-2)), stack3(y.mean(dim=-3)))
               for y in ys] if means else None)
    return ys, torch.stack(coefs), stacks


def _lib():
    """The library with its ctypes signatures set."""
    lib = _build.load("tnorm")
    if not getattr(lib, "sin3dm_bound", False):
        lib.sin3dm_tnorm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_float, ctypes.c_void_p]
        lib.sin3dm_tnorm.restype = ctypes.c_int
        lib.sin3dm_bound = True
    return lib


def supported(C: int) -> bool:
    """Whether the kernel takes C channels: GroupNorm32's groups in
    slices of lcm(8, C / 32) channels, at most 256 (every multiple of 32
    up to 1024, and wider ones whose groups are such slices)."""
    return C >= 32 and C % 32 == 0 and math.lcm(8, C // 32) <= 256


def _refuse(xs, gammas, betas, film) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (*xs, *gammas, *betas, film)):
        raise RuntimeError("tnorm_silu: the kernel has no backward; call it "
                           "under torch.no_grad")


def tnorm_silu(xs: Sequence[torch.Tensor], gammas: Sequence[torch.Tensor],
               betas: Sequence[torch.Tensor],
               film: Optional[torch.Tensor] = None, means: bool = True):
    """The triplane norm of the module doc.  xs: three planes `[B, R_i,
    S_i, C]` of one B, C, dtype and device; gammas, betas: `[C]` each
    (fp32); film: None or `B * 2C` values in x's dtype (scale then
    shift).  Returns (ys, coef `[3, 2, B, C]` fp32, stacks: per plane
    (rows `[B, R_i, 3, C]`, cols `[B, S_i, 3, C]`) in x's dtype, or
    None without `means`).  On the card: bf16 planes, C `supported`."""
    _refuse(xs, gammas, betas, film)
    if len(xs) != 3 or len(gammas) != 3 or len(betas) != 3:
        raise ValueError("tnorm_silu: three planes, one gamma and one beta "
                         "each")
    x0 = xs[0]
    B, C, dev, dt = x0.shape[0], x0.shape[-1], x0.device, x0.dtype
    for x in xs:
        if x.dim() != 4 or (x.shape[0], x.shape[3]) != (B, C) \
                or x.device != dev or x.dtype != dt:
            raise ValueError("tnorm_silu: every plane must be a [B, R, S, C] "
                             "tensor of one batch, channel count, dtype and "
                             "device")
    if film is not None and (film.numel() != B * 2 * C
                             or film.dtype != dt or film.device != dev):
        raise ValueError(f"tnorm_silu: film must hold [{B}, {2 * C}] values "
                         f"of the planes' dtype and device, got {film.dtype} "
                         f"{tuple(film.shape)} on {film.device}")
    if dev.type == "cpu":
        return tnorm_silu_reference(xs, gammas, betas, film, means)
    if dev.type != "cuda" or dt != torch.bfloat16 or not supported(C):
        raise ValueError(f"tnorm_silu: the kernel takes bf16 planes on a "
                         f"CUDA device with C `supported` (a multiple of 32 "
                         f"up to 1024), got {dt} C={C} on {dev}")
    return _launch(xs, gammas, betas, film, means)


def _as_f32(t: torch.Tensor, C: int, dev) -> torch.Tensor:
    if t.dtype != torch.float32 or not t.is_contiguous():
        t = t.to(torch.float32).contiguous()
    if tuple(t.shape) != (C,) or t.device != dev:
        raise ValueError(f"tnorm_silu: gamma and beta must be [{C}] tensors "
                         f"on {dev}, got {tuple(t.shape)} on {t.device}")
    return t


def _launch(xs, gammas, betas, film, means: bool):
    x0 = xs[0]
    B, C, dev = x0.shape[0], x0.shape[-1], x0.device
    xs = [x if x.is_contiguous() else x.contiguous() for x in xs]
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError("tnorm_silu: planes must start 16-byte aligned")
    sw = max(16, math.lcm(8, C // 32))     # csrc/tnorm.cu:slice_width
    if means and 4 * sw * max(x.shape[2] for x in xs) > 160 * 1024:
        raise ValueError(f"tnorm_silu: the column sums of {sw}-channel "
                         f"slices of rows of {max(x.shape[2] for x in xs)} "
                         f"pixels exceed the kernel's 160 KiB")
    gb = [(_as_f32(g, C, dev), _as_f32(b, C, dev))
          for g, b in zip(gammas, betas)]
    if film is not None:
        film = film.reshape(B, 2 * C).contiguous()
    ys = [torch.empty_like(x) for x in xs]
    coef = torch.empty((3, 2, B, C), dtype=torch.float32, device=dev)
    stacks: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
    if means:
        lens = [n for x in xs for n in (x.shape[1], x.shape[2])]
        buf = torch.empty(B * 3 * C * sum(lens), dtype=torch.bfloat16,
                          device=dev)
        views = [v.view(B, n, 3, C) for v, n in
                 zip(buf.split([B * 3 * C * n for n in lens]), lens)]
        stacks = list(zip(views[0::2], views[1::2]))
    ptrs = []
    for i, x in enumerate(xs):
        rows, cols = stacks[i] if means else (None, None)
        ptrs += [t.data_ptr() if t is not None else 0
                 for t in (x, ys[i], *gb[i], rows, cols)]
    rs = [n for x in xs for n in (x.shape[1], x.shape[2])]
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.sin3dm_tnorm(
            struct.pack(f"{len(ptrs)}Q", *ptrs), struct.pack("6i", *rs), B,
            C, ctypes.c_void_p(film.data_ptr() if film is not None else 0),
            ctypes.c_void_p(coef.data_ptr()), EPS,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"tnorm_silu: CUDA error {err} at launch")
    _count()
    return ys, coef, stacks


# launches from concurrent threads each count once; a thread capturing a
# CUDA graph tallies its launches instead (`tallied`)
_count_lock = threading.Lock()
_local = threading.local()


def _count() -> None:
    tally = getattr(_local, "tally", None)
    if tally is None:
        count_launches({"tnorm": 1})
    else:
        tally["tnorm"] = tally.get("tnorm", 0) + 1


@contextlib.contextmanager
def tallied():
    """For the block, in this thread, launches are being captured into a
    CUDA graph: they are tallied into the dict this yields, which
    `count_launches` counts at each replay."""
    tally = {}
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = None


def count_launches(tally) -> None:
    """Count launches the card runs: one, or one replay's tally."""
    with _count_lock:
        tnorm_silu.launches += tally.get("tnorm", 0)


tnorm_silu.launches = 0
profiling.counter("tnorm.launches", lambda: tnorm_silu.launches)
