"""Triplane container — the port's native tensor type
(counterpart of `sin3dm_tpu/core/triplane.py`).

Three channels-last planes: xy `[..., H, W, C]`, xz `[..., H, D, C]`,
yz `[..., W, D, C]` (H indexes x, W indexes y, D indexes z).  On disk a
triplane is the reference's `feat.npz`: keys `feat_xy, feat_xz, feat_yz`
holding channels-FIRST float arrays without a batch dim.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch


class Triplane(NamedTuple):
    xy: torch.Tensor
    xz: torch.Tensor
    yz: torch.Tensor

    @property
    def sizes(self) -> Tuple[int, int, int]:
        """(H, W, D) spatial sizes."""
        return self.xy.shape[-3], self.xy.shape[-2], self.xz.shape[-2]

    @property
    def channels(self) -> int:
        return self.xy.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.xy.dtype

    def to(self, *args, **kwargs) -> "Triplane":
        return self.map(lambda p: p.to(*args, **kwargs))

    def map(self, fn) -> "Triplane":
        """Apply `fn` to each plane."""
        return Triplane(fn(self.xy), fn(self.xz), fn(self.yz))

    def __add__(self, other):
        return _zip_op(torch.add, self, other)

    def __sub__(self, other):
        return _zip_op(torch.sub, self, other)

    def __mul__(self, other):
        return _zip_op(torch.mul, self, other)


def _zip_op(op, a: Triplane, b) -> Triplane:
    if isinstance(b, Triplane):
        return Triplane(op(a.xy, b.xy), op(a.xz, b.xz), op(a.yz, b.yz))
    return Triplane(op(a.xy, b), op(a.xz, b), op(a.yz, b))


def randn_like(gen: torch.Generator, t: Triplane) -> Triplane:
    """Per-plane standard normal noise of t's shapes and dtype, drawn from
    `gen` (xy, then xz, then yz) on the generator's device."""
    return t.map(lambda p: torch.randn(p.shape, generator=gen,
                                       dtype=p.dtype, device=gen.device))


def save_triplane_npz(path: str, t: Triplane) -> None:
    """Write one triplane (no batch dim, or a batch of 1) as the
    reference's channels-first `feat.npz`."""
    planes = [p.detach().to("cpu", torch.float32).numpy() for p in t]
    if planes[0].ndim == 4:
        if planes[0].shape[0] != 1:
            raise ValueError("save_triplane_npz takes one sample, got a "
                             f"batch of {planes[0].shape[0]}")
        planes = [p[0] for p in planes]
    arrs = [p.transpose(2, 0, 1) for p in planes]  # HWC -> CHW
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, feat_xy=arrs[0], feat_xz=arrs[1],
                        feat_yz=arrs[2])


def load_triplane_npz(path: str, device="cpu",
                      dtype=torch.float32) -> Triplane:
    """Read a reference-format `feat.npz` into a (no-batch) Triplane."""
    with np.load(path) as data:
        planes = [np.ascontiguousarray(
            np.asarray(data[k], np.float32).transpose(1, 2, 0))
            for k in ("feat_xy", "feat_xz", "feat_yz")]
    return Triplane(*[torch.from_numpy(p).to(device=device, dtype=dtype)
                      for p in planes])
