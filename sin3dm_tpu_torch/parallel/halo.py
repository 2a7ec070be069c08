"""Plane-spatial sharding with halo exchange (counterpart of
`sin3dm_tpu/parallel/halo.py`), for planes too large for one device.

Dim 1 of a `[B, H, W, C]` plane is split into equal contiguous shards,
one per rank of a `DataGroup` (`shard_plane`; rank r holds rows
`[r h, (r+1) h)`).  A 3x3 conv then needs the `(k-1)/2` rows on either
side of a shard: `exchange_halos` brings them from the neighbours (zeros
at the plane's top and bottom edges, the zero-'SAME' conv's padding) and
`halo_conv2d` convolves with VALID rows and SAME columns.  JAX moves the
rows with `ppermute` and differentiates through it; here the exchange is
an autograd function whose backward sends each halo row's gradient back
to the rank that owns the row.  Both directions are one `all_reduce` of
a zero-filled buffer (`mesh.gather_slot`) for every plane of the call.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core import nn
from .mesh import DataGroup, all_reduce_many, gather_rows, gather_slot, \
    local_rows


def shard_plane(group: DataGroup, x: torch.Tensor,
                dim: int = 1) -> torch.Tensor:
    """This rank's rows of a whole plane (dim 1 of `[B, H, W, C]` by
    default); H must divide over the group."""
    return local_rows(group, x, dim)


def gather_plane(group: DataGroup, x: torch.Tensor,
                 dim: int = 1) -> torch.Tensor:
    """The whole plane from every rank's shard, on every rank."""
    return gather_rows(group, x, dim)


def neighbour_rows(group: DataGroup, xs: Sequence[torch.Tensor], pad: int
                   ) -> List[Tuple[Optional[torch.Tensor],
                                   Optional[torch.Tensor]]]:
    """For each shard x `[B, h, ...]`: (the `pad` rows above it, the `pad`
    rows below it), i.e. the last rows of rank r-1's shard and the first
    of rank r+1's; None past the plane's edges.  One `all_reduce`."""
    bufs = all_reduce_many(group, [
        gather_slot(group, torch.stack([x[:, :pad], x[:, -pad:]]))
        for x in xs])
    r, n = group.rank, group.size
    return [(buf[r - 1, 1] if r > 0 else None,
             buf[r + 1, 0] if r < n - 1 else None) for buf in bufs]


class _Halo(torch.autograd.Function):
    """Each shard `[B, h, ...]` -> `[B, h + 2 pad, ...]` with its
    neighbours' rows (zeros past the edges); the backward adds each halo
    row's gradient into the rank that owns the row."""

    @staticmethod
    def forward(ctx, group, pad, *xs):
        ctx.group, ctx.pad = group, pad
        out = []
        for x, (top, bot) in zip(xs, neighbour_rows(group, xs, pad)):
            zero = x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))
            out.append(torch.cat([zero if top is None else top, x,
                                  zero if bot is None else bot], dim=1))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        group, pad = ctx.group, ctx.pad
        r, n = group.rank, group.size
        # slot r: (the grad of my top halo, owned by rank r-1's last rows;
        # that of my bottom halo, owned by rank r+1's first rows)
        bufs = all_reduce_many(group, [
            gather_slot(group, torch.stack([g[:, :pad], g[:, -pad:]]))
            for g in grads])
        out = []
        for g, buf in zip(grads, bufs):
            gx = g[:, pad:g.shape[1] - pad].clone()
            if r < n - 1:
                gx[:, -pad:] += buf[r + 1, 0]
            if r > 0:
                gx[:, :pad] += buf[r - 1, 1]
            out.append(gx)
        return (None, None, *out)


def exchange_halos(group: DataGroup, xs: Sequence[torch.Tensor],
                   pad: int) -> List[torch.Tensor]:
    """Every shard of `xs` with `pad` rows of its neighbours above and
    below (zeros at the plane's edges), differentiable."""
    return list(_Halo.apply(group, pad, *xs))


def halo_conv2d_many(ps: Sequence[Dict], xs: Sequence[torch.Tensor],
                     group: DataGroup) -> List[torch.Tensor]:
    """`halo_conv2d` of several planes with one exchange (all kernels of
    one size)."""
    kh, kw = ps[0]["w"].shape[0], ps[0]["w"].shape[1]
    assert kh % 2 == 1 and kw % 2 == 1, "odd kernels only"
    pad = (kh - 1) // 2
    if pad == 0:
        return [nn.conv2d(p, x) for p, x in zip(ps, xs)]
    for x in xs:
        assert x.shape[1] >= pad, "local shard must be at least the halo " \
            "width"
    out = []
    for p, x in zip(ps, exchange_halos(group, xs, pad)):
        w = p["w"].to(x.dtype).permute(3, 2, 0, 1)
        y = F.conv2d(x.permute(0, 3, 1, 2), w,
                     padding=(0, (kw - 1) // 2)).permute(0, 2, 3, 1)
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        out.append(y)
    return out


def halo_conv2d(p: Dict, x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """`core.nn.conv2d` (stride 1, zero-'SAME') of a plane whose dim 1 is
    sharded over `group`; `x` is this rank's shard `[B, h, W, C]`.  Odd
    kernels only; every shard holds at least the halo's rows (the plane's
    H divides over the group: `shard_plane`)."""
    return halo_conv2d_many([p], [x], group)[0]


def upsample2x_bilinear(xs: Sequence[torch.Tensor],
                        group: DataGroup) -> List[torch.Tensor]:
    """`core.nn.upsample2x_bilinear` of sharded planes (one exchange for
    all): each shard with one neighbour row on each side, resized, cut
    back to its own rows.  Half-pixel centres read one row beyond the
    shard; at the plane's edges the resize's own clamp applies, so every
    output row takes the weights and rows of the whole plane's resize."""
    out = []
    for x, (top, bot) in zip(xs, neighbour_rows(group, xs, 1)):
        ext = torch.cat([v for v in (top, x, bot) if v is not None], dim=1)
        first = 2 if top is not None else 0
        out.append(nn.upsample2x_bilinear(ext)[:, first:first
                                                + 2 * x.shape[1]])
    return out
