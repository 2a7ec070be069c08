"""Sparse near-surface wire of the int8 TSDF grid (counterpart of
`sin3dm_tpu/ops/sparse_grid.py`, the same format bit for bit).

Marching cubes reads voxel magnitudes only at the two ends of an edge
whose sign changes; every other voxel gives its sign alone.  So the grid
travels from the device to the host as:

* the sign (value < 0) of every voxel, bit-packed in np.packbits order
  (first voxel in the most significant bit), and
* the int8 values of every 4^3 block holding a voxel that an MC edge can
  read (flagged blocks first, ascending by id, up to a fixed capacity;
  then the rest), with int32 block ids and the count of flagged blocks.

`encode` runs on the grid's device as torch operations; `occupancy_host`
and `decode_host` rebuild on the host with numpy.  Where the flagged
blocks overflow the capacity (`count > capacity`), the caller takes the
dense grid, which it keeps.  The rebuilt grid has every voxel's sign and
every value MC reads; the mesh equals the dense grid's bit for bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

BLOCK = 4


class SparseGrid(NamedTuple):
    """One encoded grid: arrays (device tensors or host numpy) and shapes."""
    signs: Any            # [ceil(N/8)] uint8, np.packbits bit order
    block_ids: Any        # [K] int32 (flagged first, ascending; then rest)
    block_vals: Any       # [K, BLOCK**3] int8
    count: Any            # number of flagged blocks
    shape: Tuple[int, int, int]          # unpadded grid shape
    padded: Tuple[int, int, int]         # multiple-of-BLOCK shape


def padded_shape(shape) -> Tuple[int, int, int]:
    """The multiple-of-BLOCK shape `encode` pads to."""
    return tuple(-(-int(s) // BLOCK) * BLOCK for s in shape)


def default_capacity(padded: Tuple[int, int, int]) -> int:
    """A fifth of all blocks (real decodes flag about a tenth)."""
    nb = (padded[0] // BLOCK) * (padded[1] // BLOCK) * (padded[2] // BLOCK)
    return max(1, nb // 5)


def _pad_to_block(q: torch.Tensor) -> torch.Tensor:
    """Edge-replicate to a multiple of BLOCK (no fake sign crossing)."""
    for axis, s in enumerate(q.shape):
        p = (-s) % BLOCK
        if p:
            idx = torch.clamp(torch.arange(s + p, device=q.device), max=s - 1)
            q = q.index_select(axis, idx)
    return q


@torch.no_grad()
def encode(q: torch.Tensor, capacity: int = None) -> SparseGrid:
    """Encode an int8 TSDF grid `[X, Y, Z]` on its device."""
    shape = tuple(int(s) for s in q.shape)
    qp = _pad_to_block(q)
    P = tuple(int(s) for s in qp.shape)
    if capacity is None:
        capacity = default_capacity(P)

    neg = qp < 0

    # a voxel matters iff it is an end of a sign-crossing edge
    matter = torch.zeros_like(neg)
    for axis in range(3):
        a = neg.movedim(axis, 0)
        cross = a[1:] != a[:-1]
        m = matter.movedim(axis, 0)
        m[1:] |= cross
        m[:-1] |= cross

    # marching cubes pads one layer of +1.0: a negative voxel on the
    # volume's boundary crosses against it, so its magnitude is read too
    for axis, size in enumerate(shape):
        for i in (0, size - 1):
            m = matter.select(axis, i)
            m |= neg.select(axis, i)

    bx, by, bz = P[0] // BLOCK, P[1] // BLOCK, P[2] // BLOCK
    mb = matter.reshape(bx, BLOCK, by, BLOCK, bz, BLOCK)
    bflag = mb.any(dim=5).any(dim=3).any(dim=1).reshape(-1)     # [nb]

    # flagged blocks first, each group in ascending id order
    order = torch.argsort((~bflag).to(torch.uint8), stable=True)
    block_ids = order[:capacity].to(torch.int32)

    blocks = (qp.reshape(bx, BLOCK, by, BLOCK, bz, BLOCK)
              .permute(0, 2, 4, 1, 3, 5).reshape(-1, BLOCK ** 3))
    block_vals = blocks.index_select(0, block_ids.long())

    # np.packbits bit order: the first element in the most significant bit
    flat = neg.reshape(-1)
    pad = (-flat.shape[0]) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=q.device)
    signs = (flat.reshape(-1, 8).to(torch.int32) * weights).sum(
        dim=-1).to(torch.uint8)

    return SparseGrid(signs, block_ids, block_vals,
                      bflag.sum(dtype=torch.int32), shape, P)


def occupancy_host(sg: SparseGrid) -> np.ndarray:
    """Occupancy (sdf < 0) `[X, Y, Z]` bool from the sign bits: what
    voxel.npz stores (floor quantization keeps every sign)."""
    P = sg.padded
    n = P[0] * P[1] * P[2]
    bits = np.unpackbits(np.asarray(sg.signs))[:n].reshape(P)
    X, Y, Z = sg.shape
    return bits[:X, :Y, :Z].astype(bool)


def decode_host(sg: SparseGrid, quant: float) -> np.ndarray:
    """Rebuild the fp32 TSDF grid `[X, Y, Z]` on the host, dequantized to
    bucket centres as the dense int8 path does.  The caller has checked
    `count <= capacity`."""
    P = sg.padded
    n = P[0] * P[1] * P[2]
    signs = np.unpackbits(np.asarray(sg.signs))[:n]
    # far field: the saturated bucket of the right sign (MC reads no
    # magnitude there)
    q = np.where(signs, np.int8(-128), np.int8(127)).reshape(P)

    by, bz = P[1] // BLOCK, P[2] // BLOCK
    count = int(sg.count)
    ids = np.asarray(sg.block_ids)[:count].astype(np.int64)
    vals = np.asarray(sg.block_vals)[:count].reshape(-1, BLOCK, BLOCK,
                                                     BLOCK)
    b0, rem = np.divmod(ids, by * bz)
    b1, b2 = np.divmod(rem, bz)
    r = np.arange(BLOCK)
    q[(b0 * BLOCK)[:, None, None, None] + r[None, :, None, None],
      (b1 * BLOCK)[:, None, None, None] + r[None, None, :, None],
      (b2 * BLOCK)[:, None, None, None] + r[None, None, None, :]] = vals

    X, Y, Z = sg.shape
    q = q[:X, :Y, :Z]
    return (q.astype(np.float32) + 0.5) * (quant / 127.0)
