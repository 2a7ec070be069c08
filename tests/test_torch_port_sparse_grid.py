"""Port parity of the sparse near-surface grid wire (`ops/sparse_grid.py`):
the same int8 grid into the JAX package's `encode` and the port's gives
the same wire, both host rebuilds agree, and marching cubes from the
port's wire equals marching cubes from the dense grid, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.ops import sparse_grid as jsg
from sin3dm_tpu_torch.geometry import meshproc
from sin3dm_tpu_torch.ops import sparse_grid as tsg

torch.set_num_threads(2)
SHAPES = [(17, 23, 9), (40, 36, 36), (60, 52, 44)]


def _sphere_q(shape, radius=0.55, thr=0.0234375):
    """Floor-quantized int8 clamped TSDF of a sphere (bucket k covers
    [k, k+1)), as `tests/test_sparse_grid.py` builds it."""
    axes = [np.linspace(-1, 1, s) for s in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    v = np.clip(np.sqrt(x * x + y * y + z * z) - radius, -thr, thr)
    return np.clip(np.floor(v * 127.0 / thr), -128, 127).astype(np.int8), thr


def _full_capacity(shape):
    return int(np.prod([-(-s // tsg.BLOCK) for s in shape]))


def _both(q, capacity=None):
    """(JAX SparseGrid, port SparseGrid) of q, arrays as numpy."""
    j = jax.jit(lambda x: tuple(jsg.encode(x, capacity=capacity))[:4])(
        jnp.asarray(q))
    jg = jsg.SparseGrid(*[np.asarray(a) for a in j], q.shape,
                        jsg.padded_shape(q.shape))
    t = tsg.encode(torch.from_numpy(q), capacity=capacity)
    tg = t._replace(signs=t.signs.numpy(), block_ids=t.block_ids.numpy(),
                    block_vals=t.block_vals.numpy(), count=int(t.count))
    return jg, tg


@pytest.mark.parametrize("capacity", [None, "full"])
@pytest.mark.parametrize("shape", SHAPES)
def test_encode_matches_jax(shape, capacity):
    q, thr = _sphere_q(shape)
    cap = _full_capacity(shape) if capacity == "full" else None
    jg, tg = _both(q, cap)
    assert tg.shape == jg.shape and tg.padded == jg.padded
    n = int(jg.count)
    assert tg.count == n > 0
    assert tg.signs.dtype == np.uint8 and tg.block_ids.dtype == np.int32
    assert tg.block_vals.dtype == np.int8
    np.testing.assert_array_equal(tg.signs, jg.signs)
    np.testing.assert_array_equal(tg.block_ids[:n], jg.block_ids[:n])
    np.testing.assert_array_equal(tg.block_vals[:n], jg.block_vals[:n])
    assert tg.block_ids.shape == jg.block_ids.shape
    if n <= len(jg.block_ids):
        np.testing.assert_array_equal(tsg.occupancy_host(tg),
                                      jsg.occupancy_host(jg))
        np.testing.assert_array_equal(tsg.decode_host(tg, thr),
                                      jsg.decode_host(jg, thr))


@pytest.mark.parametrize("shape", SHAPES)
def test_sparse_marching_cubes_equals_dense(shape):
    """The port's library: MC from the wire == MC from the dense
    dequantized grid (vertices and faces, in order); occupancy == sdf < 0
    of the dense grid."""
    q, thr = _sphere_q(shape)
    _, tg = _both(q, _full_capacity(shape))
    dense = (q.astype(np.float32) + 0.5) * (thr / 127.0)
    v1, f1 = meshproc.sdfgrid_to_mesh(dense)
    v2, f2 = meshproc.sdfgrid_to_mesh_sparse(tg, thr)
    assert len(f1) > 100
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(tsg.occupancy_host(tg), dense < 0)


def test_boundary_clipped_shape_and_overflow():
    """A sphere clipped by the volume (negative boundary voxels cross the
    +1.0 MC pad) matches JAX's wire; random signs overflow the default
    capacity, and marching cubes refuses that wire."""
    q, thr = _sphere_q((24, 24, 24), radius=1.4)
    assert (q[0] < 0).any()
    jg, tg = _both(q, 216)
    np.testing.assert_array_equal(tg.signs, jg.signs)
    n = int(jg.count)
    np.testing.assert_array_equal(tg.block_ids[:n], jg.block_ids[:n])
    v1, f1 = meshproc.sdfgrid_to_mesh(tsg.decode_host(tg, thr))
    v2, f2 = meshproc.sdfgrid_to_mesh_sparse(tg, thr)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(f1, f2)

    rng = np.random.default_rng(0)
    q = rng.integers(-128, 128, (32, 32, 32)).astype(np.int8)
    jg, tg = _both(q)
    assert tg.count == int(jg.count) > len(tg.block_ids)
    with pytest.raises(ValueError, match="overflow"):
        meshproc.sdfgrid_to_mesh_sparse(tg, 0.05)
