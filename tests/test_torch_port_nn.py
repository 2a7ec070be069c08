"""Port parity: `sin3dm_tpu_torch.core.nn` against `sin3dm_tpu.core.nn`.

The same numpy inputs go through both; fp32 on the CPU, tolerance 1e-5
(summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core import nn as jnn
from sin3dm_tpu_torch.core import nn as tnn

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _both(p):
    """A param dict as (jax, torch) trees."""
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_linear_and_silu():
    rng = np.random.default_rng(0)
    x = _rand(rng, 5, 24)
    jp, tp = _both({"w": _rand(rng, 24, 16), "b": _rand(rng, 16)})
    _close(tnn.linear(tp, torch.from_numpy(x)), jnn.linear(jp, jnp.asarray(x)))
    _close(tnn.silu(torch.from_numpy(x)), jnn.silu(jnp.asarray(x)))


@pytest.mark.parametrize("k,shape", [(1, (2, 9, 7, 12)), (5, (1, 11, 8, 4)),
                                     (5, (1, 12, 12, 64))])
def test_conv2d(k, shape):
    rng = np.random.default_rng(k)
    C = shape[-1]
    x = _rand(rng, *shape)
    jp, tp = _both({"w": _rand(rng, k, k, C, 16, scale=(k * k * C) ** -0.5),
                    "b": _rand(rng, 16)})
    _close(tnn.conv2d(tp, torch.from_numpy(x)),
           jnn.conv2d(jp, jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(2, 9, 7, 64), (1, 15, 16, 192)])
def test_group_norm32(shape):
    rng = np.random.default_rng(1)
    C = shape[-1]
    x = _rand(rng, *shape, scale=3.0) + 1.0
    jp, tp = _both({"g": _rand(rng, C) + 1.0, "b": _rand(rng, C)})
    _close(tnn.group_norm32(tp, torch.from_numpy(x)),
           jnn.group_norm32(jp, jnp.asarray(x)))


@pytest.mark.parametrize("with_film", [False, True])
def test_group_norm32_film_silu(with_film):
    rng = np.random.default_rng(2)
    B, C = 2, 64
    x = _rand(rng, B, 10, 13, C, scale=2.0)
    jp, tp = _both({"g": _rand(rng, C) + 1.0, "b": _rand(rng, C)})
    film = None
    jfilm = tfilm = None
    if with_film:
        film = (_rand(rng, B, 1, 1, C, scale=0.3),
                _rand(rng, B, 1, 1, C, scale=0.3))
        jfilm = tuple(jnp.asarray(f) for f in film)
        tfilm = tuple(torch.from_numpy(f) for f in film)
    _close(tnn.group_norm32_film_silu(tp, torch.from_numpy(x), tfilm),
           jnn.group_norm32_film_silu(jp, jnp.asarray(x), jfilm))


def test_instance_norm_affine():
    rng = np.random.default_rng(3)
    x = _rand(rng, 1, 12, 9, 8, scale=2.0) + 0.5
    g, b = _rand(rng, 8) + 1.0, _rand(rng, 8)
    _close(tnn.instance_norm(torch.from_numpy(x), 1e-6, torch.from_numpy(g),
                             torch.from_numpy(b)),
           jnn.instance_norm(jnp.asarray(x), 1e-6, jnp.asarray(g),
                             jnp.asarray(b)))
    _close(tnn.instance_norm(torch.from_numpy(x)),
           jnn.instance_norm(jnp.asarray(x)))


@pytest.mark.parametrize("hw", [(12, 16), (15, 11), (7, 7)])
def test_avg_pool2x(hw):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, *hw, 8)
    _close(tnn.avg_pool2x(torch.from_numpy(x)), jnn.avg_pool2x(jnp.asarray(x)))


@pytest.mark.parametrize("src,dst", [((8, 6), (16, 12)), ((7, 5), (15, 10)),
                                     ((23, 32), (11, 16)),
                                     ((12, 9), (46, 35))])
def test_resize_bilinear(src, dst):
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, *src, 4)
    _close(tnn.resize_bilinear(torch.from_numpy(x), dst),
           jnn.resize_bilinear(jnp.asarray(x), dst))
    # unbatched [H, W, C], as the dense grid decode calls it
    _close(tnn.resize_bilinear(torch.from_numpy(x[0]), dst),
           jnn.resize_bilinear(jnp.asarray(x[0]), dst))


def _resize_axis_uncached(x, dim, n_out):
    """`_resize_axis` with its taps made from numpy at every call, as it
    was before they were kept on the device."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("src,dst", [((23, 32), (11, 16)),
                                     ((12, 9), (46, 35))])
def test_resize_bilinear_taps_kept_on_the_device(src, dst, dtype):
    """The taps kept per (sizes, device) give today's values bit for bit,
    on the first call and from the cache."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_rand(rng, 2, *src, 4)).to(dtype)
    wide = tnn._wide(x)
    want = _resize_axis_uncached(
        _resize_axis_uncached(wide, 2, dst[1]), 1, dst[0]).to(dtype)
    for _ in range(2):
        assert torch.equal(tnn.resize_bilinear(x, dst), want)
    taps = tnn._TAPS[(src[1], dst[1], x.device)]
    assert [t.dtype for t in taps] == [torch.int64, torch.int64,
                                       torch.float32, torch.float32]
    assert all(t.device == x.device for t in taps)


def test_upsample2x_bilinear():
    rng = np.random.default_rng(6)
    x = _rand(rng, 1, 7, 5, 8)
    _close(tnn.upsample2x_bilinear(torch.from_numpy(x)),
           jnn.upsample2x_bilinear(jnp.asarray(x)))


@pytest.mark.parametrize("dim", [64, 33])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 17, 500, 999], np.int32)
    got = tnn.timestep_embedding(torch.from_numpy(t).long(), dim)
    want = jnn.timestep_embedding(jnp.asarray(t), dim)
    # cos/sin of arguments up to ~1e3 rad: float32 argument rounding
    # dominates, identical on both sides up to the libm's last ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)
