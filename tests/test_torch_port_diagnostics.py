"""The JAX package's diagnostics and UV-atlas switches in the port,
against the JAX functions on the same numpy inputs: `seam_stats`,
`parametrize`'s `SIN3DM_UV_TARGET` / `SIN3DM_UV_MAX_SPLITS` defaults and
`SIN3DM_UV_DEBUG` prints, the sparse wire's `wire_bytes`, the composed
feature map (`compose_featmaps`, `decompose_featmaps`), `pad_triplane`,
`zeros_like`, `randn` (an explicit generator), and `named_scope` in a
`torch.profiler` trace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core import triplane as jtri
from sin3dm_tpu.geometry import native as jnat
from sin3dm_tpu.geometry import uvatlas as juv
from sin3dm_tpu.ops import sparse_grid as jsg
from sin3dm_tpu_torch.core import profiling
from sin3dm_tpu_torch.core import triplane as ttri
from sin3dm_tpu_torch.geometry import uvatlas as tuv
from sin3dm_tpu_torch.ops import sparse_grid as tsg
from test_torch_port_geometry import _bumpy_sdf
from test_torch_port_sparse_grid import _sphere_q

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh():
    v, f = jnat.marching_cubes(np.pad(_bumpy_sdf(32), 1,
                                      constant_values=1.0))
    return jnat.decimate(v, f, 400, prepass_mult=4)


def test_seam_stats_matches_jax(mesh):
    v, f = mesh
    _, tex_idx = juv.parametrize(v, f)
    got, want = tuv.seam_stats(v, f, tex_idx), juv.seam_stats(v, f, tex_idx)
    assert got == want and 0 < got["seam_ratio"] < 1


UV_ENV = [({}, None, None), ({"SIN3DM_UV_TARGET": "0.95"}, 0.95, None),
          ({"SIN3DM_UV_MAX_SPLITS": "1"}, None, 1),
          ({"SIN3DM_UV_TARGET": "0.99", "SIN3DM_UV_MAX_SPLITS": "3"}, 0.99,
           3)]


@pytest.mark.parametrize("env,target,splits", UV_ENV)
def test_parametrize_reads_the_uv_switches(mesh, monkeypatch, capsys, env,
                                           target, splits):
    """The same atlas as JAX's under each setting, and as passing the
    values; with `SIN3DM_UV_DEBUG` the same printed rounds."""
    v, f = mesh
    for k in ("SIN3DM_UV_TARGET", "SIN3DM_UV_MAX_SPLITS", "SIN3DM_UV_DEBUG"):
        monkeypatch.delenv(k, raising=False)
    for k, x in env.items():
        monkeypatch.setenv(k, x)
    got, want = tuv.parametrize(v, f), juv.parametrize(v, f)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    kw = {}
    if target is not None:
        kw["target_util"] = target
    if splits is not None:
        kw["max_splits"] = splits
    monkeypatch.delenv("SIN3DM_UV_TARGET", raising=False)
    monkeypatch.delenv("SIN3DM_UV_MAX_SPLITS", raising=False)
    for a, b in zip(got, tuv.parametrize(v, f, **kw)):
        np.testing.assert_array_equal(a, b)
    capsys.readouterr()
    monkeypatch.setenv("SIN3DM_UV_DEBUG", "1")
    tuv.parametrize(v, f, **kw)
    printed = capsys.readouterr().out
    juv.parametrize(v, f, **kw)
    assert printed and printed == capsys.readouterr().out


@pytest.mark.parametrize("shape", [(17, 23, 9), (40, 36, 36)])
def test_wire_bytes_matches_jax(shape):
    q, _ = _sphere_q(shape)
    j = jsg.encode(jnp.asarray(q))
    t = tsg.encode(torch.from_numpy(q))
    want = jsg.wire_bytes(j)
    assert tsg.wire_bytes(t) == want
    host = t._replace(signs=t.signs.numpy(), block_ids=t.block_ids.numpy(),
                      block_vals=t.block_vals.numpy())
    assert tsg.wire_bytes(host) == want


def _planes(lead, sizes, c, seed=0):
    rng = np.random.default_rng(seed)
    H, W, D = sizes
    return [rng.standard_normal(lead + s + (c,)).astype(np.float32)
            for s in ((H, W), (H, D), (W, D))]


@pytest.mark.parametrize("lead", [(), (2,)])
def test_composed_map_and_pad_match_jax(lead):
    sizes = (5, 7, 3)
    planes = _planes(lead, sizes, 4)
    jt = jtri.Triplane(*map(jnp.asarray, planes))
    tt = ttri.Triplane(*map(torch.from_numpy, planes))
    comp = ttri.compose_featmaps(tt)
    np.testing.assert_array_equal(comp.numpy(),
                                  np.asarray(jtri.compose_featmaps(jt)))
    for a, b in zip(ttri.decompose_featmaps(comp, sizes), planes):
        np.testing.assert_array_equal(a.numpy(), b)
    pads = ((1, 2), (0, 3), (2, 1))
    for a, b in zip(ttri.pad_triplane(tt, *pads),
                    jtri.pad_triplane(jt, *pads)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ttri.zeros_like(tt), jtri.zeros_like(jt)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_randn_shapes_and_draw_order(dtype):
    """JAX's shapes; the draws are the generator's own, xy, then xz, then
    yz (threefry is not portable: the noise rule)."""
    sizes = (5, 7, 3)
    got = ttri.randn(torch.Generator().manual_seed(3), 2, 4, sizes, dtype)
    want = jtri.randn(jax.random.PRNGKey(0), 2, 4, sizes)
    assert [tuple(p.shape) for p in got] == [p.shape for p in want]
    g = torch.Generator().manual_seed(3)
    for p in got:
        assert p.dtype == dtype
        assert torch.equal(p, torch.randn(p.shape, generator=g,
                                          dtype=dtype))


def test_named_scope_marks_the_trace():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.named_scope("decode/heads"):
            torch.ones(4).sum()
    assert "decode/heads" in {e.key for e in prof.key_averages()}
