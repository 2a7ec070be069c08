"""The slice from one `feat.npz`: the committed towerruins AE decodes the
tag's own `encoding/feat.npz` to a textured mesh through
`AETrainer.decode_texmesh` in the JAX package and in the port, on the
CPU in fp32 (SIN3DM_DECODE_BF16=0), at reso 64, texture reso 256 and
2,000 faces; and the port's one decode route: the sparse wire's
overflow to the dense grid, and the files that the variables which once
chose another route leave unchanged."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sin3dm_tpu.core.triplane import load_triplane_npz as jload
from sin3dm_tpu.models import autoencoder as jae
from sin3dm_tpu.training.ae import AETrainer as JTrainer
from sin3dm_tpu.training.ae import AETrainerConfig as JTCfg
from sin3dm_tpu_torch.core.triplane import load_triplane_npz as tload
from sin3dm_tpu_torch.geometry import uvatlas
from sin3dm_tpu_torch.models import autoencoder as tae
from sin3dm_tpu_torch.ops import sparse_grid as tsg
from sin3dm_tpu_torch.training.ae import AETrainer as TTrainer
from sin3dm_tpu_torch.training.ae import AETrainerConfig as TTCfg

torch.set_num_threads(2)
ENC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "checkpoints", "towerruins", "encoding")
FEAT = os.path.join(ENC, "feat.npz")
RESO, TEX, FACES = 64, 256, 2000
ENCODE = tsg.encode


def _faces(path):
    with open(path) as fh:
        return sum(1 for ln in fh if ln.startswith("f "))


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    """Each side's object files from decode_texmesh, and each side's int8
    grid from its geo-grid dispatch (the port's: the device grid that its
    sparse wire encodes)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SIN3DM_DECODE_BF16", "0")
    out = tmp_path_factory.mktemp("texmesh")
    jt = JTrainer(ENC, jae.AEConfig(), JTCfg())
    jt.load_ckpt("final")
    tt = TTrainer(ENC, tae.AEConfig(), "cpu", TTCfg())
    tt.load_ckpt("final")
    jt.decode_texmesh(str(out / "jax"), jload(FEAT), RESO, n_faces=FACES,
                      texture_reso=TEX)
    tt.decode_texmesh(str(out / "port"), tload(FEAT), RESO, n_faces=FACES,
                      texture_reso=TEX)
    jfeat = jload(FEAT).map(lambda p: p[None])
    want = np.asarray(jt._dispatch_geo_grid(
        jfeat, RESO, jt._resize_aabb((92, 128, 92)))[0])[..., 0]
    h = tt._dispatch_geo_grid(tload(FEAT), RESO, tt._feat_aabb(tload(FEAT)))
    assert h.sparse is not None
    assert h.quant == pytest.approx(float(jt.meta["threshold"]))
    mp.undo()
    yield out, want, h.grid.cpu().numpy(), jt, tt


def test_voxels_and_int8_grid(decoded):
    """voxel.npz is equal; the int8 grids differ only at a counted number
    of bucket-edge voxels (at most 1e-3 of them), every sign the same."""
    out, want, got = decoded[:3]
    with np.load(out / "jax" / "voxel.npz") as a, \
            np.load(out / "port" / "voxel.npz") as b:
        np.testing.assert_array_equal(b["vox_grid"], a["vox_grid"])
    assert got.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got < 0, want < 0)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"int8 grid {got.shape}: {int((d > 0).sum())} bucket-edge voxels "
          "differ")
    assert d.max() <= 1 and (d > 0).sum() <= 1e-3 * d.size


def test_object_obj_face_count(decoded):
    """Same face count and .mtl; where no int8 voxel differs, the same
    .obj."""
    out, want, got = decoded[:3]
    a, b = out / "jax" / "object.obj", out / "port" / "object.obj"
    assert 0 < _faces(b) == _faces(a) <= FACES
    assert (out / "port" / "object.mtl").read_bytes() == \
        (out / "jax" / "object.mtl").read_bytes()
    if np.array_equal(got, want):
        assert b.read_bytes() == a.read_bytes()


def _obj_mesh(path):
    """(vertices float64 [n, 3], faces int64 [m, 3]) of an object.obj."""
    v, f = [], []
    with open(path) as fh:
        for ln in fh:
            if ln.startswith("v "):
                v.append([float(x) for x in ln.split()[1:4]])
            elif ln.startswith("f "):
                f.append([int(c.split("/")[0]) - 1 for c in ln.split()[1:4]])
    return np.asarray(v, np.float64), np.asarray(f, np.int64)


def test_object_png_texels(decoded):
    """The textures: within 1, fewer than 1 % of the texels differing,
    where the meshes are the same.  A bucket-edge voxel moves a few
    marching-cubes vertices, which moves the UV atlas: texels at chart
    edges are then covered on one side only, so at most 1 % of the
    pixels may differ, by any amount."""
    out, want, got = decoded[:3]
    a = np.asarray(Image.open(out / "jax" / "object.png")).astype(np.int32)
    b = np.asarray(Image.open(out / "port" / "object.png")).astype(np.int32)
    assert a.shape == b.shape == (TEX, TEX, 3)
    d = np.abs(a - b)
    print(f"object.png: max diff {d.max()}, {(d > 0).mean():.3%} differ")
    assert (d > 0).mean() < 0.01
    if np.array_equal(got, want):
        assert d.max() <= 1


def test_texels_on_one_atlas(decoded):
    """Each side's texel decode (the default compact run wire) over the
    atlas of JAX's own mesh: uint8 within 1, fewer than 1 % differing."""
    out, _, _, jt, tt = decoded
    v, f = _obj_mesh(out / "jax" / "object.obj")
    _, _, mask, runs = uvatlas.uv_unwrap_and_rasterize_runs(v, f, TEX)
    mp = pytest.MonkeyPatch()
    mp.setenv("SIN3DM_DECODE_BF16", "0")
    try:
        aabb = jt._resize_aabb((92, 128, 92))
        chunks, n = jt._dispatch_texels_runs(
            jload(FEAT).map(lambda p: p[None]), runs, aabb)
        want = np.concatenate([np.asarray(c) for c in chunks])[:n]
        fetch, n2 = tt._dispatch_texels_runs(tload(FEAT), runs, aabb)
        got = np.concatenate(fetch.wait())[:n2]
    finally:
        mp.undo()
    assert n == n2 == int(mask.sum()) > 1000
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"texels on one atlas: max diff {d.max()}, {(d > 0).mean():.3%} "
          "differ")
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def _wire_capacity(monkeypatch, blocks=None):
    """Give the sparse wire a capacity of `blocks` (None: every block, so
    that marching cubes reads the wire at these small grids, whose
    flagged blocks overflow the default fifth of them)."""
    def capped(q, capacity=None):
        every = int(np.prod(tsg.padded_shape(q.shape))) // tsg.BLOCK ** 3
        return ENCODE(q, capacity=blocks or every)
    monkeypatch.setattr(tsg, "encode", capped)


def test_overflowed_sparse_wire_falls_back_to_the_dense_grid(decoded,
                                                             monkeypatch):
    """Where the flagged blocks overflow the sparse wire's capacity (here
    one block), `_fetch_geo_grid` hands marching cubes the dense grid:
    (int8 + 0.5) * thr / 127 of the dispatched grid, whose occupancy is
    the wire's where every block fits."""
    tt = decoded[4]
    monkeypatch.setenv("SIN3DM_DECODE_BF16", "0")
    feat = tload(FEAT)
    aabb = tt._feat_aabb(feat)
    _wire_capacity(monkeypatch)
    _, fitted = tt._fetch_geo_grid(tt._dispatch_geo_grid(feat, RESO, aabb))
    assert fitted is not None
    _wire_capacity(monkeypatch, 1)
    h = tt._dispatch_geo_grid(feat, RESO, aabb)
    assert h.sparse is not None and int(h.sparse.count) > 1
    dense, sparse = tt._fetch_geo_grid(h)
    assert sparse is None
    q = h.grid.cpu().numpy()
    np.testing.assert_array_equal(
        dense, (q.astype(np.float32) + 0.5) * (h.quant / 127.0))
    np.testing.assert_array_equal(dense < 0, tsg.occupancy_host(fitted))


def test_deleted_route_variables_change_nothing(tmp_path, monkeypatch):
    """The decode has one route: with the variables that once chose
    another (the fp32 texel points, the dense int8 grid, marching cubes
    over the dense grid, the export inline) set to those choices, the
    committed PBR tag's decode_texmesh writes the same bytes, four maps
    whose heads do not saturate included.  Every block fits the sparse
    wire, so that marching cubes reads it."""
    enc = os.path.join(os.path.dirname(ENC), "..", "towerruins-pbr",
                       "encoding")
    with open(os.path.join(enc, "args.json")) as fh:
        a = json.load(fh)
    tt = TTrainer(enc, tae.AEConfig(**{k: a[k] for k in (
        "data_type", "enc_net_type", "fdim_geo", "fdim_tex", "fdim_up",
        "hidden_dim", "n_hidden_layers")}), "cpu")
    tt.load_ckpt("final")
    feat = tload(os.path.join(enc, "feat.npz"))
    monkeypatch.setenv("SIN3DM_DECODE_BF16", "0")
    _wire_capacity(monkeypatch)
    old = {"SIN3DM_TEXEL_WIRE": "f32", "SIN3DM_SPARSE_GRID": "0",
           "SIN3DM_SPARSE_MC": "0", "SIN3DM_ASYNC_EXPORT": "0"}
    files = []
    for env in ({}, old):
        d = tmp_path / f"env{len(env)}"
        with monkeypatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            tt.decode_texmesh(str(d), feat, RESO, n_faces=500,
                              texture_reso=128)
        files.append({str(f.relative_to(d)): f.read_bytes()
                      for f in sorted(d.rglob("*")) if f.is_file()})
    assert "textures/albedo.png" in files[0] and "voxel.npz" in files[0]
    assert files[1].keys() == files[0].keys()
    for name, data in files[0].items():
        assert files[1][name] == data, name
