"""The slice from one `feat.npz`: the committed towerruins AE decodes the
tag's own `encoding/feat.npz` to a textured mesh through
`AETrainer.decode_texmesh` in the JAX package and in the port, on the
CPU in fp32 (SIN3DM_DECODE_BF16=0), at reso 64, texture reso 256 and
2,000 faces."""

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
from sin3dm_tpu_torch.training.ae import AETrainer as TTrainer
from sin3dm_tpu_torch.training.ae import AETrainerConfig as TTCfg

torch.set_num_threads(2)
ENC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "checkpoints", "towerruins", "encoding")
FEAT = os.path.join(ENC, "feat.npz")
RESO, TEX, FACES = 64, 256, 2000


def _faces(path):
    with open(path) as fh:
        return sum(1 for ln in fh if ln.startswith("f "))


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    """Each side's object files from decode_texmesh, and each side's int8
    grid from its geo-grid dispatch on the dense wire."""
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
    mp.setenv("SIN3DM_SPARSE_GRID", "0")
    jfeat = jload(FEAT).map(lambda p: p[None])
    want = np.asarray(jt._dispatch_geo_grid(
        jfeat, RESO, jt._resize_aabb((92, 128, 92)))[0])[..., 0]
    h = tt._dispatch_geo_grid(tload(FEAT), RESO, tt._feat_aabb(tload(FEAT)))
    assert h.sparse is None
    assert h.quant == pytest.approx(float(jt.meta["threshold"]))
    mp.undo()
    yield out, want, h.fetch.wait()[0], jt, tt


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
