"""The port's host geometry against the JAX package's: the C++ library
(a byte-identical copy of the source, built with the same flags into the
port's build directory, and without -fopenmp as where g++ cannot link
OpenMP) gives bit-identical outputs on the same seeded inputs; the UV
atlas is identical; the file writers write the same OBJ and MTL text, a
PNG that decodes to the image, and a GLB of the same layout."""

import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from sin3dm_tpu.geometry import meshio as jio
from sin3dm_tpu.geometry import native as jnat
from sin3dm_tpu.geometry import uvatlas as juv
from sin3dm_tpu_torch.geometry import meshio as tio
from sin3dm_tpu_torch.geometry import native as tnat
from sin3dm_tpu_torch.geometry import uvatlas as tuv
from sin3dm_tpu_torch.ops import _build

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _bumpy_sdf(n=40):
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    bump = (0.1 * np.sin(5 * g[..., 0]) * np.sin(4 * g[..., 1])
            * np.sin(6 * g[..., 2]))
    return (np.linalg.norm(g, axis=-1) - 0.7 + bump).astype(np.float32)


@pytest.fixture(scope="module")
def mesh():
    """A bumpy sphere from marching cubes, and its decimation to 600
    faces (JAX's library)."""
    v, f = jnat.marching_cubes(np.pad(_bumpy_sdf(), 1, constant_values=1.0))
    vd, fd = jnat.decimate(v, f, 600, prepass_mult=4)
    return v, f, vd, fd


@pytest.fixture(params=["openmp", "serial"])
def flavour(request, monkeypatch):
    """The port's library as built here (JAX's flags, OpenMP) and as built
    where g++ cannot link OpenMP (the same flags without -fopenmp)."""
    if request.param == "serial":
        flags = tuple(f for f in tnat.CXX_FLAGS if f != "-fopenmp")
        monkeypatch.setattr(tnat, "build_flags", lambda: flags)
        monkeypatch.setattr(tnat, "_lib", None)
    return request.param


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_source_is_a_copy_built_into_build_dir():
    src = os.path.join(ROOT, "sin3dm_tpu", "geometry", "cpp", "geometry.cpp")
    with open(src, "rb") as a, open(tnat.SOURCE, "rb") as b:
        assert a.read() == b.read()
    info = tnat.build()
    assert info["flags"] == tnat.CXX_FLAGS      # this host's g++ links OpenMP
    assert os.path.dirname(info["path"]) == str(_build.BUILD_DIR)
    assert os.path.basename(info["path"]).startswith("geometry-")
    assert os.path.exists(info["path"])
    assert not [p for p in os.listdir(os.path.dirname(tnat.SOURCE))
                if p != "geometry.cpp"]
    with open(os.path.join(ROOT, "sin3dm_tpu", "geometry", "cpp",
                           "Makefile")) as mk:
        flags = [ln for ln in mk if ln.startswith("CXXFLAGS")][0]
    assert flags.split("=", 1)[1].split() + ["-shared"] == tnat.CXX_FLAGS


def test_marching_cubes_components_decimation(mesh, flavour):
    v, f, vd, fd = mesh
    g = np.pad(_bumpy_sdf(), 1, constant_values=1.0)
    _same(tnat.marching_cubes(g, 0.0), (v, f))
    _same(tnat.marching_cubes(-g, -0.5), jnat.marching_cubes(-g, -0.5))
    _same(tnat.face_components(f, len(v)), jnat.face_components(f, len(v)))
    _same(tnat.decimate(v, f, 600, prepass_mult=4), (vd, fd))
    _same(tnat.decimate(v, f, 900), jnat.decimate(v, f, 900))


def test_sparse_marching_cubes(flavour):
    from sin3dm_tpu.ops import sparse_grid as jsg
    import jax
    import jax.numpy as jnp
    thr = 0.05
    q = np.clip(np.floor(np.clip(_bumpy_sdf(36), -thr, thr) / thr * 127),
                -128, 127).astype(np.int8)
    cap = int(np.prod([-(-s // 4) for s in q.shape]))
    arrs = jax.jit(lambda x: tuple(jsg.encode(x, capacity=cap))[:4])(
        jnp.asarray(q))
    signs, ids, vals, count = [np.asarray(a) for a in arrs]
    args = (signs, ids, vals, int(count), q.shape, jsg.padded_shape(q.shape),
            thr)
    _same(tnat.marching_cubes_sparse(*args), jnat.marching_cubes_sparse(*args))


def test_rasterizers_and_texel_wire(mesh, flavour):
    _, _, vd, fd = mesh
    uvs, tex_idx = juv.parametrize(vd, fd, padding=2 / 128)
    args = (uvs.astype(np.float32), tex_idx.astype(np.int32),
            vd.astype(np.float32), fd.astype(np.int32), 128)
    pos, mask = tnat.rasterize_uv(*args)
    _same((pos, mask), jnat.rasterize_uv(*args))
    _same(tnat.rasterize_uv_runs(*args), jnat.rasterize_uv_runs(*args))
    rng = np.random.default_rng(3)
    for C in (3, 8, 1):
        preds = rng.integers(0, 256, (int(mask.sum()), C)).astype(np.uint8)
        _same([tnat.tex_assemble(preds, mask, 128)],
              [jnat.tex_assemble(preds, mask, 128)])


def test_charts_and_rect_angles(mesh, flavour):
    v, f, _, _ = mesh
    _same(tnat.charts_by_axis(v, f), jnat.charts_by_axis(v, f))
    rng = np.random.default_rng(0)
    clouds = [rng.normal(size=(n, 2)) * rng.uniform(0.1, 3)
              for n in (2, 3, 4, 8, 9, 20, 77, 200)]
    clouds.append(np.repeat(np.linspace(0, 1, 5)[:, None], 2, axis=1))
    clouds.append(np.zeros((6, 2)))
    _same([tnat.oriented_rect_angles(clouds)],
          [jnat.oriented_rect_angles(clouds)])


def test_parametrize_identical(mesh, flavour):
    _, _, vd, fd = mesh
    _same(tuv.parametrize(vd, fd), juv.parametrize(vd, fd))
    _same(tuv.uv_unwrap_and_rasterize_runs(vd, fd, 128),
          juv.uv_unwrap_and_rasterize_runs(vd, fd, 128))


@pytest.mark.parametrize("shape", [(37, 53, 3), (64, 48), (16, 16, 4),
                                   (2048, 2048, 3)])
def test_png_decodes_to_the_image(tmp_path, shape):
    rng = np.random.default_rng(len(shape))
    img = rng.integers(0, 256, shape).astype(np.uint8)
    if len(shape) == 3 and shape[0] == 2048:
        img[:1500] = 0          # a texture's empty atlas space
    path = str(tmp_path / "t.png")
    tio._save_png(path, img)
    got = np.asarray(Image.open(path))
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)


def test_obj_and_mtl_equal_jax(tmp_path, mesh):
    _, _, vd, fd = mesh
    uvs, tex_idx = juv.parametrize(vd, fd)
    tex = np.random.default_rng(1).integers(0, 256, (32, 32, 3)).astype(
        np.uint8)
    for mod, d in ((jio, "jax"), (tio, "port")):
        os.makedirs(tmp_path / d)
        mod.save_mesh_with_tex(str(tmp_path / d / "object.obj"), vd, uvs, fd,
                               tex_idx, tex, Kd=[1, 1, 1], Ka=[0, 0, 0],
                               Ks=[0.4, 0.4, 0.4], Ns=10)
        mod.save_mesh_with_tex(str(tmp_path / d / "m2.obj"), vd, uvs, fd,
                               tex_idx, tex, mtl_str="Kd 0.5 0.5 0.5\n")
        mod.save_mesh_vf(str(tmp_path / d / "vf.obj"), vd, fd)
    for name in ("object.obj", "object.mtl", "m2.obj", "m2.mtl", "vf.obj"):
        a = (tmp_path / "jax" / name).read_bytes()
        assert a == (tmp_path / "port" / name).read_bytes(), name
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "port" / "object.png")),
        np.asarray(Image.open(tmp_path / "jax" / "object.png")))


def _glb(path):
    with open(path, "rb") as fh:
        data = fh.read()
    magic, version, total = struct.unpack("<III", data[:12])
    assert (magic, version, total) == (0x46546C67, 2, len(data))
    n_json, kind = struct.unpack("<II", data[12:20])
    assert kind == 0x4E4F534A
    gltf = json.loads(data[20:20 + n_json])
    n_bin, kind = struct.unpack("<II", data[20 + n_json:28 + n_json])
    assert kind == 0x004E4942 and 28 + n_json + n_bin == len(data)
    return gltf, data[28 + n_json:]


def test_glb_layout_equals_jax(tmp_path, mesh):
    _, _, vd, fd = mesh
    uvs, tex_idx = juv.parametrize(vd, fd)
    tex = np.random.default_rng(2).integers(0, 256, (24, 24, 3)).astype(
        np.uint8)
    jio.save_mesh_with_tex_to_glb(str(tmp_path / "j.glb"), vd, uvs, fd,
                                  tex_idx, tex)
    tio.save_mesh_with_tex_to_glb(str(tmp_path / "t.glb"), vd, uvs, fd,
                                  tex_idx, tex)
    (jg, jb), (tg, tb) = _glb(tmp_path / "j.glb"), _glb(tmp_path / "t.glb")
    assert ([a["count"] for a in tg["accessors"]]
            == [a["count"] for a in jg["accessors"]])
    for k in ("meshes", "materials", "samplers", "accessors"):
        assert tg[k] == jg[k]
    for i in range(3):    # positions, uvs and indices equal
        jv, tv = jg["bufferViews"][i], tg["bufferViews"][i]
        assert jv == tv
        o, n = jv["byteOffset"], jv["byteLength"]
        assert jb[o:o + n] == tb[o:o + n]
    img = tg["bufferViews"][3]
    png = tb[img["byteOffset"]:img["byteOffset"] + img["byteLength"]]
    import io
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  tex)
