"""The port's data preparation against the JAX package's: the OBJ/MTL
loader, the BVH queries (with the library built as here, with OpenMP,
and without it, where the port splits the queries over threads), and
`mesh_sampler.run` / `mesh_sampler_pbr.run`, whose npz must equal JAX's
key for key, bit for bit: the same C++ and the same numpy draws."""

import os

import numpy as np
import pytest
from PIL import Image

from sin3dm_tpu.dataio import mesh_sampler as jms
from sin3dm_tpu.dataio import mesh_sampler_pbr as jpbr
from sin3dm_tpu.dataio.grid import normalize_aabb as j_normalize_aabb
from sin3dm_tpu.geometry import meshproc as jmp
from sin3dm_tpu.geometry import native as jnat
from sin3dm_tpu_torch.dataio import mesh_sampler as tms
from sin3dm_tpu_torch.dataio import mesh_sampler_pbr as tpbr
from sin3dm_tpu_torch.dataio.grid import normalize_aabb as t_normalize_aabb
from sin3dm_tpu_torch.geometry import meshproc as tmp
from sin3dm_tpu_torch.geometry import native as tnat


def write_cube_obj(path: str):
    """Unit cube with uvs and one Kd-only material (a copy of
    `tests/test_e2e.py:_write_cube_obj`)."""
    mtl = path.replace(".obj", ".mtl")
    with open(mtl, "w") as f:
        f.write("newmtl m0\nKd 0.8 0.3 0.2\nKa 0 0 0\nKs 0.4 0.4 0.4\n"
                "Ns 10\n")
    v = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
         (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
    faces = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7),
             (0, 1, 5), (0, 5, 4), (2, 3, 7), (2, 7, 6),
             (0, 4, 7), (0, 7, 3), (1, 2, 6), (1, 6, 5)]
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl)}\n")
        for p in v:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        f.write("vt 0 0\nvt 1 0\nvt 1 1\n")
        f.write("usemtl m0\n")
        for a, b, c in faces:
            f.write(f"f {a + 1}/1 {b + 1}/2 {c + 1}/3\n")


def write_textured_sphere(dirpath: str, n_th: int = 16, n_ph: int = 32,
                          seed: int = 0) -> str:
    """A UV sphere: the upper half textured by an 8-bit RGB PNG (written
    by PIL), the lower half a second, Kd-only material."""
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    tex = (rng.random((24, 32, 3)) * 64
           + np.arange(32)[None, :, None] * 6).astype(np.uint8)
    Image.fromarray(tex).save(os.path.join(dirpath, "tex.png"))
    with open(os.path.join(dirpath, "sphere.mtl"), "w") as f:
        f.write("newmtl textured\nKd 1 1 1\nKa 0.1 0.1 0.1\nKs 0.5 0.5 0.5\n"
                "Ns 20\nmap_Kd tex.png\n"
                "newmtl plain\nKd 0.2 0.6 0.3\n")
    th = np.linspace(0, np.pi, n_th + 1)
    ph = np.linspace(0, 2 * np.pi, n_ph + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                  np.cos(T)], -1).reshape(-1, 3) * 0.7 + [0.1, -0.2, 0.05]
    uv = np.stack([P / (2 * np.pi), 1 - T / np.pi], -1).reshape(-1, 2)
    path = os.path.join(dirpath, "sphere.obj")
    with open(path, "w") as f:
        f.write("mtllib sphere.mtl\n")
        for p in v:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for t in uv:
            f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        for half, mat in ((range(n_th // 2), "textured"),
                          (range(n_th // 2, n_th), "plain")):
            f.write(f"usemtl {mat}\n")
            for i in half:
                for j in range(n_ph):
                    a = i * (n_ph + 1) + j + 1
                    b, c = a + 1, a + n_ph + 1
                    d = c + 1
                    f.write(f"f {a}/{a} {c}/{c} {b}/{b}\n"
                            f"f {b}/{b} {c}/{c} {d}/{d}\n")
    return path


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _npz(path) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


@pytest.fixture(params=["openmp", "serial"])
def flavour(request, monkeypatch):
    """The port's library as built here (OpenMP) and as built where g++
    cannot link OpenMP (no -fopenmp: the queries split over threads)."""
    if request.param == "serial":
        flags = tuple(f for f in tnat.CXX_FLAGS if f != "-fopenmp")
        monkeypatch.setattr(tnat, "build_flags", lambda: flags)
        monkeypatch.setattr(tnat, "_lib", None)
        monkeypatch.setattr(tnat.MeshBVH, "_MIN_CHUNK", 1024)
    return request.param


def test_normalize_aabb_equals_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(500, 3)) * [1.0, 2.5, 0.7] + [3, -1, 2]
    for reso, mult in ((256, 8), (64, 8), (24, 4)):
        want = j_normalize_aabb(v, reso, mult=mult)
        got = t_normalize_aabb(v, reso, mult=mult)
        for x, y in zip(want, got):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_obj_scene_equals_jax(tmp_path):
    """Polygons fanned, negative indices, corners without a uv, faces
    before any `usemtl` (a default material), a PNG map read as RGBA."""
    Image.fromarray(np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
                    ).save(tmp_path / "t.png")
    (tmp_path / "m.mtl").write_text(
        "newmtl a\nKd 0.1 0.2 0.3\nKs 0.9 0.8 0.7\nNs 5\nmap_Kd t.png\n"
        "newmtl b\nKa 0.3 0.3 0.3\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nv 1 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1 2 3\n"
        "usemtl a\nf 1/1 2/2 3/3 4/4\nf -1/-1 -2/-2 -3/-3\n"
        "usemtl b\nf 5/1 6 -4/2 1/3 2/4\nusemtl a\nf 2//1 3//2 6//3\n")
    want = jmp.load_obj_scene(str(tmp_path / "m.obj"))
    got = tmp.load_obj_scene(str(tmp_path / "m.obj"))
    _same({k: want[k] for k in ("verts", "faces", "face_uvs", "face_mat")},
          {k: got[k] for k in ("verts", "faces", "face_uvs", "face_mat")})
    assert [m.name for m in want["materials"]] == \
        [m.name for m in got["materials"]] == ["a", "b", "default"]
    for wm, gm in zip(want["materials"], got["materials"]):
        _same({k: getattr(wm, k) for k in ("Ka", "Kd", "Ks", "Ns")},
              {k: getattr(gm, k) for k in ("Ka", "Kd", "Ks", "Ns")})
        assert (wm.image is None) == (gm.image is None)
        if wm.image is not None:
            assert gm.image.dtype == np.float32
            np.testing.assert_array_equal(wm.image, gm.image)


def _meshes():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5],
                  [0, 5, 4], [2, 3, 7], [2, 7, 6], [0, 4, 7], [0, 7, 3],
                  [1, 2, 6], [1, 6, 5]], np.int32)
    n = 24
    xs = np.linspace(0, 1, n)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    sdf = (np.linalg.norm(g - 0.5, axis=-1) - 0.3).astype(np.float32)
    sv, sf = jnat.marching_cubes(sdf, 0.0)
    return {"cube": (v, f), "sphere": (sv / (n - 1), sf)}


@pytest.mark.parametrize("shape", ["cube", "sphere"])
def test_bvh_queries_equal_jax(shape, flavour):
    v, f = _meshes()[shape]
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.3, 1.3, size=(20000, 3)).astype(np.float32)
    jb = jnat.MeshBVH(v, f)
    tb = tnat.MeshBVH(v, f)
    for q in ("closest", "signed_distance"):
        for x, y in zip(getattr(jb, q)(pts), getattr(tb, q)(pts)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=q)
    np.testing.assert_array_equal(jb.winding(pts), tb.winding(pts))
    # the reference's analytic check on the cube: inside negative
    if shape == "cube":
        sdf, _, _ = tb.signed_distance([[0.5, 0.5, 0.5], [-0.3, 0.5, 0.5]])
        np.testing.assert_allclose(sdf, [-0.5, 0.3], atol=1e-5)


def test_watertight_remesh_equals_jax(flavour):
    v, f = _meshes()["sphere"]
    for x, y in zip(jmp.make_mesh_watertight(v, f, resolution=30000),
                    tmp.make_mesh_watertight(v, f, resolution=30000)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jmp.estimate_vertex_normals(v, f),
                                  tmp.estimate_vertex_normals(v, f))


@pytest.mark.parametrize("watertight", [True, False])
@pytest.mark.parametrize("shape", ["cube", "sphere"])
def test_mesh_sampler_npz_equals_jax(tmp_path, shape, watertight):
    """Each package samples its own copy of the OBJ (the remesh is cached
    beside it); reso 24/32, 20,000 surface points."""
    out = {}
    for name, mod in (("jax", jms), ("port", tms)):
        d = str(tmp_path / name)
        if shape == "cube":
            os.makedirs(d)
            obj = os.path.join(d, "model.obj")
            write_cube_obj(obj)
        else:
            obj = write_textured_sphere(d)
        mod.run(obj, os.path.join(d, "shape.npz"),
                reso=24 if shape == "cube" else 32, n_surf=20000,
                watertight=watertight)
        out[name] = _npz(os.path.join(d, "shape.npz"))
        if not watertight:
            assert os.path.exists(obj.replace(".obj",
                                              "_watertight_r100000.obj"))
    _same(out["jax"], out["port"])
    data = out["port"]
    assert data["tex_on_surf"].shape == (20000, 3)
    if shape == "sphere":
        # both materials reached: Kd-only points exactly Kd
        kd = np.all(data["tex_on_surf"] == [0.2, 0.6, 0.3], axis=1)
        assert 0.2 < kd.mean() < 0.8


def test_mesh_sampler_reads_the_cached_remesh(tmp_path):
    """The port writes the remesh beside the OBJ; then JAX's run and the
    port's CLI both read it (rounded to 6 decimals by the OBJ text), and
    give the same file."""
    obj = write_textured_sphere(str(tmp_path))
    tms.run(obj, str(tmp_path / "a.npz"), reso=24, n_surf=2000)
    jms.run(obj, str(tmp_path / "b.npz"), reso=24, n_surf=2000)
    tms.main(["-s", obj, "-d", str(tmp_path / "c.npz"), "--reso", "24",
              "--n_surf", "2000"])
    _same(_npz(tmp_path / "b.npz"), _npz(tmp_path / "c.npz"))


def _write_pbr_cube(dirpath: str, maps: str):
    tex = os.path.join(dirpath, "textures")
    os.makedirs(tex)
    rng = np.random.default_rng(0)
    Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(
        os.path.join(tex, "albedo.png"))
    if maps == "separate":
        Image.fromarray((rng.random((32, 32)) * 255).astype(np.uint8)).save(
            os.path.join(tex, "metallic.png"))
        Image.fromarray(np.full((32, 32), 64, np.uint8)).save(
            os.path.join(tex, "roughness.png"))
        normal = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
        Image.fromarray(normal).save(os.path.join(tex, "normal.png"))
    obj = os.path.join(dirpath, "model.obj")
    write_cube_obj(obj)
    return obj


@pytest.mark.parametrize("maps", ["separate", "albedo only"])
def test_pbr_sampler_npz_equals_jax(tmp_path, maps):
    out = {}
    for name, mod in (("jax", jpbr), ("port", tpbr)):
        d = str(tmp_path / name)
        os.makedirs(d)
        obj = _write_pbr_cube(d, maps)
        mod.run(obj, os.path.join(d, "pbr.npz"), reso=24, n_surf=5000,
                watertight=True)
        out[name] = _npz(os.path.join(d, "pbr.npz"))
    _same(out["jax"], out["port"])
    assert out["port"]["tex_grid"].shape[-1] == 8
    assert out["port"]["tex_on_surf"].shape == (5000, 8)
