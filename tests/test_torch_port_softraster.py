"""The port's software renderer against the JAX package's: `render_view`
bit for bit with a texture and with Kd only, the library's raster
against the port's numpy plain version, the 8 views of
`render_multiview` and the CLI, and no fallback when the library cannot
be built."""

import os

import numpy as np
import pytest
from PIL import Image

from sin3dm_tpu.geometry import meshproc as jmp
from sin3dm_tpu.rendering import softraster as jsr
from sin3dm_tpu_torch.geometry import meshproc as tmp
from sin3dm_tpu_torch.geometry import native as tnat
from sin3dm_tpu_torch.rendering import softraster as tsr

from test_torch_port_mesh_sampler import write_textured_sphere


def _scene(mp, tmp_path):
    obj = write_textured_sphere(str(tmp_path))
    s = mp.load_obj_scene(obj)
    s["verts"] = tsr._normalize_mesh(s["verts"])
    return s


@pytest.mark.parametrize("textured", [True, False])
def test_render_view_equals_jax(tmp_path, textured):
    js, ts = _scene(jmp, tmp_path), _scene(tmp, tmp_path)
    if not textured:
        for m in js["materials"] + ts["materials"]:
            m.image = None
    for eye in tsr.camera_eyes()[::3]:
        want = jsr.render_view(js["verts"], js["faces"], js["face_uvs"],
                               js["face_mat"], js["materials"], eye, res=64)
        got = tsr.render_view(ts["verts"], ts["faces"], ts["face_uvs"],
                              ts["face_mat"], ts["materials"], eye, res=64)
        assert got.dtype == np.uint8 and got.shape == (64, 64, 4)
        np.testing.assert_array_equal(got, want)
        assert 0.1 < (got[..., 3] > 0).mean() < 0.9


def test_native_raster_equals_the_numpy_plain_version():
    """`tests/test_infra.py`'s random soup: the library's maps and the
    port's numpy raster give the same image."""
    class _Mat:
        def __init__(self, image, Kd):
            self.image = image
            self.Kd = Kd

    rng = np.random.default_rng(3)
    mats = [_Mat(rng.random(size=(64, 64, 3)), np.array([1.0, 0, 0])),
            _Mat(None, np.array([0.2, 0.5, 0.9]))]
    verts = tsr._normalize_mesh(rng.normal(size=(300, 3)))
    faces = rng.integers(0, 300, size=(500, 3)).astype(np.int64)
    face_uvs = rng.random(size=(500, 3, 2))
    face_mat = rng.integers(0, 2, size=500).astype(np.int64)
    eye = np.array([2.0, 1.0, 1.5])
    args = (verts, faces, face_uvs, face_mat, mats, eye)
    a = tsr.render_view(*args, res=160, use_native=True)
    b = tsr.render_view(*args, res=160, use_native=False)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        a, jsr.render_view(*args, res=160, use_native=False))


def test_multiview_and_cli_equal_jax(tmp_path):
    obj = write_textured_sphere(str(tmp_path / "gen" / "000"))
    jsr.render_multiview(obj, str(tmp_path / "jax"), res=64)
    tsr.render_multiview(obj, str(tmp_path / "port"), res=64)
    names = [f"{i:03d}.png" for i in range(8)]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        want = np.asarray(Image.open(tmp_path / "jax" / n))
        got = np.asarray(Image.open(tmp_path / "port" / n))
        np.testing.assert_array_equal(got, want)
    # the CLI: every **/object.obj of the results dir, at res 512
    os.replace(obj, str(tmp_path / "gen" / "000" / "object.obj"))
    paths = tsr.main(["-s", str(tmp_path / "gen")])
    assert len(paths) == 1
    out = tmp_path / "gen" / "000" / "renderings"
    assert sorted(os.listdir(out)) == names
    img = np.asarray(Image.open(out / "000.png"))
    assert img.shape == (512, 512, 4) and 0.05 < (img[..., 3] > 0).mean()
    with pytest.raises(SystemExit):
        tsr.main(["-s", str(tmp_path / "port")])


def test_a_library_that_cannot_build_raises(tmp_path, monkeypatch):
    """No silent fallback to the numpy raster."""
    def broken():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(tnat, "_lib", None)
    monkeypatch.setattr(tnat, "build", broken)
    s = _scene(tmp, tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tsr.render_view(s["verts"], s["faces"], s["face_uvs"],
                        s["face_mat"], s["materials"],
                        tsr.camera_eyes()[0], res=32)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tsr.render_view(s["verts"], s["faces"], s["face_uvs"],
                        s["face_mat"], s["materials"],
                        tsr.camera_eyes()[0], res=32)
