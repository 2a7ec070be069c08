"""The slice as a whole: the port's `cli.sample` on the committed
towerruins tag, on the CPU at a small size, to voxel grids (`--vox`) and
to textured meshes, against the JAX package; and the port's guards (no
JAX import, the card by default, no fallback)."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core import checkpoint as jckpt
from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.core.triplane import load_triplane_npz as jload
from sin3dm_tpu.diffusion.gaussian import DiffusionConfig
from sin3dm_tpu.diffusion.sampling import ddim_sample_loop
from sin3dm_tpu.diffusion.schedule import make_schedule
from sin3dm_tpu.models import autoencoder as jae
from sin3dm_tpu.models.unet import UNetConfig, init_unet, unet_apply
from sin3dm_tpu.training.ae import AETrainer, AETrainerConfig
from sin3dm_tpu_torch.cli import sample as cli
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.core.triplane import save_triplane_npz

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TAG = os.path.join(ROOT, "checkpoints", "towerruins")
SMALL = ["--resize", "0.125", "0.125", "0.125", "--use_ddim", "true",
         "--timestep_respacing", "ddim4", "--reso", "32"]


def _argv(out, *extra):
    return ["--tag", TAG, "--vox", "--device", "cpu", "--output", str(out),
            *SMALL, *extra]


def test_cli_vox_cpu_writes_feats_and_voxels(tmp_path):
    res = cli.main(_argv(tmp_path, "--n_samples", "2"))
    assert len(res["paths"]) == 2
    for j in range(2):
        d = tmp_path / f"{j:03d}"
        with np.load(d / "feat.npz") as f:
            shapes = {k: f[k].shape for k in f.files}
            assert all(np.isfinite(f[k]).all() for k in f.files)
        assert shapes == {"feat_xy": (12, 11, 16), "feat_xz": (12, 11, 11),
                          "feat_yz": (12, 16, 11)}
        with np.load(d / "r32_voxel.npz") as v:
            grid = v["vox_grid"]
        assert grid.dtype == bool and grid.shape == (22, 32, 22)
        assert 0.0 < grid.mean() < 0.5


def test_feats_match_jax_ddim_loop(monkeypatch):
    """Injected initial noise, fp32 (SIN3DM_SAMPLE_DTYPE=train): the
    port's sampler == JAX's ddim_sample_loop on the same weights, within
    1e-4 of the feature scale (4 full-width UNet calls)."""
    monkeypatch.setenv("SIN3DM_SAMPLE_DTYPE", "train")
    args = cli.cfgmod.sample_args(_argv("unused"))
    sampler, C, sizes, device = cli._build_sampler(args)
    assert device.type == "cpu" and sizes == (11, 16, 11) and C == 12
    H, W, D = sizes
    rng = np.random.default_rng(0)
    noise = [rng.standard_normal(s).astype(np.float32)
             for s in ((2, H, W, C), (2, H, D, C), (2, W, D, C))]
    got = sampler(0, 0, 2, C, sizes, noise=TT(*map(torch.from_numpy, noise)))

    cfg = UNetConfig()
    params, _ = jckpt.load_pytree(
        os.path.join(TAG, "diffusion", "ema_0.9999_025000.pt"),
        init_unet(jax.random.PRNGKey(0), cfg))
    tables = {k: jnp.asarray(v) for k, v in
              make_schedule("linear", 1000, "ddim4").tables_f32().items()}

    @jax.jit
    def run(p, x0):
        return ddim_sample_loop(lambda x, t: unet_apply(p, cfg, x, t),
                                tables, DiffusionConfig(),
                                jax.random.PRNGKey(0), 2, C, sizes,
                                noise=x0, eta=0.0)

    want = run(params, JT(*map(jnp.asarray, noise)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_voxels_match_jax_decode_voxel(tmp_path, monkeypatch):
    """From the feat.npz the port's CLI wrote, the port's voxel grid ==
    JAX's `AETrainer.decode_voxel`, except voxels with |sdf| < 1e-5
    (fp32 heads, SIN3DM_DECODE_BF16=0)."""
    monkeypatch.setenv("SIN3DM_DECODE_BF16", "0")
    cli.main(_argv(tmp_path / "port", "--n_samples", "1"))
    feat_path = tmp_path / "port" / "000" / "feat.npz"
    with np.load(tmp_path / "port" / "000" / "r32_voxel.npz") as v:
        got = v["vox_grid"]

    trainer = AETrainer(os.path.join(TAG, "encoding"), jae.AEConfig(),
                        AETrainerConfig())
    trainer.load_ckpt("final")
    feat = jload(str(feat_path))
    trainer.decode_voxel(str(tmp_path / "jax"), feat, 32)
    with np.load(tmp_path / "jax" / "r32_voxel.npz") as v:
        want = v["vox_grid"]
    H, W = feat.xy.shape[0], feat.xy.shape[1]
    aabb = trainer._resize_aabb((H, W, feat.xz.shape[1]))
    sdf = trainer.decode_grid(feat, 32, aabb=aabb)[..., 0]
    assert got.shape == want.shape == sdf.shape
    settled = np.abs(sdf) >= 1e-5
    assert settled.mean() > 0.99
    np.testing.assert_array_equal(got[settled], want[settled])


# the modules of the stats-chain, fused-act, --inpaint, mesh, training,
# data-preparation and evaluation paths, named so that the walk cannot
# miss them; none may bring in jax, the JAX package, cv2 or PIL
CHANGED = {"sin3dm_tpu_torch.core.nn", "sin3dm_tpu_torch.ops.fused_conv",
           "sin3dm_tpu_torch.models.unet",
           "sin3dm_tpu_torch.diffusion.gaussian",
           "sin3dm_tpu_torch.diffusion.sampling",
           "sin3dm_tpu_torch.cli.sample", "sin3dm_tpu_torch.core.gridsample",
           "sin3dm_tpu_torch.models.autoencoder",
           "sin3dm_tpu_torch.ops.sparse_grid",
           "sin3dm_tpu_torch.geometry.native",
           "sin3dm_tpu_torch.geometry.meshproc",
           "sin3dm_tpu_torch.geometry.uvatlas",
           "sin3dm_tpu_torch.geometry.meshio",
           "sin3dm_tpu_torch.training.ae", "sin3dm_tpu_torch.core.config",
           # the training path
           "sin3dm_tpu_torch.cli.train", "sin3dm_tpu_torch.core.logger",
           "sin3dm_tpu_torch.core.profiling", "sin3dm_tpu_torch.core.rng",
           "sin3dm_tpu_torch.diffusion.resample",
           "sin3dm_tpu_torch.training.diffusion",
           "sin3dm_tpu_torch.training.adamw",
           # data preparation and evaluation
           "sin3dm_tpu_torch.dataio.grid",
           "sin3dm_tpu_torch.dataio.mesh_sampler",
           "sin3dm_tpu_torch.dataio.mesh_sampler_pbr",
           "sin3dm_tpu_torch.rendering.softraster",
           "sin3dm_tpu_torch.evaluation.patch_metrics",
           "sin3dm_tpu_torch.evaluation.ssfid",
           "sin3dm_tpu_torch.evaluation.sifid",
           "sin3dm_tpu_torch.evaluation.lpips",
           "sin3dm_tpu_torch.evaluation.eval_full"}


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sin3dm_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "assert len(names) >= 20, names\n"
        f"assert not set({sorted(CHANGED)}) - set(names), names\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'sin3dm_tpu', 'cv2', 'PIL')]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """`chip_smoke.py` exits non-zero and prints no result without a card,
    from the repo and from a directory that holds nothing else."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py runs there")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for script in (os.path.join(ROOT, "chip_smoke.py"), str(alone)):
        out = subprocess.run([sys.executable, script],
                             cwd=os.path.dirname(script),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    argv = ["--tag", TAG, "--vox", "--output", str(tmp_path), *SMALL]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("extra,match", [
    (["--sample_devices", "2"], "data-parallel"),
])
def test_options_of_later_slices_raise(tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(_argv(tmp_path, *extra))


def test_cli_inpaint_cpu_keeps_y0_outside_the_region(tmp_path,
                                                     monkeypatch):
    """`--inpaint` under the stats chain at a small size: a known triplane
    of the target size (y0, `--inpaint_feat`) is kept outside the box
    that regenerates the first half of x, as `tests/test_e2e.py` checks
    the JAX CLI: with `--is_mask_t0` the kept rows of xy and xz equal y0,
    yz (whose cells all support kept points) equals it everywhere, and
    the regenerated half moved."""
    monkeypatch.setenv("SIN3DM_STATS_CHAIN", "1")
    H, W, D = 11, 16, 11
    rng = np.random.default_rng(0)
    y0 = TT(*[torch.from_numpy((0.5 * rng.standard_normal(s)).astype(
        np.float32)) for s in ((H, W, 12), (H, D, 12), (W, D, 12))])
    y0_path = str(tmp_path / "y0" / "feat.npz")
    save_triplane_npz(y0_path, y0)
    res = cli.main(_argv(tmp_path / "out", "--n_samples", "2",
                         "--inpaint", "true", "--inpaint_feat", y0_path,
                         "--inpaint_region", "0", "0.5", "0", "1", "0", "1",
                         "--is_mask_t0", "true"))
    want = np.load(y0_path)
    h2 = round(0.5 * H)     # region_keep_masks' rule: rows [0, 6) go
    for path in res["paths"]:
        got = np.load(path)
        np.testing.assert_allclose(got["feat_xy"][:, h2:],
                                   want["feat_xy"][:, h2:], atol=1e-5)
        np.testing.assert_allclose(got["feat_xz"][:, h2:],
                                   want["feat_xz"][:, h2:], atol=1e-5)
        np.testing.assert_allclose(got["feat_yz"], want["feat_yz"],
                                   atol=1e-5)
        assert np.abs(got["feat_xy"][:, :h2]
                      - want["feat_xy"][:, :h2]).max() > 1e-3
        assert os.path.exists(os.path.join(os.path.dirname(path),
                                           "r32_voxel.npz"))


MESH = ["--texreso", "128", "--n_faces", "500"]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The CLI's mesh path (no --vox) for 2 samples, with --pipeline_chunk
    2 and 1, fp32 UNet and decode heads: {chunk: (output dir, main's
    result)}."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SIN3DM_DECODE_BF16", "0")
    mp.setenv("SIN3DM_SAMPLE_DTYPE", "train")
    runs = {}
    try:
        for chunk in (2, 1):
            out = tmp_path_factory.mktemp(f"mesh_chunk{chunk}")
            argv = [a for a in _argv(out, *MESH, "--n_samples", "2",
                                     "--pipeline_chunk", str(chunk))
                    if a != "--vox"]
            runs[chunk] = (out, cli.main(argv))
    finally:
        mp.undo()
    return runs


def _faces(path):
    with open(path) as fh:
        return sum(1 for ln in fh if ln.startswith("f "))


def test_mesh_path_is_a_later_slice(mesh_runs):
    """The mesh path, once a later slice, runs: per sample feat.npz,
    voxel.npz and a textured object.obj/.mtl/.png, and a stage log that
    covers the chain, the grid, the geometry, the texels and the
    export."""
    from PIL import Image
    out, res = mesh_runs[2]
    assert len(res["paths"]) == 2
    for j in range(2):
        d = out / f"{j:03d}"
        for name in ("feat.npz", "voxel.npz", "object.obj", "object.mtl",
                     "object.png"):
            assert (d / name).exists(), name
        with np.load(d / "voxel.npz") as v:
            grid = v["vox_grid"]
        assert grid.dtype == bool and grid.shape == (22, 32, 22)
        assert 0.0 < grid.mean() < 0.5
        assert 0 < _faces(d / "object.obj") <= 500
        assert "map_Kd object.png" in (d / "object.mtl").read_text()
        img = np.asarray(Image.open(d / "object.png"))
        assert img.shape == (128, 128, 3) and img.dtype == np.uint8
        stages = {e["stage"] for e in res["stages"] if e["dir"] == str(d)}
        assert {"chain", "sdf grid", "voxel.npz", "marching cubes",
                "decimation", "uv atlas + raster", "texel dispatch",
                "texel decode", "texture assembly", "export"} <= stages


def test_mesh_path_chunks_and_jax_face_count(mesh_runs):
    """--pipeline_chunk 1 and 2 draw the same samples: sample j's noise
    depends only on (seed, j).  The UNet's CPU kernels sum in another
    order at batch 1 than at batch 2 (3e-6 apart in fp32, 4e-2 in bf16),
    so the feats agree to 1e-4 of their scale, not bit for bit.  JAX's
    decode_texmesh on the port's feat.npz gives the port's face count."""
    for j in range(2):
        with np.load(mesh_runs[1][0] / f"{j:03d}" / "feat.npz") as a, \
                np.load(mesh_runs[2][0] / f"{j:03d}" / "feat.npz") as b:
            for k in a.files:
                scale = np.abs(b[k]).max()
                assert np.abs(a[k] - b[k]).max() <= 1e-4 * scale
    out = mesh_runs[2][0]
    trainer = AETrainer(os.path.join(TAG, "encoding"), jae.AEConfig(),
                        AETrainerConfig())
    trainer.load_ckpt("final")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SIN3DM_DECODE_BF16", "0")
        trainer.decode_texmesh(str(out / "jax"),
                               jload(str(out / "000" / "feat.npz")), 32,
                               n_faces=500, texture_reso=128)
    assert _faces(out / "jax" / "object.obj") == \
        _faces(out / "000" / "object.obj")


def test_mesh_decode_threads_write_what_generate_wrote(mesh_runs, tmp_path,
                                                       monkeypatch):
    """The standalone mesh decode (`cli.decode` without --vox: one thread
    per sample, device dispatch under the trainer's lock, one export
    worker) on generate's feat.npz files writes the same object files."""
    monkeypatch.setenv("SIN3DM_DECODE_BF16", "0")
    out = mesh_runs[2][0]
    paths = []
    for j in range(2):
        d = tmp_path / f"{j:03d}"
        d.mkdir()
        shutil.copy(out / f"{j:03d}" / "feat.npz", d / "feat.npz")
        paths.append(str(d / "feat.npz"))
    argv = [a for a in _argv(tmp_path, *MESH) if a != "--vox"]
    cli.decode(cli.cfgmod.sample_args(argv), paths)
    for j in range(2):
        for name in ("object.obj", "object.mtl", "object.png"):
            assert (tmp_path / f"{j:03d}" / name).read_bytes() == \
                (out / f"{j:03d}" / name).read_bytes(), name
        with np.load(tmp_path / f"{j:03d}" / "voxel.npz") as a, \
                np.load(out / f"{j:03d}" / "voxel.npz") as b:
            np.testing.assert_array_equal(a["vox_grid"], b["vox_grid"])
