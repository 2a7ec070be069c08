"""The port against the benchmark's plain references on the CPU, with
seeded random weights at small sizes: the PBR net's decode (`pbr`
over `sdfpbr`: the plane blocks, the heads at points, the uint8 maps)
against `perfbench/reference/pbr.py`, the files a tiny PBR
`decode_texmesh` writes read back through that reference's reader, the
ancestral chain (`diffusion/sampling.py:p_sample_loop`) against
`perfbench/reference/ddpm.py` with the same (seed, j) draws, and the
export tail's `export.*` spans.  The references import nothing of the
program; parameters reach them through the checkpoint container, as
the benchmark's do."""

import os
import threading

import numpy as np
import pytest
import torch

from perfbench.reference import autoencoder as RA
from perfbench.reference import ddpm as RP
from perfbench.reference import mesh as RM
from perfbench.reference import pbr as RPBR
from perfbench.reference import tree as RT
from sin3dm_tpu_torch.core import checkpoint as ckpt
from sin3dm_tpu_torch.core import profiling
from sin3dm_tpu_torch.core.triplane import Triplane
from sin3dm_tpu_torch.diffusion import gaussian as tg
from sin3dm_tpu_torch.diffusion import sampling as ts
from sin3dm_tpu_torch.diffusion import schedule as tsched
from sin3dm_tpu_torch.models import autoencoder as ae
from sin3dm_tpu_torch.models.unet import UNetConfig, init_unet, unet_apply
from sin3dm_tpu_torch.training.ae import AETrainer

torch.set_num_threads(2)
CFG = ae.AEConfig(data_type="sdfpbr", enc_net_type="pbr", fdim_geo=4,
                  fdim_tex=8, fdim_up=16, hidden_dim=32, n_hidden_layers=2)
SIZES = (12, 16, 12)
AABB = np.array([-0.75, -1.0, -0.75, 0.75, 1.0, 0.75])


def reference_flat(tmp_path, tree, name="params.pth"):
    """`tree` through the container, as the reference reads it."""
    path = os.path.join(str(tmp_path), name)
    ckpt.save_tree(path, {"params": tree})
    flat, _ = RT.load_container(path, "params")
    return RT.to_device(flat, "cpu")


def smooth_planes(seed: int, sizes=SIZES, C: int = 12) -> Triplane:
    """`[1, ., ., C]` planes of smooth seeded noise in about [-1, 1]."""
    g = torch.Generator().manual_seed(seed)
    H, W, D = sizes
    out = []
    for a, b in ((H, W), (H, D), (W, D)):
        x = torch.randn(1, C, a // 2 + 1, b // 2 + 1, generator=g)
        x = torch.nn.functional.interpolate(x, size=(a, b), mode="bilinear",
                                            align_corners=True)
        out.append(torch.tanh(x).permute(0, 2, 3, 1).contiguous())
    return Triplane(*out)


def pbr_params(seed: int = 0):
    """Seeded PBR weights whose texture heads give values inside (0, 1)
    (their last biases at 0.5, the last weights scaled down) and whose
    geometry head gives `feature 0 + bias`, an sdf with a level set in
    smooth planes (`set_surface`)."""
    p = ae.init_autoencoder(torch.Generator().manual_seed(seed), CFG)
    for k, _ in RPBR.HEADS:
        last = p[k]["second"][-1]
        last["w"] = last["w"] * 0.1
        last["b"] = torch.full_like(last["b"], 0.5)
    geo = p["geo_decoder"]
    for lp in geo["first"]:
        lp["w"] = torch.zeros_like(lp["w"])
    mid, last = geo["second"][0], geo["second"][-1]
    mid["w"] = torch.zeros_like(mid["w"])
    mid["w"][0, 0] = 1.0                    # hidden 0 = x_0 + 10
    mid["b"] = torch.zeros_like(mid["b"])
    mid["b"][0] = 10.0
    last["w"] = torch.zeros_like(last["w"])
    last["w"][0, 0] = 1.0
    last["b"] = torch.full_like(last["b"], -10.0)
    return p


def set_surface(p, planes: Triplane) -> float:
    """Shift the geometry head's bias so that half of the grid is inside;
    returns the shift."""
    geo, tex = ae.process_planes(p, CFG, planes)
    res = tuple(int(r) for r in RA.grid_resolutions(AABB, 32))
    sdf = ae.decode_grid_dense(p, CFG, geo, tex, res, geo_only=True)
    shift = float(sdf.median())
    p["geo_decoder"]["second"][-1]["b"] -= shift
    return shift


@pytest.fixture(autouse=True)
def fp32_heads(monkeypatch):
    """The program's heads in fp32 (K2's plain version on the CPU), so
    that both sides compute in one precision."""
    monkeypatch.setenv("SIN3DM_DECODE_BF16", "0")


def test_pbr_decode_points_and_texel_maps(tmp_path):
    """process_planes + decode_points, and the uint8 maps, against the
    reference at points in the box.  Heads: both fp32 over the same
    weights, summed in another order, so 1e-5 on values of order 1.
    Maps: truncation turns such a difference into one level where a
    value sits on a level's edge, so at most 1 level apart, and on at
    most 0.2 % of the values."""
    p = pbr_params()
    planes = smooth_planes(1)
    P = reference_flat(tmp_path, p)
    geo, tex = ae.process_planes(p, CFG, planes)
    ref_planes = tuple(x.permute(0, 3, 1, 2) for x in planes)
    rgeo, rtex = RA.process_planes(P, ref_planes, CFG.fdim_geo, True)
    for a, b in zip(tex, rtex):
        torch.testing.assert_close(a.permute(0, 3, 1, 2), b, atol=1e-5,
                                   rtol=1e-5)
    g = torch.Generator().manual_seed(2)
    lo, hi = torch.tensor(AABB[:3]), torch.tensor(AABB[3:])
    pts = (lo + (hi - lo) * torch.rand(4096, 3, generator=g,
                                       dtype=torch.float64)).float()
    aabb = torch.tensor(AABB, dtype=torch.float32)
    out = ae.decode_points(p, CFG, geo, tex, pts, aabb)
    x = RA.normalize(pts, aabb)
    want_sdf = RA.skip_head(P, "geo_decoder", RA.sample_planes(rgeo, x))
    want_tex = RPBR.tex_heads(P, RA.sample_planes(rtex, x))
    torch.testing.assert_close(out[:, :1], want_sdf, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out[:, 1:], want_tex, atol=1e-5, rtol=1e-5)
    assert float(want_tex.std(dim=0).min()) > 5e-3   # they vary
    got = ae.decode_texels(p, CFG, tex, pts, aabb).numpy().astype(int)
    want = RPBR.texel_maps(P, rtex, pts, aabb).numpy().astype(int)
    assert got.shape == want.shape == (4096, 8)
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() <= 2e-3
    inside = ((want > 0) & (want < 255)).mean()
    assert inside > 0.9   # the heads' values, not the clamp, are compared


def _trainer(tmp_path, p, planes):
    tr = AETrainer(os.path.join(str(tmp_path), "enc"), CFG, "cpu")
    tr.set_params(p)
    tr.meta = {"aabb": AABB.tolist(), "threshold": 0.1,
               "featmap_size": list(SIZES)}
    return tr


def test_pbr_decode_texmesh_files_read_by_the_reference(tmp_path):
    """A tiny PBR decode_texmesh writes the OBJ, the MTL naming the four
    maps and each map's PNG of its channels; the reference reader finds
    no fault, and the texels strictly inside one face read, in each
    map, the reference's values at the face's points within one level
    (the texel's point goes through the 16-bit run wire and the OBJ's
    six decimals, the reference's through the barycentric point), on at
    most 0.5 % of the values.  A texel strictly inside two faces' UV
    triangles (the atlas lets a few overlap) holds the point of the one
    rasterized last, and is left out."""
    p = pbr_params()
    planes = smooth_planes(3)
    set_surface(p, planes)
    tr = _trainer(tmp_path, p, planes)
    d = os.path.join(str(tmp_path), "000")
    tr.decode_texmesh(d, planes, 32, n_faces=400, texture_reso=128)
    faults, m = RPBR.read_pbr(d, AABB, 32, 400, 128)
    assert faults == []
    assert {k: v.shape for k, v in m["maps"].items()} == {
        "albedo": (128, 128, 3), "metallic": (128, 128, 1),
        "roughness": (128, 128, 1), "normal": (128, 128, 3)}
    P = reference_flat(tmp_path, p)
    _, rtex = RA.process_planes(
        P, tuple(x.permute(0, 3, 1, 2) for x in planes), CFG.fdim_geo, True)
    r, c, pts = RM.interior_texels(m["vt"], m["v"], m["f"], m["ft"],
                                   np.arange(len(m["f"])), 128)
    _, where, count = np.unique(r * 128 + c, return_inverse=True,
                                return_counts=True)
    one = count[where] == 1
    assert one.sum() > 500 and one.mean() > 0.98
    r, c, pts = r[one], c[one], pts[one]
    want = RPBR.texel_maps(P, rtex, torch.as_tensor(pts, dtype=torch.float32),
                           torch.tensor(AABB, dtype=torch.float32)).numpy()
    got = np.concatenate([m["maps"][n][127 - r, c] for n in RPBR.MAPS], -1)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3


def test_export_spans_one_set_a_sample_on_the_worker(tmp_path):
    """Each sample's export tail records `export.texel decode`,
    `export.texture assembly` and `export.export`, with one
    `export.png` a map inside the last, all on the export worker's
    thread."""
    p = pbr_params()
    planes = [smooth_planes(s) for s in (3, 4)]
    for q in planes[:1]:
        set_surface(p, q)
    tr = _trainer(tmp_path, p, planes[0])
    dirs = [os.path.join(str(tmp_path), f"{j:03d}") for j in range(2)]
    profiling.collect()
    profiling.record(True)
    try:
        tr.decode_texmesh_many(dirs, planes, 32, n_faces=400,
                               texture_reso=128)
    finally:
        profiling.record(False)
    spans = [s for s in profiling.collect() if s.name.startswith("export.")]
    main = threading.get_ident()
    assert spans and all(s.thread != main for s in spans)
    stages = [s for s in spans if s.name != "export.png"]
    assert sorted((s.attrs["dir"], s.name) for s in stages) == sorted(
        (d, "export." + k) for d in dirs
        for k in ("texel decode", "texture assembly", "export"))
    for d in dirs:
        export = [s for s in stages if s.name == "export.export"
                  and s.attrs["dir"] == d][0]
        pngs = [s for s in spans if s.name == "export.png"
                and export.start_ns <= s.start_ns <= s.end_ns
                <= export.end_ns]
        assert [s.attrs["map"] for s in pngs] == list(RPBR.MAPS)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_p_sample_loop_against_the_reference_chain(tmp_path, seed):
    """The ancestral chain (x_0 predicted and clipped, fixed-large
    variance) of a tiny UNet with random weights over a 25-step linear
    schedule, two samples from their (seed, j) generators, against the
    reference with the same draws.  Both fp32: the sums' order differs,
    and the chain carries that, 1e-4 of the planes' l1."""
    ucfg = UNetConfig(in_channels=6, model_channels=32, out_channels=6,
                      channel_mult=(1, 2))
    g = torch.Generator().manual_seed(7)
    params = init_unet(g, ucfg)

    def perturb(node):
        if isinstance(node, dict):
            return {k: perturb(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [perturb(v) for v in node]
        return node + 0.05 * torch.randn(node.shape, generator=g)
    params = perturb(params)
    P = reference_flat(tmp_path, params, "unet.pth")
    steps, sizes, C = 25, (8, 12, 8), 6
    tables = tg.tables_to_device(
        tsched.make_schedule("linear", steps, "").tables_f32(), "cpu")
    gens = ts.sample_generators(seed, 0, 2, "cpu")
    got = ts.p_sample_loop(lambda x, t: unet_apply(params, ucfg, x, t),
                           tables, tg.DiffusionConfig(), gens, 2, C, sizes,
                           device="cpu")
    want = RP.ddpm_chain(P, seed, [0, 1], sizes, C, steps, "cpu")
    for a, b in zip(got, want):
        a = a.permute(0, 3, 1, 2)
        assert float((a - b).abs().sum() / b.abs().sum()) < 1e-4
    # the draws matter: another seed's chain is far from this one
    other = RP.ddpm_chain(P, seed + 1, [0, 1], sizes, C, steps, "cpu")
    assert float((other[0] - want[0]).abs().sum()
                 / want[0].abs().sum()) > 0.1
