"""The PBR cell's and the DDPM cell's drivers (`drivers/generate_pbr.py`,
`drivers/generate_ddpm.py`) at test sizes on the CPU, as cells added to
a checkout by files and entries alone: the program passes its limits,
the control fails one of them, and a run whose written answer is
altered comes out not correct (a map's texels, the DDPM chain's
planes), while in a window of three DDPM samples the median sample
decides.  The limits of these test cells are set from these readings;
the benchmark cells' from the card's, in PERF.md."""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from perfbench import harness

from conftest import ROOT, make_root

SEED = 2 ** 31 + 77
TINY = {"warm_steps": 2, "pipeline_chunk": 1, "reso": 32, "texreso": 128,
        "n_faces": 500, "resize": [0.125, 0.125, 0.125],
        "nominal_s_per_sample": 1000, "trace_samples": 1,
        "texel_faces": 200, "control": "fp8"}
# test cell -> (configuration, mix name, mix, the benchmark cell whose
# metrics it reports)
CELLS = {
    "towerruins-pbr.gen-pbr-tiny": (
        "towerruins-pbr", "gen-pbr-tiny",
        dict(TINY, driver="generate_pbr", respacing="ddim4",
             limits={"chain_rel": 0.05, "occupancy_flips": 0.001,
                     "mesh_faults": 0, "texel_gap_albedo": 1.5,
                     "texel_gap_mr": 1.5, "texel_gap_normal": 1.5}),
        "towerruins-pbr.gen-ddim100"),
    "towerruins.gen-ddpm-tiny": (
        "towerruins", "gen-ddpm-tiny",
        dict(TINY, driver="generate_ddpm", respacing="ddpm1000",
             limits={"chain_rel": 0.05, "occupancy_flips": 0.001,
                     "mesh_faults": 0}),
        "towerruins.gen-ddpm1000"),
    # three samples a window (ceil(0.5 / 0.2)), one reference chain
    "towerruins.gen-ddpm3-tiny": (
        "towerruins", "gen-ddpm3-tiny",
        dict(TINY, driver="generate_ddpm", respacing="ddpm1000",
             nominal_s_per_sample=0.2, reference_batch=3,
             limits={"chain_rel": 0.05, "occupancy_flips": 0.001,
                     "mesh_faults": 0}),
        "towerruins.gen-ddpm1000"),
}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("perfbench-pbr-ddpm"))
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for cell, (conf, name, mix, like) in CELLS.items():
        with open(os.path.join(pb, "traffic", f"{name}.json"), "w") as fh:
            json.dump(mix, fh)
        spec["workloads"].append({"name": cell, "config": conf,
                                  "traffic": name, "chips": 1,
                                  "why": "a test size"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh, indent=1)
    return harness.Bench(root, pb)


def run(bench, cell):
    return harness.run(bench, cell, SEED, 0.5, False, "cpu",
                       time.perf_counter())


@pytest.mark.parametrize("name", ["towerruins-pbr.gen-pbr-tiny",
                                  "towerruins.gen-ddpm-tiny"])
def test_program_passes_and_control_fails(bench, name):
    cell = bench.cell(name)
    drv = cell.driver(cell, seed=SEED, device="cpu", root=bench.root)
    drv.setup()
    drv.plan(0.5, False)
    drv.window()
    checks = drv.check(cell.traffic["control"])
    print(name, drv.extra)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    ctl = drv.extra["control"]
    assert any(ctl[k] is not None and ctl[k] > c["limit"]
               for k, c in checks.items()), (ctl, checks)


@pytest.mark.parametrize("name", ["metallic", "albedo"])
def test_pbr_map_altered(bench, monkeypatch, name):
    """One map's texels shifted by a tenth of the range: its gap reads
    over its limit, and the others stay inside theirs."""
    from sin3dm_tpu_torch.geometry import meshio
    save = meshio.save_mesh_with_pbr
    which = ("albedo", "metallic", "roughness", "normal").index(name)

    def altered(path, v, uvs, f, ft, *maps, **kw):
        maps = list(maps)
        maps[which] = (maps[which].astype(int) + 25) % 256
        return save(path, v, uvs, f, ft,
                    *[m.astype("uint8") for m in maps], **kw)
    monkeypatch.setattr(meshio, "save_mesh_with_pbr", altered)
    r = run(bench, "towerruins-pbr.gen-pbr-tiny")
    assert r["correct"] is False
    gap = "texel_gap_mr" if name == "metallic" else "texel_gap_albedo"
    checks = r["checks"]
    assert checks[gap]["value"] > checks[gap]["limit"]
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k != gap)


def test_ddpm_answer_altered(bench, monkeypatch):
    from sin3dm_tpu_torch.diffusion import sampling
    loop = sampling.p_sample_loop

    def altered(*a, **k):
        x = loop(*a, **k)
        return x._replace(xy=-x.xy)
    monkeypatch.setattr(sampling, "p_sample_loop", altered)
    assert run(bench, "towerruins.gen-ddpm-tiny")["correct"] is False


@pytest.mark.parametrize("moved", [1, 2])
def test_ddpm_median_sample_decides(bench, monkeypatch, capsys, moved):
    """Three samples a window, the first `moved` of them written off
    their chain: one such sample shows in `chain_rel_max` and the median
    sample keeps the run correct; with two the median is one of them and
    the run is not correct."""
    from sin3dm_tpu_torch.diffusion import sampling
    loop = sampling.p_sample_loop
    chains = []

    def altered(*a, **k):
        x = loop(*a, **k)
        chains.append(x)
        return x._replace(xy=1.25 * x.xy) if len(chains) <= moved else x
    monkeypatch.setattr(sampling, "p_sample_loop", altered)
    r = run(bench, "towerruins.gen-ddpm3-tiny")
    err = capsys.readouterr().err
    assert len(chains) == r["attempted"] == 3 and r["failed"] == 0
    widest = float(re.search(r"reading chain_rel_max: ([0-9.e+-]+)",
                             err).group(1))
    chain = r["checks"]["chain_rel"]
    assert widest > chain["limit"]
    assert all(c["value"] <= c["limit"] for k, c in r["checks"].items()
               if k != "chain_rel")
    assert (chain["value"] <= chain["limit"]) is (moved == 1)
    assert r["correct"] is (moved == 1)


def test_ddpm_cell_runs_the_ancestral_chain(bench, monkeypatch):
    """The window's chain is the DDPM loop over the whole schedule, the
    warm-up's a short DDIM chain."""
    from sin3dm_tpu_torch.diffusion import sampling
    seen = []
    ddpm, ddim = sampling.p_sample_loop, sampling.ddim_sample_loop

    def count(name, fn):
        def wrapped(model, tables, *a, **k):
            seen.append((name, int(tables["betas"].shape[0])))
            return fn(model, tables, *a, **k)
        return wrapped
    monkeypatch.setattr(sampling, "p_sample_loop", count("ddpm", ddpm))
    monkeypatch.setattr(sampling, "ddim_sample_loop", count("ddim", ddim))
    r = run(bench, "towerruins.gen-ddpm-tiny")
    assert r["correct"] is True
    assert seen == [("ddim", 2), ("ddpm", 1000)]


def test_new_references_load_nothing_of_the_program():
    script = (f"import json, sys; sys.path.insert(0, {ROOT!r}); "
              "from perfbench.reference import ddpm, pbr; "
              "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    mods = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "sin3dm_tpu",
                       "sin3dm_tpu_torch"}
