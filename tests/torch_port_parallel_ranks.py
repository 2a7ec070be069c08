"""Rank functions of the port's multi-device tests
(`tests/test_torch_port_parallel*.py`), run by `parallel.spawn` in
processes of their own, and the `SIN3DM_DIST` bootstrap's worker.

This module imports neither `jax` nor `sin3dm_tpu`, so a rank that
imports it loads neither; every rank function asserts so before it
returns (the training steps also run in the test's own process, with
no group, to give the single-process result).  Inputs and results are
numpy (parameter trees in JAX's layout), so the tests hold them against
the JAX package in their own process.
"""

import json
import os
import sys

import numpy as np
import torch


def assert_clean() -> list:
    """Neither `jax` nor the JAX package in this process; returns the
    port's loaded modules."""
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "sin3dm_tpu")]
    assert not bad, bad
    return sorted(m for m in sys.modules
                  if m.split(".")[0] == "sin3dm_tpu_torch")


def audit(group) -> list:
    """The import audit's rank: what it loads when it imports every
    module of the port's `parallel` package."""
    import importlib
    import pkgutil

    import sin3dm_tpu_torch.parallel as par
    for m in pkgutil.walk_packages(par.__path__, par.__name__ + "."):
        importlib.import_module(m.name)
    return assert_clean()


def fail_on(group, rank: int) -> None:
    """Rank `rank` raises; the others wait in a collective for it."""
    from sin3dm_tpu_torch.parallel.mesh import barrier
    if group.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    barrier(group)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Sampling-side cases: the halo conv, the spatial UNet and samplers, DP
# ---------------------------------------------------------------------------

def _halo(group, x, w, b):
    from sin3dm_tpu_torch.parallel import halo, mesh
    xs = halo.shard_plane(group, _t(x)).clone().requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    y = halo.halo_conv2d({"w": wt, "b": _t(b)}, xs, group)
    (y ** 2).sum().backward()
    (gw,) = mesh.all_reduce_many(group, [wt.grad])
    return {"y": _np(halo.gather_plane(group, y.detach())),
            "gx": _np(halo.gather_plane(group, xs.grad)), "gw": _np(gw)}


def _unet(params, ucfg_kw):
    from sin3dm_tpu_torch.compat.from_jax import unet_params_from_jax
    from sin3dm_tpu_torch.models.unet import UNetConfig
    return unet_params_from_jax(params), UNetConfig(**ucfg_kw)


def _spatial_forward(group, params, ucfg_kw, x, t):
    from sin3dm_tpu_torch.core.triplane import Triplane
    from sin3dm_tpu_torch.models.unet import unet_apply
    from sin3dm_tpu_torch.parallel import halo, mesh
    p, cfg = _unet(params, ucfg_kw)
    xl = Triplane(*[halo.shard_plane(group, _t(a)) for a in x])
    before = mesh.COUNTS["all_reduce"]
    out = unet_apply(p, cfg._replace(spatial_group=group), xl, _t(t))
    n = mesh.COUNTS["all_reduce"] - before
    return {"out": [_np(halo.gather_plane(group, o)) for o in out],
            "collectives": n}


def _sampler(group, params, ucfg_kw, respacing, noise):
    """The spatial DDIM chain from injected (whole) noise."""
    from sin3dm_tpu_torch.core.triplane import Triplane
    from sin3dm_tpu_torch.diffusion.gaussian import (DiffusionConfig,
                                                     tables_to_device)
    from sin3dm_tpu_torch.diffusion.sampling import make_sampler
    from sin3dm_tpu_torch.diffusion.schedule import make_schedule
    from sin3dm_tpu_torch.models.unet import unet_apply
    p, cfg = _unet(params, ucfg_kw)
    cfg = cfg._replace(spatial_group=group)
    tables = tables_to_device(
        make_schedule("linear", 100, respacing).tables_f32(), "cpu")
    sample = make_sampler(
        lambda xx, tt: unet_apply(p, cfg, xx, tt), tables,
        DiffusionConfig(original_num_steps=100), use_ddim=True,
        device="cpu", spatial_group=group)
    B, H, W, C = noise[0].shape
    out = sample(0, 0, B, C, (H, W, noise[1].shape[2]),
                 noise=Triplane(*map(_t, noise)))
    return [_np(o) for o in out]


def _dp_cli(group, argv):
    """`cli.sample`'s data-parallel chain on this rank (its
    `sample_diffusion` with the group, as `run` calls it), fp32: this
    rank's {sample dir: planes}."""
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core.triplane import load_triplane_npz
    os.environ["SIN3DM_SAMPLE_DTYPE"] = "train"
    paths = cli.sample_diffusion(cli.cfgmod.sample_args(argv), group)
    return {os.path.basename(os.path.dirname(p)):
            [_np(a) for a in load_triplane_npz(p)] for p in paths}


CASES = {"halo": _halo, "spatial_forward": _spatial_forward,
         "sampler": _sampler, "dp_cli": _dp_cli}


def run_cases(group, cases):
    """{name: result} of `cases`, a list of (name, kind, kwargs) run in
    order on every rank of the group."""
    out = {name: CASES[kind](group, **kw) for name, kind, kw in cases}
    assert_clean()
    return out


# ---------------------------------------------------------------------------
# Training-side cases: the DP diffusion step, the DP AE step
# ---------------------------------------------------------------------------

def _warm(state, warm, load, chained=False):
    """Where `warm` is (count, mu, nu), numpy trees in JAX's layout: that
    optimiser state (both counts `count`) and step, through `load`."""
    if warm is not None:
        from sin3dm_tpu_torch.core import checkpoint as tckpt
        count, mu, nu = warm
        load(state, tckpt.adamw_tree(count, mu, nu, count, chained=chained))
        state.step = count


def diffusion_steps(group, params, ucfg_kw, tcfg_kw, batch, draws,
                    num_timesteps, warm=None):
    """The state (fresh, or with the optimiser state `warm`), the
    first step's gradient and terms through `compute_grads`, then every
    draw's step through `make_train_step` (with `group`, data-parallel on
    this rank's rows).  Returns numpy {"g", "terms", "flat", "mu", "nu",
    "metrics", "counts", "history"}."""
    from sin3dm_tpu_torch.core.triplane import Triplane
    from sin3dm_tpu_torch.diffusion.gaussian import (DiffusionConfig,
                                                     tables_to_device)
    from sin3dm_tpu_torch.diffusion.schedule import make_schedule
    from sin3dm_tpu_torch.models.unet import unet_train_apply
    from sin3dm_tpu_torch.parallel.mesh import local_rows
    from sin3dm_tpu_torch.training import adamw
    from sin3dm_tpu_torch.training import diffusion as TD
    p, cfg = _unet(params, ucfg_kw)
    tcfg = TD.DiffusionTrainerConfig(**tcfg_kw)
    T = num_timesteps
    tables = tables_to_device(make_schedule("linear", T).tables_f32(),
                              "cpu")
    dcfg = DiffusionConfig(original_num_steps=T)

    def model(pp, x, t):
        return unet_train_apply(pp, cfg, x, t)

    def rows(a):
        a = _t(a)
        return a if group is None else local_rows(group, a)

    tb = Triplane(*map(rows, batch))
    inputs = [(_t(t).to(torch.int64), Triplane(*map(_t, n)))
              for t, n in draws]
    state = TD.init_train_state(p, tcfg, T)
    _warm(state, warm, adamw.load_opt_tree)
    t0, n0 = inputs[0]
    terms, _, g = TD.compute_grads(
        state, model, tables, dcfg, tcfg, tb, rows(t0.numpy()),
        Triplane(*[rows(a.numpy()) for a in n0]), group)
    step = TD.make_train_step(model, tables, dcfg, tcfg, group)
    metrics = [step(state, tb, 0, inputs=[d]) for d in inputs]
    out = {"g": _np(g), "terms": {k: _np(v) for k, v in terms.items()},
           "flat": _np(state.flat), "mu": _np(state.mu),
           "nu": _np(state.nu),
           "metrics": [{k: _np(v) for k, v in m.items()} for m in metrics],
           "counts": _np(state.sampler_state.counts),
           "history": _np(state.sampler_state.history)}
    if group is not None:
        assert_clean()
    return out


def ae_step(group, params, acfg_kw, tcfg_kw, data, threshold, offsets,
            warm=None):
    """One AE step (from a fresh state, or with the optimiser state
    `warm`) on the batch at `offsets` (with `group`, data-parallel):
    numpy {"terms", "g", "flat", "mu", "nu"}."""
    from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
    from sin3dm_tpu_torch.models.autoencoder import AEConfig
    from sin3dm_tpu_torch.training import ae as ttr
    acfg = AEConfig(**acfg_kw)
    tcfg = ttr.AETrainerConfig(**tcfg_kw)
    td = ttr.AEData(**{k: None if v is None else _t(v)
                       for k, v in data.items()})
    state = ttr.init_train_state(ae_params_from_jax(params), tcfg)
    _warm(state, warm, ttr.load_opt_tree, chained=True)
    terms, g = ttr.compute_grads(state, acfg, tcfg, td, threshold, offsets,
                                 group)
    ttr.apply_grads(state, g, tcfg)
    out = {"terms": {k: float(v) for k, v in terms.items()}, "g": _np(g),
           "flat": _np(state.flat), "mu": _np(state.mu),
           "nu": _np(state.nu)}
    if group is not None:
        assert_clean()
    return out


def ae_trainer(group, npz, log_dir, acfg_kw, tcfg_kw, n_iters):
    """`AETrainer.train` for `n_iters` on the npz at `npz` (with `group`,
    data-parallel; rank 0 writes `log_dir`'s files): {"sha" of the
    parameters, "step", "stat" (evaluate's), "files" in log_dir}."""
    import hashlib

    from sin3dm_tpu_torch.core import logger
    from sin3dm_tpu_torch.models.autoencoder import AEConfig
    from sin3dm_tpu_torch.training import ae as ttr
    logger.configure(dir=log_dir, format_strs=[])
    tr = ttr.AETrainer(log_dir, AEConfig(**acfg_kw), "cpu",
                       ttr.AETrainerConfig(**tcfg_kw), group=group)
    tr.load_data(npz)
    stat = tr.train(0, n_iters=n_iters, log_every=n_iters)
    if group is not None:
        from sin3dm_tpu_torch.parallel.mesh import barrier
        barrier(group)          # rank 0's files are written
        assert_clean()
    return {"sha": hashlib.sha256(_np(tr.state.flat).tobytes()).hexdigest(),
            "step": tr.state.step, "stat": stat,
            "files": sorted(os.listdir(log_dir))}


def train_cases(group, cases):
    """{name: result} of (name, fn name, kwargs) cases, run in order."""
    fns = {"diffusion": diffusion_steps, "ae": ae_step,
           "ae_trainer": ae_trainer}
    return {name: fns[kind](group, **kw) for name, kind, kw in cases}


# ---------------------------------------------------------------------------
# The SIN3DM_DIST bootstrap's worker
# ---------------------------------------------------------------------------

def bootstrap_main() -> None:
    """A process of a group started by hand: joins it through
    `maybe_initialize_distributed` and runs `diffusion_steps` on the
    inputs pickled at `$SIN3DM_TEST_INPUTS`; prints one RESULT line (the
    rank, the last step's mean loss, the parameters' sha256)."""
    import hashlib
    import pickle

    from sin3dm_tpu_torch.parallel import maybe_initialize_distributed
    torch.set_num_threads(1)
    group = maybe_initialize_distributed("cpu")
    assert group is not None and group.backend == "gloo"
    with open(os.environ["SIN3DM_TEST_INPUTS"], "rb") as f:
        kw = pickle.load(f)
    out = diffusion_steps(group, **kw)
    print("RESULT " + json.dumps({
        "rank": group.rank, "size": group.size,
        "loss": float(out["metrics"][-1]["loss"].mean()),
        "sha": hashlib.sha256(out["flat"].tobytes()).hexdigest()}),
        flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    bootstrap_main()
