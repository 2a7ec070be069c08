"""Port parity on several ranks: the halo conv, the plane-spatial UNet
forward and DDIM sampler, and data-parallel sampling
(`sin3dm_tpu_torch/parallel/`, `models/unet.py:UNetConfig.spatial_group`,
`diffusion/sampling.py:make_sampler(spatial_group=)`,
`cli/sample.py:sample_diffusion(group)`), on gloo
worlds of 2 and 4 CPU ranks started by the port's own `spawn`, against
the JAX package's functions on its 8-virtual-device mesh
(`tests/conftest.py`) and unsharded, from numpy inputs made from a seed.

Each world runs all its cases in one start (a world costs seconds to
start); the rank functions live in `torch_port_parallel_ranks.py`, which
imports neither `jax` nor `sin3dm_tpu`, and every rank asserts that
neither is loaded.  Stated tolerances:

- `halo_conv2d` at (kernel, ranks) (3, 2), (3, 4), (5, 4), (1, 4) against
  `sin3dm_tpu.parallel.halo.halo_conv2d` and `core.nn.conv2d`, rtol and
  atol 1e-5; its weight gradient against `jax.grad` of the unsharded
  conv, rtol 1e-4 and atol 1e-5 (JAX's `tests/test_halo.py`), the input
  gradient against autograd of the port's unsharded conv, the same.
- The spatial UNet forward (model_channels 32, planes (32, 16, 48),
  fp32) against `unet_apply` with and without `spatial_mesh`, rtol 1e-4
  and atol 1e-5 (with fast_norm, the sampler's GroupNorm, against the
  port's unsharded forward); 26 `all_reduce`s per forward.  The DDIM5
  chain from injected noise against JAX's on its spatial mesh and the
  port's unsharded chain, rtol and atol 1e-4.
- DP sampling, through `cli.sample`'s data-parallel path
  (`sample_diffusion` with the rank's group) from a tag written with the
  same weights: 4 samples, DDIM5, fp32, each rank saving its block of
  two, within 2e-5 of the single-process CLI and of JAX's chain with
  the noise sharded over `data` (`make_jit_sampler(mesh=)`'s layout),
  fed the port's per-sample draws (its own are threefry's).
- `spawn` raises with a failing rank's traceback, and asks for the card
  by default (no fallback to the CPU).
- The backend rule (`parallel.mesh.backend_for`) over fabricated places
  (host, card): NCCL where no two ranks share a card, on one host or on
  two, gloo where two share one or the ranks run on the CPU.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_port_parallel_ranks as ranks
from sin3dm_tpu.core import nn as jnn
from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.diffusion.gaussian import DiffusionConfig as JDC
from sin3dm_tpu.diffusion.sampling import ddim_sample_loop as jddim
from sin3dm_tpu.diffusion.schedule import make_schedule
from sin3dm_tpu.models import unet as JU
from sin3dm_tpu.parallel import halo as jhalo
from sin3dm_tpu.parallel import mesh as jmesh
from sin3dm_tpu_torch.cli import sample as sample_cli
from sin3dm_tpu_torch.compat.from_jax import unet_params_from_jax
from sin3dm_tpu_torch.core import checkpoint as tckpt
from sin3dm_tpu_torch.core import config as tcfg
from sin3dm_tpu_torch.core import nn as tnn
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.core.triplane import load_triplane_npz, \
    save_triplane_npz
from sin3dm_tpu_torch.diffusion.gaussian import DiffusionConfig as TDC
from sin3dm_tpu_torch.diffusion.gaussian import tables_to_device
from sin3dm_tpu_torch.diffusion.sampling import (make_sampler,
                                                 randn_per_sample,
                                                 sample_generators)
from sin3dm_tpu_torch.models import unet as TU
from sin3dm_tpu_torch.parallel import spawn

torch.set_num_threads(2)
HALO = [(3, 2), (3, 4), (5, 4), (1, 4)]
UNET = dict(in_channels=4, model_channels=32, out_channels=4)
SIZES = (32, 16, 48)             # H and W halve once on each of 2 ranks
DP_SIZES, DP_N = (8, 8, 8), 4


def _halo_inputs(k):
    rng = np.random.default_rng(k)
    return dict(x=rng.standard_normal((2, 16, 12, 6)).astype(np.float32),
                w=(0.1 * rng.standard_normal((k, k, 6, 10))).astype(
                    np.float32),
                b=(0.1 * rng.standard_normal(10)).astype(np.float32))


def _numpy_tree(tree, rng):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v, rng) for v in tree]
    a = tree.numpy()
    return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _params():
    """A parameter tree in JAX's layout (`init_unet`'s keys, lists and
    shapes, numpy leaves), every leaf jittered from a seed (the
    zero-initialised out convs too, so that the output depends on every
    weight)."""
    return _numpy_tree(TU.init_unet(torch.Generator().manual_seed(0),
                                    TU.UNetConfig(**UNET)),
                       np.random.default_rng(9))


def _planes(seed, B, sizes):
    H, W, D = sizes
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, W, 4), (B, H, D, 4), (B, W, D, 4))]


def _write_tag(d):
    """A sampling tag holding `_params()` as its EMA weights (the UNet
    of `UNET`, a linear schedule of 100 steps) and DP_SIZES planes."""
    H, W, D = DP_SIZES
    save_triplane_npz(str(d / "encoding" / "feat.npz"), TT(
        *[torch.zeros(s) for s in ((H, W, 4), (H, D, 4), (W, D, 4))]))
    (d / "encoding" / "args.json").write_text("{}")
    args = dict(tcfg.diffusion_defaults(), **tcfg.diffusion_model_defaults())
    args.update(UNET, steps=100, diff_net_type="unet_small", ema_rate=0.9999,
                diff_n_iters=1, diff_batch_size=DP_N)
    (d / "diffusion").mkdir()
    (d / "diffusion" / "args.json").write_text(json.dumps(args))
    tckpt.save_tree(tcfg.diffusion_model_path(str(d), 0.9999, 1), _params())
    return str(d)


def _dp_argv(tag, out, *extra):
    return ["--tag", tag, "--device", "cpu", "--use_ddim", "true",
            "--timestep_respacing", "ddim5", "--n_samples", str(DP_N),
            "--output", out, *extra]


def _cases(n, tag):
    out = [(f"halo{k}", "halo", _halo_inputs(k)) for k, m in HALO if m == n]
    if n == 2:
        x = _planes(1, 1, SIZES)
        for fast in (False, True):
            out.append((f"forward{int(fast)}", "spatial_forward", dict(
                params=_params(), ucfg_kw=dict(UNET, fast_norm=fast), x=x,
                t=np.array([17]))))
        out.append(("spatial_ddim5", "sampler", dict(
            params=_params(), ucfg_kw=UNET, respacing="ddim5",
            noise=_planes(3, 1, SIZES))))
        out.append(("dp_ddim5", "dp_cli", dict(
            argv=_dp_argv(tag, os.path.join(tag, "dp")))))
    return out


@pytest.fixture(scope="module")
def dp_tag(tmp_path_factory):
    return _write_tag(tmp_path_factory.mktemp("dp_tag"))


@pytest.fixture(scope="module")
def worlds(dp_tag):
    """Each world size's ranks' results, one start per size."""
    return {n: spawn(ranks.run_cases, n, _cases(n, dp_tag), device="cpu")
            for n in (2, 4)}


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("k,n", HALO)
def test_halo_conv_matches_jax_and_unsharded(worlds, k, n):
    inp = _halo_inputs(k)
    jx, jw, jb = (jnp.asarray(inp[s]) for s in "xwb")
    mesh = jhalo.make_spatial_mesh(n)
    want_sharded = jhalo.halo_conv2d({"w": jw, "b": jb},
                                     jhalo.shard_plane(mesh, jx), mesh)
    want = jnn.conv2d({"w": jw, "b": jb}, jx)
    gw_want = jax.grad(lambda w: jnp.sum(
        jnn.conv2d({"w": w, "b": jb}, jx) ** 2))(jw)
    xt = torch.from_numpy(inp["x"]).requires_grad_(True)
    (tnn.conv2d({"w": torch.from_numpy(inp["w"]),
                 "b": torch.from_numpy(inp["b"])}, xt) ** 2).sum().backward()
    for r, res in enumerate(worlds[n]):
        got = res[f"halo{k}"]
        _close(got["y"], want_sharded, 1e-5, 1e-5, f"rank {r} vs mesh")
        _close(got["y"], want, 1e-5, 1e-5, f"rank {r} vs unsharded")
        _close(got["gw"], gw_want, 1e-4, 1e-5, f"rank {r} grad w")
        _close(got["gx"], xt.grad.numpy(), 1e-4, 1e-5, f"rank {r} grad x")


@functools.lru_cache(maxsize=None)
def _jax_forward(fast: bool, spatial: bool):
    cfg = JU.UNetConfig(**UNET, fast_norm=fast)
    if spatial:
        cfg = cfg._replace(spatial_mesh=jhalo.make_spatial_mesh(2))
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    return jax.jit(lambda x, t: JU.unet_apply(params, cfg, x, t))


@pytest.mark.parametrize("fast", [False, True])
def test_spatial_unet_forward_matches_jax(worlds, fast):
    x = _planes(1, 1, SIZES)
    t = np.array([17])
    tp = unet_params_from_jax(_params())
    plain = TU.unet_apply(tp, TU.UNetConfig(**UNET, fast_norm=fast),
                          TT(*map(torch.from_numpy, x)), torch.tensor(t))
    wants = {"unsharded port": [p.numpy() for p in plain]}
    if not fast:
        for spatial in (True, False):
            wants[f"jax, mesh={spatial}"] = _jax_forward(fast, spatial)(
                JT(*map(jnp.asarray, x)), jnp.asarray(t))
    for r, res in enumerate(worlds[2]):
        got = res[f"forward{int(fast)}"]
        assert got["collectives"] == 26
        for what, want in wants.items():
            for g, w, name in zip(got["out"], want, ("xy", "xz", "yz")):
                _close(g, w, 1e-4, 1e-5, f"rank {r} {name} vs {what}")


def _jax_chain(noise, sizes, mesh=None, spec=None):
    """JAX's DDIM5 chain from the given noise, the noise (and so the
    chain) laid out over `mesh` as `make_jit_sampler` lays it."""
    cfg = JU.UNetConfig(**UNET)
    if spec == "space":
        cfg = cfg._replace(spatial_mesh=mesh)
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    tables = {k: jnp.asarray(v) for k, v in
              make_schedule("linear", 100, "ddim5").tables_f32().items()}
    dcfg = JDC(original_num_steps=100)

    @jax.jit
    def run(nz):
        if mesh is not None:
            sh = NamedSharding(mesh, P("data") if spec == "data"
                               else P(None, "space"))
            nz = nz.map(lambda p: jax.lax.with_sharding_constraint(p, sh))
        return jddim(lambda x, t: JU.unet_apply(params, cfg, x, t), tables,
                     dcfg, jax.random.PRNGKey(0), nz.xy.shape[0], 4, sizes,
                     noise=nz)
    return run(JT(*map(jnp.asarray, noise)))


def _port_chain(noise, sizes):
    tp = unet_params_from_jax(_params())
    cfg = TU.UNetConfig(**UNET)
    tables = tables_to_device(
        make_schedule("linear", 100, "ddim5").tables_f32(), "cpu")
    sample = make_sampler(lambda x, t: TU.unet_apply(tp, cfg, x, t), tables,
                          TDC(original_num_steps=100), use_ddim=True,
                          device="cpu")
    return sample(0, 0, noise[0].shape[0], 4, sizes,
                  noise=TT(*map(torch.from_numpy, noise)))


def test_spatial_ddim_sampler_matches_jax(worlds):
    noise = _planes(3, 1, SIZES)
    plain = _port_chain(noise, SIZES)
    wants = {"mesh": _jax_chain(noise, SIZES, jhalo.make_spatial_mesh(2),
                                "space"),
             "port unsharded": [p.numpy() for p in plain]}
    for r, res in enumerate(worlds[2]):
        for what, want in wants.items():
            for g, w in zip(res["spatial_ddim5"], want):
                _close(g, w, 1e-4, 1e-4, f"rank {r} vs {what}")


def test_dp_sampling_matches_single_process_and_jax(worlds, dp_tag,
                                                    monkeypatch):
    by_rank = [res["dp_ddim5"] for res in worlds[2]]
    assert [sorted(r) for r in by_rank] == [["000", "001"], ["002", "003"]]
    got = {j: planes for r in by_rank for j, planes in r.items()}
    monkeypatch.setenv("SIN3DM_SAMPLE_DTYPE", "train")
    one = sample_cli.sample_diffusion(sample_cli.cfgmod.sample_args(
        _dp_argv(dp_tag, os.path.join(dp_tag, "one"))))
    assert len(one) == DP_N
    # DDIM with eta 0 draws only x_T: the port's per-sample draws, as
    # the CLI made them, through JAX's chain on its data mesh
    x_t = randn_per_sample(sample_generators(0, 0, DP_N, "cpu"), 4,
                           DP_SIZES, "cpu")
    jax_dp = _jax_chain([p.numpy() for p in x_t], DP_SIZES,
                        jmesh.make_mesh(2), "data")
    for j, path in enumerate(one):
        name = f"{j:03d}"
        for i, plane in enumerate(load_triplane_npz(path)):
            g = got[name][i]
            np.testing.assert_allclose(g, plane.numpy(), rtol=0, atol=2e-5,
                                       err_msg=f"{name} vs one process")
            np.testing.assert_allclose(g, np.asarray(jax_dp[i][j]), rtol=0,
                                       atol=2e-5, err_msg=f"{name} vs jax")


def test_a_failing_rank_fails_spawn():
    """The rank's traceback comes back; the rank left waiting in a
    collective is stopped."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as e:
        spawn(ranks.fail_on, 2, 1, device="cpu")
    assert "fails on purpose" in str(e.value)


def test_ranks_on_the_card_need_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(ranks.fail_on, 2, 1)


def _cards(host, n):
    return [(host, f"GPU-{host}-{i}") for i in range(n)]


@pytest.mark.parametrize("places, want", [
    (_cards("a", 4), "nccl"),                       # one host, 4 cards
    (_cards("a", 1) * 2, "gloo"),                   # 2 ranks, one card
    (_cards("a", 4) + _cards("b", 4), "nccl"),      # 2 hosts x 4 cards
    ([("a", None)] * 2, "gloo"),                    # the CPU
], ids=["one host 4 cards", "two ranks one card", "two hosts 4 cards",
        "cpu"])
def test_backend_from_the_ranks_places(monkeypatch, places, want):
    """The rule reads where the ranks sit, not the world size against
    this host's cards (2 hosts x 4 cards is 8 ranks on 4 cards a host);
    NCCL is taken as available, as it is in a CUDA build."""
    from sin3dm_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh.dist, "is_nccl_available", lambda: True)
    assert mesh.backend_for(places) == want
