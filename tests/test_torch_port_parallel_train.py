"""Port parity of data-parallel training on 2 gloo CPU ranks
(`training/diffusion.py` and `training/ae.py` with `group=`, the
`SIN3DM_DIST` bootstrap of `parallel/mesh.py`), against the JAX package's
steps with and without its data mesh and against the port's
single-process step, from numpy inputs made from a seed.  One world (the
port's `spawn`) runs every case; the rank functions are
`torch_port_parallel_ranks.py`'s, which import neither `jax` nor
`sin3dm_tpu` (each rank asserts so).

The optimiser state is a warm one (count 100, mu 0, nu of the grads'
squared sizes): AdamW's first step from a fresh state, g / (|g| + eps),
turns roundoff into steps of lr; and with mu 0 JAX's updated mu is
(1 - b1) g, from which the test reads JAX's gradient.

- The diffusion step, global batch 8 (4 a rank), injected (t, noise) as
  JAX draws them, a one-level UNet of model_channels 64 on 8x8x4 planes:
  uniform sampling against JAX's `make_train_step` with and without
  `mesh`, the loss-aware sampler over 3 steps against JAX's without
  (its state: counts equal, history 1e-5 relative).  Loss terms 1e-5
  relative, each leaf's grad 1e-4 of its largest |g|, params 1e-5
  absolute; every rank's parameters equal bit for bit.
- The AE step at `tests/test_sharding.py`'s sizes against JAX's
  `make_train_step` with and without `mesh` (JAX's own offsets): the
  loss 1e-5 relative and the params 1e-4 relative + 1e-6 (that test's
  tolerances), each leaf's grad 1e-4 of its largest (a bias that an
  InstanceNorm cancels: 1e-5 of the whole grad's largest).  A batch
  whose texture-masked rows all fall in rank 0's half (injected
  offsets) against JAX's loss and `jax.grad` on it: the same
  tolerances; a mean of per-rank masked means would miss by far more.
- `AETrainer(group=)` for 3 iterations on a sphere npz at tiny widths:
  the ranks' parameters equal bit for bit, their `evaluate` statistics
  equal, rank 0 alone wrote the checkpoint and `eval_stat.json`.
- The bootstrap: 2 processes started by hand with `SIN3DM_DIST=1` and a
  `tcp://localhost` coordinator, 3 steps: parameters equal bit for bit
  across them, the last loss within 1e-5 of one process's.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_parallel_ranks as ranks
from sin3dm_tpu.core.checkpoint import _path_str
from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.core.triplane import randn_like as jrandn_like
from sin3dm_tpu.diffusion import resample as jres
from sin3dm_tpu.diffusion.gaussian import DiffusionConfig as JDC
from sin3dm_tpu.diffusion.schedule import make_schedule
from sin3dm_tpu.models import autoencoder as jae
from sin3dm_tpu.models import unet as JU
from sin3dm_tpu.parallel import mesh as jmesh
from sin3dm_tpu.training import ae as jtr
from sin3dm_tpu.training import diffusion as JD
from sin3dm_tpu_torch.models import autoencoder as tae
from sin3dm_tpu_torch.models import unet as TU
from sin3dm_tpu_torch.parallel import spawn
from test_ae import _make_sphere_npz
from test_torch_port_ae_train import cancelled

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, C, T, WARM = 8, 4, 50, 100
SIZES = (8, 8, 4)
UCFG = dict(in_channels=C, model_channels=64, out_channels=C,
            channel_mult=(1,))
ACFG = dict(fdim_up=32, hidden_dim=64)
ATCFG = dict(enc_batch_size=1024)
SAMPLERS = {"uniform": 1, "loss-second-moment": 3}     # steps


def _numpy_tree(tree, rng, scale):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, rng, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v, rng, scale) for v in tree]
    a = tree.numpy()
    return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)


def _like(tree, fn):
    if isinstance(tree, dict):
        return {k: _like(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(v, fn) for v in tree]
    return fn(tree)


def _warm(params, seed):
    """(WARM, mu 0, nu) numpy trees of the parameters' layout."""
    rng = np.random.default_rng(seed)
    nu = _like(params, lambda a: ((1e-3 * (1 + np.abs(rng.standard_normal(
        a.shape)))) ** 2).astype(np.float32))
    return WARM, _like(params, np.zeros_like), nu


def _leaves(tree):
    return {_path_str(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_leaves(flat, like):
    """A port flat buffer as {path: array} in the tree `like`'s order."""
    out, i = {}, 0
    for p, v in _leaves(like).items():
        out[p] = flat[i:i + v.size].reshape(v.shape)
        i += v.size
    assert i == flat.size
    return out


# ---------------------------------------------------------------------------
# The diffusion step
# ---------------------------------------------------------------------------

def _diff_setup():
    rng = np.random.default_rng(0)
    params = _numpy_tree(TU.init_unet(torch.Generator().manual_seed(0),
                                      TU.UNetConfig(**UCFG)), rng, 0.02)
    H, W, D = SIZES
    batch = [np.tanh(rng.standard_normal(s)).astype(np.float32)
             for s in ((B, H, W, C), (B, H, D, C), (B, W, D, C))]
    return params, batch


def _jax_diffusion(sampler, mesh, params, batch, warm, n_calls):
    """JAX's `make_train_step` from the warm state: (state, metrics of the
    last call, the (t, noise) of every call as the step draws them)."""
    tcfg = JD.DiffusionTrainerConfig(lr=5e-4, lr_anneal_steps=1000,
                                     ema_rates=(0.9,), batch_size=B,
                                     schedule_sampler=sampler)
    jcfg = JU.UNetConfig(**UCFG)
    tables = {k: jnp.asarray(v) for k, v in
              make_schedule("linear", T).tables_f32().items()}
    st = JD.init_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                             tcfg, T)
    adam = st.opt_state[0]
    count = jnp.asarray(WARM, jnp.int32)
    _, mu, nu = warm
    opt = (adam._replace(count=count, mu=jax.tree_util.tree_map(
        jnp.asarray, mu), nu=jax.tree_util.tree_map(jnp.asarray, nu)),) \
        + tuple(o._replace(count=count) if "count" in o._fields else o
                for o in st.opt_state[1:])
    # a buffer of its own for every leaf: the step donates its state
    st = jax.tree_util.tree_map(jnp.array, st._replace(opt_state=opt,
                                                       step=count))
    jbatch = JT(*map(jnp.asarray, batch))
    step = JD.make_train_step(lambda p, x, t: JU.unet_apply(p, jcfg, x, t),
                              tables, JDC(original_num_steps=T), tcfg,
                              mesh=mesh)
    if mesh is not None:
        st = jmesh.replicate(mesh, st)
        jbatch = jmesh.shard_batch(mesh, jbatch)
    draws, metrics = [], None
    for c in range(n_calls):
        ck = jax.random.fold_in(jax.random.PRNGKey(7), c)
        tkey, nkey = jax.random.split(ck)
        if sampler == "loss-second-moment":
            t, _ = jres.sample_loss_aware(tkey, B, st.sampler_state)
        else:
            t, _ = jres.sample_uniform(tkey, B, T)
        noise = jrandn_like(nkey, JT(*map(jnp.asarray, batch)))
        draws.append((np.asarray(t), [np.asarray(p) for p in noise]))
        st, metrics = step(st, jbatch, ck)
    return jax.device_get(st), jax.device_get(metrics), draws


def _diff_kw(sampler, params, batch, draws, warm):
    return dict(params=params, ucfg_kw=UCFG, tcfg_kw=dict(
        lr=5e-4, lr_anneal_steps=1000, ema_rates=(0.9,), batch_size=B,
        schedule_sampler=sampler), batch=batch, draws=draws,
        num_timesteps=T, warm=warm)


# ---------------------------------------------------------------------------
# The AE step
# ---------------------------------------------------------------------------

def _ae_data(uneven: bool):
    """`tests/test_sharding.py`'s AE data; `uneven`: every grid point and
    the first 1000 near-surface points inside the texture band, the rest
    outside it."""
    rng = np.random.default_rng(0)
    n_grid, n_near = 512, 2048
    d = dict(
        input_grid=rng.standard_normal((1, 16, 16, 8, 4)).astype(
            np.float32),
        pts_grid=rng.uniform(-1, 1, (n_grid, 3)).astype(np.float32),
        sdf_grid=rng.uniform(-0.02, 0.02, (n_grid, 1)).astype(np.float32),
        pts_near_surf=rng.uniform(-1, 1, (n_near, 3)).astype(np.float32),
        sdf_near_surf=rng.uniform(-0.02, 0.02, (n_near, 1)).astype(
            np.float32),
        tex_grid=rng.uniform(0, 1, (n_grid, 3)).astype(np.float32),
        tex_near_surf=rng.uniform(0, 1, (n_near, 3)).astype(np.float32),
        pts_on_surf=None, tex_on_surf=None,
        aabb=np.asarray([-1, -1, -1, 1, 1, 1], np.float32))
    if uneven:
        d["sdf_grid"] = 0.5 * d["sdf_grid"]
        far = d["sdf_near_surf"][1000:]
        d["sdf_near_surf"][1000:] = np.where(far < 0, -0.03, 0.03)
    return d


# the batch's rows: 102 grid rows, then 8 near-surface windows of 115
# rows (117 the last); rank 0 takes rows [0, 512): the grid windows, near
# windows 0-2 and the first 65 rows of window 3
UNEVEN_OFFSETS = ([0, 50, 100, 150, 200, 250, 300, 350],
                  [0, 115, 230, 1000 - 65, 1000, 1200, 1400, 1600])


def _ae_params():
    acfg = tae.AEConfig(**ACFG)
    return _numpy_tree(tae.init_autoencoder(torch.Generator().manual_seed(0),
                                            acfg), np.random.default_rng(1),
                       0.02)


def _jax_ae_state(params, warm, jc):
    labels = jae.geo_param_labels(params)
    opt = jtr.make_optimizer(jc, labels)
    st = opt.init(params)
    _, mu, nu = warm

    def w():        # a buffer of its own each: the JAX step donates them
        return jnp.asarray(WARM, jnp.int32)
    return labels, jtr.AETrainState(
        jax.tree_util.tree_map(jnp.asarray, params),
        ((st[0][0]._replace(count=w(), mu=jax.tree_util.tree_map(
            jnp.asarray, mu), nu=jax.tree_util.tree_map(jnp.asarray, nu)),
          st[0][1], st[0][2]._replace(count=w())), st[1]), w())


def _jax_offsets(jc, data, key):
    """The window offsets JAX's `sample_batch` draws from `key`."""
    from sin3dm_tpu_torch.training.ae import window_sizes
    kg, ks = jax.random.split(key)
    n_grid = int(jc.enc_batch_size * jc.vol_ratio)
    out = []
    for kk, total, rows in ((kg, n_grid, data["pts_grid"].shape[0]),
                            (ks, jc.enc_batch_size - n_grid,
                             data["pts_near_surf"].shape[0])):
        hi = rows - max(window_sizes(total)) + 1
        out.append([int(o) for o in jax.random.randint(kk, (8,), 0, hi)])
    return tuple(out)


def _jax_ae_loss(acfg, jc, data, offsets):
    """JAX's AE loss terms on the batch at `offsets` (its train step's
    `loss_fn`, on an injected batch)."""
    from sin3dm_tpu_torch.training.ae import window_sizes
    n_grid = int(jc.enc_batch_size * jc.vol_ratio)

    def take(a, total, offs):
        return np.concatenate([a[o:o + n] for o, n in
                               zip(offs, window_sizes(total))])

    pts, sdf, tex = [jnp.asarray(np.concatenate([
        take(data[f"{k}_grid"], n_grid, offsets[0]),
        take(data[f"{k}_near_surf"], jc.enc_batch_size - n_grid,
             offsets[1])])) for k in ("pts", "sdf", "tex")]
    jd = jtr.AEData(**{k: None if v is None else jnp.asarray(v)
                       for k, v in data.items()})

    def loss(params):
        pred = jae.forward(params, acfg, jd.input_grid, pts, jd.aabb)
        terms = {"sdf_loss": jtr.sdf_loss_fn(jc.sdf_loss, pred[:, :1], sdf)}
        mask = jnp.abs(sdf[:, 0]) < 0.02 * jc.tex_threshold_ratio
        terms["tex_loss"] = jtr.masked_tex_loss_fn(
            jc.tex_loss, pred[:, 1:], tex, mask) * jc.tex_weight
        total = sum(terms.values())
        return total, dict(terms, loss=total)
    return loss


# ---------------------------------------------------------------------------
# One world for every case
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs (their draws and offsets feed the port's), then every
    port case on the 2-rank world and in this one process."""
    params, batch = _diff_setup()
    warm = _warm(params, 2)
    out = {"jax": {}, "single": {}, "params": params, "batch": batch,
           "warm": warm}
    cases = []
    for sampler, n in SAMPLERS.items():
        js = _jax_diffusion(sampler, None, params, batch, warm, n)
        out["jax"][sampler] = js
        kw = _diff_kw(sampler, params, batch, js[2], warm)
        cases.append((sampler, "diffusion", kw))
        out["single"][sampler] = ranks.diffusion_steps(None, **kw)
    aparams = _ae_params()
    awarm = _warm(aparams, 3)
    jc = jtr.AETrainerConfig(**ATCFG)
    acfg = jae.AEConfig(**ACFG)
    for name in ("even", "uneven"):
        data = _ae_data(name == "uneven")
        offsets = (UNEVEN_OFFSETS if name == "uneven" else _jax_offsets(
            jc, data, jax.random.PRNGKey(7)))
        kw = dict(params=aparams, acfg_kw=ACFG, tcfg_kw=ATCFG, data=data,
                  threshold=0.02, offsets=offsets, warm=awarm)
        cases.append((f"ae_{name}", "ae", kw))
        out["single"][f"ae_{name}"] = ranks.ae_step(None, **kw)
        out[f"ae_{name}"] = (acfg, jc, data, offsets, aparams, awarm)
    d = tmp_path_factory.mktemp("ae_trainer")
    npz = str(d / "sphere.npz")
    _make_sphere_npz(npz)
    out["ae_trainer_dir"] = d / "log"
    cases.append(("ae_trainer", "ae_trainer", dict(
        npz=npz, log_dir=str(d / "log"), acfg_kw=dict(
            fdim_geo=2, fdim_tex=4, fdim_up=16, hidden_dim=32,
            n_hidden_layers=2), tcfg_kw=dict(enc_batch_size=512,
                                             enc_n_iters=3, fm_reso=16),
        n_iters=3)))
    out["world"] = spawn(ranks.train_cases, 2, cases, device="cpu")
    return out


def _grads_close(got, want, what, net=None):
    top = max(np.abs(w).max() for w in want.values())
    for p, w in want.items():
        if net is not None and cancelled(p, net):
            assert max(np.abs(w).max(), np.abs(got[p]).max()) <= 1e-5 * top
            continue
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(got[p] - w).max() <= 1e-4 * scale, (what, p)


def _jax_grads(state, tree_of):
    """JAX's gradient from its updated mu (mu was 0: mu = (1 - b1) g)."""
    adam = state.opt_state[0] if tree_of == "diffusion" else \
        state.opt_state[0][0]
    return {p: v / np.float32(1 - 0.9) for p, v in _leaves(adam.mu).items()}


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_dp_diffusion_step_matches_jax(runs, sampler):
    world = [r[sampler] for r in runs["world"]]
    for r in world[1:]:
        for k in ("flat", "mu", "nu", "history", "counts"):
            assert np.array_equal(r[k], world[0][k]), k
    like = runs["params"]
    single = runs["single"][sampler]
    wants = {"jax": runs["jax"][sampler]}
    if sampler == "uniform":
        wants["jax mesh"] = _jax_diffusion(
            sampler, jmesh.make_mesh(2), like, runs["batch"], runs["warm"],
            SAMPLERS[sampler])
    got = world[0]
    for k in ("loss", "mse_xy", "mse_xz", "mse_yz"):
        np.testing.assert_allclose(got["metrics"][-1][k],
                                   single["metrics"][-1][k], rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["metrics"][-1]["t"],
                                  single["metrics"][-1]["t"])
    _grads_close(_flat_leaves(got["g"], like),
                 _flat_leaves(single["g"], like), "single process")
    for what, (js, jm, _) in wants.items():
        for k in ("loss", "mse_xy", "mse_xz", "mse_yz"):
            np.testing.assert_allclose(got["metrics"][-1][k],
                                       np.asarray(jm[k]), rtol=1e-5,
                                       err_msg=f"{what} {k}")
        if SAMPLERS[sampler] == 1:
            _grads_close(_flat_leaves(got["g"], like),
                         _jax_grads(js, "diffusion"), what)
        params = _flat_leaves(got["flat"], like)
        for p, w in _leaves(js.params).items():
            np.testing.assert_allclose(params[p], w, rtol=0, atol=1e-5,
                                       err_msg=f"{what} {p}")
        if sampler == "loss-second-moment":
            ss = js.sampler_state
            np.testing.assert_array_equal(got["counts"],
                                          np.asarray(ss.counts))
            np.testing.assert_allclose(got["history"],
                                       np.asarray(ss.history), rtol=1e-5,
                                       atol=0)


def test_dp_ae_step_matches_jax(runs):
    acfg, jc, data, offsets, params, warm = runs["ae_even"]
    world = [r["ae_even"] for r in runs["world"]]
    assert np.array_equal(world[0]["flat"], world[1]["flat"])
    got = world[0]
    jd = jtr.AEData(**{k: None if v is None else jnp.asarray(v)
                       for k, v in data.items()})
    key = jax.random.PRNGKey(7)
    for mesh in (None, jmesh.make_mesh(2)):
        labels, st = _jax_ae_state(params, warm, jc)
        if mesh is not None:
            st = jmesh.replicate(mesh, st)
        step = jtr.make_train_step(acfg, jc, jd, 0.02, labels, mesh=mesh)
        st, m = step(st, jd, key)
        st = jax.device_get(st)
        what = f"mesh={mesh is not None}"
        assert abs(got["terms"]["loss"] - float(m["loss"])) <= \
            1e-5 * abs(float(m["loss"])), what
        _grads_close(_flat_leaves(got["g"], params),
                     _jax_grads(st, "ae"), what, net="skip")
        flat = _flat_leaves(got["flat"], params)
        for p, w in _leaves(st.params).items():
            np.testing.assert_allclose(flat[p], w, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{what} {p}")


def test_dp_ae_step_with_the_mask_in_one_half(runs):
    acfg, jc, data, offsets, params, _ = runs["ae_uneven"]
    world = [r["ae_uneven"] for r in runs["world"]]
    assert np.array_equal(world[0]["flat"], world[1]["flat"])
    (_, jterms), jgrads = jax.jit(jax.value_and_grad(
        _jax_ae_loss(acfg, jc, data, offsets), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    single = runs["single"]["ae_uneven"]
    for k, v in jterms.items():
        want = float(v)
        for what, got in (("dp", world[0]), ("single", single)):
            assert abs(got["terms"][k] - want) <= 1e-5 * abs(want), (what, k)
    _grads_close(_flat_leaves(world[0]["g"], params), _leaves(jgrads), "dp",
                 net="skip")
    # the texture band: every masked row is rank 0's
    from sin3dm_tpu_torch.training.ae import window_sizes
    n_grid = int(jc.enc_batch_size * jc.vol_ratio)
    sdf = np.concatenate([np.concatenate([
        data[f"sdf_{k}"][o:o + n] for o, n in zip(offs, window_sizes(m))])
        for k, offs, m in (("grid", offsets[0], n_grid),
                           ("near_surf", offsets[1],
                            jc.enc_batch_size - n_grid))])
    masked = np.abs(sdf[:, 0]) < 0.02 * jc.tex_threshold_ratio
    assert masked[:512].sum() > 0 and masked[512:].sum() == 0


def test_dp_ae_trainer(runs):
    a, b = (r["ae_trainer"] for r in runs["world"])
    assert a["sha"] == b["sha"] and a["step"] == b["step"] == 3
    assert a["stat"] == b["stat"]
    assert 0.0 <= a["stat"]["mean_tsdf_acc"] <= 1.0
    assert {"ckpt_final.pth", "eval_stat.json"} <= set(a["files"])


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_bootstrap_two_processes(runs, tmp_path):
    import pickle
    params, batch = runs["params"], runs["batch"]
    js = runs["jax"]["loss-second-moment"]
    kw = _diff_kw("loss-second-moment", params, batch, js[2], runs["warm"])
    path = tmp_path / "inputs.pkl"
    path.write_bytes(pickle.dumps(kw))
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, SIN3DM_DIST="1",
                   SIN3DM_COORDINATOR=f"localhost:{port}",
                   SIN3DM_NUM_PROCESSES="2", SIN3DM_PROCESS_ID=str(pid),
                   SIN3DM_TEST_INPUTS=str(path),
                   PYTHONPATH=os.pathsep.join([ROOT, os.path.join(
                       ROOT, "tests")]))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "torch_port_parallel_ranks.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    res = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        res.append(json.loads(line[-1][len("RESULT "):]))
    assert sorted(r["rank"] for r in res) == [0, 1]
    assert res[0]["sha"] == res[1]["sha"]
    want = float(runs["single"]["loss-second-moment"]["metrics"][-1][
        "loss"].mean())
    for r in res:
        assert abs(r["loss"] - want) <= 1e-5 * abs(want)


def test_bootstrap_needs_a_coordinator(monkeypatch):
    from sin3dm_tpu_torch.parallel import maybe_initialize_distributed
    monkeypatch.delenv("SIN3DM_DIST", raising=False)
    assert maybe_initialize_distributed("cpu") is None
    monkeypatch.setenv("SIN3DM_DIST", "1")
    for v in ("SIN3DM_COORDINATOR", "SIN3DM_NUM_PROCESSES",
              "SIN3DM_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError, match="SIN3DM_COORDINATOR"):
        maybe_initialize_distributed("cpu")
