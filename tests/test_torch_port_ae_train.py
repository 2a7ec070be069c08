"""Port parity: the AE trainer's data, losses, optimiser and train step
against the JAX package (`sin3dm_tpu/training/ae.py`), on the CPU in fp32,
in the three AE configurations (skip/sdftex, base/sdftex, pbr/sdfpbr) at
small widths (hidden 32, 2 hidden layers, fdim_up 16) on a synthetic
32^3 sphere npz written as `tests/test_ae.py:_make_sphere_npz` writes it
(with 8 texture channels for sdfpbr).

- `load_ae_data`: every table bit for bit where the volume needs no
  resize, within 1e-6 with one; the meta and `grid_perm` equal.
- The losses within 1e-6 relative of JAX's on the same predictions.
- The lr schedule at counts 0, 1, 1000 and n_iters - 1 within 2e-7
  relative of `make_optimizer`'s schedule expression evaluated by XLA.
- One train step from the same params, a warm optimiser state (count
  100, mu and nu of the grads' sizes: from a fresh state AdamW's first
  step is g / (|g| + eps), which turns roundoff into steps of size lr)
  and JAX's own window offsets (drawn from the key JAX's step splits):
  loss terms within 1e-5 relative, each leaf's grad within 1e-4 of its
  largest |g| (a bias an InstanceNorm cancels has a zero grad: both
  sides' roundoff below 1e-5 of the whole grad's largest |g|), params within 1e-5 absolute, mu within 1e-4 and nu within
  2e-4 of the leaf's largest magnitude; counts and step equal.
- A steps_per_call=3 call equals three single steps, exactly.
- `evaluate_tsdf_prediction` equals JAX's exactly, exact-zero ground
  truth included.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core.checkpoint import _path_str
from sin3dm_tpu.models import autoencoder as jae
from sin3dm_tpu.training import ae as jtr
from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
from sin3dm_tpu_torch.core import checkpoint as tckpt
from sin3dm_tpu_torch.models import autoencoder as tae
from sin3dm_tpu_torch.training import ae as ttr

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_ae import _make_sphere_npz  # noqa: E402

torch.set_num_threads(2)
NETS = [("skip", "sdftex"), ("base", "sdftex"), ("pbr", "sdfpbr")]
SMALL = dict(fdim_geo=2, fdim_tex=4, fdim_up=16, hidden_dim=32,
             n_hidden_layers=2)
WARM = 100


def _cfgs(net, dt):
    return (jae.AEConfig(data_type=dt, enc_net_type=net, **SMALL),
            tae.AEConfig(data_type=dt, enc_net_type=net, **SMALL))


def _tcfgs(**kw):
    kw = {"enc_batch_size": 512, "enc_n_iters": 40, "fm_reso": 16, **kw}
    return jtr.AETrainerConfig(**kw), ttr.AETrainerConfig(**kw)


def write_npz(path, data_type="sdftex"):
    """The sphere npz; for sdfpbr its texture tables widened to 8
    channels (rgb, metal/rough, normal), each a smooth function of
    position."""
    _make_sphere_npz(path)
    if data_type != "sdfpbr":
        return path
    with np.load(path) as f:
        d = dict(f)

    def widen(t, p):
        extra = [0.5 + 0.5 * np.tanh(p[..., i % 3:i % 3 + 1] * (i + 1))
                 for i in range(5)]
        return np.concatenate([t] + extra, axis=-1).astype(np.float32)

    d["tex_grid"] = widen(d["tex_grid"], d["pts_grid"])
    for k in ("on_surf", "near_surf"):
        d[f"tex_{k}"] = widen(d[f"tex_{k}"], d[f"pts_{k}"])
    np.savez(path, **d)
    return path


@pytest.fixture(scope="module")
def npzs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ae_train")
    return {dt: write_npz(str(d / f"{dt}.npz"), dt)
            for dt in ("sdftex", "sdfpbr")}


@pytest.mark.parametrize("fm_reso,renorm", [(16, False), (12, True),
                                            (20, False)])
def test_load_ae_data_matches_jax(npzs, fm_reso, renorm):
    """fm_reso 16: the 32^3 grid is the 2x feature-map size (no resize);
    12 and 20: resized down and up by non-integer ratios."""
    jc, tc = _tcfgs(fm_reso=fm_reso, sdf_renorm=renorm)
    jd, jm, jperm = jtr.load_ae_data(npzs["sdftex"], jc)
    td, tm, tperm = ttr.load_ae_data(npzs["sdftex"], tc, "cpu")
    assert tm == jm and np.array_equal(tperm, jperm)
    for k in jd._fields:
        want = np.asarray(getattr(jd, k))
        got = getattr(td, k).numpy()
        assert got.shape == want.shape, k
        if k == "input_grid" and fm_reso != 16:
            assert np.abs(got - want).max() <= 1e-6, k
        else:
            assert np.array_equal(got, want), k
    assert td.input_grid.shape[1:4] == tuple(2 * s for s in
                                             tm["featmap_size"])


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.normal(0, 0.02, (600, 1)).astype(np.float32)
    gt = rng.normal(0, 0.02, (600, 1)).astype(np.float32)
    gt[::7] = 0.0                      # exact zeros: sign(0) = 0
    for kind in ("l1", "weightedl1"):
        want = float(jtr.sdf_loss_fn(kind, jnp.asarray(pred),
                                     jnp.asarray(gt)))
        got = float(ttr.sdf_loss_fn(kind, torch.from_numpy(pred),
                                    torch.from_numpy(gt)))
        assert abs(got - want) <= 1e-6 * abs(want), kind
    tp = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    tg = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    for mask in (np.abs(gt[:, 0]) < 0.02, np.zeros(600, bool)):
        for kind in ("l1", "l2", "huber"):
            want = float(jtr.masked_tex_loss_fn(
                kind, jnp.asarray(tp), jnp.asarray(tg), jnp.asarray(mask)))
            got = float(ttr.masked_tex_loss_fn(
                kind, torch.from_numpy(tp), torch.from_numpy(tg),
                torch.from_numpy(mask)))
            assert abs(got - want) <= 1e-6 * abs(want), (kind, mask.sum())


def test_lr_schedule_matches_optax():
    cfg = jtr.AETrainerConfig()          # the committed tag's lr, decay
    gamma = cfg.enc_lr_decay ** (1.0 / cfg.enc_n_iters)
    sched = jax.jit(lambda count: cfg.enc_lr * (gamma ** count))
    tcfg = ttr.AETrainerConfig()
    for count in (0, 1, 1000, cfg.enc_n_iters - 1):
        want = float(sched(jnp.asarray(count, jnp.int32)))
        got = float(ttr.learning_rate(tcfg, count))
        assert abs(got - want) <= 2e-7 * want, count
    assert ttr.learning_rate(tcfg, 0) == np.float32(cfg.enc_lr)


def _jax_offsets(jc, jd, key):
    """The window offsets JAX's `sample_batch` draws from `key`."""
    kg, ks = jax.random.split(key)
    n_grid = int(jc.enc_batch_size * jc.vol_ratio)
    out = []
    for kk, total, rows in ((kg, n_grid, jd.pts_grid.shape[0]),
                            (ks, jc.enc_batch_size - n_grid,
                             jd.pts_near_surf.shape[0])):
        hi = rows - max(ttr.window_sizes(total)) + 1
        out.append([int(o) for o in jax.random.randint(kk, (8,), 0, hi)])
    return tuple(out)


def _jax_loss(acfg, jc, jd, threshold, offsets):
    """JAX's `make_train_step` loss, on the batch at `offsets`."""
    n_grid = int(jc.enc_batch_size * jc.vol_ratio)

    def take(arr, total, offs):
        a = np.asarray(arr)
        return np.concatenate([a[o:o + n] for o, n in
                               zip(offs, ttr.window_sizes(total))])

    cols = [(jd.pts_grid, jd.pts_near_surf), (jd.sdf_grid, jd.sdf_near_surf),
            (jd.tex_grid, jd.tex_near_surf)]
    pts, sdf, tex = [jnp.asarray(np.concatenate([
        take(g, n_grid, offsets[0]),
        take(s, jc.enc_batch_size - n_grid, offsets[1])])) for g, s in cols]
    tex_thr = threshold * jc.tex_threshold_ratio

    def loss(params):
        pred = jae.forward(params, acfg, jd.input_grid, pts, jd.aabb)
        terms = {"sdf_loss": jtr.sdf_loss_fn(jc.sdf_loss, pred[:, :1], sdf)}
        mask = jnp.abs(sdf[:, 0]) < tex_thr
        parts = ({"rgb_loss": slice(0, 3), "mr_loss": slice(3, 5),
                  "normal_loss": slice(5, None)}
                 if acfg.data_type == "sdfpbr" else {"tex_loss": slice(None)})
        for k, sl in parts.items():
            terms[k] = jtr.masked_tex_loss_fn(
                jc.tex_loss, pred[:, 1:][:, sl], tex[:, sl], mask) \
                * jc.tex_weight
        total = sum(terms.values())
        return total, dict(terms, loss=total)
    return loss


def _warm_setup(net, dt, npzs, seed=0):
    """Both frameworks' data, perturbed params and a warm optimiser state
    (count WARM) of the same values."""
    acfg, tcfg = _cfgs(net, dt)
    jc, tc = _tcfgs()
    jd, meta, _ = jtr.load_ae_data(npzs[dt], jc, dt)
    td, _, _ = ttr.load_ae_data(npzs[dt], tc, "cpu", dt)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
                   ).astype(np.float32),
        jae.init_autoencoder(jax.random.PRNGKey(seed), acfg))
    mu = jax.tree_util.tree_map(
        lambda a: (1e-3 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    nu = jax.tree_util.tree_map(
        lambda a: ((1e-3 * (1 + np.abs(rng.standard_normal(a.shape)))) ** 2
                   ).astype(np.float32), params)
    labels = jae.geo_param_labels(params)
    opt = jtr.make_optimizer(jc, labels)
    st = opt.init(params)
    def w():        # a buffer of its own each: the JAX step donates them
        return jnp.asarray(WARM, jnp.int32)
    jstate = jtr.AETrainState(
        params, ((st[0][0]._replace(count=w(), mu=mu, nu=nu), st[0][1],
                  st[0][2]._replace(count=w())), st[1]), w())
    tstate = ttr.init_train_state(ae_params_from_jax(params), tc)
    ttr.load_opt_tree(tstate, tckpt.adamw_tree(WARM, mu, nu, WARM,
                                               chained=True))
    tstate.step = WARM
    return acfg, tcfg, jc, tc, jd, td, meta, labels, jstate, tstate


def cancelled(path: str, net: str) -> bool:
    """Leaves whose gradient is 0 but for roundoff: a per-channel bias
    that an InstanceNorm right after it removes (the encoders' conv biases
    before the planes' norm, every block's in conv bias before its mid
    norm, and under pbr the first texture block's output biases before
    the second block's input norm).  A relative check of such a leaf
    compares two roundoffs, so they are held to the whole gradient's
    scale instead."""
    parts = path.split("/")
    if parts[0] in ("geo_encoder", "tex_encoder") and parts[-1] == "b":
        return True
    if parts[-1] == "b" and "in_conv" in parts:
        return True
    return (net == "pbr" and parts[:2] == ["tex_convs", "0"]
            and parts[2] in ("out_conv", "shortcut") and parts[-1] == "b")


def _by_leaf(state, buf):
    return dict(tckpt.leaves_with_paths(state.tree(buf)))


def _leaves(tree):
    return {_path_str(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("net,dt", NETS)
def test_one_train_step_matches_jax(net, dt, npzs):
    (acfg, tcfg, jc, tc, jd, td, meta, labels, jstate,
     tstate) = _warm_setup(net, dt, npzs)
    thr = meta["threshold"]
    key = jnp.asarray(np.array([0, WARM], np.uint32))
    offsets = _jax_offsets(jc, jd, key)

    (_, jterms), jgrads = jax.value_and_grad(
        _jax_loss(acfg, jc, jd, thr, offsets), has_aux=True)(jstate.params)
    step = jtr.make_train_step(acfg, jc, jd, thr, labels)
    jnew, jmetrics = step(jstate, jd, key)

    terms, g = ttr.compute_grads(tstate, tcfg, tc, td, thr, offsets)
    ttr.apply_grads(tstate, g, tc)
    tstate.step += 1

    for k, v in jmetrics.items():
        want = float(v)
        assert abs(float(terms[k]) - want) <= 1e-5 * abs(want), k
        assert abs(float(jterms[k]) - want) <= 1e-6 * abs(want), k
    got_g = _by_leaf(tstate, g)
    jg = _leaves(jgrads)
    top = max(np.abs(w).max() for w in jg.values())
    for p, w in jg.items():
        if cancelled(p, net):
            # both are roundoff of a zero gradient
            assert max(np.abs(w).max(), got_g[p].abs().max()) <= 1e-5 * top
            continue
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(got_g[p].numpy() - w).max() <= 1e-4 * scale, p
    got = {"params": _by_leaf(tstate, tstate.flat),
           "mu": _by_leaf(tstate, tstate.mu),
           "nu": _by_leaf(tstate, tstate.nu)}
    adam = jnew.opt_state[0][0]
    for name, tree, rel, tol in (("params", jnew.params, False, 1e-5),
                                 ("mu", adam.mu, True, 1e-4),
                                 ("nu", adam.nu, True, 2e-4)):
        for p, w in _leaves(tree).items():
            scale = max(np.abs(w).max(), 1e-30) if rel else 1.0
            err = np.abs(got[name][p].numpy() - w).max()
            assert err <= tol * scale, (name, p, err / scale)
    assert (tstate.count, tstate.sched_count, tstate.step) == (
        int(adam.count), int(jnew.opt_state[0][2].count), int(jnew.step))


def test_k_step_call_equals_single_steps(npzs):
    *_, tcfg, _, tc, _, td, meta, _, _, _ = _warm_setup("skip", "sdftex",
                                                       npzs)
    thr = meta["threshold"]
    states = []
    for K, calls in ((3, 1), (1, 3)):
        *_, st = _warm_setup("skip", "sdftex", npzs)
        fn = ttr.make_train_step(tcfg, dataclasses.replace(
            tc, steps_per_call=K), thr)
        for _ in range(calls):
            metrics = fn(st, td, 7)
        states.append((st, metrics))
    (a, ma), (b, mb) = states
    assert a.step == b.step == WARM + 3 and a.count == b.count
    for buf in ("flat", "mu", "nu"):
        assert torch.equal(getattr(a, buf), getattr(b, buf)), buf
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_evaluate_tsdf_prediction_matches_jax():
    rng = np.random.default_rng(3)
    thr = 0.0234375
    gt = np.clip(rng.normal(0, 0.02, (5000, 1)), -thr, thr).astype(
        np.float32)
    gt[::50] = 0.0
    pred = (gt + rng.normal(0, 0.003, gt.shape)).astype(np.float32)
    want = jtr.evaluate_tsdf_prediction(pred, gt, thr)
    got = ttr.evaluate_tsdf_prediction(pred, gt, thr)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == v or (np.isnan(v) and np.isnan(got[k])), k
    empty = ttr.evaluate_tsdf_prediction(pred[:0], gt[:0] + 1, thr)
    jempty = jtr.evaluate_tsdf_prediction(pred[:0], gt[:0] + 1, thr)
    assert np.isnan(empty["mean_tsdf_rel_error"]) and np.isnan(
        jempty["mean_tsdf_rel_error"])
