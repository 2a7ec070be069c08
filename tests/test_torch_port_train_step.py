"""Port parity: one diffusion train step, and 3 fused steps, against the
JAX package's `make_train_step` from the same parameters, optimiser
state, batch, t and noise (drawn with JAX's own `resample.sample_uniform`
and `core.triplane.randn_like` from the split of the key the JAX step
uses, and handed to the port); the NaN-guard step; the loss-aware
sampler's state; the lr anneal.

The optimiser state is a warm one, written by JAX's `save_pytree` and
read through the port's checkpoint layout (count 100, mu and nu of the
grads' magnitudes): from a fresh state AdamW's first step is
g / (|g| + eps), which turns the roundoff of near-zero grads (a few
elements in a million, |g| ~ eps) into steps of up to lr, in either
framework.  `test_lr_anneal_matches_optax` covers the fresh state.

A narrow UNet (model_channels 64, channel_mult (1, 2)) on 8x12x6 planes,
fp32 on the CPU, at the committed tag's lr (5e-4: the first AdamW step
moves each parameter by up to lr, sign(g) for most, so 1e-5 absolute is
2 % of it).  Stated tolerances: loss terms 1e-5 relative; params and
EMA 1e-5 absolute; mu 1e-4 and nu 2e-4 of each leaf's largest magnitude
(the grads agree to 1e-4 of it, nu holds their squares); counts equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core import checkpoint as jckpt
from sin3dm_tpu.core.checkpoint import _path_str
from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.core.triplane import randn_like as jrandn_like
from sin3dm_tpu.diffusion import resample as jres
from sin3dm_tpu.diffusion.gaussian import DiffusionConfig as JDC
from sin3dm_tpu.diffusion.schedule import make_schedule
from sin3dm_tpu.models import unet as JU
from sin3dm_tpu.training import diffusion as JD
from sin3dm_tpu_torch.compat.from_jax import unet_params_from_jax
from sin3dm_tpu_torch.core import checkpoint as tckpt
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.diffusion.gaussian import DiffusionConfig as TDC
from sin3dm_tpu_torch.diffusion.gaussian import tables_to_device
from sin3dm_tpu_torch.models import unet as TU
from sin3dm_tpu_torch.training import adamw
from sin3dm_tpu_torch.training import diffusion as TD

torch.set_num_threads(2)
SIZES = (8, 12, 6)
C, B, T = 4, 2, 50
# 64, not 32: at 32 channels GroupNorm32 has one channel per group and
# cancels the bias of every conv before it exactly, so those grads are
# roundoff and AdamW's first step, g / (|g| + eps), amplifies it
MC = 64


def _setup(seed=0):
    jcfg = JU.UNetConfig(in_channels=C, model_channels=MC, out_channels=C)
    tcfg = TU.UNetConfig(in_channels=C, model_channels=MC, out_channels=C)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
                   ).astype(np.float32),
        JU.init_unet(jax.random.PRNGKey(seed), jcfg))
    H, W, D = SIZES
    batch = [np.tanh(rng.standard_normal(s)).astype(np.float32)
             for s in ((B, H, W, C), (B, H, D, C), (B, W, D, C))]
    tables = make_schedule("linear", T).tables_f32()
    return jcfg, tcfg, params, batch, tables


@functools.lru_cache(maxsize=None)
def _jax_stepper(jcfg, kw_items):
    """The jitted JAX step of one trainer configuration (compiled once)."""
    tcfg = JD.DiffusionTrainerConfig(**dict(kw_items))
    jt = {k: jnp.asarray(v) for k, v in
          make_schedule("linear", T).tables_f32().items()}
    return tcfg, JD.make_train_step(
        lambda p, x, t: JU.unet_apply(p, jcfg, x, t), jt,
        JDC(original_num_steps=T), tcfg)


def _jax_step(jcfg, tcfg_kw, params, batch, key, n_calls=1, state=None):
    """(state after the last call, its metrics, the (t, noise) of every
    step) of JAX's `make_train_step`, call c keyed fold_in(key, c); the
    draws re-derived from the keys as the step derives them."""
    tcfg, step = _jax_stepper(jcfg, tuple(sorted(tcfg_kw.items())))
    jbatch = JT(*map(jnp.asarray, batch))
    if state is None:
        state = JD.init_train_state(
            jax.tree_util.tree_map(jnp.asarray, params), tcfg, T)
    K = max(tcfg.steps_per_call, 1)
    draws, metrics = [], None
    for c in range(n_calls):
        ck = jax.random.fold_in(key, c)
        for i in range(K):
            k = jax.random.fold_in(ck, i) if K > 1 else ck
            tkey, nkey = jax.random.split(k)
            if tcfg.schedule_sampler == "loss-second-moment":
                t, _ = jres.sample_loss_aware(tkey, B, state.sampler_state)
            else:
                t, _ = jres.sample_uniform(tkey, B, T)
            noise = jrandn_like(nkey, jbatch)
            draws.append((np.asarray(t), [np.asarray(p) for p in noise]))
        state, metrics = step(state, jbatch, ck)
        state = jax.device_get(state)
    return state, jax.device_get(metrics), draws


WARM = 100


def _warm_jax_state(jcfg, tcfg_kw, params, path, seed=0):
    """JAX's train state at step WARM with mu, nu of the grads' sizes,
    its optimiser state saved to `path` by JAX's `save_pytree`."""
    tcfg, _ = _jax_stepper(jcfg, tuple(sorted(tcfg_kw.items())))
    st = JD.init_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                             tcfg, T)
    rng = np.random.default_rng(seed)
    adam = st.opt_state[0]
    mu = jax.tree_util.tree_map(lambda a: jnp.asarray(
        1e-3 * rng.standard_normal(a.shape), jnp.float32), adam.mu)
    nu = jax.tree_util.tree_map(lambda a: jnp.asarray(
        (1e-3 * (1 + np.abs(rng.standard_normal(a.shape)))) ** 2,
        jnp.float32), adam.nu)
    count = jnp.asarray(WARM, jnp.int32)
    opt = (adam._replace(count=count, mu=mu, nu=nu),) + tuple(
        o._replace(count=count) if "count" in o._fields else o
        for o in st.opt_state[1:])
    jckpt.save_pytree(str(path), opt)
    return jax.device_get(st._replace(opt_state=opt, step=count))


def _port(params, tcfg_kw, tables, tucfg, opt_path=None):
    tcfg = TD.DiffusionTrainerConfig(**tcfg_kw)
    state = TD.init_train_state(unet_params_from_jax(params), tcfg, T)
    if opt_path is not None:
        adamw.load_opt_tree(state, tckpt.load_tree(str(opt_path))[0])
        state.step = WARM
    step = TD.make_train_step(
        lambda p, x, t: TU.unet_train_apply(p, tucfg, x, t),
        tables_to_device(tables, "cpu"), TDC(original_num_steps=T), tcfg)
    return state, step


def _inputs(draws):
    return [(torch.tensor(t, dtype=torch.int64),
             TT(*[torch.tensor(p) for p in n])) for t, n in draws]


def _leaves(tree):
    return {_path_str(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_state(js, ts, tcfg_kw, mu_tol=1e-4, nu_tol=2e-4):
    want_p = _leaves(js.params)
    got_p = {p: v.detach().numpy()
             for p, v in tckpt.leaves_with_paths(ts.params)}
    assert list(got_p) == list(want_p)
    for p in want_p:
        np.testing.assert_allclose(got_p[p], want_p[p], rtol=0, atol=1e-5,
                                   err_msg=p)
    for e_j, e_t in zip(js.ema_params, ts.ema):
        got = dict(tckpt.leaves_with_paths(ts.tree(e_t)))
        for p, v in _leaves(e_j).items():
            np.testing.assert_allclose(got[p].numpy(), v, rtol=0, atol=1e-5,
                                       err_msg=p)
    adam = js.opt_state[0]
    for name, buf, tol in (("mu", ts.mu, mu_tol), ("nu", ts.nu, nu_tol)):
        got = dict(tckpt.leaves_with_paths(ts.tree(buf)))
        for p, v in _leaves(getattr(adam, name)).items():
            scale = np.abs(v).max()
            assert np.abs(got[p].numpy() - v).max() <= tol * scale + 1e-30, \
                (name, p)
    assert ts.count == int(adam.count)
    if tcfg_kw.get("lr_anneal_steps", 25000):
        assert ts.sched_count == int(js.opt_state[2].count)
    assert ts.step == int(js.step)


def _assert_terms(jm, tm):
    for k in ("loss", "mse_xy", "mse_xz", "mse_yz"):
        want = np.asarray(jm[k])
        np.testing.assert_allclose(tm[k].numpy(), want, rtol=1e-5, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_train_step_matches_jax(steps_per_call, tmp_path):
    jcfg, tucfg, params, batch, tables = _setup()
    kw = dict(lr=5e-4, lr_anneal_steps=1000, ema_rates=(0.9, 0.5),
              batch_size=B, steps_per_call=steps_per_call)
    key = jax.random.PRNGKey(7)
    js0 = _warm_jax_state(jcfg, kw, params, tmp_path / "opt.pt")
    js, jm, draws = _jax_step(jcfg, kw, params, batch, key, state=js0)
    ts, step = _port(params, kw, tables, tucfg, tmp_path / "opt.pt")
    tm = step(ts, TT(*map(torch.from_numpy, batch)), 0,
              inputs=_inputs(draws))
    assert len(draws) == steps_per_call
    _assert_terms(jm, tm)
    np.testing.assert_array_equal(tm["t"].numpy(), np.asarray(jm["t"]))
    assert bool(tm["skipped"]) is False
    _assert_state(js, ts, kw)


def test_nan_guard_step_matches_jax(tmp_path):
    """A normal step, then one on a batch holding a NaN: the params stay,
    mu and nu decay, both counts advance and the EMA moves toward the kept
    params, as in JAX."""
    jcfg, tucfg, params, batch, tables = _setup(1)
    kw = dict(lr=5e-4, lr_anneal_steps=1000, ema_rates=(0.9, 0.5),
              batch_size=B, steps_per_call=1)
    key = jax.random.PRNGKey(3)
    js0 = _warm_jax_state(jcfg, kw, params, tmp_path / "opt.pt", seed=1)
    js1, _, d1 = _jax_step(jcfg, kw, params, batch, key, state=js0)
    bad = [b.copy() for b in batch]
    bad[0][0, 0, 0, 0] = np.nan
    js2, jm, d2 = _jax_step(jcfg, kw, params, bad, jax.random.PRNGKey(4),
                            state=js1)
    assert bool(jm["skipped"])
    ts, step = _port(params, kw, tables, tucfg, tmp_path / "opt.pt")
    step(ts, TT(*map(torch.from_numpy, batch)), 0, inputs=_inputs(d1))
    mu1, nu1, p1 = ts.mu.clone(), ts.nu.clone(), ts.flat.clone()
    ema1 = ts.ema[0].clone()
    tm = step(ts, TT(*map(torch.from_numpy, bad)), 0, inputs=_inputs(d2))
    assert bool(tm["skipped"]) and not torch.isfinite(tm["grad_norm"])
    assert torch.equal(ts.flat, p1)
    torch.testing.assert_close(ts.mu, mu1 * 0.9, rtol=1e-6, atol=0)
    torch.testing.assert_close(ts.nu, nu1 * 0.999, rtol=1e-6, atol=0)
    torch.testing.assert_close(ts.ema[0], ema1 * 0.9 + p1 * 0.1, rtol=1e-6,
                               atol=1e-7)
    assert (ts.count, ts.sched_count, ts.step) == (WARM + 2,) * 3
    _assert_state(js2, ts, kw)


def test_loss_aware_sampler_state_after_3_steps(tmp_path):
    jcfg, tucfg, params, batch, tables = _setup(2)
    kw = dict(lr=5e-4, lr_anneal_steps=1000, batch_size=B,
              schedule_sampler="loss-second-moment")
    js0 = _warm_jax_state(jcfg, kw, params, tmp_path / "opt.pt", seed=2)
    js, jm, draws = _jax_step(jcfg, kw, params, batch,
                              jax.random.PRNGKey(10), n_calls=3, state=js0)
    ts, step = _port(params, kw, tables, tucfg, tmp_path / "opt.pt")
    tb = TT(*map(torch.from_numpy, batch))
    for d in draws:
        tm = step(ts, tb, 0, inputs=_inputs([d]))
    np.testing.assert_allclose(tm["loss_w"].numpy(),
                               np.asarray(jm["loss_w"]), rtol=1e-5)
    ss = js.sampler_state
    np.testing.assert_array_equal(ts.sampler_state.counts.numpy(),
                                  np.asarray(ss.counts))
    np.testing.assert_allclose(ts.sampler_state.history.numpy(),
                               np.asarray(ss.history), rtol=1e-5, atol=0)
    assert int(np.asarray(ss.counts).sum()) == 3 * B
    _assert_state(js, ts, kw)


@pytest.mark.parametrize("count", [0, 5, 10, 15])
def test_lr_anneal_matches_optax(count):
    """One update at schedule count k (0, mid-run, the end, past it) with
    unit grads on a fresh state: the step is -lr(k) up to eps."""
    kw = dict(lr=5e-4, lr_anneal_steps=10)
    p = {"w": jnp.zeros((3,), jnp.float32)}
    opt = JD.make_optimizer(JD.DiffusionTrainerConfig(**kw))
    st = opt.init(p)
    st = (st[0], st[1], st[2]._replace(count=jnp.asarray(count, jnp.int32)))
    upd, _ = opt.update({"w": jnp.ones((3,))}, st, p)
    want = np.asarray(upd["w"])

    state = TD.init_train_state({"w": torch.zeros(3)},
                                TD.DiffusionTrainerConfig(**kw), T)
    state.sched_count = count
    TD.apply_grads(state, torch.ones(3), TD.DiffusionTrainerConfig(**kw))
    np.testing.assert_allclose(state.flat.numpy(), want, rtol=1e-6, atol=0)
    assert state.sched_count == count + 1
    lr = TD.learning_rate(TD.DiffusionTrainerConfig(**kw), count)
    assert lr == np.float32(5e-4) * (np.float32(1)
                                     - min(np.float32(count) / 10, 1))
