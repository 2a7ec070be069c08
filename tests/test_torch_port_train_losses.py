"""Port parity: the training half of `diffusion/gaussian.py` against the
JAX package on the same numpy inputs.

`q_sample`; `training_losses` over {MSE, RESCALED_MSE} x {START_X,
EPSILON, PREVIOUS_X} x {fixed, learned-range variance}, with the noise
JAX draws from its key handed to the port, loss terms within 1e-5
relative, and with a learned variance the grads of the mean loss
within 1e-4 of the largest (the mean half detached, as JAX's
stop_gradient); `vb_terms_bpd`, `prior_bpd`, `normal_kl` and
`discretized_gaussian_log_likelihood`; KL kinds raise.

The model is a per-plane linear map with a timestep-dependent bias, the
same numpy weights on both sides.

The discretized likelihood (the vb term at t = 0) takes the log of a
difference of two approximate normal CDFs, 0.5 (1 + tanh(.)): XLA's CPU
tanh errs by up to 2.83e-7 absolute, torch's by 3.2e-8 (measured on 1e6
uniform draws in [-5, 5] against float64), so each log(p) may differ by
(2 x 0.5 x 3.2e-7) / p <= 4e-7 / p, p computed in float64; those terms
are held to that bound, and the loss tests draw t >= 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.core.triplane import randn_like as jrandn_like
from sin3dm_tpu.diffusion import gaussian as jg
from sin3dm_tpu.diffusion.schedule import make_schedule
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.diffusion import gaussian as tg

torch.set_num_threads(2)
C, B, T = 4, 3, 40
SHAPES = ((B, 6, 5, C), (B, 6, 4, C), (B, 5, 4, C))
REL = 1e-5


def _tables():
    np_t = make_schedule("linear", T).tables_f32()
    return ({k: jnp.asarray(v) for k, v in np_t.items()},
            tg.tables_to_device(np_t, "cpu"))


def _data(seed, t0=1):
    rng = np.random.default_rng(seed)
    x0 = [np.tanh(rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
    t = np.array([t0, 7, T - 1], np.int64)
    return x0, t


def _log_p(x, means, log_scales):
    """float64 probabilities whose logs the discretized likelihood takes,
    and the bound 4e-7 / p on each log's difference (module doc)."""
    x, m, ls = (np.asarray(a, np.float64) for a in (x, means, log_scales))
    def cdf(v):
        return 0.5 * (1.0 + np.tanh(np.sqrt(2.0 / np.pi)
                                    * (v + 0.044715 * v ** 3)))
    inv = np.exp(-ls)
    cp, cm = cdf(inv * (x - m + 1 / 255)), cdf(inv * (x - m - 1 / 255))
    p = np.where(x < -0.999, cp, np.where(x > 0.999, 1 - cm, cp - cm))
    return 4e-7 / np.maximum(p, 1e-12)


def _models(seed, cout):
    """(jax model, torch model, torch weight leaf) of out = x @ W + t/T."""
    rng = np.random.default_rng(seed)
    W = (0.5 * rng.standard_normal((C, cout))).astype(np.float32)

    def jmodel(x, tt, w=jnp.asarray(W)):
        bias = (tt.astype(jnp.float32) / T)[:, None, None, None]
        return x.map(lambda p: jnp.tanh(p @ w + bias))

    tw = torch.tensor(W, requires_grad=True)

    def tmodel(x, tt):
        bias = (tt.float() / T)[:, None, None, None]
        return x.map(lambda p: torch.tanh(p @ tw + bias))
    return jmodel, tmodel, tw, W


def _close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


def test_q_sample_and_q_mean_variance():
    jt, tt = _tables()
    x0, t = _data(0)
    noise = [np.random.default_rng(1).standard_normal(s).astype(np.float32)
             for s in SHAPES]
    want = jg.q_sample(jt, JT(*map(jnp.asarray, x0)), jnp.asarray(t),
                       JT(*map(jnp.asarray, noise)))
    got = tg.q_sample(tt, TT(*map(torch.from_numpy, x0)),
                      torch.from_numpy(t), TT(*map(torch.from_numpy, noise)))
    for g, w in zip(got, want):
        _close(g, w)
    for g3, w3 in zip(tg.q_mean_variance(tt, TT(*map(torch.from_numpy, x0)),
                                         torch.from_numpy(t)),
                      jg.q_mean_variance(jt, JT(*map(jnp.asarray, x0)),
                                         jnp.asarray(t))):
        for g, w in zip(g3, w3):
            _close(g, w)


@pytest.mark.parametrize("learned", [False, True])
@pytest.mark.parametrize("mean", ["start_x", "epsilon", "previous_x"])
@pytest.mark.parametrize("loss", ["mse", "rescaled_mse"])
def test_training_losses_match_jax(loss, mean, learned):
    var = "learned_range" if learned else "fixed_large"
    jc = jg.DiffusionConfig(mean_type=jg.MeanType(mean),
                            var_type=jg.VarType(var),
                            loss_kind=jg.LossKind(loss), original_num_steps=T)
    tc = tg.DiffusionConfig(mean_type=tg.MeanType(mean),
                            var_type=tg.VarType(var),
                            loss_kind=tg.LossKind(loss), original_num_steps=T)
    jt, tt = _tables()
    x0, t = _data(2)
    jmodel, tmodel, tw, W = _models(3, 2 * C if learned else C)
    key = jax.random.PRNGKey(5)
    jx0 = JT(*map(jnp.asarray, x0))
    noise = jrandn_like(key, jx0)              # what JAX draws from `key`

    def jloss(w):
        terms = jg.training_losses(lambda x, s: jmodel(x, s, w), jt, jc,
                                   jx0, jnp.asarray(t), key)
        return terms["loss"].mean(), terms
    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(W))
    got = tg.training_losses(tmodel, tt, tc, TT(*map(torch.from_numpy, x0)),
                             torch.from_numpy(t),
                             TT(*[torch.tensor(np.asarray(n))
                                  for n in noise]))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    g, = torch.autograd.grad(got["loss"].mean(), [tw])
    jgrad = np.asarray(jgrad)
    assert np.abs(g.numpy() - jgrad).max() <= 1e-4 * np.abs(jgrad).max()


@pytest.mark.parametrize("kind", ["kl", "rescaled_kl"])
def test_kl_losses_raise(kind):
    _, tt = _tables()
    x0, t = _data(0)
    x = TT(*map(torch.from_numpy, x0))
    with pytest.raises(NotImplementedError):
        tg.training_losses(lambda a, s: a, tt,
                           tg.DiffusionConfig(loss_kind=tg.LossKind(kind)),
                           x, torch.from_numpy(t), x)


@pytest.mark.parametrize("clip", [True, False])
def test_vb_terms_and_prior_bpd_match_jax(clip):
    jc = jg.DiffusionConfig(var_type=jg.VarType.LEARNED_RANGE,
                            original_num_steps=T)
    tc = tg.DiffusionConfig(var_type=tg.VarType.LEARNED_RANGE,
                            original_num_steps=T)
    jt, tt = _tables()
    x0, t = _data(4, t0=0)
    rng = np.random.default_rng(6)
    xt = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jmodel, tmodel, _, _ = _models(7, 2 * C)
    want = jg.vb_terms_bpd(jmodel, jt, jc, JT(*map(jnp.asarray, x0)),
                           JT(*map(jnp.asarray, xt)), jnp.asarray(t), clip)
    with torch.no_grad():
        got = tg.vb_terms_bpd(tmodel, tt, tc, TT(*map(torch.from_numpy, x0)),
                              TT(*map(torch.from_numpy, xt)),
                              torch.from_numpy(t), clip)
    # t = 0 (row 0) is the decoder NLL: its bound is the mean of the
    # per-element log bounds, in bits; rows 1, 2 are KL terms
    pm = jg.p_mean_variance(jmodel, jt, jc, JT(*map(jnp.asarray, xt)),
                            jnp.asarray(t), clip)
    nll_tol = sum(_log_p(x[0], m[0], 0.5 * np.asarray(lv[0])).sum()
                  for x, m, lv in zip(x0, pm.mean, pm.log_variance))
    nll_tol /= sum(np.prod(s[1:]) for s in SHAPES) * np.log(2.0)
    w = np.asarray(want["output"])
    g = got["output"].numpy()
    assert abs(g[0] - w[0]) <= REL * abs(w[0]) + nll_tol, (g[0], w[0])
    _close(g[1:], w[1:])
    for g, w in zip(got["pred_xstart"], want["pred_xstart"]):
        _close(g, w)
    _close(tg.prior_bpd(tt, TT(*map(torch.from_numpy, x0))),
           jg.prior_bpd(jt, JT(*map(jnp.asarray, x0))))


def test_normal_kl_and_discretized_likelihood_match_jax():
    rng = np.random.default_rng(8)
    a, b, c, d = (rng.standard_normal((4, 33)).astype(np.float32)
                  for _ in range(4))
    _close(tg.normal_kl(*map(torch.from_numpy, (a, b, c, d))),
           jg.normal_kl(*map(jnp.asarray, (a, b, c, d))))
    # x spans the three branches: below -0.999, above 0.999, between
    x = np.concatenate([np.full(3, -1.0), np.full(3, 1.0),
                        rng.uniform(-0.99, 0.99, 26)]).astype(np.float32)
    m = (0.5 * rng.standard_normal(32)).astype(np.float32)
    ls = rng.uniform(-4, 0, 32).astype(np.float32)
    got = tg.discretized_gaussian_log_likelihood(
        torch.from_numpy(x), means=torch.from_numpy(m),
        log_scales=torch.from_numpy(ls)).numpy()
    want = np.asarray(jg.discretized_gaussian_log_likelihood(
        jnp.asarray(x), means=jnp.asarray(m), log_scales=jnp.asarray(ls)))
    assert (np.abs(got - want) <= REL * np.abs(want) + _log_p(x, m, ls)).all()
