"""Port parity: guidance (`condition_mean`, `condition_score`, `cond_fn=`
on both sampling steps), DDIM inversion (`ddim_reverse_step`), the bpd
loop (`calc_bpd_loop`) and the progressive sampling loops, against the
JAX package with its toy model (`tanh`), as `tests/test_guidance_bpd.py`
and `tests/test_diffusion_math.py` hold JAX.

Both sides get the same numpy inputs and noise (the bpd loop JAX's own
per-t draws, `randn_like(fold_in(key, t), x)`); fp32 on the CPU,
tolerance 1e-5 of each plane's scale (the bpd loop's decoder NLL term
1e-3 relative, see NLL_REL).  The port's own invariants (a zero
guidance gradient, the last snapshot) hold bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.core.triplane import randn_like as jrandn_like
from sin3dm_tpu.diffusion import gaussian as jg
from sin3dm_tpu.diffusion import sampling as js
from sin3dm_tpu.diffusion.schedule import make_schedule
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.diffusion import gaussian as tg
from sin3dm_tpu_torch.diffusion import sampling as ts

torch.set_num_threads(2)
REL = 1e-5
SIZES = (8, 6, 4)
C = 4


def _tables(steps=50, respacing=""):
    np_tables = make_schedule("linear", steps, respacing).tables_f32()
    return ({k: jnp.asarray(v) for k, v in np_tables.items()},
            tg.tables_to_device(np_tables, "cpu"))


def _cfgs(steps):
    return (jg.DiffusionConfig(original_num_steps=steps),
            tg.DiffusionConfig(original_num_steps=steps))


def _jmodel(x, t):
    return x.map(jnp.tanh)


def _tmodel(x, t):
    return x.map(torch.tanh)


def _planes(seed, B, scale=1.0):
    rng = np.random.default_rng(seed)
    H, W, D = SIZES
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in ((B, H, W, C), (B, H, D, C), (B, W, D, C))]


def _jt(p):
    return JT(*[jnp.asarray(a) for a in p])


def _tt(p):
    return TT(*[torch.from_numpy(np.array(a)) for a in p])


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy() if hasattr(g, "numpy") else np.asarray(g)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= REL * max(np.abs(w).max(), 1.0)


def _equal(a, b):
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def _cond_fns(y):
    """grad log p(y | x) of a Gaussian around the planes y, scale 0.3."""
    jy, ty = _jt(y), _tt(y)
    return ((lambda x, t: (jy - x).map(lambda p: 0.3 * p)),
            (lambda x, t: (ty - x).map(lambda p: 0.3 * p)))


@pytest.mark.parametrize("t", [0, 20, 49])
def test_condition_mean_and_score(t):
    jt, tt = _tables()
    jc, tc = _cfgs(50)
    x, y = _planes(0, 2), _planes(1, 2, 0.5)
    jcond, tcond = _cond_fns(y)
    tb = np.full(2, t, np.int64)
    jout = jg.p_mean_variance(_jmodel, jt, jc, _jt(x),
                              jnp.asarray(tb, jnp.int32))
    tout = tg.p_mean_variance(_tmodel, tt, tc, _tt(x), torch.from_numpy(tb))
    _close(tg.condition_mean(tcond, tt, tc, tout, _tt(x),
                             torch.from_numpy(tb)),
           jg.condition_mean(jcond, jt, jc, jout, _jt(x),
                             jnp.asarray(tb, jnp.int32)))
    got = tg.condition_score(tcond, tt, tc, tout, _tt(x),
                             torch.from_numpy(tb))
    want = jg.condition_score(jcond, jt, jc, jout, _jt(x),
                              jnp.asarray(tb, jnp.int32))
    _close(got.pred_xstart, want.pred_xstart)
    _close(got.mean, want.mean)
    _close(got.log_variance, want.log_variance)


@pytest.mark.parametrize("kind", ["p", "ddim eta 0", "ddim eta 0.5"])
def test_guided_steps(kind):
    steps, respacing = (50, "") if kind == "p" else (100, "ddim10")
    jt, tt = _tables(steps, respacing)
    jc, tc = _cfgs(steps)
    x, y, noise = _planes(2, 2), _planes(3, 2, 0.5), _planes(4, 2)
    jcond, tcond = _cond_fns(y)
    tb = np.array([7, 0], np.int64)
    jtb = jnp.asarray(tb, jnp.int32)
    if kind == "p":
        want = jg.p_sample_step(_jmodel, jt, jc, _jt(x), jtb, None,
                                cond_fn=jcond, noise=_jt(noise))
        got = tg.p_sample_step(_tmodel, tt, tc, _tt(x),
                               torch.from_numpy(tb), _tt(noise),
                               cond_fn=tcond)
    else:
        eta = float(kind.split()[-1])
        want = jg.ddim_sample_step(_jmodel, jt, jc, _jt(x), jtb, None,
                                   eta=eta, cond_fn=jcond, noise=_jt(noise))
        got = tg.ddim_sample_step(_tmodel, tt, tc, _tt(x),
                                  torch.from_numpy(tb), _tt(noise), eta=eta,
                                  cond_fn=tcond)
    _close(got, want)


def test_zero_guidance_is_the_unguided_step_bit_for_bit():
    """A cond_fn of zeros changes nothing, through condition_mean (DDPM)
    and condition_score (DDIM)."""
    def zeros(x, t):
        return x.map(torch.zeros_like)
    for steps, respacing in ((50, ""), (100, "ddim10")):
        _, tt = _tables(steps, respacing)
        _, tc = _cfgs(steps)
        x, noise = _tt(_planes(5, 2)), _tt(_planes(6, 2))
        t = torch.tensor([9, 0])
        if respacing:
            _equal(tg.ddim_sample_step(_tmodel, tt, tc, x, t, None,
                                       cond_fn=zeros),
                   tg.ddim_sample_step(_tmodel, tt, tc, x, t, None))
        else:
            _equal(tg.p_sample_step(_tmodel, tt, tc, x, t, noise,
                                    cond_fn=zeros),
                   tg.p_sample_step(_tmodel, tt, tc, x, t, noise))


@pytest.mark.parametrize("clip", [True, False])
def test_ddim_reverse_step(clip):
    jt, tt = _tables(100, "ddim10")
    jc, tc = _cfgs(100)
    x = _planes(7, 2)
    tb = np.array([0, 6], np.int64)
    want = jg.ddim_reverse_step(_jmodel, jt, jc, _jt(x),
                                jnp.asarray(tb, jnp.int32),
                                clip_denoised=clip)
    got = tg.ddim_reverse_step(_tmodel, tt, tc, _tt(x), torch.from_numpy(tb),
                               clip_denoised=clip)
    _close(got, want)


# the t = 0 term is the decoder NLL: the log of cdf(x + 1/255) -
# cdf(x - 1/255), two values near each other that each framework's tanh
# and exp round to within an ulp (6e-8): their difference, of 1e-3 to
# 1e-2 at t = 0's scale, carries 1e-5 to 1e-4 of itself into the log, so
# that column (and total_bpd, which sums it) is held to 1e-3 relative
NLL_REL = 1e-3


def test_calc_bpd_loop_with_jax_draws():
    T = 20
    jt, tt = _tables(T)
    jc, tc = _cfgs(T)
    x0 = [np.tanh(p) for p in _planes(8, 2)]
    key = jax.random.PRNGKey(1)
    want = jg.calc_bpd_loop(_jmodel, jt, jc, _jt(x0), key)
    draws = {t: [np.asarray(p) for p in
                 jrandn_like(jax.random.fold_in(key, t), _jt(x0))]
             for t in range(T)}
    got = tg.calc_bpd_loop(_tmodel, tt, tc, _tt(x0),
                           noise=lambda t: _tt(draws[t]))
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape, k
        if k == "vb":   # columns t = T-1 .. 1, then t = 0
            np.testing.assert_allclose(g[:, :-1], w[:, :-1], rtol=REL,
                                       atol=REL * np.abs(w).max())
            g, w = g[:, -1], w[:, -1]
        rel = NLL_REL if k in ("vb", "total_bpd") else REL
        np.testing.assert_allclose(g, w, rtol=rel,
                                   atol=REL * np.nanmax(np.abs(w)),
                                   err_msg=k)


def test_calc_bpd_loop_from_a_seed():
    """Without injected noise: one draw per t from
    `step_generator(seed, t)`; the same seed gives the same bound, and
    total = sum(vb) + prior."""
    T = 20
    _, tt = _tables(T)
    _, tc = _cfgs(T)
    x0 = _tt([np.tanh(p) for p in _planes(9, 2)])
    a = tg.calc_bpd_loop(_tmodel, tt, tc, x0, seed=3)
    b = tg.calc_bpd_loop(_tmodel, tt, tc, x0, seed=3)
    assert a["vb"].shape == a["mse"].shape == (2, T)
    assert a["total_bpd"].shape == a["prior_bpd"].shape == (2,)
    torch.testing.assert_close(a["total_bpd"], b["total_bpd"], rtol=0,
                               atol=0)
    torch.testing.assert_close(a["total_bpd"],
                               a["vb"].sum(dim=1) + a["prior_bpd"])
    with pytest.raises(ValueError, match="seed or noise"):
        tg.calc_bpd_loop(_tmodel, tt, tc, x0)


@pytest.mark.parametrize("snapshot_every,n_expected",
                         [(1, 20), (7, 3), (50, 1)])
def test_p_sample_loop_progressive_last_is_the_loop(snapshot_every,
                                                    n_expected):
    _, tt = _tables(20)
    _, tc = _cfgs(20)
    final = ts.p_sample_loop(_tmodel, tt, tc,
                             ts.sample_generators(4, 0, 2, "cpu"), 2, C,
                             SIZES, device="cpu")
    snaps = ts.p_sample_loop_progressive(
        _tmodel, tt, tc, ts.sample_generators(4, 0, 2, "cpu"), 2, C, SIZES,
        device="cpu", snapshot_every=snapshot_every)
    assert snaps.xy.shape == (n_expected, 2) + final.xy.shape[1:]
    _equal(snaps.map(lambda p: p[-1]), final)


@pytest.mark.parametrize("masked", [False, True])
def test_ddim_sample_loop_progressive_equals_jax(masked):
    """Snapshots every 3 of 10 DDIM steps (a ragged tail of 1) from the
    same initial noise: each equals JAX's, the last the port's plain
    loop bit for bit; masked generation carried over."""
    jt, tt = _tables(100, "ddim10")
    jc, tc = _cfgs(100)
    x_T = _planes(10, 2)
    kw_j, kw_t = {}, {}
    if masked:
        y0 = _planes(11, 1, 0.5)
        jm = js.region_keep_masks(SIZES, (0, 0.5, 0, 1, 0, 1))
        tm = ts.region_keep_masks(SIZES, (0, 0.5, 0, 1, 0, 1))
        kw_j = dict(y0=_jt(y0), mask=jm, is_mask_t0=True)
        kw_t = dict(y0=_tt(y0), mask=tm, is_mask_t0=True)
    want = js.ddim_sample_loop_progressive(
        _jmodel, jt, jc, jax.random.PRNGKey(0), 2, C, SIZES,
        noise=_jt(x_T), snapshot_every=3, **kw_j)
    got = ts.ddim_sample_loop_progressive(
        _tmodel, tt, tc, None, 2, C, SIZES, noise=_tt(x_T), device="cpu",
        snapshot_every=3, **kw_t)
    assert got.xy.shape[0] == want.xy.shape[0] == 4
    for s in range(4):
        _close(got.map(lambda p: p[s]), want.map(lambda p: p[s]))
    final = ts.ddim_sample_loop(_tmodel, tt, tc, None, 2, C, SIZES,
                                noise=_tt(x_T), device="cpu", **kw_t)
    _equal(got.map(lambda p: p[-1]), final)
