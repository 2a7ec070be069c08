"""Port parity: schedule tables, sampling steps and the DDIM loop.

Both sides get the same numpy inputs and noise and the same toy model
(an affine function of x_t and t, written once per framework); fp32 on
the CPU, tolerance 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.diffusion import gaussian as jg
from sin3dm_tpu.diffusion import sampling as js
from sin3dm_tpu.diffusion import schedule as jsched
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.diffusion import gaussian as tg
from sin3dm_tpu_torch.diffusion import sampling as ts
from sin3dm_tpu_torch.diffusion import schedule as tsched

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
SIZES = (6, 5, 4)
C = 3


def _planes(rng, B, channels=C):
    H, W, D = SIZES
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, W, channels), (B, H, D, channels),
                      (B, W, D, channels))]


def _jt(p):
    return JT(*[jnp.asarray(a) for a in p])


def _tt(p):
    return TT(*[torch.from_numpy(a) for a in p])


def _assert_tp(got: TT, want: JT, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **(tol or TOL))


def _jmodel(out_ch):
    def f(x, t):
        s = 0.9 - 0.0004 * t.astype(jnp.float32)
        return x.map(lambda p: jnp.tile(
            p * s[:, None, None, None] + 0.05, (1, 1, 1, out_ch // C)))
    return f


def _tmodel(out_ch):
    def f(x, t):
        s = 0.9 - 0.0004 * t.float()
        return x.map(lambda p: (p * s[:, None, None, None] + 0.05).repeat(
            1, 1, 1, out_ch // C))
    return f


def _tables(respacing=""):
    sched = jsched.make_schedule("linear", 100, respacing)
    np_tables = sched.tables_f32()
    return ({k: jnp.asarray(v) for k, v in np_tables.items()},
            tg.tables_to_device(np_tables, "cpu"))


@pytest.mark.parametrize("name,respacing", [("linear", ""), ("cosine", ""),
                                            ("linear", "ddim10"),
                                            ("linear", "10,5")])
def test_schedule_tables_equal(name, respacing):
    want = jsched.make_schedule(name, 100, respacing).tables_f32()
    got = tsched.make_schedule(name, 100, respacing).tables_f32()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tsched.space_timesteps(1000, "ddim50") == \
        jsched.space_timesteps(1000, "ddim50")


VAR_CASES = [
    (jg.MeanType.START_X, jg.VarType.FIXED_LARGE, True),
    (jg.MeanType.EPSILON, jg.VarType.FIXED_SMALL, False),
    (jg.MeanType.START_X, jg.VarType.LEARNED_RANGE, True),
    (jg.MeanType.EPSILON, jg.VarType.FIXED_LARGE, True),
]


def _cfgs(mean, var):
    jc = jg.DiffusionConfig(mean_type=mean, var_type=var)
    tc = tg.DiffusionConfig(mean_type=tg.MeanType(mean.value),
                            var_type=tg.VarType(var.value))
    out_ch = C * (2 if var == jg.VarType.LEARNED_RANGE else 1)
    return jc, tc, out_ch


@pytest.mark.parametrize("mean,var,clip", VAR_CASES)
def test_p_sample_step(mean, var, clip):
    rng = np.random.default_rng(0)
    jt, tt = _tables()
    jc, tc, out_ch = _cfgs(mean, var)
    x, noise = _planes(rng, 2), _planes(rng, 2)
    t = np.array([37, 0], np.int64)
    want = jg.p_sample_step(_jmodel(out_ch), jt, jc, _jt(x),
                            jnp.asarray(t, jnp.int32), None,
                            clip_denoised=clip, noise=_jt(noise))
    got = tg.p_sample_step(_tmodel(out_ch), tt, tc, _tt(x),
                           torch.from_numpy(t), _tt(noise),
                           clip_denoised=clip)
    _assert_tp(got, want)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("mean,var,clip", VAR_CASES[:2])
def test_ddim_sample_step(mean, var, clip, eta):
    rng = np.random.default_rng(1)
    jt, tt = _tables("ddim10")
    jc, tc, out_ch = _cfgs(mean, var)
    x, noise = _planes(rng, 2), _planes(rng, 2)
    t = np.array([7, 3], np.int64)
    want = jg.ddim_sample_step(_jmodel(out_ch), jt, jc, _jt(x),
                               jnp.asarray(t, jnp.int32), None, eta=eta,
                               clip_denoised=clip, noise=_jt(noise))
    got = tg.ddim_sample_step(_tmodel(out_ch), tt, tc, _tt(x),
                              torch.from_numpy(t), _tt(noise), eta=eta,
                              clip_denoised=clip)
    _assert_tp(got, want)


def test_ddim_sample_loop_10_steps():
    rng = np.random.default_rng(2)
    jt, tt = _tables("ddim10")
    jc, tc, out_ch = _cfgs(jg.MeanType.START_X, jg.VarType.FIXED_LARGE)
    noise = _planes(rng, 2)
    # with eta 0 the JAX loop's key only feeds step noise that is
    # multiplied by sigma = 0
    want = js.ddim_sample_loop(_jmodel(out_ch), jt, jc,
                               jax.random.PRNGKey(0), 2, C, SIZES,
                               noise=_jt(noise), eta=0.0)
    got = ts.ddim_sample_loop(_tmodel(out_ch), tt, tc, None, 2, C, SIZES,
                              noise=_tt(noise), eta=0.0, device="cpu")
    _assert_tp(got, want)


def test_sample_depends_only_on_seed_and_index():
    """Sample j is the same whatever batch it is drawn in."""
    _, tt = _tables("ddim10")
    _, tc, out_ch = _cfgs(jg.MeanType.START_X, jg.VarType.FIXED_LARGE)
    for use_ddim in (True, False):
        sample = ts.make_sampler(_tmodel(out_ch), tt, tc, use_ddim=use_ddim,
                                 eta=0.3, device="cpu")
        both = sample(5, 0, 2, C, SIZES)
        alone = sample(5, 1, 1, C, SIZES)
        other_seed = sample(6, 1, 1, C, SIZES)
        for b, a, o in zip(both, alone, other_seed):
            torch.testing.assert_close(b[1:], a, rtol=0, atol=0)
            assert not torch.equal(b[1:], o)
