"""Port parity of masked generation (`--inpaint`): `region_keep_masks`,
the y0/mask blend of `ddim_sample_step` and the DDIM loop against the
JAX package, and the CLI's refusals.  Same numpy inputs, noise and toy
model on both sides (`test_torch_port_diffusion.py`); fp32 on the CPU,
tolerance 2e-5.  The CLI drive on the committed tag is in
`test_torch_port_sample.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.diffusion import gaussian as jg
from sin3dm_tpu.diffusion import sampling as js
from sin3dm_tpu_torch.cli import sample as cli
from sin3dm_tpu_torch.diffusion import gaussian as tg
from sin3dm_tpu_torch.diffusion import sampling as ts

from test_torch_port_diffusion import (C, SIZES, _cfgs, _jmodel, _jt,
                                       _planes, _tables, _tmodel, _tt)
from test_torch_port_sample import _argv

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
REGIONS = [
    (0.0, 0.5, 0.0, 1.0, 0.0, 1.0),      # half of H, all of W and D
    (0.25, 0.75, 0.1, 0.9, 0.0, 1.0),    # spans D only: xy cells go
    (0.2, 0.55, 0.0, 1.0, 0.3, 0.7),     # spans W only: xz cells go
    (0.0, 1.0, 0.45, 0.5, 0.5, 1.0),     # spans H only; x.5 roundings
    (0.1, 0.2, 0.1, 0.2, 0.1, 0.2),      # spans nothing: all kept
]


def _assert_tp(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("sizes", [(11, 16, 11), (92, 128, 92), (5, 6, 7)])
@pytest.mark.parametrize("region", REGIONS)
def test_region_keep_masks_equal_jax(sizes, region):
    want = js.region_keep_masks(sizes, region)
    got = ts.region_keep_masks(sizes, region)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _masked_inputs(rng, region=REGIONS[1]):
    y0 = [p[:1] for p in _planes(rng, 1)]
    return y0, ts.region_keep_masks(SIZES, region), \
        js.region_keep_masks(SIZES, region)


@pytest.mark.parametrize("is_mask_t0", [False, True])
@pytest.mark.parametrize("t", [[7, 3], [0, 0]])
def test_masked_ddim_step_matches_jax(t, is_mask_t0):
    rng = np.random.default_rng(3)
    jt, tt = _tables("ddim10")
    jc, tc, out_ch = _cfgs(jg.MeanType.START_X, jg.VarType.FIXED_LARGE)
    x, noise = _planes(rng, 2), _planes(rng, 2)
    y0, tmask, jmask = _masked_inputs(rng)
    t = np.array(t, np.int64)
    want = jg.ddim_sample_step(_jmodel(out_ch), jt, jc, _jt(x),
                               jnp.asarray(t, jnp.int32), None, eta=0.5,
                               y0=_jt(y0), mask=jmask, is_mask_t0=is_mask_t0,
                               noise=_jt(noise))
    got = tg.ddim_sample_step(_tmodel(out_ch), tt, tc, _tt(x),
                              torch.from_numpy(t), _tt(noise), eta=0.5,
                              y0=_tt(y0), mask=tmask, is_mask_t0=is_mask_t0)
    _assert_tp(got, want)


@pytest.mark.parametrize("is_mask_t0", [False, True])
def test_masked_ddim_loop_matches_jax(is_mask_t0):
    rng = np.random.default_rng(4)
    jt, tt = _tables("ddim10")
    jc, tc, out_ch = _cfgs(jg.MeanType.START_X, jg.VarType.FIXED_LARGE)
    noise = _planes(rng, 2)
    y0, tmask, jmask = _masked_inputs(rng, REGIONS[0])
    want = js.ddim_sample_loop(_jmodel(out_ch), jt, jc,
                               jax.random.PRNGKey(0), 2, C, SIZES,
                               noise=_jt(noise), eta=0.0, y0=_jt(y0),
                               mask=jmask, is_mask_t0=is_mask_t0)
    got = ts.ddim_sample_loop(_tmodel(out_ch), tt, tc, None, 2, C, SIZES,
                              noise=_tt(noise), eta=0.0, device="cpu",
                              y0=_tt(y0), mask=tmask, is_mask_t0=is_mask_t0)
    _assert_tp(got, want)


def test_keep_all_mask_reproduces_y0():
    """mask = 1 everywhere with `is_mask_t0`: every step's pred_xstart is
    y0, and the last step (alpha_bar_prev = 1) returns it."""
    rng = np.random.default_rng(5)
    _, tt = _tables("ddim10")
    _, tc, out_ch = _cfgs(jg.MeanType.START_X, jg.VarType.FIXED_LARGE)
    y0 = _tt([p[:1] for p in _planes(rng, 1)])
    keep = ts.region_keep_masks(SIZES, REGIONS[4])
    assert all(bool((m == 1).all()) for m in keep)
    sample = ts.make_sampler(_tmodel(out_ch), tt, tc, use_ddim=True,
                             eta=0.3, device="cpu", y0=y0, mask=keep,
                             is_mask_t0=True)
    for got, want in zip(sample(0, 0, 2, C, SIZES), y0):
        torch.testing.assert_close(got, want.expand_as(got), rtol=0,
                                   atol=1e-6)


def test_masks_need_ddim():
    _, tt = _tables()
    _, tc, out_ch = _cfgs(jg.MeanType.START_X, jg.VarType.FIXED_LARGE)
    with pytest.raises(ValueError, match="requires use_ddim"):
        ts.make_sampler(_tmodel(out_ch), tt, tc, use_ddim=False,
                        device="cpu",
                        mask=ts.region_keep_masks(SIZES, REGIONS[0]))


@pytest.mark.parametrize("extra,match", [
    (["--use_ddim", "false"], "requires --use_ddim"),
    ([], "does not combine with --resize"),   # y0 92x128x92, target 11x16x11
])
def test_cli_inpaint_refusals(tmp_path, extra, match):
    with pytest.raises(ValueError, match=match):
        cli.main(_argv(tmp_path, "--inpaint", "true", *extra))
    assert not any(tmp_path.iterdir())
