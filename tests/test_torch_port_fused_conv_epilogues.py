"""Port parity of K1′, the act/skip/emit_stats forms of K1's plain version
`conv3x3_rollout_reference`, against the JAX package's Pallas kernel
`conv3x3_rollout_fused` (interpret mode on the CPU, `tile_h=4`), and of
the GroupNorm coefficient folds that feed `act=` against `core/nn.py`.

The CUDA kernel runs only on the card: `chip_smoke.py` and
`tests/test_torch_port_cuda.py` hold it against this plain version
there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core import nn as jnn
from sin3dm_tpu.ops.fused_conv import conv3x3_rollout_fused
from sin3dm_tpu_torch.core import nn as tnn
from sin3dm_tpu_torch.ops import fused_conv as tfc
from sin3dm_tpu_torch.ops import pack_params

torch.set_num_threads(2)
F32_TOL = dict(rtol=2e-5, atol=2e-5)   # summation order only
BF16_EPS = 2.0 ** -8                    # bf16 unit roundoff


def _case(seed, B, H, W, C, Co, rollout=True, act=True, skip=False):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    return dict(
        x=f(B, H, W, C), w=f(3, 3, C, Co, scale=(9 * C) ** -0.5),
        b=f(Co, scale=0.1),
        col=[f(B, W, Co, scale=0.3) for _ in range(3)] if rollout else None,
        row=[f(B, H, Co, scale=0.3) for _ in range(3)] if rollout else None,
        act=(1.0 + f(B, C, scale=0.3), f(B, C, scale=0.5)) if act else None,
        skip=f(B, H, W, Co) if skip else None)


def _jax(c, dt, emit_stats=False):
    j = lambda a, d=dt: None if a is None else jnp.asarray(a, d)
    col3 = tuple(j(v) for v in c["col"]) if c["col"] else None
    row3 = tuple(j(v) for v in c["row"]) if c["row"] else None
    act = (tuple(j(a, jnp.float32) for a in c["act"]) if c["act"]
           else None)
    out = conv3x3_rollout_fused(j(c["x"]), jnp.asarray(c["w"]),
                                jnp.asarray(c["b"]), col3, row3, tile_h=4,
                                mxu_dtype=dt, act=act, skip=j(c["skip"]),
                                emit_stats=emit_stats)
    y, s = out if emit_stats else (out, None)
    return (np.asarray(y.astype(jnp.float32)),
            None if s is None else np.asarray(s))


def _port(c, dt, emit_stats=False):
    t = lambda a: None if a is None else torch.from_numpy(a)
    stack = lambda vs: (torch.from_numpy(np.stack(vs, axis=2)).to(dt)
                        if vs else None)
    act = tuple(map(t, c["act"])) if c["act"] else None
    skip = t(c["skip"]).to(dt) if c["skip"] is not None else None
    out = tfc.conv3x3_rollout(t(c["x"]).to(dt), t(c["w"]), t(c["b"]),
                              stack(c["col"]), stack(c["row"]), act, skip,
                              emit_stats)
    y, s = out if emit_stats else (out, None)
    assert y.dtype == dt
    return y.float().numpy(), None if s is None else s.numpy()


def _check_stats(got_s, want_s, got_y, want_y):
    """(sum, sum of squares) per channel: each side sums its own rounded
    y in fp32, so they differ by the y difference summed (plus the
    squares' cross term) and by fp32 summation order (1e-5 of the sum of
    |y| or y^2: a few hundred terms, each side k * 2^-24 at worst)."""
    d = np.abs(got_y.astype(np.float64) - want_y)
    mass = np.stack([np.abs(want_y).sum((1, 2)),
                     (want_y.astype(np.float64) ** 2).sum((1, 2))], 1)
    slack = np.stack([d.sum((1, 2)),
                      (d * (2 * np.abs(want_y) + d)).sum((1, 2))], 1)
    assert got_s.shape == want_s.shape
    assert (np.abs(got_s - want_s) <= slack + 1e-5 * mass + 1e-30).all()


def _check_bf16(got, want, C):
    """The bounds of `test_torch_port_fused_conv.py`: at C <= 128 both
    round the same fp32 sum of the same bf16 activated inputs once (one
    bf16 step where summation order tips the rounding); at C = 192 the
    JAX kernel splits the channels and rounds each partial conv."""
    err = np.abs(got - want)
    scale = np.abs(want).max()
    if C <= 128:
        assert (err <= 2 * BF16_EPS * np.abs(want) + 1e-6 * scale).all()
    else:
        assert err.max() <= 2 * 2 * BF16_EPS * scale
        assert err.mean() <= 0.25 * BF16_EPS * scale


@pytest.mark.parametrize("C", [32, 64, 192])
def test_act_matches_pallas_fp32(C):
    c = _case(0, 2, 9, 13, C, 32)
    np.testing.assert_allclose(_port(c, torch.float32)[0],
                               _jax(c, jnp.float32)[0], **F32_TOL)


@pytest.mark.parametrize("C", [32, 64, 192])
def test_act_matches_pallas_bf16(C):
    c = _case(1, 2, 10, 14, C, 64)
    _check_bf16(_port(c, torch.bfloat16)[0], _jax(c, jnp.bfloat16)[0], C)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_skip_and_stats_match_pallas(dt):
    """skip + emit_stats, no act, no rollout terms (ragged row tiles:
    H = 9 with tile_h = 4)."""
    c = _case(2, 2, 9, 11, 32, 64, rollout=False, act=False, skip=True)
    got_y, got_s = _port(c, getattr(torch, dt), emit_stats=True)
    want_y, want_s = _jax(c, getattr(jnp, dt), emit_stats=True)
    if dt == "float32":
        np.testing.assert_allclose(got_y, want_y, **F32_TOL)
    else:
        _check_bf16(got_y, want_y, 32)
    _check_stats(got_s, want_s, got_y, want_y)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [False, True])
def test_rollout_act_stats_match_pallas(dt, skip):
    """The chained block's two forms: act + stats (in conv) and
    act + skip + stats (out conv), with the rollout terms."""
    c = _case(3, 2, 7, 12, 64, 64, skip=skip)
    got_y, got_s = _port(c, getattr(torch, dt), emit_stats=True)
    want_y, want_s = _jax(c, getattr(jnp, dt), emit_stats=True)
    if dt == "float32":
        np.testing.assert_allclose(got_y, want_y, **F32_TOL)
    else:
        _check_bf16(got_y, want_y, 64)
    _check_stats(got_s, want_s, got_y, want_y)


def test_stats_are_of_the_rounded_output():
    """The kernel re-reads its written (rounded) tile: in bf16 the stats
    equal the fp32 sums of the bf16 output, exactly up to order."""
    c = _case(4, 1, 6, 8, 32, 32, act=False)
    y, s = tfc.conv3x3_rollout_reference(
        torch.from_numpy(c["x"]).bfloat16(), torch.from_numpy(c["w"]),
        emit_stats=True)
    yf = y.float()
    torch.testing.assert_close(s[:, 0], yf.sum((1, 2)))
    torch.testing.assert_close(s[:, 1], (yf * yf).sum((1, 2)))


def _gn_params(rng, C):
    return {"g": (1 + 0.2 * rng.standard_normal(C)).astype(np.float32),
            "b": (0.2 * rng.standard_normal(C)).astype(np.float32)}


@pytest.mark.parametrize("film", [False, True])
def test_group_norm_coeffs_match_jax(film):
    rng = np.random.default_rng(5)
    B, H, W, C = 2, 6, 7, 64
    x = (rng.standard_normal((B, H, W, C)) * 2 + 0.5).astype(np.float32)
    p = _gn_params(rng, C)
    fl = ((0.3 * rng.standard_normal((B, 1, 1, C))).astype(np.float32),
          (0.3 * rng.standard_normal((B, 1, 1, C))).astype(np.float32)
          ) if film else None
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jf = tuple(map(jnp.asarray, fl)) if fl else None
    tf = tuple(map(torch.from_numpy, fl)) if fl else None

    wa, wb = jnn.group_norm32_film_coeffs(jp, jnp.asarray(x), film=jf)
    ga, gb = tnn.group_norm32_film_coeffs(tp, torch.from_numpy(x), film=tf)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-4,
                               atol=1e-4)

    xf = x.astype(np.float64)
    stats = np.stack([xf.sum((1, 2)), (xf * xf).sum((1, 2))], 1).astype(
        np.float32)
    wa, wb = jnn.group_norm32_coeffs_from_sums(jp, jnp.asarray(stats), H * W,
                                               film=jf)
    ga, gb = tnn.group_norm32_coeffs_from_sums(tp, torch.from_numpy(stats),
                                               H * W, film=tf)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-4,
                               atol=1e-4)

    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = jnn.apply_film_coeffs(jnp.asarray(x, jdt), wa, wb)
        got = tnn.apply_film_coeffs(torch.from_numpy(x).to(dt), ga, gb)
        assert got.dtype == dt
        tol = 1e-4 if dt == torch.float32 else 4 * BF16_EPS
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_coeffs_from_sums_clamp_a_negative_variance():
    """A constant group whose E[x^2] - mean^2 rounds below zero gives
    rstd = 1/sqrt(eps), not NaN, as in JAX."""
    C = 32
    p = {"g": np.ones(C, np.float32), "b": np.zeros(C, np.float32)}
    n = 10
    stats = np.zeros((1, 2, C), np.float32)
    stats[0, 0] = 0.1 * n
    stats[0, 1] = np.float32(0.1) ** 2 * n * (1 - 1e-6)
    wa, _ = jnn.group_norm32_coeffs_from_sums(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(stats), n)
    ga, _ = tnn.group_norm32_coeffs_from_sums(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(stats), n)
    assert np.isfinite(ga.numpy()).all()
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-4)


def _unpack_conv(wp, C, Co):
    """[3, 3, C, Co] back from the bf16 kernel's packed weights."""
    n_cc, nine, co_pad, kch = wp.shape
    assert nine == 9 and kch == tfc.KCH and n_cc == -(-C // kch)
    assert co_pad % tfc.block_n(Co) == 0 and co_pad - Co < tfc.block_n(Co)
    full = wp.permute(1, 2, 0, 3).reshape(9, co_pad, n_cc * kch)
    assert not full[:, Co:].any() and not full[:, :, C:].any()   # padding
    return full[:, :Co, :C].transpose(1, 2).reshape(3, 3, C, Co)


@pytest.mark.parametrize("C,Co", [(64, 64), (192, 64), (64, 128),
                                  (128, 128),          # towerruins widths
                                  (12, 20), (33, 70), (8, 8), (65, 129)])
def test_pack_conv_weights_unpacks_exactly(C, Co):
    rng = np.random.default_rng(C * 1000 + Co)
    w = torch.from_numpy(rng.standard_normal((3, 3, C, Co)).astype(
        np.float32))
    wp = tfc.pack_conv_weights(w)
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert torch.equal(_unpack_conv(wp, C, Co), w.bfloat16())
    # a view packs like the tensor it shows (the UNet packs w[:, :, :C])
    wide = torch.cat([w, w], dim=2)
    assert torch.equal(tfc.pack_conv_weights(wide[:, :, :C]), wp)


@pytest.mark.parametrize("C,Co", [(64, 64), (128, 128), (32, 32),
                                  (12, 20)])
def test_whole_conv_pack_holds_its_rollout_slice(C, Co):
    """A rollout conv's weight [3, 3, 3C, Co] is packed whole; K1 reads
    its first ceil(C/64) chunks, where the first C input channels lie as
    in the pack of the slice, and the rest of a partial chunk meets the
    zeros the kernel stages past C."""
    rng = np.random.default_rng(C + Co)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3 * C, Co)).astype(
        np.float32))
    whole = tfc.pack_conv_weights(w)
    own = tfc.pack_conv_weights(w[:, :, :C])
    n_cc = own.shape[0]
    assert whole.shape[1:] == own.shape[1:] and whole.shape[0] >= n_cc
    head = whole[:n_cc].clone()
    rest = n_cc * tfc.KCH - C        # channels C.. of the last chunk
    if rest:
        head[-1, :, :, tfc.KCH - rest:] = 0
    assert torch.equal(head, own)


def test_pack_params_packs_each_3x3_conv_once():
    g = torch.Generator().manual_seed(3)
    conv = lambda *s: {"w": torch.randn(*s, generator=g),
                       "b": torch.randn(s[-1], generator=g)}
    tree = {"in_conv": {"xy": conv(1, 1, 12, 64)},
            "down": [[{"in_conv": {k: conv(3, 3, 192, 64)
                                   for k in ("xy", "xz", "yz")}}]]}
    packed = pack_params(tree)
    assert "k1" not in packed["in_conv"]["xy"]            # 1x1: not K1
    for k, p in packed["down"][0][0]["in_conv"].items():
        src = tree["down"][0][0]["in_conv"][k]
        assert p["w"] is src["w"] and p["b"] is src["b"]
        assert torch.equal(p["k1"], tfc.pack_conv_weights(src["w"]))
        assert "k1" not in src                            # tree unchanged


@pytest.mark.parametrize("form", ["default", "act", "act+stats",
                                  "act+skip+stats"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_triplane_matches_three_pallas_calls(form, dt):
    """`conv3x3_rollout_triplane` (on the CPU: the plain version per
    plane) equals three JAX `conv3x3_rollout_fused` calls, one per plane
    with its own sizes and weights, at the tolerances above."""
    act, skip, stats = "act" in form, "skip" in form, "stats" in form
    cases = [_case(10 + i, 2, H, W, 64, 64, act=act, skip=skip)
             for i, (H, W) in enumerate(((7, 12), (7, 9), (12, 9)))]
    tdt = getattr(torch, dt)
    t = lambda a: None if a is None else torch.from_numpy(a)
    stack = lambda vs: torch.from_numpy(np.stack(vs, axis=2)).to(tdt)
    out = tfc.conv3x3_rollout_triplane(
        [t(c["x"]).to(tdt) for c in cases], [t(c["w"]) for c in cases],
        [t(c["b"]) for c in cases], [stack(c["col"]) for c in cases],
        [stack(c["row"]) for c in cases],
        [tuple(map(t, c["act"])) if act else None for c in cases],
        [t(c["skip"]).to(tdt) if skip else None for c in cases], stats)
    ys, ss = out if stats else (out, [None] * 3)
    for c, y, s in zip(cases, ys, ss):
        assert y.dtype == tdt
        got_y = y.float().numpy()
        want_y, want_s = _jax(c, getattr(jnp, dt), emit_stats=stats)
        if dt == "float32":
            np.testing.assert_allclose(got_y, want_y, **F32_TOL)
        elif act:
            # the two frameworks' sigmoids may differ by an fp32 ulp, which
            # can put an activated input on the other side of a bf16
            # rounding boundary: that moves an output by one bf16 step of
            # one input times its weight, far below 1% of a step of the
            # output scale (seen: 1.4e-5 of the scale, at outputs near 0)
            err = np.abs(got_y - want_y)
            scale = np.abs(want_y).max()
            assert (err <= 2 * BF16_EPS * np.abs(want_y)
                    + 0.01 * BF16_EPS * scale).all()
        else:
            _check_bf16(got_y, want_y, 64)
        if stats:
            _check_stats(s.numpy(), want_s, got_y, want_y)


def test_triplane_refuses_mixed_forms():
    x = torch.zeros(1, 3, 3, 8)
    w = torch.zeros(3, 3, 8, 8)
    act = (torch.ones(1, 8), torch.zeros(1, 8))
    with pytest.raises(ValueError, match="every plane or for none"):
        tfc.conv3x3_rollout_triplane([x] * 3, [w] * 3, [None] * 3,
                                     [None] * 3, [None] * 3,
                                     [act, None, act], [None] * 3)
    with pytest.raises(ValueError, match="1 to 3 planes"):
        tfc.conv3x3_rollout_triplane([x] * 4, [w] * 4, [None] * 4,
                                     [None] * 4, [None] * 4, [None] * 4,
                                     [None] * 4)
