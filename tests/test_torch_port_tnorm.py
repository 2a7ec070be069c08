"""The sampler's triplane norm (`ops/tnorm.py`) and the rollout products'
packed weights on the CPU: the norm's plain version against the eager
GroupNorm32 [+ FiLM] + SiLU and the six axis means it replaces, the
stacked layout, the "k1v" packs of `ops.pack_params`, the UNet's forward
with and without them, and the launch tally.  Its kernel is held to the
plain version on the card in `tests/test_torch_port_cuda.py`."""

import pytest
import torch

from sin3dm_tpu_torch import ops
from sin3dm_tpu_torch.core import nn
from sin3dm_tpu_torch.core.triplane import Triplane
from sin3dm_tpu_torch.models import unet as U
from sin3dm_tpu_torch.ops import fused_conv as tfc
from sin3dm_tpu_torch.ops import tnorm


def _case(seed, sizes, C, B=2, dt=torch.bfloat16, film=True):
    g = torch.Generator().manual_seed(seed)
    xs = [(torch.randn(B, R, S, C, generator=g) * 1.3 + 0.2).to(dt)
          for R, S in sizes]
    gam = [1.0 + 0.2 * torch.randn(C, generator=g) for _ in range(3)]
    bet = [0.2 * torch.randn(C, generator=g) for _ in range(3)]
    fm = ((0.3 * torch.randn(B, 2 * C, generator=g)).to(dt) if film
          else None)
    return xs, gam, bet, fm


def _stacked(v):
    """(v[l-1], v[l], v[l+1]) per line, zeros past the ends, by index."""
    B, L, C = v.shape
    out = torch.zeros(B, L, 3, C, dtype=v.dtype)
    for l in range(L):
        if l > 0:
            out[:, l, 0] = v[:, l - 1]
        out[:, l, 1] = v[:, l]
        if l + 1 < L:
            out[:, l, 2] = v[:, l + 1]
    return out


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("sizes,C", [
    (((9, 14), (9, 11), (14, 11)), 64),
    (((5, 7), (5, 3), (7, 3)), 96),       # odd sizes, 3 channels a group
    (((1, 2), (1, 1), (2, 1)), 32),
])
def test_plain_version_is_the_eager_norm_and_means(sizes, C, film, dt):
    """On the CPU `tnorm_silu` is the eager `_group_stats` ->
    `_fold_coeffs` -> `apply_film_coeffs` of each plane, with the FiLM's
    (scale, shift) split from `emb_out`, and the activated planes' six
    axis means in the stacked layout: bit for bit."""
    xs, gam, bet, fm = _case(len(sizes) * C + film, sizes, C, dt=dt,
                             film=film)
    before = tnorm.tnorm_silu.launches
    ys, coef, stacks = tnorm.tnorm_silu(xs, gam, bet, fm)
    assert tnorm.tnorm_silu.launches == before     # the plain version
    pair = (None if fm is None else
            tuple(torch.chunk(fm[:, None, None, :], 2, dim=-1)))
    for i, x in enumerate(xs):
        mean, rstd = nn._group_stats(x, 32, 1e-5)
        A, Bc = nn._fold_coeffs({"g": gam[i], "b": bet[i]}, mean, rstd, C,
                                pair)
        assert torch.equal(coef[i, 0], A) and torch.equal(coef[i, 1], Bc)
        y = nn.apply_film_coeffs(x, A, Bc)
        assert torch.equal(ys[i], y)
        assert torch.equal(y, nn.group_norm32_film_silu(
            {"g": gam[i], "b": bet[i]}, x, pair))
        rows, cols = stacks[i]
        assert torch.equal(rows, _stacked(y.mean(dim=-2)))
        assert torch.equal(cols, _stacked(y.mean(dim=-3)))
    _, _, none = tnorm.tnorm_silu(xs, gam, bet, fm, means=False)
    assert none is None


def test_stack3_is_the_shifted_lines():
    v = torch.randn(2, 5, 4)
    assert torch.equal(tnorm.stack3(v), _stacked(v))
    assert torch.equal(tnorm.stack3(v[:, :1]), _stacked(v[:, :1]))


@pytest.mark.parametrize("C,ok", [(32, True), (64, True), (96, True),
                                  (128, True), (192, True), (384, True),
                                  (160, True), (320, True), (288, True),
                                  (1024, True), (2048, True), (1056, False),
                                  (48, False), (16, False)])
def test_supported_widths(C, ok):
    """Every multiple of 32 up to 1024, and wider ones whose slice of
    lcm(8, C / 32) channels is at most 256 (not C = 32 x 33)."""
    assert tnorm.supported(C) == ok


def test_refuses_a_call_autograd_would_record():
    xs, gam, bet, fm = _case(1, ((4, 5), (4, 3), (5, 3)), 32,
                             dt=torch.float32)
    xs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tnorm.tnorm_silu(xs, gam, bet, fm)
    with torch.no_grad():
        tnorm.tnorm_silu(xs, gam, bet, fm)


def test_tally_counts_at_each_replay():
    """Launches inside `tallied()` (a graph capture) count only when
    `count_launches` replays their tally; elsewhere each counts once."""
    n0 = tnorm.tnorm_silu.launches
    with tnorm.tallied() as tally:
        tnorm._count()
        tnorm._count()
    assert tally == {"tnorm": 2} and tnorm.tnorm_silu.launches == n0
    tnorm.count_launches(tally)
    tnorm.count_launches(tally)
    tnorm._count()
    assert tnorm.tnorm_silu.launches == n0 + 5
    from sin3dm_tpu_torch.core import profiling
    assert profiling.counters()["tnorm.launches"] == n0 + 5


def _tconv(g, cin, cout, k=3):
    return {p: {"w": torch.randn(k, k, cin, cout, generator=g) * 0.1,
                "b": torch.randn(cout, generator=g) * 0.1}
            for p in ("xy", "xz", "yz")}


def test_pack_params_rollout_taps():
    """With `rollout` each plane of a triplane 3x3 conv gets "k1v": the
    bf16 col3 and row3 kernels of its broadcast blocks, the xy plane's
    col-varying block first; 1x1 convs and trees packed without
    `rollout` get none."""
    g = torch.Generator().manual_seed(7)
    C, Co = 32, 48
    tree = {"in_conv": _tconv(g, 12, 64, k=1),
            "down": [[{"in_conv": _tconv(g, 3 * C, Co)}]]}
    packed = ops.pack_params(tree, rollout=True)
    assert all("k1v" not in packed["in_conv"][k] for k in U.PLANES)
    for k in U.PLANES:
        w = tree["down"][0][0]["in_conv"][k]["w"]
        kv = packed["down"][0][0]["in_conv"][k]["k1v"]
        cs, rs = (C, 2 * C) if k == "xy" else (2 * C, C)
        col = torch.stack([t.bfloat16() for t in (
            w[1:, :, cs:cs + C].sum(0), w[:, :, cs:cs + C].sum(0),
            w[:2, :, cs:cs + C].sum(0))], dim=2)
        row = torch.stack([t.bfloat16() for t in (
            w[:, 1:, rs:rs + C].sum(1), w[:, :, rs:rs + C].sum(1),
            w[:, :2, rs:rs + C].sum(1))], dim=2)
        assert kv.dtype == torch.bfloat16 and kv.shape == (2, 3, C, 3, Co)
        assert torch.equal(kv[0], col) and torch.equal(kv[1], row)
        assert torch.equal(kv, tfc.pack_rollout_taps(w, k == "xy"))
    plain = ops.pack_params(tree)
    assert all("k1v" not in plain["down"][0][0]["in_conv"][k]
               for k in U.PLANES)


def _unet(ss, seed=1):
    cfg = U.UNetConfig(model_channels=32, compute_dtype=torch.bfloat16,
                       fast_norm=True, use_scale_shift_norm=ss)
    g = torch.Generator().manual_seed(seed)

    def jitter(t):   # move the zero-initialised convs and the norms
        if isinstance(t, dict):
            return {k: jitter(v) for k, v in t.items()}
        if isinstance(t, list):
            return [jitter(v) for v in t]
        return t + 0.05 * torch.randn(t.shape, generator=g)

    x = Triplane(torch.randn(2, 9, 14, 12, generator=g),
                 torch.randn(2, 9, 11, 12, generator=g),
                 torch.randn(2, 14, 11, 12, generator=g))
    return cfg, jitter(U.init_unet(g, cfg)), x


@pytest.mark.parametrize("ss", [True, False])
def test_unet_reads_the_packs_to_the_same_bits(ss):
    """The sampler's bf16 forward with the rollout packs equals the one
    that sums and casts the weight slices every call, bit for bit, and
    makes one `tnorm_silu` call a triplane norm: 9 a forward."""
    cfg, params, x = _unet(ss)
    t = torch.tensor([3, 700])
    calls = []
    real = U.tnorm_silu

    def counted(*a, **k):
        calls.append(k.get("means", a[4] if len(a) > 4 else True))
        return real(*a, **k)

    U.tnorm_silu = counted
    try:
        got = U.unet_apply(ops.pack_params(params, rollout=True), cfg, x, t)
    finally:
        U.tnorm_silu = real
    want = U.unet_apply(params, cfg, x, t)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # 4 blocks x 2 norms, each feeding a rollout conv its means, then
    # the final norm without
    assert calls == [True] * 8 + [False]


@pytest.mark.parametrize("env", [{}, {"SIN3DM_STATS_CHAIN": "1"},
                                 {"SIN3DM_FUSED_ACT": "1"}])
def test_tnorm_launches_per_forward_counts_the_calls(env, monkeypatch):
    """`tnorm_launches_per_forward` is the number of `tnorm_silu` calls a
    bf16 `fast_norm` forward makes, in each configuration (9 by default:
    4 blocks x 2 norms and the final one), and 0 in fp32."""
    for k in ("SIN3DM_STATS_CHAIN", "SIN3DM_FUSED_ACT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg, params, x = _unet(True)
    calls = []
    real = U.tnorm_silu

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(U, "tnorm_silu", counted)
    U.unet_apply(ops.pack_params(params, rollout=True), cfg, x,
                 torch.tensor([3, 700]))
    assert len(calls) == U.tnorm_launches_per_forward(cfg)
    if not env:
        assert len(calls) == 9
    f32 = U.UNetConfig(model_channels=32, compute_dtype=torch.float32,
                       fast_norm=True)
    assert U.tnorm_launches_per_forward(f32) == 0


def test_axis_means_one_helper():
    """`_axis_means` gives the six means every rollout form reads, in
    their order; with the whole planes' sizes the dim -3 ones are sums
    over those lengths (a shard's share)."""
    g = torch.Generator().manual_seed(3)
    t = Triplane(torch.randn(2, 4, 6, 8, generator=g),
                 torch.randn(2, 4, 5, 8, generator=g),
                 torch.randn(2, 6, 5, 8, generator=g))
    want = (t.yz.mean(-2), t.xz.mean(-2), t.xy.mean(-2), t.yz.mean(-3),
            t.xy.mean(-3), t.xz.mean(-3))
    assert all(torch.equal(a, b) for a, b in zip(U._axis_means(t), want))
    got = U._axis_means(t, torch.float32, (8, 12, 5))
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    for a, v, n in zip(got[3:], (t.yz, t.xy, t.xz), (12, 8, 8)):
        assert torch.equal(a, v.sum(-3) / n)
