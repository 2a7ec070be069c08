"""The port's CUDA kernels on the card: K1, its act/skip/emit_stats forms
K1′ and K2 against their plain versions at edge shapes the main path does
not reach (sizes of 1 and 2, channel counts off the 16-byte vector width,
ragged row and channel tiles, stats blocks that end mid-row of a batch
item), the bf16 kernels' own tile edges (pixel tiles cut by the plane's
edge, planes narrower or shorter than a tile, 64- and 128-column blocks,
K2's 128-row tiles and narrow last layers), the triplane launch against three
single-plane launches, the launch counters, and the wrappers' refusals;
and the UNet's training form (cuDNN convs, autograd, the NaN-guard step)
on the card against the CPU.

Every test needs an NVIDIA card and skips without one.  The file imports
no JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from sin3dm_tpu_torch.ops import _build
from sin3dm_tpu_torch.ops import fused_conv as tfc
from sin3dm_tpu_torch.ops import fused_mlp as tfm

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0 ** -7   # bf16 spacing relative to a value, at worst
F32_TOL = 1e-4         # relative to the output scale: summation order


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False   # the plain versions in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,C,Co,rollout", [
    (1, 1, 1, 8, 8, True),        # one pixel: row 0 and column 0 win ties
    (1, 2, 3, 16, 24, True),      # every pixel on a border
    (2, 9, 17, 12, 20, True),     # C and Co off the vector width
    (1, 5, 70, 33, 70, False),    # plain conv, odd C, ragged tiles
    (3, 7, 7, 64, 128, True),
])
def test_k1_edge_shapes(card, B, H, W, C, Co, rollout, dt):
    g = torch.Generator().manual_seed(B * 1000 + H * 100 + C)
    x = _randn(g, B, H, W, C).to(card, dt)
    w = _randn(g, 3, 3, C, Co, scale=(9 * C) ** -0.5).to(card)
    b = _randn(g, Co, scale=0.1).to(card)
    col3 = _randn(g, B, W, 3, Co, scale=0.3).to(card, dt) if rollout else None
    row3 = _randn(g, B, H, 3, Co, scale=0.3).to(card, dt) if rollout else None
    before = tfc.conv3x3_rollout.launches
    got = tfc.conv3x3_rollout(x, w, b, col3, row3)
    assert tfc.conv3x3_rollout.launches == before + 1
    ref = tfc.conv3x3_rollout_reference(x, w, b, col3, row3)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (B, H, W, Co)
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    if dt == torch.bfloat16:   # one rounding each, of sums in other orders
        tol = 2 * BF16_ULP * (ref.abs() + 0.01 * scale)
    else:
        tol = torch.full_like(ref, F32_TOL * scale)
    assert ((got - ref).abs() <= tol).all()


def _y_tol(ref, dt):
    """K1's per-element tolerance against its plain version (see
    `test_k1_edge_shapes`)."""
    scale = ref.abs().max().item()
    if dt == torch.bfloat16:
        return 2 * BF16_ULP * (ref.abs() + 0.01 * scale)
    return torch.full_like(ref, F32_TOL * scale)


def _check_stats(got_y, got_s, ref_y, ref_s, tol):
    """Stats of the kernel against (a) fp64 sums of its own rounded y: the
    two differ by fp32 summation order only, at most k * 2^-24 of the sum
    of |terms| for k-term sequential sums (the kernel sums 32 rows a
    thread, then 2 threads, then the torch sum of the block partials:
    k < 64 at the card's sizes), so 1e-5 of sum |y| (sum y^2); and
    (b) the plain version's stats: each y element may differ by its
    tolerance `tol`, so the sums may differ by the sum of those
    differences (sum of 2|y| tol + tol^2 for the squares) on top."""
    yk = got_y.double()
    own = torch.stack([yk.sum(dim=(1, 2)), (yk * yk).sum(dim=(1, 2))], 1)
    mass = torch.stack([yk.abs().sum(dim=(1, 2)),
                        (yk * yk).sum(dim=(1, 2))], 1)
    assert ((got_s.double() - own).abs() <= 1e-5 * mass + 1e-30).all()
    t = tol.double()
    ya = ref_y.double().abs()
    slack = torch.stack([t.sum(dim=(1, 2)),
                         (2 * ya * t + t * t).sum(dim=(1, 2))], 1)
    assert ((got_s.double() - ref_s.double()).abs()
            <= slack + 1e-5 * mass + 1e-30).all()


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["act", "act+stats", "act+skip+stats",
                                  "skip", "stats"])
@pytest.mark.parametrize("B,H,W,C,Co,rollout", [
    (1, 1, 1, 32, 32, True),      # one pixel: the halo is all of the taps
    (1, 2, 3, 32, 32, True),      # every pixel on a border
    (2, 9, 17, 12, 20, True),     # C and Co off the vector width
    (3, 9, 17, 32, 64, True),     # 153 pixels: blocks end mid-row, per item
    (2, 7, 10, 192, 64, True),    # the up path's 192-channel input
    (1, 5, 70, 33, 70, False),    # plain conv, odd C, ragged tiles
])
def test_k1_forms_edge_shapes(card, B, H, W, C, Co, rollout, form, dt):
    g = torch.Generator().manual_seed(B * 1000 + H * 100 + C + len(form))
    x = _randn(g, B, H, W, C).to(card, dt)
    w = _randn(g, 3, 3, C, Co, scale=(9 * C) ** -0.5).to(card)
    b = _randn(g, Co, scale=0.1).to(card)
    col3 = _randn(g, B, W, 3, Co, scale=0.3).to(card, dt) if rollout else None
    row3 = _randn(g, B, H, 3, Co, scale=0.3).to(card, dt) if rollout else None
    act = ((1.0 + _randn(g, B, C, scale=0.3)).to(card),
           _randn(g, B, C, scale=0.5).to(card)) if "act" in form else None
    skip = _randn(g, B, H, W, Co).to(card, dt) if "skip" in form else None
    stats = "stats" in form
    before = dict(tfc.conv3x3_rollout.form_launches)
    got = tfc.conv3x3_rollout(x, w, b, col3, row3, act, skip, stats)
    after = tfc.conv3x3_rollout.form_launches
    assert after[form] == before.get(form, 0) + 1
    ref = tfc.conv3x3_rollout_reference(x, w, b, col3, row3, act, skip,
                                        stats)
    torch.cuda.synchronize()
    (got_y, got_s), (ref_y, ref_s) = (got, ref) if stats else \
        ((got, None), (ref, None))
    assert got_y.dtype == dt and got_y.shape == (B, H, W, Co)
    got_y, ref_y = got_y.float(), ref_y.float()
    tol = _y_tol(ref_y, dt)
    assert ((got_y - ref_y).abs() <= tol).all()
    if stats:
        assert got_s.dtype == torch.float32 and got_s.shape == (B, 2, Co)
        _check_stats(got_y, got_s, ref_y, ref_s, tol)


def test_k1_stats_are_the_same_every_run(card):
    """No atomics: two launches on the same inputs give the same bits."""
    g = torch.Generator().manual_seed(7)
    B, H, W, C, Co = 2, 46, 64, 128, 128
    x = _randn(g, B, H, W, C).to(card, torch.bfloat16)
    w = _randn(g, 3, 3, C, Co, scale=(9 * C) ** -0.5).to(card)
    act = (torch.ones(B, C, device=card), torch.zeros(B, C, device=card))
    y1, s1 = tfc.conv3x3_rollout(x, w, None, act=act, emit_stats=True)
    y2, s2 = tfc.conv3x3_rollout(x, w, None, act=act, emit_stats=True)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def _skip_head(g, cin, cout, hidden, n_hidden):
    """A skip head in `init_autoencoder`'s layout, uniform +-1/sqrt(fan_in)."""
    def lin(k, n):
        bound = k ** -0.5
        return {"w": (torch.rand(k, n, generator=g) * 2 - 1) * bound,
                "b": (torch.rand(n, generator=g) * 2 - 1) * bound}
    first = [lin(cin, hidden)] + [lin(hidden, hidden)
                                  for _ in range(n_hidden // 2)]
    second = ([lin(cin + hidden, hidden)]
              + [lin(hidden, hidden) for _ in range(n_hidden // 2 - 1)]
              + [lin(hidden, cout)])
    return {"first": first, "second": second}


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,cout,hidden,n_hidden,n", [
    (64, 1, 256, 4, 1000),        # the towerruins geometry head
    (64, 3, 256, 4, 64 * 3 + 5),  # texture head, a ragged last tile
    (64, 2, 256, 4, 1000),        # pbr's metallic-roughness head
    (32, 4, 64, 2, 77),
    (16, 3, 48, 0, 130),          # widths off the 64-column fragment grid
])
def test_k2_edge_shapes(card, cin, cout, hidden, n_hidden, n, dt):
    g = torch.Generator().manual_seed(cin + hidden + n)
    params = _skip_head(g, cin, cout, hidden, n_hidden)
    params = {k: [{n_: t.to(card) for n_, t in lp.items()} for lp in v]
              for k, v in params.items()}
    x = _randn(g, n, cin, scale=0.5).to(card)
    before = tfm.skip_mlp.launches
    by_shape = tfm.skip_mlp.shape_launches.get((n, cin, cout), 0)
    got = tfm.skip_mlp(params, x, mxu_dtype=dt)
    assert tfm.skip_mlp.launches == before + 1
    assert tfm.skip_mlp.shape_launches[(n, cin, cout)] == by_shape + 1
    ref = tfm.skip_mlp_reference(params, x, mxu_dtype=dt)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (n, cout)
    scale = ref.abs().max().item()
    # bf16 operands: a hidden value whose sum lands the other side of a
    # bf16 rounding boundary moves the output by a fraction of a step
    tol = 2.0 ** -8 if dt == torch.bfloat16 else F32_TOL
    assert (got - ref).abs().max().item() <= tol * scale


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.zeros(1, 4, 4, 8, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tfc.conv3x3_rollout(x, torch.zeros(3, 3, 8, 8, device=card))
    x = torch.zeros(1, 4, 8, 4, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfc.conv3x3_rollout(x, torch.zeros(3, 3, 4, 8, device=card))
    head = _skip_head(torch.Generator().manual_seed(0), 64, 1, 256, 4)
    head = {k: [{n: t.to(card) for n, t in lp.items()} for lp in v]
            for k, v in head.items()}
    with pytest.raises(ValueError, match="fp32"):
        tfm.skip_mlp(head, torch.zeros(8, 64, device=card,
                                       dtype=torch.bfloat16))


@pytest.mark.parametrize("kernel", ["conv", "mlp"])
def test_cuda_tensor_without_library_raises(card, kernel, monkeypatch,
                                            tmp_path):
    """On a CUDA tensor a wrapper launches its kernel or raises: with no
    built library and no nvcc it must not fall back to the plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    if kernel == "conv":
        fn = tfc.conv3x3_rollout
        args = (torch.zeros(1, 4, 4, 8, device=card, dtype=torch.bfloat16),
                torch.zeros(3, 3, 8, 8, device=card))
    else:
        fn = tfm.skip_mlp
        head = _skip_head(torch.Generator().manual_seed(0), 64, 1, 256, 4)
        args = ({k: [{n: t.to(card) for n, t in lp.items()} for lp in v]
                 for k, v in head.items()},
                torch.zeros(64, 64, device=card))
    before = fn.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(*args)
    assert fn.launches == before


def _triplane_case(g, card, B, sizes, C, Co, form, dt=torch.bfloat16):
    """Operands of one triplane conv in `form`, per plane."""
    xs, ws, bs, cols, rows, acts, skips = [], [], [], [], [], [], []
    for H, W in sizes:
        xs.append(_randn(g, B, H, W, C).to(card, dt))
        ws.append(_randn(g, 3, 3, C, Co, scale=(9 * C) ** -0.5).to(card))
        bs.append(_randn(g, Co, scale=0.1).to(card))
        cols.append(_randn(g, B, W, 3, Co, scale=0.3).to(card, dt))
        rows.append(_randn(g, B, H, 3, Co, scale=0.3).to(card, dt))
        acts.append(((1.0 + _randn(g, B, C, scale=0.3)).to(card),
                     _randn(g, B, C, scale=0.5).to(card))
                    if "act" in form else None)
        skips.append(_randn(g, B, H, W, Co).to(card, dt)
                     if "skip" in form else None)
    return xs, ws, bs, cols, rows, acts, skips


@pytest.mark.parametrize("form", ["default", "act", "act+stats",
                                  "act+skip+stats"])
@pytest.mark.parametrize("B,sizes,C,Co", [
    (1, ((5, 37), (5, 11), (37, 11)), 64, 64),    # tiles cut by both edges
    (3, ((2, 9), (2, 2), (9, 2)), 64, 64),        # H = 2, batch 3
    (2, ((7, 30), (7, 7), (30, 7)), 192, 64),     # C = 192 -> 64
    (1, ((9, 20), (9, 13), (20, 13)), 128, 128),  # Co = 128: 8 x 8 tiles
    (2, ((3, 70), (3, 5), (70, 5)), 64, 96),      # Co padded to 128
])
def test_k1_bf16_tiles_and_triplane(card, B, sizes, C, Co, form):
    """The bf16 kernel at its tile edges, each plane against the plain
    version; one triplane launch equals the three single-plane launches
    bit for bit (y and stats)."""
    g = torch.Generator().manual_seed(B * 100 + C + Co + len(form))
    xs, ws, bs, cols, rows, acts, skips = _triplane_case(g, card, B, sizes,
                                                         C, Co, form)
    stats = "stats" in form
    before = dict(tfc.conv3x3_rollout.form_launches)
    tri = tfc.conv3x3_rollout_triplane(xs, ws, bs, cols, rows, acts, skips,
                                       stats)
    assert tfc.conv3x3_rollout.form_launches[form] == before.get(form, 0) + 1
    tri_y, tri_s = tri if stats else (tri, [None] * 3)
    for i in range(3):
        args = (xs[i], ws[i], bs[i], cols[i], rows[i], acts[i], skips[i],
                stats)
        one = tfc.conv3x3_rollout(*args)
        ref = tfc.conv3x3_rollout_reference(*args)
        torch.cuda.synchronize()
        (one_y, one_s), (ref_y, ref_s) = (one, ref) if stats else \
            ((one, None), (ref, None))
        assert torch.equal(tri_y[i], one_y)
        tol = _y_tol(ref_y.float(), torch.bfloat16)
        assert ((one_y.float() - ref_y.float()).abs() <= tol).all()
        if stats:
            assert torch.equal(tri_s[i], one_s)
            _check_stats(one_y.float(), one_s, ref_y.float(), ref_s, tol)


def test_k1_triplane_stats_are_the_same_every_run(card):
    """The stats partials are summed in tile order by the last block of
    each item: two launches give the same bits."""
    g = torch.Generator().manual_seed(11)
    case = _triplane_case(g, card, 2, ((46, 64), (46, 46), (64, 46)), 128,
                          128, "act+skip+stats")
    y1, s1 = tfc.conv3x3_rollout_triplane(*case, emit_stats=True)
    y2, s2 = tfc.conv3x3_rollout_triplane(*case, emit_stats=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(y1, y2))
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))


def test_k1_stats_launches_on_two_streams(card):
    """Each stats launch counts its finished tiles in counters of its
    own: launches that overlap on two streams give the bits of one
    launch alone."""
    g = torch.Generator().manual_seed(15)
    cases = [_triplane_case(g, card, 2, ((46, 64), (46, 46), (64, 46)), 64,
                            128, "act+stats") for _ in range(2)]
    want = [tfc.conv3x3_rollout_triplane(*c, emit_stats=True) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in cases]
    got = [[], []]
    for _ in range(20):
        for i, (c, st) in enumerate(zip(cases, streams)):
            with torch.cuda.stream(st):
                got[i].append(tfc.conv3x3_rollout_triplane(*c,
                                                           emit_stats=True))
    torch.cuda.synchronize()
    for (wy, ws), runs in zip(want, got):
        for y, s in runs:
            assert all(torch.equal(a, b) for a, b in zip(y, wy))
            assert all(torch.equal(a, b) for a, b in zip(s, ws))


def test_k1_triplane_fp32_is_three_launches(card):
    """fp32 keeps the single-plane SIMT kernel: three launches."""
    g = torch.Generator().manual_seed(12)
    case = _triplane_case(g, card, 1, ((4, 5), (4, 3), (5, 3)), 16, 16,
                          "default", dt=torch.float32)
    before = tfc.conv3x3_rollout.launches
    ys = tfc.conv3x3_rollout_triplane(*case)
    assert tfc.conv3x3_rollout.launches == before + 3
    for i, y in enumerate(ys):
        ref = tfc.conv3x3_rollout_reference(*[a[i] for a in case])
        assert torch.allclose(y, ref, atol=F32_TOL * ref.abs().max().item())


def test_k1_bf16_takes_planes_of_any_width(card):
    """A tile stages a fixed (8 + 2) x (TW + 2) pixels, whatever the
    plane's width: a 3 x 4000 plane runs and agrees with the plain
    version."""
    g = torch.Generator().manual_seed(14)
    x = _randn(g, 1, 3, 4000, 64).to(card, torch.bfloat16)
    w = _randn(g, 3, 3, 64, 64, scale=(9 * 64) ** -0.5).to(card)
    y = tfc.conv3x3_rollout(x, w)
    ref = tfc.conv3x3_rollout_reference(x, w)
    torch.cuda.synchronize()
    tol = _y_tol(ref.float(), torch.bfloat16)
    assert ((y.float() - ref.float()).abs() <= tol).all()


@pytest.mark.parametrize("C", [32, 64])
def test_k1_takes_the_whole_rollout_conv_packed(card, C):
    """The UNet passes a rollout conv's [3, 3, 3C, Co] weight packed
    whole beside its first C input channels: the same bits as that slice
    packed on the call (C = 32: half of the one chunk read is the next
    block's weights, met by staged zeros).  A pack of other widths is
    refused."""
    g = torch.Generator().manual_seed(13 + C)
    x = _randn(g, 2, 6, 7, C).to(card, torch.bfloat16)
    wfull = _randn(g, 3, 3, 3 * C, 48, scale=0.1).to(card)
    w = wfull[:, :, :C]
    act = ((1.0 + _randn(g, 2, C, scale=0.3)).to(card),
           _randn(g, 2, C, scale=0.5).to(card))
    whole = tfc.pack_conv_weights(wfull)
    for a in (None, act):
        y1, s1 = tfc.conv3x3_rollout(x, w, act=a, emit_stats=True)
        y2, s2 = tfc.conv3x3_rollout(x, w, act=a, emit_stats=True,
                                     packed=whole)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2) and torch.equal(s1, s2)
    with pytest.raises(ValueError, match="packed"):
        tfc.conv3x3_rollout(x, w, packed=tfc.pack_conv_weights(
            _randn(g, 3, 3, C, 96).to(card)))


def test_k2_takes_its_head_packed_once(card):
    """A head packed by `pack_params` launches on its "k2" entry and
    gives the bits of the head packed on the call."""
    from sin3dm_tpu_torch.ops import pack_params
    g = torch.Generator().manual_seed(16)
    head = _skip_head(g, 64, 3, 256, 4)
    head = {k: [{n: t.to(card) for n, t in lp.items()} for lp in v]
            for k, v in head.items()}
    x = _randn(g, 300, 64, scale=0.5).to(card)
    packed = pack_params(head)
    assert "k2" in packed
    assert torch.equal(tfm.skip_mlp(packed, x, mxu_dtype=torch.bfloat16),
                       tfm.skip_mlp(head, x, mxu_dtype=torch.bfloat16))


@pytest.mark.parametrize("n", [1, 77, 128, 129, 64 * 3 + 5, 4096 + 17])
@pytest.mark.parametrize("cout", [1, 3, 8])
def test_k2_bf16_tiles(card, n, cout):
    """K2's 128-row tiles (N below one tile, not a multiple of it, more
    tiles than SMs would take in one pass at larger N) and its narrow last
    layer (m64n8) at cout 1, 3 and 8."""
    g = torch.Generator().manual_seed(n + cout)
    params = _skip_head(g, 64, cout, 256, 4)
    params = {k: [{n_: t.to(card) for n_, t in lp.items()} for lp in v]
              for k, v in params.items()}
    x = _randn(g, n, 64, scale=0.5).to(card)
    got = tfm.skip_mlp(params, x, mxu_dtype=torch.bfloat16)
    ref = tfm.skip_mlp_reference(params, x, mxu_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (n, cout)
    assert (got - ref).abs().max().item() <= 2.0 ** -8 * ref.abs().max().item()


@pytest.mark.parametrize("C", [64, 192])
def test_k1_bf16_act_is_exact(card, C):
    """The bf16 kernel activates each staged value once with a fast
    sigmoid, and recomputes the exact one wherever the fast value lies
    near a bf16 rounding midpoint or outside its range.  With the
    identity at the centre tap and no bias, y is the activated input
    itself: it equals, bit for bit, torch's silu in fp32 (each operation
    rounded) rounded to bf16.  Per-channel coefficients from 0.03 to 30
    spread v = x*A + B past |v| = 30, and 4 channels hold v = 0.  C = 64
    takes 8 x 16 tiles, C = 192 (Co = 192) three chunks and 8 x 8."""
    g = torch.Generator().manual_seed(C)
    B, sizes = 2, ((33, 47), (33, 20), (47, 20))
    xs = [_randn(g, B, H, W, C).to(card, torch.bfloat16) for H, W in sizes]
    w = torch.zeros(3, 3, C, C, device=card)
    w[1, 1] = torch.eye(C, device=card)
    scale = torch.logspace(-1.5, 1.5, C)
    a = (_randn(g, B, C) * scale).to(card)
    b = (_randn(g, B, C) * scale).to(card)
    a[:, :4], b[:, :4] = 0.0, 0.0
    ys = tfc.conv3x3_rollout_triplane(xs, [w] * 3, [None] * 3, [None] * 3,
                                      [None] * 3, [(a, b)] * 3)
    torch.cuda.synchronize()
    for x, y in zip(xs, ys):
        v = x.float() * a[:, None, None, :] + b[:, None, None, :]
        want = (v * torch.sigmoid(v)).to(torch.bfloat16)
        assert torch.equal(y, want)


# ---------------------------------------------------------------------------
# The mesh path's device work: the sparse wire, the int8 grid, the texels
# ---------------------------------------------------------------------------

def _sphere_q(shape, radius=0.55, thr=0.0234375):
    axes = [torch.linspace(-1, 1, s, dtype=torch.float64) for s in shape]
    x, y, z = torch.meshgrid(*axes, indexing="ij")
    v = torch.clamp((x * x + y * y + z * z).sqrt() - radius, -thr, thr)
    return torch.clamp(torch.floor(v * 127.0 / thr), -128, 127).to(
        torch.int8)


@pytest.mark.parametrize("shape", [(17, 23, 9), (60, 52, 44),
                                   (184, 256, 184)])
def test_sparse_encode_on_card_equals_cpu(card, shape):
    """The block order of the stable argsort, the packed signs and the
    block values: the card's wire equals the CPU's exactly."""
    from sin3dm_tpu_torch.ops import sparse_grid as sg
    q = _sphere_q(shape)
    want = sg.encode(q)
    got = sg.encode(q.to(card))
    n = int(want.count)
    assert int(got.count) == n > 0
    assert torch.equal(got.signs.cpu(), want.signs)
    assert torch.equal(got.block_ids.cpu()[:n], want.block_ids[:n])
    assert torch.equal(got.block_vals.cpu()[:n], want.block_vals[:n])


def _committed_trainer(device):
    import os
    from sin3dm_tpu_torch.models.autoencoder import AEConfig
    from sin3dm_tpu_torch.training.ae import AETrainer
    enc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "checkpoints", "towerruins", "encoding")
    tr = AETrainer(enc, AEConfig(), device)
    tr.load_ckpt("final")
    return tr, os.path.join(enc, "feat.npz")


@pytest.mark.parametrize("bf16", ["0", "1"])
def test_int8_grid_and_texels_on_card(card, bf16, monkeypatch):
    """The committed AE on the tag's feat.npz at reso 64 on the card and on
    the CPU (fp32, or bf16 operands): the card's int8 grid exactly numpy's
    floor(clip(fp32 / q, -1, 1) * 127) of its own fp32 grid (a true
    division), the int8 grids a bucket apart at most 1e-3 of the voxels
    with no sign flip, the fp16 upload of the u16 run starts widened
    exactly, and the texels of one atlas within 1 (fp32) or 2 (bf16, fewer
    than 1 % by more than 1)."""
    import numpy as np
    from sin3dm_tpu_torch.core.triplane import load_triplane_npz
    from sin3dm_tpu_torch.geometry import meshproc, uvatlas
    from sin3dm_tpu_torch.models import autoencoder as ae
    from sin3dm_tpu_torch.training.ae import _u16_to_device
    monkeypatch.setenv("SIN3DM_DECODE_BF16", bf16)
    cd, feat_path = _committed_trainer(card)
    hd, _ = _committed_trainer("cpu")
    feat = load_triplane_npz(feat_path)
    aabb = cd._feat_aabb(feat)
    quant = float(cd.meta["threshold"])
    handles = [t._dispatch_geo_grid(feat, 64, aabb) for t in (cd, hd)]
    assert all(h.sparse is not None for h in handles)
    gc, gh = [h.grid.cpu().numpy() for h in handles]
    f32 = ae.decode_grid_dense(cd.params, cd.acfg, *cd._planes(feat),
                               gc.shape, geo_only=True)[..., 0].cpu().numpy()
    one = np.float32(1.0)
    np.testing.assert_array_equal(gc, np.floor(
        np.clip(f32 / np.float32(quant), -one, one) * np.float32(127.0)
    ).astype(np.int8))
    d = np.abs(gc.astype(np.int32) - gh.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    assert ((gc < 0) != (gh < 0)).sum() == 0
    u = np.arange(65536, dtype=np.uint16).reshape(-1, 4)
    assert torch.equal(_u16_to_device(u, card).cpu(),
                       torch.from_numpy(u.astype(np.int32)))
    v, f = meshproc.sdfgrid_to_mesh((gh.astype(np.float32) + 0.5)
                                    * (quant / 127.0))
    box = aabb[3:].max() - aabb[:3].min()
    v, f = meshproc.mesh_decimation(v / 64 * box + aabb[:3], f, 2000)
    _, _, mask, runs = uvatlas.uv_unwrap_and_rasterize_runs(v, f, 256)
    fc, n = cd._dispatch_texels_runs(feat, runs, aabb)
    fh, _ = hd._dispatch_texels_runs(feat, runs, aabb)
    tc = np.concatenate(fc.wait())[:n].astype(np.int32)
    th = np.concatenate(fh.wait())[:n].astype(np.int32)
    dt = np.abs(tc - th)
    assert n == int(mask.sum()) > 1000
    if bf16 == "0":
        assert dt.max() <= 1 and (dt > 0).mean() < 0.01
    else:
        assert dt.max() <= 2 and (dt > 1).mean() < 0.01


# ---------------------------------------------------------------------------
# The training form: cuDNN convs and autograd on the card, TF32 off
# ---------------------------------------------------------------------------

def _train_setup(dev):
    """A narrow UNet (model_channels 64: every leaf has a gradient), every
    leaf perturbed so the zero convs are live, and one 8x12x6 batch."""
    from sin3dm_tpu_torch.core import checkpoint as ck
    from sin3dm_tpu_torch.core.triplane import Triplane
    from sin3dm_tpu_torch.models import unet as TU
    cfg = TU.UNetConfig(in_channels=4, model_channels=64, out_channels=4)
    g = torch.Generator().manual_seed(0)
    params = TU.init_unet(g, cfg)
    params = ck.unflatten_like(params, [
        (v + 0.02 * torch.randn(v.shape, generator=g)).to(dev)
        for _, v in ck.leaves_with_paths(params)])
    x = Triplane(*[torch.randn(s, generator=g).to(dev)
                   for s in ((2, 8, 12, 4), (2, 8, 6, 4), (2, 12, 6, 4))])
    return cfg, params, x


def test_train_forward_backward_card_vs_cpu(card):
    """`unet_train_apply` and its grads on the card against the CPU: out
    within 1e-4 of its scale, each leaf's grad within 1e-4 of its largest
    |g| (fp32 summation order)."""
    from sin3dm_tpu_torch.core import checkpoint as ck
    from sin3dm_tpu_torch.models import unet as TU
    cfg, params, x = _train_setup("cpu")
    t = torch.tensor([999, 17])
    res = {}
    for dev in ("cpu", card):
        p = ck.unflatten_like(params, [
            v.to(dev).requires_grad_(True)
            for _, v in ck.leaves_with_paths(params)])
        leaves = [v for _, v in ck.leaves_with_paths(p)]
        out = TU.unet_train_apply(p, cfg, x.to(dev), t.to(dev))
        loss = sum((o * o).mean() for o in out)
        res[str(dev)] = ([o.detach().cpu() for o in out],
                         [gr.cpu() for gr in torch.autograd.grad(loss,
                                                                 leaves)])
    (oc, gc), (og, gg) = res["cpu"], res[str(card)]
    for a, b in zip(og, oc):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    for a, b in zip(gg, gc):
        assert b.abs().max() > 0
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_nan_guard_step_on_the_card(card):
    """A step on a batch holding a NaN: params kept bit for bit, mu and nu
    decayed, both counts advanced, the step reported skipped."""
    from sin3dm_tpu_torch.diffusion.gaussian import (DiffusionConfig,
                                                     tables_to_device)
    from sin3dm_tpu_torch.diffusion.schedule import make_schedule
    from sin3dm_tpu_torch.models import unet as TU
    from sin3dm_tpu_torch.training import diffusion as TD
    cfg, params, x = _train_setup(card)
    tcfg = TD.DiffusionTrainerConfig(batch_size=2)
    tables = tables_to_device(make_schedule("linear", 50).tables_f32(), card)
    state = TD.init_train_state(params, tcfg, 50)
    step = TD.make_train_step(
        lambda p, xx, tt: TU.unet_train_apply(p, cfg, xx, tt), tables,
        DiffusionConfig(original_num_steps=50), tcfg)
    m = step(state, x, 0)
    assert not bool(m["skipped"]) and torch.isfinite(m["loss"]).all()
    flat, mu, nu = state.flat.clone(), state.mu.clone(), state.nu.clone()
    bad = x.map(torch.clone)
    bad.xy[0, 0, 0, 0] = float("nan")
    m = step(state, bad, 0)
    torch.cuda.synchronize()
    assert bool(m["skipped"]) and not torch.isfinite(m["grad_norm"])
    assert torch.equal(state.flat, flat)
    torch.testing.assert_close(state.mu, mu * 0.9, rtol=1e-6, atol=0)
    torch.testing.assert_close(state.nu, nu * 0.999, rtol=1e-6, atol=0)
    assert (state.count, state.sched_count, state.step) == (2, 2, 2)


@pytest.mark.parametrize("model", ["diffusion", "ae"])
def test_two_train_steps_of_one_seed_are_equal_bits(card, model, tmp_path):
    """Under `core.rng.deterministic_algorithms` (what `cli.train` runs
    in), two runs of two train steps from the same state and seed give
    the same params, mu and nu, bit for bit."""
    from sin3dm_tpu_torch.core import checkpoint as ck
    from sin3dm_tpu_torch.core.rng import deterministic_algorithms
    runs = []
    with deterministic_algorithms():
        for _ in range(2):
            if model == "diffusion":
                from sin3dm_tpu_torch.diffusion.gaussian import (
                    DiffusionConfig, tables_to_device)
                from sin3dm_tpu_torch.diffusion.schedule import make_schedule
                from sin3dm_tpu_torch.models import unet as TU
                from sin3dm_tpu_torch.training import diffusion as TD
                cfg, params, x = _train_setup(card)
                tcfg = TD.DiffusionTrainerConfig(batch_size=2)
                state = TD.init_train_state(params, tcfg, 50)
                step = TD.make_train_step(
                    lambda p, xx, tt: TU.unet_train_apply(p, cfg, xx, tt),
                    tables_to_device(make_schedule("linear", 50)
                                     .tables_f32(), card),
                    DiffusionConfig(original_num_steps=50), tcfg)
                for _ in range(2):
                    step(state, x, 0)
            else:
                from sin3dm_tpu_torch.models import autoencoder as tae
                from sin3dm_tpu_torch.training import ae as ta
                npz = str(tmp_path / "sphere.npz")
                _ae_sphere_npz(npz)
                acfg = tae.AEConfig(fdim_geo=4, fdim_tex=8, fdim_up=32,
                                    hidden_dim=64, n_hidden_layers=2)
                tcfg = ta.AETrainerConfig(enc_batch_size=4096,
                                          enc_n_iters=100, fm_reso=16)
                data, meta, _ = ta.load_ae_data(npz, tcfg, card)
                state = ta.init_train_state(tae.init_autoencoder(
                    torch.Generator(card).manual_seed(3), acfg), tcfg)
                step = ta.make_train_step(acfg, tcfg, meta["threshold"])
                for _ in range(2):
                    step(state, data, 0)
            torch.cuda.synchronize()
            runs.append([b.clone() for b in (state.flat, state.mu,
                                             state.nu)])
    assert not torch.equal(runs[0][1], torch.zeros_like(runs[0][1]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# The AE's training form: K2 closed to autograd, a train step on the card
# ---------------------------------------------------------------------------

def test_k2_refuses_grad_on_the_card(card):
    head = _skip_head(torch.Generator().manual_seed(1), 64, 3, 256, 4)
    head = {k: [{n: t.to(card) for n, t in lp.items()} for lp in v]
            for k, v in head.items()}
    x = torch.randn(256, 64, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tfm.skip_mlp(head, x, torch.bfloat16)
    head["first"][0]["w"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tfm.skip_mlp(head, x.detach(), torch.bfloat16)
    with torch.no_grad():
        out = tfm.skip_mlp(head, x, torch.bfloat16)
    assert out.shape == (256, 3) and torch.isfinite(out).all()


def _ae_sphere_npz(path, n=32):
    """A textured sphere in the mesh sampler's npz schema (an n^3 grid in
    [-1, 1]^3, 2,000 on- and near-surface points)."""
    import numpy as np
    rng = np.random.default_rng(0)
    xs = (np.arange(n) + 0.5) / n * 2 - 1
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    on = rng.standard_normal((2000, 3))
    on = on / np.linalg.norm(on, axis=-1, keepdims=True) * 0.6
    near = on + rng.normal(0, 0.005, on.shape)

    def tex(p):
        return np.stack([0.5 + 0.5 * p[..., 0], 0.5 + 0.5 * p[..., 1],
                         0.5 + 0.5 * p[..., 2]], -1).astype(np.float32)

    def sdf(p):
        return (np.linalg.norm(p, axis=-1) - 0.6).astype(np.float32)

    f32 = np.float32
    np.savez(path, pts_grid=grid.astype(f32), sdf_grid=sdf(grid),
             tex_grid=tex(grid), pts_on_surf=on.astype(f32),
             tex_on_surf=tex(on), pts_near_surf=near.astype(f32),
             sdf_near_surf=sdf(near), tex_near_surf=tex(near),
             aabb=np.array([-1, -1, -1, 1, 1, 1], f32),
             threshold=f32(2.0 / n * 3))


def test_ae_train_step_card_vs_cpu(card, tmp_path):
    """One AE train step (hidden 64, 2 hidden layers, fdim_up 32, batch
    4096) on the card against the CPU from the same params, warm AdamW
    state and window offsets: loss terms 1e-5 relative, each leaf's grad
    1e-4 of its largest |g| (the biases an InstanceNorm cancels: both
    below 1e-5 of the whole grad's), params 1e-5 absolute, mu 1e-4 and nu
    2e-4 of the leaf's largest; no K2 launch."""
    from sin3dm_tpu_torch.core import checkpoint as ck
    from sin3dm_tpu_torch.models import autoencoder as tae
    from sin3dm_tpu_torch.training import ae as ta
    npz = str(tmp_path / "sphere.npz")
    _ae_sphere_npz(npz)
    acfg = tae.AEConfig(fdim_geo=4, fdim_tex=8, fdim_up=32, hidden_dim=64,
                        n_hidden_layers=2)
    tcfg = ta.AETrainerConfig(enc_batch_size=4096, enc_n_iters=100,
                              fm_reso=16)
    g = torch.Generator().manual_seed(3)
    params = tae.init_autoencoder(g, acfg)
    params = ck.unflatten_like(params, [
        v + 0.02 * torch.randn(v.shape, generator=g)
        for _, v in ck.leaves_with_paths(params)])
    n = sum(v.numel() for _, v in ck.leaves_with_paths(params))
    mu = 1e-3 * torch.randn(n, generator=g)
    nu = (1e-3 * (1 + torch.randn(n, generator=g).abs())) ** 2
    offsets = ([0, 500, 1000, 1500, 2000, 2500, 3000, 3500],
               [0, 100, 200, 300, 400, 500, 600, 700])
    res = {}
    launches = tfm.skip_mlp.launches
    for dev in ("cpu", card):
        data, meta, _ = ta.load_ae_data(npz, tcfg, dev)
        st = ta.init_train_state(ck.unflatten_like(params, [
            v.to(dev) for _, v in ck.leaves_with_paths(params)]), tcfg)
        st.mu.copy_(mu)
        st.nu.copy_(nu)
        st.count = st.sched_count = 100
        terms, grad = ta.compute_grads(st, acfg, tcfg, data,
                                       meta["threshold"], offsets)
        ta.apply_grads(st, grad, tcfg)
        res[str(dev)] = ({k: v.cpu() for k, v in terms.items()},
                         grad.cpu(), st.flat.cpu(), st.mu.cpu(),
                         st.nu.cpu(), st)
    assert tfm.skip_mlp.launches == launches
    (tc, gc, fc, mc, nc, ref), (tg, gg, fg, mg, ng, _) = (
        res["cpu"], res[str(card)])
    for k, v in tc.items():
        assert (tg[k] - v).abs() <= 1e-5 * v.abs(), k

    def leaves(buf):
        return dict(ck.leaves_with_paths(ref.tree(buf)))

    top = gc.abs().max()
    lg, lc = leaves(gg), leaves(gc)
    for p, want in lc.items():
        parts = p.split("/")
        if parts[-1] == "b" and (parts[0].endswith("_encoder")
                                 or "in_conv" in parts):
            assert max(want.abs().max(), lg[p].abs().max()) <= 1e-5 * top
        else:
            assert (lg[p] - want).abs().max() <= 1e-4 * want.abs().max(), p
    assert (fg - fc).abs().max() <= 1e-5
    for got, want, tol in ((mg, mc, 1e-4), (ng, nc, 2e-4)):
        lg, lc = leaves(got), leaves(want)
        for p, w in lc.items():
            assert (lg[p] - w).abs().max() <= tol * w.abs().max(), p


# ---------------------------------------------------------------------------
# The triplane norm kernel (ops/tnorm.py)
# ---------------------------------------------------------------------------

# the towerruins tag's planes at the UNet's two levels
TNORM_PLANES = {0: ((92, 128), (92, 92), (128, 92)),
                1: ((46, 64), (46, 46), (64, 46))}
# fp32 GroupNorm statistics of up to 128 x 92 x 6 values, summed in fp32
# in the kernel's order or in torch's: both lie well within 1e-5 of the
# fp64 statistics, relative to |A| and to B's terms (seen: ~1e-6)
TNORM_F32_TOL = 1e-5


def _tnorm_case(card, level, C, film, B=1, seed=0):
    g = torch.Generator().manual_seed(seed + 10 * level + C)
    xs = [(_randn(g, B, R, S, C, scale=1.7) + 0.4).to(card, torch.bfloat16)
          for R, S in TNORM_PLANES[level]]
    gam = [(1.0 + _randn(g, C, scale=0.2)).to(card) for _ in range(3)]
    bet = [_randn(g, C, scale=0.2).to(card) for _ in range(3)]
    fm = (_randn(g, B, 2 * C, scale=0.3).to(card, torch.bfloat16)
          if film else None)
    return xs, gam, bet, fm


def _coef_fp64(x, gamma, beta, film):
    """(A, B, mean, std) `[B, C]` of one plane in fp64 on the card, and the
    scale (1 + film scale): the truth both fp32 versions estimate."""
    B_, R, S, C = x.shape
    xg = x.double().reshape(B_, R * S, 32, C // 32)
    mean = xg.mean(dim=(1, 3))
    var = ((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    rep = C // 32
    m = mean.repeat_interleave(rep, dim=-1)
    A = torch.rsqrt(var + 1e-5).repeat_interleave(rep, dim=-1) \
        * gamma.double()
    Bc = beta.double() - m * A
    one = torch.ones_like(A)
    if film is not None:
        one = 1.0 + film[:, :C].double()
        A, Bc = A * one, Bc * one + film[:, C:].double()
    return A, Bc, m, var.sqrt().repeat_interleave(rep, dim=-1), one


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("level,C,film,means", [
    (0, 64, False, True),     # level-0 in norm
    (0, 64, True, True),      # level-0 out norm (FiLM)
    (1, 64, False, True),     # level-1 in norm of the 64 -> 128 block
    (1, 128, True, True),
    (1, 128, False, True),
    (0, 192, False, True),    # the skip concat's in norm
    (0, 64, False, False),    # the final norm: no rollout conv after it
])
def test_tnorm_main_path_shapes(card, level, C, film, means, B):
    """The norm kernel at the tag's plane sizes of both levels in bf16,
    at batch 1 and at the main path's batch 2,
    one launch a triplane, against its plain version on the card: (A, B)
    within TNORM_F32_TOL of the fp64 statistics, as the plain version's;
    y equal bit for bit to the plain apply of the kernel's own (A, B)
    (the same fp32 operations, each rounded to bf16 as torch rounds
    them); the stacked means within one bf16 rounding of torch's means of
    the kernel's y (fp32 sums in two orders, each rounded once), with
    their zero taps exactly zero."""
    from sin3dm_tpu_torch.core import nn
    from sin3dm_tpu_torch.ops import tnorm
    xs, gam, bet, fm = _tnorm_case(card, level, C, film, B=B)
    before = tnorm.tnorm_silu.launches
    ys, coef, stacks = tnorm.tnorm_silu(xs, gam, bet, fm, means)
    torch.cuda.synchronize()
    assert tnorm.tnorm_silu.launches == before + 1
    _, pcoef, _ = tnorm.tnorm_silu_reference(xs, gam, bet, fm, means)
    for i, x in enumerate(xs):
        A64, B64, m64, sd64, one = _coef_fp64(x, gam[i], bet[i], fm)
        tol_b = TNORM_F32_TOL * (B64.abs() + (m64.abs() + sd64)
                                 * A64.abs() + one.abs())
        for c in (coef, pcoef):
            assert ((c[i, 0].double() - A64).abs()
                    <= TNORM_F32_TOL * A64.abs()).all()
            assert ((c[i, 1].double() - B64).abs() <= tol_b).all()
        assert torch.equal(ys[i], nn.apply_film_coeffs(x, coef[i, 0],
                                                       coef[i, 1]))
    if not means:
        assert stacks is None
        return
    for y, pair in zip(ys, stacks):
        for st, dim in zip(pair, (-2, -3)):
            want = tnorm.stack3(y.mean(dim=dim)).float()
            got = st.float()
            assert (got[:, 0, 0] == 0).all() and (got[:, -1, 2] == 0).all()
            tol = BF16_ULP * want.abs() + 1e-5 * y.float().abs().mean()
            assert ((got - want).abs() <= tol).all()


def test_tnorm_is_the_same_every_run(card):
    """Fixed-order sums, no atomics: two launches give the same bits."""
    from sin3dm_tpu_torch.ops import tnorm
    xs, gam, bet, fm = _tnorm_case(card, 0, 192, True)
    a = tnorm.tnorm_silu(xs, gam, bet, fm)
    b = tnorm.tnorm_silu(xs, gam, bet, fm)
    assert all(torch.equal(u, v) for u, v in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1])
    assert all(torch.equal(u, v) for p, q in zip(a[2], b[2])
               for u, v in zip(p, q))


@pytest.mark.parametrize("B,sizes,C", [
    (2, ((1, 1), (1, 3), (2, 1)), 32),     # bands with no rows, C = 32
    (3, ((9, 17), (9, 5), (17, 5)), 96),   # 24-channel slices, B = 3
    (1, ((300, 7), (300, 40), (7, 40)), 128),
    # bands too large to stage in shared memory: read from device memory
    (1, ((1024, 96), (1024, 8), (96, 8)), 192),
    # slices wider than 32 channels: 40 (C 160, 320), 72 (C 288), 248
    # (C 992, 31 threads a pixel), one 32-channel group (C 1024)
    (2, ((9, 17), (9, 5), (17, 5)), 160),
    (1, ((46, 64), (46, 46), (64, 46)), 320),
    (2, ((5, 13), (5, 3), (13, 3)), 288),
    (1, ((23, 32), (23, 23), (32, 23)), 992),
    (2, ((6, 9), (6, 4), (9, 4)), 1024),
])
def test_tnorm_edge_shapes(card, B, sizes, C):
    """Planes shorter than the cluster's 8 bands, odd sizes, other
    widths and batches, bands the kernel cannot stage, with the FiLM: as
    `test_tnorm_main_path_shapes` against the plain version."""
    from sin3dm_tpu_torch.core import nn
    from sin3dm_tpu_torch.ops import tnorm
    g = torch.Generator().manual_seed(B * 100 + C)
    xs = [_randn(g, B, R, S, C).to(card, torch.bfloat16) for R, S in sizes]
    gam = [(1.0 + _randn(g, C, scale=0.2)).to(card) for _ in range(3)]
    bet = [_randn(g, C, scale=0.2).to(card) for _ in range(3)]
    fm = _randn(g, B, 2 * C, scale=0.3).to(card, torch.bfloat16)
    ys, coef, stacks = tnorm.tnorm_silu(xs, gam, bet, fm)
    _, pcoef, _ = tnorm.tnorm_silu_reference(xs, gam, bet, fm)
    torch.cuda.synchronize()
    scale = pcoef.abs().amax(dim=-1, keepdim=True)
    assert ((coef - pcoef).abs() <= 1e-4 * scale).all()
    for i, x in enumerate(xs):
        assert torch.equal(ys[i], nn.apply_film_coeffs(x, coef[i, 0],
                                                       coef[i, 1]))
    for y, pair in zip(ys, stacks):
        for st, dim in zip(pair, (-2, -3)):
            want = tnorm.stack3(y.mean(dim=dim)).float()
            tol = BF16_ULP * want.abs() + 1e-5 * y.float().abs().mean()
            assert ((st.float() - want).abs() <= tol).all()


def test_tnorm_refuses_what_it_does_not_take(card):
    from sin3dm_tpu_torch.ops import tnorm
    xs, gam, bet, _ = _tnorm_case(card, 1, 64, False)
    with pytest.raises(ValueError):
        tnorm.tnorm_silu([x.float() for x in xs], gam, bet)
    g = torch.Generator().manual_seed(5)
    C = 32 * 33       # a slice of lcm(8, 33) = 264 channels: too wide
    x = [_randn(g, 1, 4, 4, C).to(card, torch.bfloat16) for _ in range(3)]
    with pytest.raises(ValueError):
        tnorm.tnorm_silu(x, [torch.ones(C, device=card)] * 3,
                         [torch.zeros(C, device=card)] * 3)


# ---------------------------------------------------------------------------
# The chain's step replayed as a CUDA graph (diffusion/sampling.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_graph_chain_equals_the_eager_chain(card, masked):
    """DDIM-100 from the committed tag at its plane sizes, the sampler's
    bf16 forward: the sampler's graph chain (one capture at the first
    chain's first step, replays after) against the eager loop, bit for
    bit, on 3 seeds, plain and masked (`--inpaint`'s y0/mask); per chain
    K1 launches 800, all of the default form, the norm kernel's 900, and
    the graph's captures and replays 1 and 99, then 0 and 100."""
    import os
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core import profiling
    from sin3dm_tpu_torch.core.triplane import load_triplane_npz
    from sin3dm_tpu_torch.diffusion import sampling as ts
    tag = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "checkpoints", "towerruins")
    args = cli.cfgmod.sample_args(["--tag", tag, "--use_ddim", "true",
                                   "--timestep_respacing", "ddim100"])
    model, tables, dcfg = cli.build_model(args, card)
    feat = load_triplane_npz(cli.cfgmod.encoding_feat_path(tag), card)
    C, sizes = feat.channels, feat.sizes
    kw = {}
    if masked:
        kw = {"y0": feat.map(lambda p: p[None]),
              "mask": ts.region_keep_masks(sizes, (0, 0.5, 0, 1, 0, 1),
                                           card),
              "is_mask_t0": True}
    sample = ts.make_sampler(model, tables, dcfg, use_ddim=True,
                             device=card, **kw)
    for i, seed in enumerate((0, 1, 2)):
        gens = ts.sample_generators(seed, 0, 1, card)
        want = ts.ddim_sample_loop(model, tables, dcfg, gens, 1, C, sizes,
                                   device=card, **kw)
        before = profiling.counters()
        got = sample(seed, 0, 1, C, sizes)
        torch.cuda.synchronize()
        after = profiling.counters()
        worst = max((g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want))
        assert worst == 0.0, f"seed {seed}: largest difference {worst}"
        assert after["k1.launches"] - before["k1.launches"] == 800
        assert after["tnorm.launches"] - before["tnorm.launches"] == 900
        assert {f: n - before["k1.forms"].get(f, 0)
                for f, n in after["k1.forms"].items()
                if n != before["k1.forms"].get(f, 0)} == {"default": 800}
        assert (after["chain.graph_captures"]
                - before["chain.graph_captures"],
                after["chain.graph_replays"]
                - before["chain.graph_replays"]) == ((1, 99) if i == 0
                                                     else (0, 100))


@pytest.mark.parametrize("batch", [1, 2])
def test_ddpm_graph_chain_equals_the_eager_chain(card, batch):
    """The ancestral chain over a 50-step respaced schedule from the
    committed tag at its plane sizes, the sampler's bf16 forward: the
    sampler's graph chain, whose steps read each step's noise drawn from
    the samples' generators into the graph's static buffers, against
    the eager `p_sample_loop`, bit for bit, on 3 seeds at batch 1 and 2;
    per chain K1 launches 8 a step, the norm kernel's 9, and the graph's
    captures and replays 1 and 49, then 0 and 50."""
    import os
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core import profiling
    from sin3dm_tpu_torch.core.triplane import load_triplane_npz
    from sin3dm_tpu_torch.diffusion import sampling as ts
    tag = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "checkpoints", "towerruins")
    args = cli.cfgmod.sample_args(["--tag", tag, "--use_ddim", "true",
                                   "--timestep_respacing", "50"])
    model, tables, dcfg = cli.build_model(args, card)
    T = tables["betas"].shape[0]
    assert T == 50
    feat = load_triplane_npz(cli.cfgmod.encoding_feat_path(tag), card)
    C, sizes = feat.channels, feat.sizes
    sample = ts.make_sampler(model, tables, dcfg, use_ddim=False,
                             device=card)
    for i, seed in enumerate((0, 1, 2)):
        gens = ts.sample_generators(seed, 0, batch, card)
        want = ts.p_sample_loop(model, tables, dcfg, gens, batch, C, sizes,
                                device=card)
        before = profiling.counters()
        got = sample(seed, 0, batch, C, sizes)
        torch.cuda.synchronize()
        after = profiling.counters()
        worst = max((g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want))
        assert worst == 0.0, f"seed {seed}: largest difference {worst}"
        assert after["k1.launches"] - before["k1.launches"] == 8 * T
        assert after["tnorm.launches"] - before["tnorm.launches"] == 9 * T
        assert {f: n - before["k1.forms"].get(f, 0)
                for f, n in after["k1.forms"].items()
                if n != before["k1.forms"].get(f, 0)} == {"default": 8 * T}
        assert (after["chain.graph_captures"]
                - before["chain.graph_captures"],
                after["chain.graph_replays"]
                - before["chain.graph_replays"]) == ((1, T - 1) if i == 0
                                                     else (0, T))


# ---------------------------------------------------------------------------
# generate's decode worker beside the chain (training/ae.py)
# ---------------------------------------------------------------------------

def test_generate_decodes_beside_the_chain(card, tmp_path):
    """`generate` at the tests' small sizes, 3 samples in chunks of 2,
    DDIM-10: the last chunk's chain captures its own graph (batch 1)
    while the first chunk's decode waits to be handed over, then runs
    beside it.  Every file equals what a serial `cli.decode` of the same
    feat.npz files writes (the npz files' arrays: their zip entries carry
    the time of writing), and a `decode.*` span of another thread than
    the main one overlaps a `gen.chain` span."""
    import os
    import shutil
    import threading

    import numpy as np

    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core import profiling
    tag = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "checkpoints", "towerruins")

    def argv(out, *extra):
        return ["--tag", tag, "--device", "cuda", "--output", str(out),
                "--resize", "0.125", "0.125", "0.125", "--use_ddim", "true",
                "--timestep_respacing", "ddim10", "--reso", "32",
                "--texreso", "128", "--n_faces", "500", *extra]

    out, serial = tmp_path / "gen", tmp_path / "serial"
    profiling.collect()
    profiling.record(True)
    try:
        paths, _ = cli.generate(cli.cfgmod.sample_args(argv(
            out, "--n_samples", "3", "--pipeline_chunk", "2")))
    finally:
        profiling.record(False)
    spans = profiling.collect()
    assert len(paths) == 3
    copies = []
    for j in range(3):
        d = serial / f"{j:03d}"
        d.mkdir(parents=True)
        shutil.copy(out / f"{j:03d}" / "feat.npz", d / "feat.npz")
        copies.append(str(d / "feat.npz"))
    cli.decode(cli.cfgmod.sample_args(argv(serial)), copies)
    for j in range(3):
        a, b = out / f"{j:03d}", serial / f"{j:03d}"
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        assert "object.obj" in os.listdir(a)
        for name in os.listdir(a):
            if name.endswith(".npz"):
                with np.load(a / name) as x, np.load(b / name) as y:
                    for k in x.files:
                        np.testing.assert_array_equal(x[k], y[k])
            else:
                assert (a / name).read_bytes() == (b / name).read_bytes(), \
                    f"{j:03d}/{name}"
    main = threading.get_ident()
    chains = [(s.start_ns, s.end_ns) for s in spans
              if s.name == "gen.chain"]
    worker = [(s.start_ns, s.end_ns) for s in spans
              if s.name.startswith("decode.") and s.thread != main]
    assert len(chains) == 2 and worker
    assert any(min(b, d) > max(a, c) for a, b in chains for c, d in worker)
