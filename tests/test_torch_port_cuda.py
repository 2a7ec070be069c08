"""The port's CUDA kernels on the card: K1, its act/skip/emit_stats forms
K1′ and K2 against their plain versions at edge shapes the main path does
not reach (sizes of 1 and 2, channel counts off the 16-byte vector width,
ragged row and channel tiles, stats blocks that end mid-row of a batch
item), the launch counters, and the wrappers' refusals.

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
    got = tfm.skip_mlp(params, x, mxu_dtype=dt)
    assert tfm.skip_mlp.launches == before + 1
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
