"""The port's CUDA kernels on the card: K1 and K2 against their plain
versions at edge shapes the main path does not reach (sizes of 1 and 2,
channel counts off the 16-byte vector width, ragged row and channel
tiles), the launch counters, and the wrappers' refusals.

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
