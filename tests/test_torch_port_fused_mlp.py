"""Port parity of kernel K2's plain version, `skip_mlp_reference`, against
the JAX package's Pallas kernel `skip_mlp_fused` (interpret mode on the
CPU), in fp32 and with bf16 operands.

The CUDA kernel itself runs only on the card: `chip_smoke.py` and
`tests/test_torch_port_cuda.py` hold it against this plain version
there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.models.autoencoder import _mlp_skip_init
from sin3dm_tpu.ops.fused_mlp import skip_mlp_fused
from sin3dm_tpu_torch.ops import fused_mlp as tfm
from sin3dm_tpu_torch.ops import pack_params

torch.set_num_threads(2)


def _head(seed, cin, cout, hidden, n_hidden):
    jp = _mlp_skip_init(jax.random.PRNGKey(seed), cin, cout, hidden,
                        n_hidden)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                jp)
    return jp, tp


@pytest.mark.parametrize("cin,cout,hidden,n_hidden,n", [
    (64, 1, 256, 4, 1000),    # the towerruins geometry head
    (64, 3, 256, 4, 777),     # the towerruins texture head
    (32, 4, 64, 2, 300),
])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_matches_pallas(cin, cout, hidden, n_hidden, n, dt):
    """fp32: summation order only, 1e-5 relative to the output scale.
    bf16 operands: both sides multiply the same bf16-rounded operands in
    fp32; a hidden activation whose fp32 sum lands the other side of a
    bf16 rounding boundary moves the output by a fraction of one bf16
    step, so the bound is 2^-8 of the output scale."""
    jp, tp = _head(0, cin, cout, hidden, n_hidden)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((n, cin)) * 0.5).astype(np.float32)
    want = np.asarray(skip_mlp_fused(jp, jnp.asarray(x), tile_n=256,
                                     mxu_dtype=getattr(jnp, dt)))
    got = tfm.skip_mlp(tp, torch.from_numpy(x),
                       mxu_dtype=getattr(torch, dt)).numpy()
    assert got.shape == (n, cout) and got.dtype == np.float32
    scale = np.abs(want).max()
    tol = 1e-5 if dt == "float32" else 2.0 ** -8
    assert np.abs(got - want).max() <= tol * scale


def test_pack_weights_layout_and_checks():
    _, tp = _head(2, 64, 3, 256, 4)
    wts, bias, dims = tfm.pack_weights(tp, torch.bfloat16)
    assert dims == (64, 256, 3, 3, 3)
    assert wts.dtype == torch.bfloat16 and bias.dtype == torch.float32
    layers = tp["first"] + tp["second"]
    assert wts.numel() == sum(lp["w"].numel() for lp in layers)
    torch.testing.assert_close(wts[:64 * 256].view(64, 256),
                               tp["first"][0]["w"].bfloat16())
    _, bad = _head(3, 24, 3, 64, 2)   # cin not a multiple of 16
    with pytest.raises(ValueError, match="multiples of 16"):
        tfm.pack_weights(bad, torch.float32)


def _unpack_mlp(pk, params):
    """Each layer's [K, N] weight and [N] bias back from the bf16 kernel's
    packed chunks (`pack_mlp_weights`), following the table alone."""
    cin = pk["dims"][0]
    n_first = pk["dims"][3]
    wbytes = pk["wts"]
    layers = tfm._layers(params)
    got = [torch.zeros(lp["w"].shape, dtype=torch.bfloat16) for lp in layers]
    seen = [torch.zeros(lp["w"].shape[0], dtype=torch.int64) for lp in layers]
    for l, src, k0, kc, off16, npad, flags, _ in pk["table"].tolist():
        blk = wbytes[off16 * 16: off16 * 16 + npad * kc * 2].view(
            torch.bfloat16).reshape(npad // 8, kc // 8, 8, 8)
        blk = blk.permute(0, 2, 1, 3).reshape(npad, kc)      # [n, k]
        N = layers[l]["w"].shape[1]
        assert not blk[N:].any()                               # zero padding
        k = k0 + (cin if src == 1 and l == n_first else 0)
        got[l][k:k + kc] = blk[:N].t()
        seen[l][k:k + kc] += 1
    bias = [pk["bias"][l, :lp["b"].numel()] for l, lp in enumerate(layers)]
    for l, lp in enumerate(layers):
        assert (seen[l] == 1).all()                            # each row once
        assert not pk["bias"][l, lp["b"].numel():].any()
    return got, bias


@pytest.mark.parametrize("cin,cout,hidden,n_hidden", [
    (64, 1, 256, 4),      # the towerruins geometry head
    (64, 3, 256, 4),      # the towerruins texture head
    (32, 4, 64, 2),
    (16, 3, 48, 0),       # widths off the 64-row chunk grid
    (64, 8, 256, 2),      # the widest last layer that takes m64n8
    (32, 12, 64, 2),      # a last layer wider than 8: padded to 256
])
def test_pack_mlp_weights_unpacks_exactly(cin, cout, hidden, n_hidden):
    """The bf16 kernel's layout holds every weight exactly once, rounded
    to bf16, and the table walks each layer's K in order: x before h in
    the skip layer, first/last flags on each layer's chunk run."""
    _, tp = _head(4, cin, cout, hidden, n_hidden)
    pk = tfm.pack_mlp_weights(tp)
    assert pk["dims"] == tfm._dims(tp)
    assert pk["wts"].dtype == torch.uint8 and pk["table"].dtype == torch.int32
    got, bias = _unpack_mlp(pk, tp)
    for g, b, lp in zip(got, bias, tfm._layers(tp)):
        assert torch.equal(g, lp["w"].bfloat16())
        assert torch.equal(b, lp["b"].float())
    tab = pk["table"].tolist()
    n_layers = len(tfm._layers(tp))
    assert [r[0] for r in tab] == sorted(r[0] for r in tab)
    for l in range(n_layers):
        rows = [r for r in tab if r[0] == l]
        assert rows[0][6] & 1 and rows[-1][6] & 2
        assert all(r[3] % 16 == 0 and 0 < r[3] <= 64 for r in rows)
        assert all(bool(r[6] & 4) == (l == n_layers - 1) for r in rows)
        if l == pk["dims"][3]:                       # the skip layer
            assert [r[1] for r in rows] == sorted(r[1] for r in rows)
    last = [r for r in tab if r[0] == n_layers - 1]
    assert all(r[5] == (8 if cout <= 8 else 256) for r in last)


def test_pack_params_packs_each_skip_head_once():
    """`pack_params` puts each head's `pack_mlp_weights` beside it as
    "k2" (a head K2 does not take stays unpacked, for skip_mlp to refuse)
    and leaves the tree it was given as it was."""
    _, geo = _head(5, 64, 1, 256, 4)
    _, odd = _head(6, 24, 3, 64, 2)      # cin not a multiple of 16
    tree = {"geo_decoder": geo, "odd_decoder": odd}
    packed = pack_params(tree)
    want = tfm.pack_mlp_weights(geo)
    got = packed["geo_decoder"]["k2"]
    assert got["dims"] == want["dims"]
    for k in ("wts", "bias", "table"):
        assert torch.equal(got[k], want[k])
    assert "k2" not in packed["odd_decoder"] and "k2" not in geo
    assert packed["geo_decoder"]["first"][0]["w"] is geo["first"][0]["w"]
    x = torch.randn(50, 64)
    assert torch.equal(tfm.skip_mlp(packed["geo_decoder"], x, torch.bfloat16),
                       tfm.skip_mlp(geo, x, torch.bfloat16))


@pytest.mark.parametrize("what", ["x", "weights"])
def test_skip_mlp_refuses_grad(what):
    """K2 has no backward: where autograd would record the call (x or a
    weight that requires grad, grad mode on) `skip_mlp` raises on the CPU
    as it does on the card, though the plain version it computes here is
    differentiable; under `torch.no_grad` it runs."""
    _, head = _head(7, 32, 3, 64, 2)
    x = torch.randn(40, 32)
    if what == "x":
        x.requires_grad_()
    else:
        head["second"][-1]["b"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tfm.skip_mlp(head, x)
    with torch.no_grad():
        out = tfm.skip_mlp(head, x)
    assert torch.equal(out, tfm.skip_mlp_reference(head, x.detach()))
