"""Port parity of kernel K1's plain version, `conv3x3_rollout_reference`,
against the JAX package's Pallas kernel `conv3x3_rollout_fused` (run in
interpret mode on the CPU, as its own tests run it) and against the JAX
rollout conv without the kernel (`_tconv_apply_rollout_fast`).

The CUDA kernel itself runs only on the card: `chip_smoke.py` and
`tests/test_torch_port_cuda.py` hold it against this plain version
there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core.triplane import Triplane as JT
from sin3dm_tpu.models import unet as JU
from sin3dm_tpu.ops.fused_conv import conv3x3_rollout_fused
from sin3dm_tpu_torch.core.triplane import Triplane as TT
from sin3dm_tpu_torch.models import unet as TU
from sin3dm_tpu_torch.ops import fused_conv as tfc

torch.set_num_threads(2)
F32_TOL = dict(rtol=2e-5, atol=2e-5)   # summation order only
BF16_EPS = 2.0 ** -8                    # bf16 unit roundoff


def _case(seed, B, H, W, C, Co, rollout):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    x = f(B, H, W, C)
    w = f(3, 3, C, Co, scale=(9 * C) ** -0.5)
    b = f(Co, scale=0.1)
    col = [f(B, W, Co, scale=0.3) for _ in range(3)] if rollout else None
    row = [f(B, H, Co, scale=0.3) for _ in range(3)] if rollout else None
    return x, w, b, col, row


def _jax(x, w, b, col, row, dt):
    col3 = tuple(jnp.asarray(c, dt) for c in col) if col else None
    row3 = tuple(jnp.asarray(r, dt) for r in row) if row else None
    y = conv3x3_rollout_fused(jnp.asarray(x, dt), jnp.asarray(w),
                              jnp.asarray(b), col3, row3, tile_h=8,
                              mxu_dtype=dt)
    return np.asarray(y.astype(jnp.float32))


def _port(x, w, b, col, row, dt):
    stack = lambda vs: (torch.from_numpy(np.stack(vs, axis=2)).to(dt)
                        if vs else None)
    y = tfc.conv3x3_rollout(torch.from_numpy(x).to(dt), torch.from_numpy(w),
                            torch.from_numpy(b), stack(col), stack(row))
    assert y.dtype == dt
    return y.float().numpy()


@pytest.mark.parametrize("shape,rollout", [
    ((1, 12, 20, 32, 32), True),
    ((2, 9, 17, 64, 64), True),     # odd sizes, batch 2
    ((1, 16, 16, 64, 128), False),  # plain conv + bias (unet_raw form)
    ((1, 2, 3, 32, 32), True),      # rows/cols that are all border
    ((1, 11, 13, 192, 64), True),   # JAX splits C at 64 in fp32
])
def test_plain_matches_pallas_fp32(shape, rollout):
    args = _case(0, *shape, rollout)
    want = _jax(*args, jnp.float32)
    got = _port(*args, torch.float32)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("C", [64, 192])
def test_plain_matches_pallas_bf16(C):
    """bf16 in and out, fp32 accumulation, one rounding.  At C=64 both
    sides round the same fp32 sum once: they differ by at most one bf16
    step where summation order tips the rounding.  At C=192 the JAX
    kernel splits the input channels into 128 + 64, rounds each partial
    conv to bf16 and adds them in bf16 (three roundings, the port one):
    the bound is then 3/2 bf16 ulps of the largest partial magnitude,
    taken as 2 * 2^-8 of the output's largest magnitude."""
    args = _case(1, 2, 10, 14, C, 64, True)
    want = _jax(*args, jnp.bfloat16)
    got = _port(*args, torch.bfloat16)
    err = np.abs(got - want)
    scale = np.abs(want).max()
    if C == 64:
        assert (err <= 2 * BF16_EPS * np.abs(want) + 1e-6 * scale).all()
    else:
        assert err.max() <= 2 * 2 * BF16_EPS * scale
        assert err.mean() <= 0.25 * BF16_EPS * scale


@pytest.mark.parametrize("sizes", [(12, 20, 8), (9, 17, 5)])
def test_rollout_tconv_matches_jax_unfused(sizes):
    """The port's rollout conv (mean vectors -> packed col3/row3 -> K1's
    plain version) == JAX `_tconv_apply` without the kernel, fp32."""
    H, W, D = sizes
    C, Co = 32, 32
    rng = np.random.default_rng(2)
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, H, W, C), (2, H, D, C), (2, W, D, C))]
    params = {k: {"w": (rng.standard_normal((3, 3, 3 * C, Co))
                        * (27 * C) ** -0.5).astype(np.float32),
                  "b": rng.standard_normal(Co).astype(np.float32)}
              for k in ("xy", "xz", "yz")}
    want = JU._tconv_apply(
        {k: {n: jnp.asarray(a) for n, a in v.items()}
         for k, v in params.items()},
        JT(*map(jnp.asarray, planes)), rollout=True, fused=False)
    got = TU._tconv_apply(
        {k: {n: torch.from_numpy(a) for n, a in v.items()}
         for k, v in params.items()},
        TT(*map(torch.from_numpy, planes)), rollout=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


def test_rollout_vectors_match_jax():
    """Packed (s_top, s_full, s_bot) / (r_left, r_full, r_right) equal the
    JAX tuples."""
    rng = np.random.default_rng(3)
    vec = rng.standard_normal((2, 9, 16)).astype(np.float32)
    kb = rng.standard_normal((3, 3, 16, 8)).astype(np.float32)
    for jf, tf in ((JU._colvar_vecs, TU._colvar_vecs),
                   (JU._rowvar_vecs, TU._rowvar_vecs)):
        want = jf(jnp.asarray(vec), jnp.asarray(kb))
        got = tf(torch.from_numpy(vec), torch.from_numpy(kb))
        assert got.shape == (2, 9, 3, 8)
        for v in range(3):
            np.testing.assert_allclose(got[:, :, v].numpy(),
                                       np.asarray(want[v]), **F32_TOL)


def test_wrapper_rejects_half_a_rollout():
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(3, 3, 8, 8)
    with pytest.raises(ValueError, match="both col3 and row3"):
        tfc.conv3x3_rollout(x, w, None, torch.zeros(1, 4, 3, 8), None)
