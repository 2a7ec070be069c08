"""Port parity: `process_planes` + `decode_grid_dense` on the committed
towerruins AE weights and the committed `encoding/feat.npz`, at
`--reso 32`, against the JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sin3dm_tpu.core import checkpoint as jckpt
from sin3dm_tpu.core.triplane import load_triplane_npz as jload
from sin3dm_tpu.dataio.grid import grid_resolutions as jgrid
from sin3dm_tpu.models import autoencoder as jae
from sin3dm_tpu_torch.compat.from_jax import ae_params_from_jax
from sin3dm_tpu_torch.core import checkpoint as tckpt
from sin3dm_tpu_torch.core.triplane import load_triplane_npz as tload
from sin3dm_tpu_torch.dataio.grid import grid_resolutions as tgrid
from sin3dm_tpu_torch.models import autoencoder as tae

torch.set_num_threads(2)
ENC = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                   "towerruins", "encoding")


@pytest.fixture(scope="module")
def committed():
    like = jae.init_autoencoder(jax.random.PRNGKey(0), jae.AEConfig())
    jparams, meta = jckpt.load_subtree(os.path.join(ENC, "ckpt_final.pth"),
                                       like, "params")
    tree, _ = tckpt.load_tree(os.path.join(ENC, "ckpt_final.pth"), "params")
    jfeat = jload(os.path.join(ENC, "feat.npz")).map(lambda p: p[None])
    tfeat = tload(os.path.join(ENC, "feat.npz")).map(lambda p: p[None])
    res = tuple(int(v) for v in tgrid(np.asarray(meta["aabb"]), 32))
    assert res == tuple(int(v) for v in jgrid(np.asarray(meta["aabb"]), 32))
    return jparams, ae_params_from_jax(tree), jfeat, tfeat, res


def test_process_planes(committed):
    jparams, tparams, jfeat, tfeat, _ = committed
    jg, jt = jae.process_planes(jparams, jae.AEConfig(), jfeat)
    tg, tt = tae.process_planes(tparams, tae.AEConfig(), tfeat)
    for got, want in zip(list(tg) + list(tt), list(jg) + list(jt)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_decode_grid_dense_fp32(committed, monkeypatch):
    """fp32 head operands: summation order only (sdf ~1e-2, tex in
    [0, 1]): 1e-5 of each channel group's scale."""
    monkeypatch.setenv("SIN3DM_DECODE_BF16", "0")
    jparams, tparams, jfeat, tfeat, res = committed
    jgp, jtp = jae.process_planes(jparams, jae.AEConfig(), jfeat)
    want = np.asarray(jae.decode_grid_dense(jparams, jae.AEConfig(), jgp, jtp,
                                            res, 8, False, fused_heads=False))
    tgp, ttp = tae.process_planes(tparams, tae.AEConfig(), tfeat)
    got = tae.decode_grid_dense(tparams, tae.AEConfig(), tgp, ttp,
                                res).numpy()
    assert got.shape == want.shape == res + (4,)
    for sl in (slice(0, 1), slice(1, 4)):
        scale = np.abs(want[..., sl]).max()
        np.testing.assert_allclose(got[..., sl], want[..., sl], rtol=0,
                                   atol=1e-5 * scale)
    np.testing.assert_array_equal(got[..., 0] < 0, want[..., 0] < 0)


def test_decode_grid_dense_bf16_heads(committed, monkeypatch):
    """bf16 head operands (the default) against JAX's fused bf16 heads
    (Pallas, interpret mode): the same rounded operands, fp32 sums, so
    within 2^-8 of each channel group's scale."""
    monkeypatch.setenv("SIN3DM_DECODE_BF16", "1")
    jparams, tparams, jfeat, tfeat, res = committed
    jgp, jtp = jae.process_planes(jparams, jae.AEConfig(), jfeat)
    want = np.asarray(jae.decode_grid_dense(jparams, jae.AEConfig(), jgp, jtp,
                                            res, 8, False, fused_heads=True))
    monkeypatch.delenv("SIN3DM_DECODE_BF16")
    assert tae.decode_mxu_dtype() == torch.bfloat16
    tgp, ttp = tae.process_planes(tparams, tae.AEConfig(), tfeat)
    got = tae.decode_grid_dense(tparams, tae.AEConfig(), tgp, ttp,
                                res).numpy()
    for sl in (slice(0, 1), slice(1, 4)):
        scale = np.abs(want[..., sl]).max()
        assert np.abs(got[..., sl] - want[..., sl]).max() <= 2 ** -8 * scale
