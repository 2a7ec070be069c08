"""Port parity: the numpy checkpoint container and the weight carry-over.

The port's reader loads both committed checkpoints leaf for leaf equal to
the JAX package's `load_pytree` / `load_subtree`, and a file the port
writes reads back through `load_pytree`."""

import os

import jax
import numpy as np
import torch

from sin3dm_tpu.core import checkpoint as jckpt
from sin3dm_tpu.models import autoencoder as jae
from sin3dm_tpu.models.unet import UNetConfig, init_unet
from sin3dm_tpu_torch.compat.from_jax import (ae_params_from_jax,
                                               unet_params_from_jax)
from sin3dm_tpu_torch.core import checkpoint as tckpt

torch.set_num_threads(2)
TAG = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                   "towerruins")
EMA = os.path.join(TAG, "diffusion", "ema_0.9999_025000.pt")
AE = os.path.join(TAG, "encoding", "ckpt_final.pth")


def _pairs(a, b, path=""):
    """Leaves of two nested dict/list trees, asserting equal structure."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}/{i}")
    else:
        yield path, a, b


def test_ema_checkpoint_matches_load_pytree():
    like = init_unet(jax.random.PRNGKey(0), UNetConfig())
    want, _ = jckpt.load_pytree(EMA, like)
    got, _ = tckpt.load_tree(EMA)
    n = 0
    for path, g, w in _pairs(got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=path)
        n += 1
    assert n == 138
    params = unet_params_from_jax(got)
    for path, t, g in _pairs(params, got):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), g, err_msg=path)


def test_ae_checkpoint_matches_load_subtree():
    like = jae.init_autoencoder(jax.random.PRNGKey(0), jae.AEConfig())
    want, want_meta = jckpt.load_subtree(AE, like, "params")
    got, meta = tckpt.load_tree(AE, "params")
    assert meta == want_meta
    assert meta["featmap_size"] == [92, 128, 92]
    for path, g, w in _pairs(got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=path)
    params = ae_params_from_jax(got)
    assert params["geo_decoder"]["second"][-1]["w"].shape == (256, 1)
    assert len(params["tex_convs"]) == 1


def test_written_file_reads_back_through_load_pytree(tmp_path):
    tree, _ = tckpt.load_tree(EMA)
    rng = np.random.default_rng(0)
    tree["in_conv"]["xy"]["b"] = rng.standard_normal(64).astype(np.float32)
    path = str(tmp_path / "ema_port.pt")
    tckpt.save_tree(path, tree, meta={"step": 7})
    like = init_unet(jax.random.PRNGKey(0), UNetConfig())
    back, meta = jckpt.load_pytree(path, like)
    assert meta == {"step": 7}
    for p, g, w in _pairs(tree, back):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=p)
    assert tckpt.peek_paths(path) == jckpt.peek_paths(EMA)
