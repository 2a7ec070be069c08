"""Weight carry-over from the JAX package.

The port keeps JAX's parameter layouts (conv `[kh, kw, Cin, Co]`, linear
`[in, out]`, the same dict keys and list positions), so carrying a JAX
parameter pytree over is a rename: each leaf becomes a float32 tensor on
`device`, in the same nested dicts and lists.  The trees come as nested
numpy arrays, either read from a checkpoint by `core/checkpoint.py` or
built in a test with `jax.tree_util.tree_map(np.asarray, init_unet(...))`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_torch(tree: Any, device, path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device, f"{path}/{i}")
                for i, v in enumerate(tree)]
    a = np.asarray(tree)
    if a.dtype.kind != "f":
        raise ValueError(f"parameter {path} is not floating point "
                         f"({a.dtype})")
    return torch.as_tensor(a.astype(np.float32), device=device)


def _require(tree: Dict, keys, what: str) -> None:
    missing = [k for k in keys if k not in tree]
    if missing:
        raise ValueError(f"{what} parameters lack {missing}; got "
                         f"{sorted(tree)}")


def unet_params_from_jax(tree: Dict, device="cpu") -> Dict:
    """UNet parameters (`sin3dm_tpu.models.unet.init_unet` layout)."""
    _require(tree, ("time_embed", "in_conv", "down", "up", "out"), "UNet")
    return _to_torch(tree, device)


def ae_params_from_jax(tree: Dict, device="cpu") -> Dict:
    """Autoencoder parameters (`init_autoencoder` layout; the `params/`
    subtree of an AE checkpoint)."""
    _require(tree, ("geo_convs", "geo_decoder"), "autoencoder")
    return _to_torch(tree, device)
