"""Hand-written CUDA kernels (csrc/) with their wrappers and plain PyTorch versions."""

from __future__ import annotations

from typing import Any


def pack_params(tree: Any) -> Any:
    """A parameter tree (nested dicts and lists of tensors) with the bf16
    kernels' weight layouts beside the weights, packed once: "k1" in every
    dict whose "w" is a 3x3 conv's `[3, 3, C, Co]` (`pack_conv_weights` of
    the whole weight; the rollout convs' K1 reads its first C/3 input
    channels), "k2" in every skip head K2 takes (`pack_mlp_weights`).
    The packs are taken from the weights as they are now: code that
    changes the weights packs again.  The input tree is not modified."""
    from .fused_conv import pack_conv_weights
    from .fused_mlp import pack_mlp_weights

    if isinstance(tree, (list, tuple)):
        return [pack_params(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {k: pack_params(v) for k, v in tree.items()}
    w = tree.get("w")
    if w is not None and w.dim() == 4 and tuple(w.shape[:2]) == (3, 3):
        out["k1"] = pack_conv_weights(w)
    if "first" in tree and "second" in tree:
        try:
            out["k2"] = pack_mlp_weights(tree)
        except ValueError:   # a head K2 does not take: skip_mlp raises
            pass
    return out
