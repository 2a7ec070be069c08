"""Hand-written CUDA kernels (csrc/) with their wrappers and plain PyTorch versions."""

from __future__ import annotations

from typing import Any


PLANES = ("xy", "xz", "yz")


def pack_params(tree: Any, rollout: bool = False) -> Any:
    """A parameter tree (nested dicts and lists of tensors) with the bf16
    kernels' weight layouts beside the weights, packed once: "k1" in every
    dict whose "w" is a 3x3 conv's `[3, 3, C, Co]` (`pack_conv_weights` of
    the whole weight; the rollout convs' K1 reads its first C/3 input
    channels), "k2" in every skip head K2 takes (`pack_mlp_weights`).
    With `rollout` (a UNet whose 3x3 triplane convs are rollout convs),
    each plane of such a conv (a dict of "xy", "xz", "yz" 3x3 convs) also
    gets "k1v", its col3 and row3 kernels (`pack_rollout_taps`; the xy
    plane's col-varying block comes first, the others' row-varying, as
    `models/unet.py:_rollout_cat` concatenates them).  The packs are taken
    from the weights as they are now: code that changes the weights packs
    again.  The input tree is not modified."""
    from .fused_conv import pack_conv_weights, pack_rollout_taps
    from .fused_mlp import pack_mlp_weights

    if isinstance(tree, (list, tuple)):
        return [pack_params(v, rollout) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {k: pack_params(v, rollout) for k, v in tree.items()}
    w = tree.get("w")
    if w is not None and w.dim() == 4 and tuple(w.shape[:2]) == (3, 3):
        out["k1"] = pack_conv_weights(w)
    ws = [tree[k].get("w") if isinstance(tree.get(k), dict) else None
          for k in PLANES]
    if rollout and all(v is not None and v.dim() == 4
                       and tuple(v.shape[:2]) == (3, 3) and v.shape[2] % 3 == 0
                       for v in ws):
        for k, v in zip(PLANES, ws):
            out[k]["k1v"] = pack_rollout_taps(v, k == "xy")
    if "first" in tree and "second" in tree:
        try:
            out["k2"] = pack_mlp_weights(tree)
        except ValueError:   # a head K2 does not take: skip_mlp raises
            pass
    return out
