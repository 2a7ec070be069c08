"""Parameter trees for the reference: leaves keyed by their `/`-joined
path, in the flatten order of the checkpoint container (dict keys
sorted, lists in order), which is also the order of the program's flat
parameter buffers.

The container is an npz whose keys are `{i:05d}|{path}`, with an
optional `__meta__` entry of utf-8 JSON bytes.  Nothing here imports
the program.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def load_container(path: str, prefix: str = "") -> Tuple[Dict[str, np.ndarray],
                                                         Optional[dict]]:
    """({path: array} in stored order, meta) of the leaves under
    `prefix/` (the prefix stripped)."""
    want = prefix + "/" if prefix else ""
    leaves: Dict[str, np.ndarray] = {}
    meta = None
    with np.load(path, allow_pickle=False) as data:
        for k in sorted(data.files):
            if k == "__meta__":
                meta = json.loads(bytes(data[k]).decode())
                continue
            stored = k.split("|", 1)[1]
            if stored.startswith(want):
                leaves[stored[len(want):]] = np.asarray(data[k])
    if not leaves:
        raise ValueError(f"no leaves under {prefix!r} in {path}")
    return leaves, meta


def sort_key(path: str):
    """The flatten order of a path: list indices numerically, dict keys
    as strings (the container's order)."""
    return [(0, int(p), "") if p.isdigit() else (1, 0, p)
            for p in path.split("/")]


def ordered(paths) -> List[str]:
    return sorted(paths, key=sort_key)


def nest(flat: Dict[str, object]) -> Dict:
    """{path: leaf} -> nested dicts, with dicts keyed "0".."n-1" turned
    into lists (how the program's trees hold lists)."""
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        keys = list(node)
        if keys and all(k.isdigit() for k in keys) and \
                sorted(int(k) for k in keys) == list(range(len(keys))):
            return [node[str(i)] for i in range(len(keys))]
        return node
    return listify(tree)


def to_device(flat: Dict[str, np.ndarray], device,
              requires_grad: bool = False) -> Dict[str, torch.Tensor]:
    out = {}
    for k in ordered(flat):
        t = torch.as_tensor(np.asarray(flat[k], np.float32), device=device)
        out[k] = t.clone().requires_grad_(requires_grad)
    return out


def leaf_norms(flat: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The fp64 norm of every leaf."""
    return {k: float(v.detach().double().norm()) for k, v in flat.items()}


def split_flat(buf: torch.Tensor, like: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """A flat buffer in flatten order as {path: leaf} of `like`'s shapes."""
    out, off = {}, 0
    for k in ordered(like):
        n = like[k].numel()
        out[k] = buf[off:off + n].view(like[k].shape)
        off += n
    if off != buf.numel():
        raise ValueError(f"flat buffer of {buf.numel()} values for leaves "
                         f"of {off}")
    return out
