"""Checkpoint IO — a numpy reader and writer of the reference's container
(counterpart of `sin3dm_tpu/core/checkpoint.py`).

The container is a (compressed) npz whose keys are `{i:05d}|{path}`: `i`
is the leaf's position in JAX's pytree flatten order (dict keys sorted,
lists in order) and `path` the `/`-joined keys.  An optional `__meta__`
entry holds utf-8 JSON bytes.  Trees here are nested dicts and lists of
numpy arrays, so the JAX side's `load_pytree` reads what `save_tree`
writes when given a same-shaped `like` tree.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np


def _meta(data) -> Optional[Dict]:
    if "__meta__" in data.files:
        return json.loads(bytes(data["__meta__"]).decode())
    return None


def _insert(tree: Dict, parts, leaf) -> None:
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def _listify(node):
    """Turn dicts whose keys are exactly "0".."n-1" into lists (how
    pytree paths spell list indices)."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    keys = list(node)
    if keys and all(k.isdigit() for k in keys) and \
            sorted(int(k) for k in keys) == list(range(len(keys))):
        return [node[str(i)] for i in range(len(keys))]
    return node


def load_tree(path: str, prefix: str = "") -> Tuple[Any, Optional[Dict]]:
    """Read every leaf (or those under `prefix/`) into nested dicts and
    lists of numpy arrays.  Returns (tree, meta)."""
    want = prefix + "/" if prefix else ""
    tree: Dict = {}
    with np.load(path, allow_pickle=False) as data:
        meta = _meta(data)
        for k in sorted(data.files):
            if k == "__meta__":
                continue
            stored = k.split("|", 1)[1]
            if not stored.startswith(want):
                continue
            _insert(tree, stored[len(want):].split("/"), np.asarray(data[k]))
    if not tree:
        raise ValueError(f"no leaves under '{prefix}' in {path}")
    return _listify(tree), meta


def peek_paths(path: str):
    """Stored leaf paths in a checkpoint."""
    with np.load(path, allow_pickle=False) as data:
        return [k.split("|", 1)[1] for k in sorted(data.files)
                if k != "__meta__"]


def _flatten(tree, prefix=""):
    """Leaves in JAX's flatten order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def save_tree(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    """Write nested dicts/lists of arrays (numpy or CPU tensors) in the
    container format, atomically (tmp file + rename)."""
    arrays = {}
    for i, (p, leaf) in enumerate(_flatten(tree)):
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().cpu().numpy()
        arrays[f"{i:05d}|{p}"] = np.asarray(leaf)
    if meta is not None:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object keeps np from adding .npz
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)
