"""Checkpoint IO — a numpy reader and writer of the reference's container
(counterpart of `sin3dm_tpu/core/checkpoint.py`).

The container is a (compressed) npz whose keys are `{i:05d}|{path}`: `i`
is the leaf's position in JAX's pytree flatten order (dict keys sorted,
lists in order) and `path` the `/`-joined keys.  An optional `__meta__`
entry holds utf-8 JSON bytes.  Trees here are nested dicts and lists of
numpy arrays, so the JAX side's `load_pytree` reads what `save_tree`
writes when given a same-shaped `like` tree.

The diffusion trainer's optimiser state is written under the leaf paths
that JAX's `save_pytree` gives `optax.adamw(...).init(params)`
(`adamw_tree`): `0/.count` (int32), `0/.mu/<param path>`,
`0/.nu/<param path>` and, where the learning rate is a schedule,
`2/.count` (int32, the schedule's count).  The AE trainer's optimiser,
`optax.chain(adamw(schedule), multi_transform(geo: scale, tex:
identity))`, nests that state one level deeper (`chained`):
`0/0/.count`, `0/0/.mu/...`, `0/0/.nu/...`, `0/2/.count`; the
multi-transform's state has no leaves.  The layout is written out here,
not derived from optax.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

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


def leaves_with_paths(tree) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's flatten order (the container's order)."""
    return list(_flatten(tree))


def unflatten_like(like, leaves) -> Any:
    """A tree of `like`'s structure holding `leaves` in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)
    return build(like)


def adamw_tree(count: int, mu, nu, sched_count: Optional[int] = None,
               chained: bool = False) -> Dict:
    """The optimiser state in the leaf layout of JAX's
    `optax.adamw(...).init(params)`, or with `chained` of the AE's chain
    around it (see the module doc)."""
    tree = {"0": {".count": np.asarray(count, np.int32), ".mu": mu,
                  ".nu": nu}}
    if sched_count is not None:
        tree["2"] = {".count": np.asarray(sched_count, np.int32)}
    return {"0": tree} if chained else tree


def _unlist(tree):
    """A root of "0" alone comes back from `load_tree` as a list."""
    if isinstance(tree, list):
        return {str(i): v for i, v in enumerate(tree)}
    return tree


def adamw_from_tree(tree, chained: bool = False
                    ) -> Tuple[int, Any, Any, Optional[int]]:
    """(count, mu, nu, schedule count or None) from a tree that
    `load_tree` read from an `adamw_tree` file (of the same `chained`);
    raises ValueError on another layout."""
    tree = _unlist(tree)
    if chained:
        if not isinstance(tree, dict) or set(tree) != {"0"}:
            raise ValueError("not a chained adamw optimiser state: "
                             f"top-level keys {sorted(tree)}")
        tree = _unlist(tree["0"])
    adam = tree.get("0") if isinstance(tree, dict) else None
    if not isinstance(adam, dict) or set(adam) != {".count", ".mu", ".nu"} \
            or not set(tree) <= {"0", "2"}:
        raise ValueError("not an adamw optimiser state: top-level keys "
                         f"{sorted(tree) if isinstance(tree, dict) else tree}")
    sched = tree.get("2")
    return (int(adam[".count"]), adam[".mu"], adam[".nu"],
            None if sched is None else int(sched[".count"]))


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
