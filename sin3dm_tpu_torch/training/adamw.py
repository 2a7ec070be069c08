"""AdamW over flat fp32 buffers, as `optax.adamw` computes it; the AE and
diffusion trainers both update through `update`.

The parameters, mu and nu are one tensor each, in the parameter tree's
flatten order; the leaves the model reads are views of the parameter
buffer (`param_views`).  One update: mu = b1 mu + (1-b1) g, nu = b2 nu +
(1-b2) g^2, the count advanced, mu and nu bias-corrected by 1 - b^count,
mu_hat / (sqrt(nu_hat) + eps) (eps outside the root), plus weight_decay *
params, times -lr, where lr is the schedule's value at its count before
it advances; then, where given, times a per-element `scale` (the AE's
geometry split, which optax applies after AdamW), and, where given a NaN
guard's `ok`, the old parameters kept unless `ok`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import checkpoint as ckpt

B1, B2, EPS = 0.9, 0.999, 1e-8
INT32_MAX = 2 ** 31 - 1


def views(flat: torch.Tensor, like: Dict) -> Dict:
    """`flat` as a tree of views with `like`'s paths and shapes."""
    leaves, off = [], 0
    for _, leaf in ckpt.leaves_with_paths(like):
        n = leaf.numel()
        leaves.append(flat[off:off + n].view(leaf.shape))
        off += n
    return ckpt.unflatten_like(like, leaves)


def flatten(tree: Dict, device=None) -> torch.Tensor:
    """The leaves of `tree` as one fp32 buffer, in flatten order."""
    return torch.cat([torch.as_tensor(v, dtype=torch.float32,
                                      device=device).reshape(-1)
                      for _, v in ckpt.leaves_with_paths(tree)])


def layout(tree) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, shape) of every leaf, in flatten order."""
    return [(p, tuple(np.shape(v))) for p, v in ckpt.leaves_with_paths(tree)]


def param_views(flat: torch.Tensor, like: Dict) -> Dict:
    """`views` whose leaves require grad: the tree the model reads."""
    tree = views(flat, like)
    for _, v in ckpt.leaves_with_paths(tree):
        v.requires_grad_(True)
    return tree


def opt_tree(state, chained: bool = False) -> Dict:
    """The state's moments and counts in JAX's leaf layout (numpy leaves;
    `chained`: the AE's chain around adamw).  `state` has params, mu, nu,
    count, sched_count and tree()."""
    def np_tree(buf):
        return ckpt.unflatten_like(state.params, [
            v.cpu().numpy() for _, v in ckpt.leaves_with_paths(
                state.tree(buf))])
    return ckpt.adamw_tree(state.count, np_tree(state.mu), np_tree(state.nu),
                           state.sched_count, chained=chained)


def load_opt_tree(state, tree, chained: bool = False) -> None:
    """Set the state's moments and counts from JAX's leaf layout;
    ValueError where the tree does not fit the parameters."""
    count, mu, nu, sched = ckpt.adamw_from_tree(tree, chained=chained)
    for name, t in (("mu", mu), ("nu", nu)):
        if layout(t) != layout(state.params):
            raise ValueError(f"optimiser state: {name} does not fit the "
                             "parameters")
    with torch.no_grad():
        state.mu.copy_(flatten(mu, state.flat.device))
        state.nu.copy_(flatten(nu, state.flat.device))
    state.count, state.sched_count = count, sched


@torch.no_grad()
def update(state, g: torch.Tensor, lr: np.float32, weight_decay: float,
           scale: Optional[torch.Tensor] = None,
           ok: Optional[torch.Tensor] = None) -> None:
    """One AdamW update of the state's flat buffers from the flat
    gradient `g` at learning rate `lr` (see the module doc); advances
    `count` and, where it is not None, `sched_count`."""
    state.mu.mul_(B1).add_(g, alpha=1 - B1)
    state.nu.mul_(B2).addcmul_(g, g, value=1 - B2)
    state.count = min(state.count + 1, INT32_MAX)
    k = np.float32(state.count)
    bc1 = float(np.float32(1.0) - np.float32(B1) ** k)
    bc2 = float(np.float32(1.0) - np.float32(B2) ** k)
    upd = (state.mu / bc1) / (torch.sqrt(state.nu / bc2) + EPS)
    if weight_decay:
        upd = upd + weight_decay * state.flat
    if state.sched_count is not None:
        state.sched_count = min(state.sched_count + 1, INT32_MAX)
    upd = upd * float(-lr)
    if scale is not None:
        upd = upd * scale
    if ok is None:
        state.flat.add_(upd)
    else:
        state.flat.copy_(torch.where(ok, state.flat + upd, state.flat))
