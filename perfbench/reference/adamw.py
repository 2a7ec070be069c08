"""AdamW as optax computes it (b1 0.9, b2 0.999, eps 1e-8 outside the
root, decoupled weight decay), over {path: tensor} leaves, and the
diffusion trainer's learning-rate schedule."""

from __future__ import annotations

from typing import Dict

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor]):
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], lr: float,
             weight_decay: float) -> None:
        self.count += 1
        bc1 = 1.0 - B1 ** self.count
        bc2 = 1.0 - B2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(B1).add_(g, alpha=1 - B1)
            self.nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS)
            if weight_decay:
                upd = upd + weight_decay * p
            p.add_(upd * -lr)


def diffusion_lr(lr: float, anneal: int, count: int) -> float:
    """lr (1 - min(k / anneal, 1)) at the schedule's count k."""
    return float(lr * (1.0 - min(count / anneal, 1.0))) if anneal else lr

