"""Beta schedules, coefficient tables and timestep respacing
(counterpart of `sin3dm_tpu/diffusion/schedule.py`, kept as the port's
own copy).

Tables are computed in float64 numpy on the host; `tables_f32` hands
them out as float32 arrays that `diffusion.gaussian.tables_to_device`
moves to the card once per sampler.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence, Set, Union

import numpy as np


def get_named_beta_schedule(name: str, num_timesteps: int) -> np.ndarray:
    """Linear (Ho et al., scaled to any T) or cosine schedule
    (`gaussian_diffusion.py:19-43`)."""
    if name == "linear":
        scale = 1000.0 / num_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02, num_timesteps,
                           dtype=np.float64)
    if name == "cosine":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return betas_for_alpha_bar(num_timesteps, alpha_bar)
    raise NotImplementedError(f"unknown beta schedule: {name}")


def betas_for_alpha_bar(num_timesteps: int, alpha_bar,
                        max_beta: float = 0.999) -> np.ndarray:
    """Discretize a continuous alpha_bar into betas
    (`gaussian_diffusion.py:46-63`)."""
    betas = []
    for i in range(num_timesteps):
        t1 = i / num_timesteps
        t2 = (i + 1) / num_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Select a subset of timesteps for respaced sampling
    (`src/diffusion/respace.py:7-60`), including the "ddimN" stride rule."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: List[int] = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        taken = []
        for _ in range(count):
            taken.append(start_idx + round(cur))
            cur += frac_stride
        all_steps += taken
        start_idx += size
    return set(all_steps)


@dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed float64 coefficient tables for a (possibly respaced)
    diffusion process.  `timestep_map[t]` maps a respaced index back to the
    original process index fed to the model (`respace.py:116-128`)."""

    betas: np.ndarray
    timestep_map: np.ndarray          # [T] int32, identity if not respaced
    original_num_steps: int

    # derived (filled in __post_init__)
    alphas_cumprod: np.ndarray = field(init=False)
    alphas_cumprod_prev: np.ndarray = field(init=False)
    alphas_cumprod_next: np.ndarray = field(init=False)
    sqrt_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_one_minus_alphas_cumprod: np.ndarray = field(init=False)
    log_one_minus_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_recip_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_recipm1_alphas_cumprod: np.ndarray = field(init=False)
    posterior_variance: np.ndarray = field(init=False)
    posterior_log_variance_clipped: np.ndarray = field(init=False)
    posterior_mean_coef1: np.ndarray = field(init=False)
    posterior_mean_coef2: np.ndarray = field(init=False)
    fixed_large_variance: np.ndarray = field(init=False)
    fixed_large_log_variance: np.ndarray = field(init=False)

    def __post_init__(self):
        betas = np.asarray(self.betas, dtype=np.float64)
        assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        set_ = object.__setattr__
        set_(self, "alphas_cumprod", acp)
        set_(self, "alphas_cumprod_prev", np.append(1.0, acp[:-1]))
        set_(self, "alphas_cumprod_next", np.append(acp[1:], 0.0))
        set_(self, "sqrt_alphas_cumprod", np.sqrt(acp))
        set_(self, "sqrt_one_minus_alphas_cumprod", np.sqrt(1.0 - acp))
        set_(self, "log_one_minus_alphas_cumprod", np.log(1.0 - acp))
        with np.errstate(divide="ignore"):  # acp -> 0 at beta=1 (test
            # schedules): inf entries match the reference's table math
            # (`gaussian_diffusion.py:133-170`); silence the warning noise
            set_(self, "sqrt_recip_alphas_cumprod", np.sqrt(1.0 / acp))
            set_(self, "sqrt_recipm1_alphas_cumprod",
                 np.sqrt(1.0 / acp - 1))
        post_var = betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - acp)
        set_(self, "posterior_variance", post_var)
        set_(self, "posterior_log_variance_clipped",
             np.log(np.append(post_var[1], post_var[1:])))
        set_(self, "posterior_mean_coef1",
             betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - acp))
        set_(self, "posterior_mean_coef2",
             (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - acp))
        # FIXED_LARGE variance table (`gaussian_diffusion.py:282-285`)
        fl = np.append(post_var[1], betas[1:])
        set_(self, "fixed_large_variance", fl)
        set_(self, "fixed_large_log_variance", np.log(fl))

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def tables_f32(self) -> dict:
        """All per-step tables as float32 numpy, ready to ship to device."""
        keys = [
            "betas", "alphas_cumprod", "alphas_cumprod_prev",
            "alphas_cumprod_next", "sqrt_alphas_cumprod",
            "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
            "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
            "posterior_variance", "posterior_log_variance_clipped",
            "posterior_mean_coef1", "posterior_mean_coef2",
            "fixed_large_variance", "fixed_large_log_variance",
        ]
        out = {k: np.asarray(getattr(self, k), dtype=np.float32) for k in keys}
        out["log_betas"] = np.asarray(np.log(self.betas), dtype=np.float32)
        # 1 - acp subtracted in float64 BEFORE the f32 cast: at small t the
        # f32 round of acp~0.9999 would cost ~1e-3 relative error here
        out["one_minus_alphas_cumprod"] = np.asarray(
            1.0 - self.alphas_cumprod, dtype=np.float32)
        out["timestep_map"] = np.asarray(self.timestep_map, dtype=np.int32)
        return out


def make_schedule(noise_schedule: str = "linear", steps: int = 1000,
                  timestep_respacing: Union[str, Sequence[int], None] = ""
                  ) -> DiffusionSchedule:
    """Build a schedule, optionally respaced (`respace.py:63-86`):
    keep only the selected original steps and recompute betas so that the
    cumulative alpha product at the kept steps is preserved."""
    base_betas = get_named_beta_schedule(noise_schedule, steps)
    if not timestep_respacing:
        return DiffusionSchedule(
            betas=base_betas,
            timestep_map=np.arange(steps, dtype=np.int32),
            original_num_steps=steps)

    use = space_timesteps(steps, timestep_respacing)
    base_acp = np.cumprod(1.0 - base_betas)
    last = 1.0
    new_betas, tmap = [], []
    for i, a in enumerate(base_acp):
        if i in use:
            new_betas.append(1 - a / last)
            last = a
            tmap.append(i)
    return DiffusionSchedule(
        betas=np.array(new_betas, dtype=np.float64),
        timestep_map=np.array(tmap, dtype=np.int32),
        original_num_steps=steps)
