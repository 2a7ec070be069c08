"""DDPM/DDIM sampling math over Triplanes (the sampling half of
`sin3dm_tpu/diffusion/gaussian.py`).

Stateless functions over a dict of float32 coefficient tables on the
device (`tables_to_device`).  The diffusion state is the Triplane itself;
timestep respacing is folded in through `tables['timestep_map']`.
Training losses come with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core.triplane import Triplane


class MeanType(enum.Enum):
    START_X = "start_x"
    EPSILON = "epsilon"


class VarType(enum.Enum):
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class DiffusionConfig(NamedTuple):
    mean_type: MeanType = MeanType.START_X
    var_type: VarType = VarType.FIXED_LARGE
    rescale_timesteps: bool = False
    original_num_steps: int = 1000


# ModelFn: (x_t: Triplane, t_model: [B] tensor) -> Triplane
ModelFn = Callable[[Triplane, torch.Tensor], Triplane]


def tables_to_device(tables_np: Dict[str, np.ndarray],
                     device) -> Dict[str, torch.Tensor]:
    """`DiffusionSchedule.tables_f32()` -> tensors on `device`
    (timestep_map as int64, the rest float32)."""
    return {k: torch.as_tensor(v, device=device,
                               dtype=(torch.int64 if k == "timestep_map"
                                      else torch.float32))
            for k, v in tables_np.items()}


def _bcast(coef: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """A `[B]` coefficient as `[B, 1, 1, 1]` in the plane's dtype."""
    return coef.reshape((-1,) + (1,) * (plane.dim() - 1)).to(plane.dtype)


def extract(tables: Dict[str, torch.Tensor], name: str, t: torch.Tensor,
            like: Triplane) -> Triplane:
    coef = tables[name][t]
    return Triplane(_bcast(coef, like.xy), _bcast(coef, like.xz),
                    _bcast(coef, like.yz))


def model_timesteps(tables, cfg: DiffusionConfig,
                    t: torch.Tensor) -> torch.Tensor:
    """Respacing remap + optional 0..1000 rescale."""
    new_t = tables["timestep_map"][t]
    if cfg.rescale_timesteps:
        return new_t.float() * (1000.0 / cfg.original_num_steps)
    return new_t


def q_posterior_mean(tables, x_start: Triplane, x_t: Triplane,
                     t: torch.Tensor) -> Triplane:
    """Mean of q(x_{t-1} | x_t, x_0)."""
    c1 = extract(tables, "posterior_mean_coef1", t, x_t)
    c2 = extract(tables, "posterior_mean_coef2", t, x_t)
    return c1 * x_start + c2 * x_t


def predict_xstart_from_eps(tables, x_t: Triplane, t,
                            eps: Triplane) -> Triplane:
    a = extract(tables, "sqrt_recip_alphas_cumprod", t, x_t)
    b = extract(tables, "sqrt_recipm1_alphas_cumprod", t, x_t)
    return a * x_t - b * eps


def predict_eps_from_xstart(tables, x_t: Triplane, t,
                            xstart: Triplane) -> Triplane:
    a = extract(tables, "sqrt_recip_alphas_cumprod", t, x_t)
    binv = extract(tables, "sqrt_recipm1_alphas_cumprod", t, x_t)
    num = a * x_t - xstart
    return Triplane(num.xy / binv.xy, num.xz / binv.xz, num.yz / binv.yz)


class PMeanVar(NamedTuple):
    mean: Triplane
    log_variance: Triplane
    pred_xstart: Triplane


def p_mean_variance(model: ModelFn, tables, cfg: DiffusionConfig,
                    x: Triplane, t: torch.Tensor,
                    clip_denoised: bool = True) -> PMeanVar:
    """Model posterior p(x_{t-1} | x_t)."""
    out = model(x, model_timesteps(tables, cfg, t))
    if cfg.var_type == VarType.LEARNED_RANGE:
        C = x.channels
        model_output = out.map(lambda p: p[..., :C])
        learned_var = out.map(lambda p: p[..., C:])
        min_log = extract(tables, "posterior_log_variance_clipped", t, x)
        max_log = extract(tables, "log_betas", t, x)

        def mix(v, lo, hi):
            frac = (v + 1.0) * 0.5
            return frac * hi + (1.0 - frac) * lo
        log_var = Triplane(*[mix(v, lo, hi) for v, lo, hi
                             in zip(learned_var, min_log, max_log)])
    elif cfg.var_type == VarType.FIXED_LARGE:
        model_output = out
        log_var = extract(tables, "fixed_large_log_variance", t, x)
    else:  # FIXED_SMALL
        model_output = out
        log_var = extract(tables, "posterior_log_variance_clipped", t, x)

    def process(xs: Triplane) -> Triplane:
        if clip_denoised:
            return xs.map(lambda p: p.clamp(-1.0, 1.0))
        return xs

    if cfg.mean_type == MeanType.START_X:
        pred_xstart = process(model_output)
    else:  # EPSILON
        pred_xstart = process(
            predict_xstart_from_eps(tables, x, t, model_output))
    mean = q_posterior_mean(tables, pred_xstart, x, t)
    return PMeanVar(mean=mean, log_variance=log_var, pred_xstart=pred_xstart)


def _nonzero_t(t: torch.Tensor, x: Triplane) -> Triplane:
    nz = (t != 0).to(x.dtype)
    return Triplane(_bcast(nz, x.xy), _bcast(nz, x.xz), _bcast(nz, x.yz))


def p_sample_step(model: ModelFn, tables, cfg: DiffusionConfig,
                  x: Triplane, t: torch.Tensor, noise: Triplane,
                  clip_denoised: bool = True) -> Triplane:
    """One ancestral sampling step with pre-drawn `noise`."""
    out = p_mean_variance(model, tables, cfg, x, t, clip_denoised)
    sigma = out.log_variance.map(lambda lv: torch.exp(0.5 * lv))
    return out.mean + _nonzero_t(t, x) * sigma * noise


def ddim_sample_step(model: ModelFn, tables, cfg: DiffusionConfig,
                     x: Triplane, t: torch.Tensor,
                     noise: Optional[Triplane], eta: float = 0.0,
                     clip_denoised: bool = True,
                     y0: Optional[Triplane] = None,
                     mask: Optional[Triplane] = None,
                     is_mask_t0: bool = False) -> Triplane:
    """One DDIM step.  `noise` may be None only for eta == 0, where the
    noise term is exactly zero.

    With `y0` and `mask` (masked generation): pred_xstart becomes
    `mask * y0 + (1 - mask) * pred_xstart` before eps is re-derived, so
    mask = 1 keeps y0 -- at every step with `is_mask_t0`, else at every
    step but the last (t = 0)."""
    out = p_mean_variance(model, tables, cfg, x, t, clip_denoised)
    pred_xstart = out.pred_xstart
    if y0 is not None and mask is not None:
        blended = mask * y0 + mask.map(lambda m: 1.0 - m) * pred_xstart
        if is_mask_t0:
            pred_xstart = blended
        else:
            nzt = _nonzero_t(t, x)
            pred_xstart = (blended * nzt
                           + pred_xstart * nzt.map(lambda m: 1.0 - m))
    eps = predict_eps_from_xstart(tables, x, t, pred_xstart)
    ab = extract(tables, "alphas_cumprod", t, x)
    ab_prev = extract(tables, "alphas_cumprod_prev", t, x)

    means, sigmas = [], []
    for xs, ep, a, ap in zip(pred_xstart, eps, ab, ab_prev):
        sigma = (eta * torch.sqrt((1 - ap) / (1 - a))
                 * torch.sqrt(1 - a / ap))
        means.append(xs * torch.sqrt(ap)
                     + torch.sqrt(1 - ap - sigma ** 2) * ep)
        sigmas.append(sigma)
    mean_pred = Triplane(*means)
    if eta == 0.0:
        return mean_pred
    if noise is None:
        raise ValueError("ddim_sample_step with eta != 0 needs noise")
    return mean_pred + _nonzero_t(t, x) * Triplane(*sigmas) * noise
