"""DDPM/DDIM math over Triplanes (counterpart of
`sin3dm_tpu/diffusion/gaussian.py`): the sampling steps with optional
guidance (`cond_fn`), DDIM inversion, the training losses and the
variational bound in bits per dim.

Stateless functions over a dict of float32 coefficient tables on the
device (`tables_to_device`).  The diffusion state is the Triplane itself;
timestep respacing is folded in through `tables['timestep_map']`.  Noise
is always passed in (`noise=`): the callers draw it from their own
generators, and tests hand both frameworks the same numpy draws.
"""

from __future__ import annotations

import enum
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.nn import mean_flat
from ..core.triplane import Triplane


class MeanType(enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class VarType(enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class LossKind(enum.Enum):
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"


class DiffusionConfig(NamedTuple):
    mean_type: MeanType = MeanType.START_X
    var_type: VarType = VarType.FIXED_LARGE
    loss_kind: LossKind = LossKind.MSE
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


def q_sample(tables, x_start: Triplane, t: torch.Tensor,
             noise: Triplane) -> Triplane:
    """A draw of q(x_t | x_0) with the given noise."""
    a = extract(tables, "sqrt_alphas_cumprod", t, x_start)
    b = extract(tables, "sqrt_one_minus_alphas_cumprod", t, x_start)
    return a * x_start + b * noise


def q_mean_variance(tables, x_start: Triplane,
                    t: torch.Tensor) -> Tuple[Triplane, Triplane, Triplane]:
    """Mean, variance, log-variance of q(x_t | x_0)."""
    mean = extract(tables, "sqrt_alphas_cumprod", t, x_start) * x_start
    var = extract(tables, "one_minus_alphas_cumprod", t, x_start)
    log_var = extract(tables, "log_one_minus_alphas_cumprod", t, x_start)
    return mean, var, log_var


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


def predict_xstart_from_xprev(tables, x_t: Triplane, t,
                              xprev: Triplane) -> Triplane:
    c1 = extract(tables, "posterior_mean_coef1", t, x_t)
    c2 = extract(tables, "posterior_mean_coef2", t, x_t)
    inv1 = Triplane(*[1.0 / c for c in c1])
    ratio = Triplane(*[b / a for a, b in zip(c1, c2)])
    return inv1 * xprev - ratio * x_t


class PMeanVar(NamedTuple):
    mean: Triplane
    log_variance: Triplane
    pred_xstart: Triplane


def _learned(cfg: DiffusionConfig) -> bool:
    return cfg.var_type in (VarType.LEARNED, VarType.LEARNED_RANGE)


def p_mean_variance(model: ModelFn, tables, cfg: DiffusionConfig,
                    x: Triplane, t: torch.Tensor,
                    clip_denoised: bool = True,
                    model_output: Optional[Triplane] = None,
                    learned_var: Optional[Triplane] = None) -> PMeanVar:
    """Model posterior p(x_{t-1} | x_t).  `model_output` (and, with a
    learned variance, `learned_var`) reuse a forward already made (the
    training loss's); otherwise the model is called here."""
    if model_output is None:
        out = model(x, model_timesteps(tables, cfg, t))
        if _learned(cfg):
            C = x.channels
            model_output = out.map(lambda p: p[..., :C])
            learned_var = out.map(lambda p: p[..., C:])
        else:
            model_output = out

    if cfg.var_type == VarType.LEARNED:
        log_var = learned_var
    elif cfg.var_type == VarType.LEARNED_RANGE:
        min_log = extract(tables, "posterior_log_variance_clipped", t, x)
        max_log = extract(tables, "log_betas", t, x)

        def mix(v, lo, hi):
            frac = (v + 1.0) * 0.5
            return frac * hi + (1.0 - frac) * lo
        log_var = Triplane(*[mix(v, lo, hi) for v, lo, hi
                             in zip(learned_var, min_log, max_log)])
    elif cfg.var_type == VarType.FIXED_LARGE:
        log_var = extract(tables, "fixed_large_log_variance", t, x)
    else:  # FIXED_SMALL
        log_var = extract(tables, "posterior_log_variance_clipped", t, x)

    def process(xs: Triplane) -> Triplane:
        if clip_denoised:
            return xs.map(lambda p: p.clamp(-1.0, 1.0))
        return xs

    if cfg.mean_type == MeanType.PREVIOUS_X:
        pred_xstart = process(
            predict_xstart_from_xprev(tables, x, t, model_output))
        mean = model_output
    else:
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


# CondFn: (x_t, t_model) -> Triplane, the gradient of log p(y | x_t)
CondFn = Callable[[Triplane, torch.Tensor], Triplane]


def condition_mean(cond_fn: CondFn, tables, cfg: DiffusionConfig,
                   out: PMeanVar, x: Triplane, t: torch.Tensor) -> Triplane:
    """The posterior mean shifted by variance * grad log p(y | x)
    (Sohl-Dickstein et al.'s conditioning)."""
    grad = cond_fn(x, model_timesteps(tables, cfg, t))
    return out.mean + out.log_variance.map(torch.exp) * grad


def condition_score(cond_fn: CondFn, tables, cfg: DiffusionConfig,
                    out: PMeanVar, x: Triplane,
                    t: torch.Tensor) -> PMeanVar:
    """Score conditioning (Song et al.): eps shifted by
    -sqrt(1 - alpha_bar) * grad, then pred_xstart and the posterior mean
    from it.  JAX re-derives pred_xstart from the shifted eps; here the
    same value comes as pred_xstart + sqrt(1/alpha_bar - 1)
    sqrt(1 - alpha_bar) grad, which adds exactly 0 for a zero grad."""
    grad = cond_fn(x, model_timesteps(tables, cfg, t))
    b = extract(tables, "sqrt_recipm1_alphas_cumprod", t, x)
    ab = extract(tables, "alphas_cumprod", t, x)
    coef = Triplane(*[bb * torch.sqrt(1 - a) for bb, a in zip(b, ab)])
    pred_xstart = out.pred_xstart + coef * grad
    mean = q_posterior_mean(tables, pred_xstart, x, t)
    return PMeanVar(mean=mean, log_variance=out.log_variance,
                    pred_xstart=pred_xstart)


def p_sample_step(model: ModelFn, tables, cfg: DiffusionConfig,
                  x: Triplane, t: torch.Tensor, noise: Triplane,
                  clip_denoised: bool = True,
                  cond_fn: Optional[CondFn] = None) -> Triplane:
    """One ancestral sampling step with pre-drawn `noise`; `cond_fn`
    guides it through `condition_mean`."""
    out = p_mean_variance(model, tables, cfg, x, t, clip_denoised)
    mean = out.mean
    if cond_fn is not None:
        mean = condition_mean(cond_fn, tables, cfg, out, x, t)
    sigma = out.log_variance.map(lambda lv: torch.exp(0.5 * lv))
    return mean + _nonzero_t(t, x) * sigma * noise


def ddim_sample_step(model: ModelFn, tables, cfg: DiffusionConfig,
                     x: Triplane, t: torch.Tensor,
                     noise: Optional[Triplane], eta: float = 0.0,
                     clip_denoised: bool = True,
                     y0: Optional[Triplane] = None,
                     mask: Optional[Triplane] = None,
                     is_mask_t0: bool = False,
                     cond_fn: Optional[CondFn] = None) -> Triplane:
    """One DDIM step.  `noise` may be None only for eta == 0, where the
    noise term is exactly zero.  `cond_fn` guides it through
    `condition_score`.

    With `y0` and `mask` (masked generation): pred_xstart becomes
    `mask * y0 + (1 - mask) * pred_xstart` before eps is re-derived, so
    mask = 1 keeps y0 -- at every step with `is_mask_t0`, else at every
    step but the last (t = 0)."""
    out = p_mean_variance(model, tables, cfg, x, t, clip_denoised)
    if cond_fn is not None:
        out = condition_score(cond_fn, tables, cfg, out, x, t)
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


def ddim_reverse_step(model: ModelFn, tables, cfg: DiffusionConfig,
                      x: Triplane, t: torch.Tensor,
                      clip_denoised: bool = True) -> Triplane:
    """One deterministic DDIM reverse-ODE step x_t -> x_{t+1} (DDIM
    inversion)."""
    out = p_mean_variance(model, tables, cfg, x, t, clip_denoised)
    eps = predict_eps_from_xstart(tables, x, t, out.pred_xstart)
    ab_next = extract(tables, "alphas_cumprod_next", t, x)
    return Triplane(*[xs * torch.sqrt(an) + torch.sqrt(1 - an) * ep
                      for xs, ep, an in zip(out.pred_xstart, eps, ab_next)])


# ---------------------------------------------------------------------------
# Training losses
# ---------------------------------------------------------------------------

def training_losses(model: ModelFn, tables, cfg: DiffusionConfig,
                    x_start: Triplane, t: torch.Tensor,
                    noise: Triplane) -> Dict[str, torch.Tensor]:
    """Per-plane MSE training loss for x_t = q_sample(x_start, t, noise).

    With a learned variance (LEARNED / LEARNED_RANGE) the model emits 2C
    channels; the variance half is trained through the variational-bound
    term with the mean half detached (JAX's `stop_gradient`), scaled by
    T/1000 under RESCALED_MSE.  KL / RESCALED_KL raise, as in JAX.
    Returns per-example `[B]` terms: mse_xy, mse_xz, mse_yz, loss (and
    vb with a learned variance)."""
    if cfg.loss_kind in (LossKind.KL, LossKind.RESCALED_KL):
        raise NotImplementedError(
            "KL training is dead code in the reference; use MSE or "
            "RESCALED_MSE")
    x_t = q_sample(tables, x_start, t, noise)
    out = model(x_t, model_timesteps(tables, cfg, t))

    terms: Dict[str, torch.Tensor] = {}
    learned = _learned(cfg)
    if learned:
        C = x_start.channels
        model_output = out.map(lambda p: p[..., :C])
        learned_var = out.map(lambda p: p[..., C:])
        vb = vb_terms_bpd(model, tables, cfg, x_start, x_t, t,
                          clip_denoised=False,
                          model_output=model_output.map(torch.detach),
                          learned_var=learned_var)["output"]
        if cfg.loss_kind == LossKind.RESCALED_MSE:
            vb = vb * (tables["betas"].shape[0] / 1000.0)
        terms["vb"] = vb
    else:
        model_output = out

    if cfg.mean_type == MeanType.PREVIOUS_X:
        target = q_posterior_mean(tables, x_start, x_t, t)
    elif cfg.mean_type == MeanType.START_X:
        target = x_start
    else:
        target = noise

    for k, tg, mo in zip(("mse_xy", "mse_xz", "mse_yz"), target,
                         model_output):
        terms[k] = mean_flat((tg - mo) ** 2)
    terms["loss"] = terms["mse_xy"] + terms["mse_xz"] + terms["mse_yz"]
    if learned:
        terms["loss"] = terms["loss"] + terms["vb"]
    return terms


def _tri_mean_flat(t: Triplane) -> torch.Tensor:
    """Per-example mean over all three planes' non-batch elements (the
    JAX package's normalisation by real elements, not the reference's
    composed map with its dead zero block)."""
    total = sum(p.sum(dim=tuple(range(1, p.dim()))) for p in t)
    return total / sum(p[0].numel() for p in t)


def vb_terms_bpd(model: ModelFn, tables, cfg: DiffusionConfig,
                 x_start: Triplane, x_t: Triplane, t: torch.Tensor,
                 clip_denoised: bool = True,
                 model_output: Optional[Triplane] = None,
                 learned_var: Optional[Triplane] = None) -> Dict[str, object]:
    """One variational-bound term in bits: KL(q(x_{t-1}|x_t,x_0) ||
    p(x_{t-1}|x_t)), or the decoder NLL at t = 0.  `model_output` /
    `learned_var` reuse the caller's forward."""
    true_mean = q_posterior_mean(tables, x_start, x_t, t)
    true_logvar = extract(tables, "posterior_log_variance_clipped", t, x_t)
    out = p_mean_variance(model, tables, cfg, x_t, t, clip_denoised,
                          model_output=model_output, learned_var=learned_var)
    kl = Triplane(*[normal_kl(tm, tl, m, lv) for tm, tl, m, lv in
                    zip(true_mean, true_logvar, out.mean,
                        out.log_variance)])
    kl_flat = _tri_mean_flat(kl) / math.log(2.0)
    nll = Triplane(*[
        -discretized_gaussian_log_likelihood(xs, means=m,
                                             log_scales=0.5 * lv)
        for xs, m, lv in zip(x_start, out.mean, out.log_variance)])
    nll_flat = _tri_mean_flat(nll) / math.log(2.0)
    return {"output": torch.where(t == 0, nll_flat, kl_flat),
            "pred_xstart": out.pred_xstart}


def prior_bpd(tables, x_start: Triplane) -> torch.Tensor:
    """Prior KL term in bits per dim."""
    B = x_start.xy.shape[0]
    T = tables["betas"].shape[0]
    t = torch.full((B,), T - 1, dtype=torch.int64, device=x_start.xy.device)
    mean, _, logvar = q_mean_variance(tables, x_start, t)
    kl = Triplane(*[normal_kl(m, lv, torch.zeros_like(m),
                              torch.zeros_like(m))
                    for m, lv in zip(mean, logvar)])
    return _tri_mean_flat(kl) / math.log(2.0)


@torch.no_grad()
def calc_bpd_loop(model: ModelFn, tables, cfg: DiffusionConfig,
                  x_start: Triplane, seed: Optional[int] = None,
                  clip_denoised: bool = True,
                  noise: Optional[Callable[[int], Triplane]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The variational lower bound in bits per dim over every timestep,
    t = T-1 down to 0.  Each t's noise is `noise(t)` where given, else one
    draw of x_start's shapes from `step_generator(seed, t)` on x_start's
    device (JAX draws it from `fold_in(key, t)`).  Returns total_bpd
    `[B]`, prior_bpd `[B]`, and vb, xstart_mse, mse `[B, T]`, column i
    for t = T-1-i."""
    from ..core.rng import step_generator
    from ..core.triplane import randn_like
    if noise is None and seed is None:
        raise ValueError("calc_bpd_loop needs a seed or noise")
    T = tables["betas"].shape[0]
    B = x_start.xy.shape[0]
    device = x_start.xy.device
    vb, xstart_mse, mse = [], [], []
    for t_scalar in range(T - 1, -1, -1):
        t = torch.full((B,), t_scalar, dtype=torch.int64, device=device)
        nz = (noise(t_scalar) if noise is not None else
              randn_like(step_generator(seed, t_scalar, device), x_start))
        x_t = q_sample(tables, x_start, t, nz)
        out = vb_terms_bpd(model, tables, cfg, x_start, x_t, t,
                           clip_denoised)
        vb.append(out["output"])
        xstart_mse.append(_tri_mean_flat(
            (out["pred_xstart"] - x_start).map(lambda p: p ** 2)))
        eps = predict_eps_from_xstart(tables, x_t, t, out["pred_xstart"])
        mse.append(_tri_mean_flat((eps - nz).map(lambda p: p ** 2)))
    vb_t = torch.stack(vb, dim=1)
    pb = prior_bpd(tables, x_start)
    return {"total_bpd": vb_t.sum(dim=1) + pb, "prior_bpd": pb,
            "vb": vb_t, "xstart_mse": torch.stack(xstart_mse, dim=1),
            "mse": torch.stack(mse, dim=1)}


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, var1) || N(mean2, var2)) in nats."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *,
                                        means: torch.Tensor,
                                        log_scales: torch.Tensor
                                        ) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized to [-1, 1] in 1/127.5
    bins."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))
