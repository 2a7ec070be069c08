"""Diffusion training (counterpart of `sin3dm_tpu/training/diffusion.py`).

One train step: timestep sampling, q_sample, the UNet's training forward
(`models.unet.unet_train_apply`), the per-plane MSE, backward, AdamW with
the linear lr anneal, the NaN guard and the EMA.  `steps_per_call` K runs
K steps per call, a Python loop (JAX scans them in one dispatch);
metrics reach the host only at the logging cadence.

Semantics follow JAX's optax chain, written out over flat fp32 buffers
(`training.adamw`; the parameters, each EMA, mu and nu are one tensor
each; the parameter leaves the model reads are views of the parameter
buffer):

- AdamW as `optax.adamw` (`adamw.update`) at lr(k), where k is the
  schedule's count before it advances: lr(k) = lr (1 - min(k / anneal,
  1)) in float32.
- NaN guard: where the global grad norm is not finite the update still
  runs on zeroed grads (mu and nu decay, both counts advance) and the old
  parameters are kept; the EMA then moves toward the kept parameters.
- EMA: e r + p (1 - r) in fp32, once per step.
- Randomness: step k's timesteps and noise are drawn from a generator
  seeded from (seed, k) alone (`core.rng.step_generator`), so a resumed
  run draws what an unbroken one would.  Tests pass t and noise in.
- Data parallel (`group=`, a `parallel.DataGroup`; JAX's `mesh=`): each
  rank holds its equal share of the batch and draws the step's whole
  (t, noise) from the generator of (seed, k), keeping its rows; its loss
  is sum(loss w) over its rows / the global batch, and one `all_reduce`
  sums the flat gradient and gathers the per-example terms.  Every rank
  then takes the same grad norm, NaN guard, AdamW and EMA from the same
  sums, and updates the loss-aware sampler from the whole batch's (t,
  loss): the parameters stay bit-identical across the ranks.  Rank 0
  alone writes logs and checkpoints and runs the sample hook.
- Checkpoints: `ema_{rate}_{step:06d}.pt` per EMA rate and
  `opt{step:06d}.pt` in JAX's container and leaf layout (the optimiser
  state as `core.checkpoint.adamw_tree`); resume loads the parameters
  from the EMA file and the optimiser state from the opt file.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core import logger, profiling
from ..core.rng import step_generator
from ..core.triplane import Triplane
from ..diffusion import resample
from ..diffusion.gaussian import DiffusionConfig, training_losses
from ..parallel.mesh import all_reduce_many, gather_slot, local_rows
from . import adamw



@dataclass
class DiffusionTrainerConfig:
    lr: float = 5e-4
    weight_decay: float = 0.0
    lr_anneal_steps: int = 25000
    ema_rates: Tuple[float, ...] = (0.9999,)
    batch_size: int = 32
    schedule_sampler: str = "uniform"   # uniform | loss-second-moment
    log_interval: int = 100
    save_interval: int = 25000
    steps_per_call: int = 1


def learning_rate(cfg: DiffusionTrainerConfig,
                  count: Optional[int]) -> np.float32:
    """optax's schedule at count k, in float32: lr (1 - min(k / anneal,
    1)), or lr where there is no anneal."""
    lr = np.float32(cfg.lr)
    if not cfg.lr_anneal_steps:
        return lr
    frac = np.minimum(np.float32(count) / np.float32(cfg.lr_anneal_steps),
                      np.float32(1.0))
    return lr * (np.float32(1.0) - frac)


@dataclass
class TrainState:
    """Parameters, EMAs and AdamW moments as flat fp32 buffers in the
    parameter tree's flatten order; `params` is the tree of views of
    `flat` that the model reads (leaves that require grad)."""
    params: Dict
    flat: torch.Tensor
    ema: List[torch.Tensor]
    mu: torch.Tensor
    nu: torch.Tensor
    count: int                    # optax ScaleByAdamState.count
    sched_count: Optional[int]    # ScaleByScheduleState.count (lr schedule)
    sampler_state: resample.SamplerState
    step: int

    def tree(self, flat: torch.Tensor) -> Dict:
        """`flat` (a buffer of this state's layout) as a detached tree."""
        return adamw.views(flat.detach(), self.params)


def init_train_state(params: Dict, cfg: DiffusionTrainerConfig,
                     num_timesteps: int) -> TrainState:
    """A fresh state whose buffers copy `params` (a tree of tensors)."""
    device = next(iter(ckpt.leaves_with_paths(params)))[1].device
    flat = adamw.flatten(params, device).detach().clone()
    return TrainState(
        params=adamw.param_views(flat, params), flat=flat,
        ema=[flat.clone() for _ in cfg.ema_rates],
        mu=torch.zeros_like(flat), nu=torch.zeros_like(flat), count=0,
        sched_count=0 if cfg.lr_anneal_steps else None,
        sampler_state=resample.init_sampler_state(num_timesteps, device),
        step=0)


def draw_step_inputs(tcfg: DiffusionTrainerConfig, state: TrainState,
                     batch: Triplane, seed: int, step: int,
                     num_timesteps: int,
                     n: Optional[int] = None) -> Tuple[torch.Tensor,
                                                       Triplane]:
    """(t, noise) of global step `step` for `n` examples (default the
    batch's): drawn from the generator of (seed, step) on the batch's
    device, t first."""
    g = step_generator(seed, step, batch.xy.device)
    B = batch.xy.shape[0] if n is None else n
    if tcfg.schedule_sampler == "loss-second-moment":
        t, _ = resample.sample_loss_aware(g, B, state.sampler_state)
    else:
        t, _ = resample.sample_uniform(g, B, num_timesteps)
    return t, batch.map(lambda p: torch.randn(
        (B,) + tuple(p.shape[1:]), generator=g, dtype=p.dtype,
        device=g.device))


@torch.no_grad()
def apply_grads(state: TrainState, g: torch.Tensor,
                tcfg: DiffusionTrainerConfig) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """AdamW, the NaN guard and the EMA on the flat buffers, from the flat
    gradient `g` (see the module doc).  Returns (global grad norm, ok)."""
    gnorm = torch.sqrt((g * g).sum())
    ok = torch.isfinite(gnorm)
    g = torch.where(ok, g, torch.zeros((), device=g.device))
    adamw.update(state, g, learning_rate(tcfg, state.sched_count),
                 tcfg.weight_decay, ok=ok)
    for rate, e in zip(tcfg.ema_rates, state.ema):
        e.mul_(rate).add_(state.flat, alpha=1.0 - rate)
    return gnorm, ok


def compute_grads(state: TrainState, model_apply: Callable, tables,
                  dcfg: DiffusionConfig, tcfg: DiffusionTrainerConfig,
                  batch: Triplane, t: torch.Tensor, noise: Triplane,
                  group=None):
    """(loss terms, importance weights, flat gradient of the weighted mean
    loss) at the state's parameters, from the given timesteps and noise.
    `model_apply(params, x_t, t_model)` must be differentiable
    (`unet_train_apply`).  With a data `group`, batch, t and noise are
    this rank's rows: the gradient is the whole batch's, summed over the
    ranks, and the terms and weights are gathered for the whole batch,
    in rank order (one `all_reduce`)."""
    if tcfg.schedule_sampler == "loss-second-moment":
        weights = resample.loss_aware_weights(state.sampler_state, t)
    else:
        weights = torch.ones(t.shape, dtype=torch.float32, device=t.device)
    terms = training_losses(lambda x, tt: model_apply(state.params, x, tt),
                            tables, dcfg, batch, t, noise)
    if group is None:
        loss = (terms["loss"] * weights).mean()
    else:
        loss = (terms["loss"] * weights).sum() / (t.shape[0] * group.size)
    leaves = [v for _, v in ckpt.leaves_with_paths(state.params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    g = torch.cat([(torch.zeros_like(v) if gr is None else gr).reshape(-1)
                   for v, gr in zip(leaves, grads)])
    terms = {k: v.detach() for k, v in terms.items()}
    if group is not None:
        keys = sorted(terms)
        red = all_reduce_many(group, [g] + [
            gather_slot(group, v) for v in [terms[k] for k in keys]
            + [weights]])
        g, weights = red[0], red[-1].reshape(-1)
        terms = {k: v.reshape(-1) for k, v in zip(keys, red[1:-1])}
    return terms, weights, g


def train_step(state: TrainState, model_apply: Callable, tables,
               dcfg: DiffusionConfig, tcfg: DiffusionTrainerConfig,
               batch: Triplane, t: torch.Tensor,
               noise: Triplane, group=None) -> Dict[str, torch.Tensor]:
    """One step from the given timesteps and noise (the whole batch's;
    with a data `group`, `batch` is this rank's rows and the rank takes
    its rows of t and noise); updates `state` in place.  Returns the
    step's metrics as device tensors: grad_norm, skipped, and per example
    of the whole batch t, loss_w and the loss terms."""
    t_loc, noise_loc = t, noise
    if group is not None:
        t_loc = local_rows(group, t)
        noise_loc = noise.map(lambda p: local_rows(group, p))
    with profiling.span("train.grads"):
        terms, weights, g = compute_grads(state, model_apply, tables, dcfg,
                                          tcfg, batch, t_loc, noise_loc,
                                          group)
    with profiling.span("train.apply"):
        gnorm, ok = apply_grads(state, g, tcfg)
    if tcfg.schedule_sampler == "loss-second-moment":
        state.sampler_state = resample.update_sampler_state(
            state.sampler_state, t, terms["loss"])
    state.step += 1
    return {"grad_norm": gnorm, "skipped": ~ok, "t": t,
            "loss_w": terms["loss"] * weights, **terms}


def make_train_step(model_apply: Callable, tables, dcfg: DiffusionConfig,
                    tcfg: DiffusionTrainerConfig, group=None):
    """`step_fn(state, batch, seed, inputs=None) -> metrics`: K =
    steps_per_call steps.  `inputs` (K pairs of (t, noise), the whole
    batch's) replaces the draws.  Metrics as JAX's fused call gives them:
    the last step's scalars, every step's per-example values
    concatenated.  With a data `group` (JAX's `mesh=`), `batch` is this
    rank's equal share of the global batch (see the module doc).  Each
    step's phases are spans (`core.profiling`): `train.draw`,
    `train.grads` (the forward's and backward's launches) and
    `train.apply` (AdamW, the NaN guard, the EMA)."""
    T = int(tables["betas"].shape[0])
    K = max(tcfg.steps_per_call, 1)
    size = 1 if group is None else group.size

    @profiling.follow_profiler()
    def step_fn(state: TrainState, batch: Triplane, seed: int,
                inputs: Optional[Sequence[Tuple[torch.Tensor,
                                                Triplane]]] = None):
        per = []
        for i in range(K):
            with profiling.span("train.draw"):
                t, noise = inputs[i] if inputs is not None else \
                    draw_step_inputs(tcfg, state, batch, seed, state.step,
                                     T, n=batch.xy.shape[0] * size)
            per.append(train_step(state, model_apply, tables, dcfg, tcfg,
                                  batch, t, noise, group))
        return {k: (torch.cat([m[k] for m in per]) if v.dim() else v)
                for k, v in per[-1].items()}

    return step_fn


def quartile_log(metrics: Dict, num_timesteps: int) -> None:
    """Loss keys, overall and per quarter of the timesteps."""
    t = metrics["t"].cpu().numpy()
    for key in ("loss", "mse_xy", "mse_xz", "mse_yz", "vb"):
        if key not in metrics:
            continue
        vals = metrics[key].float().cpu().numpy()
        logger.logkv_mean(key, float(vals.mean()), count=len(vals))
        quartile = (4 * t // num_timesteps).astype(np.int32)
        for q in range(4):
            m = quartile == q
            if m.any():
                logger.logkv_mean(f"{key}_q{q}", float(vals[m].mean()),
                                  count=int(m.sum()))


def ema_checkpoint_name(rate: float, step: int) -> str:
    return f"ema_{rate}_{step:06d}.pt"


def opt_checkpoint_name(step: int) -> str:
    return f"opt{step:06d}.pt"


def find_resume_step(log_dir: str, ema_rate: float) -> int:
    """The latest step of an `ema_{rate}_{step:06d}.pt` in log_dir, or 0."""
    if not os.path.isdir(log_dir):
        return 0
    pat = re.compile(rf"ema_{re.escape(str(ema_rate))}_(\d+)\.pt$")
    steps = [int(m.group(1)) for m in map(pat.match, os.listdir(log_dir))
             if m]
    return max(steps, default=0)


class DiffusionTrainLoop:
    """The host loop: KV and TensorBoard logging, checkpoints, the
    periodic sample hook, resume.  With `DIFFUSION_TRAINING_TEST` set in
    the environment, `run` returns after the first save.  With a data
    `group`, `batch` is this rank's share; rank 0 alone writes
    TensorBoard, checkpoints and runs the sample hook."""

    def __init__(self, model_apply: Callable, params: Dict, tables,
                 dcfg: DiffusionConfig, tcfg: DiffusionTrainerConfig,
                 log_dir: str, batch: Triplane, sample_hook=None,
                 resume: bool = False, group=None):
        self.group = group
        self.is_main = group is None or group.rank == 0
        self.model_apply = model_apply
        self.tables = tables
        self.dcfg = dcfg
        self.tcfg = tcfg
        self.log_dir = log_dir
        self.batch = batch
        self.sample_hook = sample_hook
        self.T = int(tables["betas"].shape[0])
        self.state = init_train_state(params, tcfg, self.T)
        self.resume_step = 0
        os.makedirs(log_dir, exist_ok=True)
        if resume:
            self._try_resume()
        self.step_fn = make_train_step(model_apply, tables, dcfg, tcfg,
                                       group)
        self.tb = None
        if self.is_main:
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(os.path.join(log_dir, "tblog"))
            except ImportError:
                pass

    def _try_resume(self) -> None:
        """Load the latest EMA (as the parameters and every EMA) and, where
        present and compatible, its opt file; continue at its step."""
        rate = self.tcfg.ema_rates[0]
        step = find_resume_step(self.log_dir, rate)
        if step <= 0:
            return
        logger.log(f"resuming from step {step}")
        st = self.state
        ema, _ = ckpt.load_tree(os.path.join(
            self.log_dir, ema_checkpoint_name(rate, step)))
        if adamw.layout(ema) != adamw.layout(st.params):
            raise ValueError(f"checkpoint structure mismatch at step {step}")
        with torch.no_grad():
            st.flat.copy_(adamw.flatten(ema, st.flat.device))
            for e in st.ema:
                e.copy_(st.flat)
        opt_path = os.path.join(self.log_dir, opt_checkpoint_name(step))
        if os.path.exists(opt_path):
            try:
                adamw.load_opt_tree(st, ckpt.load_tree(opt_path)[0])
            except ValueError:
                logger.log("optimizer state incompatible; reinitialized")
        st.step = step
        self.resume_step = step

    def run(self, seed: int, n_steps: Optional[int] = None) -> None:
        """Train from the state's step to `n_steps` (default the anneal
        length) with step k's draws from (seed, k)."""
        n_steps = n_steps or self.tcfg.lr_anneal_steps
        saved_at = -1
        K = max(self.tcfg.steps_per_call, 1)
        # reading metrics waits for the card: only at this cadence
        metrics_every = max(10, K, self.tcfg.log_interval // 10)
        step = self.state.step
        while step < n_steps:
            with profiling.span("train.call", step=step):
                metrics = self.step_fn(self.state, self.batch, seed)
            last = step + K - 1
            if last % metrics_every < K:
                quartile_log(metrics, self.T)
                logger.logkv("step", last)
                logger.logkv("samples", (last + 1) * self.tcfg.batch_size)
                if self.tb is not None:
                    self.tb.add_scalar("loss", metrics["loss"].mean().item(),
                                       global_step=last)
                    self.tb.add_scalar("grad_norm",
                                       metrics["grad_norm"].item(),
                                       global_step=last)
            if last % self.tcfg.log_interval < K:
                logger.dumpkvs()
            if self.sample_hook and self.is_main and step % 5000 < K:
                self.sample_hook(self, step)
            step += K
            if step > 0 and step % self.tcfg.save_interval < K:
                self.save(step)
                saved_at = step
                if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                    return
        if saved_at != n_steps:
            self.save(n_steps)

    def save(self, step: int) -> None:
        if not self.is_main:
            return
        for rate, ema in zip(self.tcfg.ema_rates, self.state.ema):
            path = os.path.join(self.log_dir, ema_checkpoint_name(rate, step))
            ckpt.save_tree(path, self.state.tree(ema))
            logger.log(f"saved {path}")
        ckpt.save_tree(os.path.join(self.log_dir, opt_checkpoint_name(step)),
                       adamw.opt_tree(self.state))
