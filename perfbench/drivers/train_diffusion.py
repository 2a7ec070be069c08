"""Diffusion training: the train step that `cli/train.py` builds
(`training/diffusion.py:make_train_step`) on the tag's feat.npz.

Configuration keys: `tag`, `ema_file` (the starting weights, read by
both sides), `diffusion_steps`, `unet`, `train` (diff_batch_size,
diff_lr, diff_n_iters, ema_rate, weight_decay, steps_per_call).  Mix
keys: `warm_calls` (calls after the checked one, which size the window:
whole calls for about --seconds), `trace_calls` (the traced window's
calls), `control` and `limits`.

Set-up builds one train state and one step function from the tag's EMA
weights, as `cli/train.py:train_diffusion` builds its loop (the batch is
the feat repeated, timesteps and noise drawn from (seed, step)), under
`cli.train`'s settings: TF32 on, deterministic algorithms only.  Its
first call (`steps_per_call` steps) is the checked one; the warm calls
follow, then the window runs whole calls of the same function on the
same state and ends in a sync; `diff_step_ms` is its time over its
steps.

The check follows the first call's steps in the reference (fp32, TF32
off) from the same weights and draws: `loss_gap_1`, the first step's
relative loss gap, and `loss_gap`, the widest step's; `row_gap_1`, the
median example's relative loss gap at the first step, before any
update can set the two sides apart; `moment_gap`, the worst leaf's gap
between the norms of the first moment after the call (AdamW's running
mean of the call's gradients) over the larger of that leaf's and the
median leaf's reference norm; `update_gap` and `ema_gap`, the same for
the parameters' and the EMA's change over the call, over the leaves
whose reference first gradient exceeds a thousandth of the median
leaf's; each with the median leaf's gap beside it (`*_gap_median`).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from perfbench.reference import adamw as RW
from perfbench.reference import compare
from perfbench.reference import diffusion as RD
from perfbench.reference import precision, tree
from perfbench.reference.unet import PLANES

class Driver:
    def __init__(self, cell, seed: int, device: str, root: str):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg, self.mix = cell.config, cell.traffic
        self.tag = os.path.join(root, self.cfg["tag"])
        self.info = {}

    def sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def args(self):
        """The tag's diffusion args.json with the configuration's
        training settings over it, as `cli.train` reads them."""
        with open(os.path.join(self.tag, "diffusion", "args.json")) as fh:
            a = json.load(fh)
        a.update(self.cfg["train"])
        a.update({k: v for k, v in self.cfg["unet"].items()
                  if k != "planes"})
        return argparse.Namespace(**a)

    def setup(self):
        from sin3dm_tpu_torch.compat.from_jax import unet_params_from_jax
        from sin3dm_tpu_torch.core import checkpoint as ckpt
        from sin3dm_tpu_torch.core import config as cfgmod
        from sin3dm_tpu_torch.core.rng import deterministic_algorithms
        from sin3dm_tpu_torch.core.triplane import (Triplane,
                                                    load_triplane_npz)
        from sin3dm_tpu_torch.diffusion.gaussian import tables_to_device
        from sin3dm_tpu_torch.models.unet import unet_train_apply
        from sin3dm_tpu_torch.training import diffusion as TD

        dev = torch.device(self.device)
        args = self.args()
        feat = load_triplane_npz(os.path.join(self.tag, "encoding",
                                              "feat.npz"), dev)
        B = int(args.diff_batch_size)
        batch = Triplane(*[p[None].expand(B, *p.shape).contiguous()
                           for p in feat])
        ucfg = cfgmod.unet_config_from_args(args)
        tables = tables_to_device(cfgmod.schedule_from_args(args)
                                  .tables_f32(), dev)
        dcfg = cfgmod.diffusion_config_from_args(args)
        tcfg = cfgmod.diffusion_trainer_config_from_args(args)
        tree_np, _ = ckpt.load_tree(os.path.join(self.tag, "diffusion",
                                                 self.cfg["ema_file"]))
        params = unet_params_from_jax(tree_np, dev)

        def model(p, x, t):
            return unet_train_apply(p, ucfg, x, t)

        # cli.train's settings for the set-up and the window
        self.flags = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        self.det = deterministic_algorithms()
        self.det.__enter__()

        st = self.state = TD.init_train_state(params, tcfg,
                                              int(tables["betas"].shape[0]))
        self.step_fn = TD.make_train_step(model, tables, dcfg, tcfg)
        self.k = max(int(tcfg.steps_per_call), 1)
        self.batch, self.dev_batch = batch, B
        self.sizes = tuple(feat.sizes)
        start, start_ema = st.flat.detach().clone(), st.ema[0].detach().clone()
        m = self.step_fn(st, batch, self.seed)
        rows = m["loss"].reshape(self.k, -1).double().cpu()
        self.losses, self.rows = [float(x) for x in rows.mean(1)], rows[0]
        self.moved = {"moment": st.mu.detach().clone(),
                      "update": st.flat.detach() - start,
                      "ema": st.ema[0].detach() - start_ema}
        self.sync()
        t0 = time.perf_counter()
        for _ in range(int(self.mix["warm_calls"])):
            self.step_fn(st, batch, self.seed)
        self.sync()
        self.call_s = (time.perf_counter() - t0) / int(self.mix["warm_calls"])

    def plan(self, seconds: float, trace: bool):
        self.calls = (int(self.mix["trace_calls"]) if trace else
                      max(1, round(seconds / self.call_s)))

    def window(self) -> dict:
        st, losses = self.state, []
        self.sync()
        t0 = time.perf_counter()
        for _ in range(self.calls):
            losses.append(self.step_fn(st, self.batch, self.seed)["loss"])
        self.sync()
        t1 = time.perf_counter()
        steps = self.calls * self.k
        failed = int(sum((~torch.isfinite(x.reshape(self.k, -1).mean(1)))
                         .sum() for x in losses))
        self.info = {"t0": t0, "steps": steps,
                     "batch": self.dev_batch, "plane_sizes": self.sizes,
                     "metrics": {"diff_step_ms": 1e3 * (t1 - t0) / steps},
                     "attempted": steps, "failed": failed}
        return self.info

    # -- the check ------------------------------------------------------------

    def release(self):
        self.det.__exit__(None, None, None)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.flags
        like = self.reference_start()
        self.prog = {"losses": self.losses, "rows": self.rows,
                     **{k: tree.leaf_norms(tree.split_flat(v, like))
                        for k, v in self.moved.items()}}
        del self.state, self.step_fn, self.batch, self.moved
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference_start(self):
        flat, _ = tree.load_container(os.path.join(
            self.tag, "diffusion", self.cfg["ema_file"]))
        return tree.to_device(flat, self.device)

    def reference(self, q=precision.fp32, half_batch: bool = False) -> dict:
        """The reference's readings over the checked call's steps: the
        losses, the first gradient's and the first moment's norms per
        leaf, and the norms of the change.  `half_batch` plants a fault:
        the loss is the mean over the first half of the batch only."""
        dev, tr = self.device, self.cfg["train"]
        B, T = self.dev_batch, int(self.cfg["diffusion_steps"])
        with np.load(os.path.join(self.tag, "encoding", "feat.npz")) as f:
            x0 = tuple(torch.as_tensor(f[f"feat_{k}"], device=dev)[None]
                       .expand(B, -1, -1, -1) for k in PLANES)
        C = x0[0].shape[1]
        P = self.reference_start()
        start = {k: v.detach().clone() for k, v in P.items()}
        ema = {k: v.detach().clone() for k, v in P.items()}
        for v in P.values():
            v.requires_grad_(True)
        opt = RW.AdamW(P)
        keys = tree.ordered(P)
        losses, first_rows, grad = [], None, None
        for k in range(self.k):
            t, noise = RD.train_draws(self.seed, k, B, self.sizes, C, T, dev)
            rows = slice(0, B // 2 if half_batch else B)
            loss = RD.train_loss(P, tuple(p[rows] for p in x0), t[rows],
                                 tuple(n[rows] for n in noise), T, q)
            if first_rows is None:
                first_rows = loss.detach().double().cpu()
            loss = loss.mean()
            g = torch.autograd.grad(loss, [P[k_] for k_ in keys],
                                    allow_unused=True)
            g = {k_: (torch.zeros_like(P[k_]) if x is None else x)
                 for k_, x in zip(keys, g)}
            losses.append(float(loss.detach()))
            if grad is None:
                grad = tree.leaf_norms(g)
            opt.step(P, g, RW.diffusion_lr(tr["diff_lr"], tr["diff_n_iters"],
                                           k), tr["weight_decay"])
            r = float(tr["ema_rate"])
            with torch.no_grad():
                for k_ in keys:
                    ema[k_].mul_(r).add_(P[k_], alpha=1.0 - r)
        with torch.no_grad():
            return {"losses": losses, "rows": first_rows, "grad": grad,
                    "moment": tree.leaf_norms(opt.mu),
                    "update": tree.leaf_norms({k_: P[k_] - start[k_]
                                               for k_ in keys}),
                    "ema": tree.leaf_norms({k_: ema[k_] - start[k_]
                                            for k_ in keys})}

    @staticmethod
    def gaps(got: dict, want: dict) -> dict:
        moved = compare.moved_leaves(want["grad"])
        steps = [compare.rel_gap(a, b) for a, b in
                 zip(got["losses"], want["losses"])]
        a, b = got["rows"], want["rows"]
        n = min(len(a), len(b))
        return {"loss_gap": max(steps), "loss_gap_1": steps[0],
                "row_gap_1": float(((a[:n] - b[:n]).abs() / b[:n].abs())
                                   .median()),
                **compare.leaf_readings("moment", got["moment"],
                                        want["moment"]),
                **compare.leaf_readings("update", got["update"],
                                        want["update"], moved),
                **compare.leaf_readings("ema", got["ema"], want["ema"],
                                        moved)}

    def check(self, control: str = None) -> dict:
        """The numbers compared with their limits; every reading, and with
        `control` the control's and the half-batch fault's, in
        `self.extra`."""
        self.release()
        with precision.exact_fp32():
            want = self.reference()
            got = self.gaps(self.prog, want)
            self.extra = {"readings": got}
            if control:
                self.extra["control"] = self.gaps(
                    self.reference(precision.rounding(control)), want)
                self.extra["half_batch"] = self.gaps(
                    self.reference(half_batch=True), want)
        lim = self.mix["limits"]
        return {k: {"value": got[k], "limit": lim[k]} for k in lim}
