"""`correct` at test sizes on the CPU: the program passes its limits;
the control (the reference in the program's place, its products one
precision below what the configuration states) fails one of them; and a
run whose timed path is broken underneath comes out not correct, once
for each fault the cell can have (one card: no exchange to leave out).
The limits of the test cells are set from these readings; the
benchmark cells' limits from the card's, in PERF.md."""

import time

import pytest
import torch

from perfbench import harness

SEED = 2 ** 31 + 77


def run(bench, cell):
    return harness.run(bench, cell, SEED, 0.5, False, "cpu",
                       time.perf_counter())


@pytest.mark.parametrize("name", ["towerruins.gen-tiny",
                                  "towerruins.train-diffusion-tiny"])
def test_program_passes_and_control_fails(tiny_bench, name):
    cell = tiny_bench.cell(name)
    drv = cell.driver(cell, seed=SEED, device="cpu", root=tiny_bench.root)
    drv.setup()
    drv.plan(0.5, False)
    drv.window()
    checks = drv.check(cell.traffic["control"])
    print(name, drv.extra)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    ctl = drv.extra["control"]
    assert any(ctl[k] is not None and ctl[k] > c["limit"]
               for k, c in checks.items()), (ctl, checks)


def test_answer_altered(tiny_bench, monkeypatch):
    from sin3dm_tpu_torch.diffusion import sampling
    loop = sampling.ddim_sample_loop

    def altered(*a, **k):
        x = loop(*a, **k)
        return x._replace(xy=-x.xy)
    monkeypatch.setattr(sampling, "ddim_sample_loop", altered)
    assert run(tiny_bench, "towerruins.gen-tiny")["correct"] is False


def test_diffusion_state_unchanged(tiny_bench, monkeypatch):
    from sin3dm_tpu_torch.training import diffusion as TD

    def unchanged(state, g, tcfg):
        n = torch.sqrt((g * g).sum())
        return n, torch.isfinite(n)
    monkeypatch.setattr(TD, "apply_grads", unchanged)
    assert run(tiny_bench,
               "towerruins.train-diffusion-tiny")["correct"] is False


def test_diffusion_half_batch(tiny_bench, monkeypatch):
    from sin3dm_tpu_torch.training import diffusion as TD
    grads = TD.compute_grads

    def half(state, model_apply, tables, dcfg, tcfg, batch, t, noise,
             group=None):
        n = max(1, t.shape[0] // 2)
        return grads(state, model_apply, tables, dcfg, tcfg,
                     batch.map(lambda p: p[:n]), t[:n],
                     noise.map(lambda p: p[:n]), group)
    monkeypatch.setattr(TD, "compute_grads", half)
    assert run(tiny_bench,
               "towerruins.train-diffusion-tiny")["correct"] is False


def test_diffusion_stops_after_first_inner_step(tiny_bench, monkeypatch):
    """The call's first step updates the state, the others do not: a
    fault that only a call of several steps can have."""
    from sin3dm_tpu_torch.training import diffusion as TD
    apply = TD.apply_grads
    k = tiny_bench.cell("towerruins.train-diffusion-tiny").config[
        "train"]["steps_per_call"]

    def first_only(state, g, tcfg):
        if state.step % k == 0:
            return apply(state, g, tcfg)
        n = torch.sqrt((g * g).sum())
        return n, torch.isfinite(n)
    monkeypatch.setattr(TD, "apply_grads", first_only)
    assert run(tiny_bench,
               "towerruins.train-diffusion-tiny")["correct"] is False


def test_diffusion_draws_reused(tiny_bench, monkeypatch):
    """Every step of a call draws the timesteps and noise of its first."""
    from sin3dm_tpu_torch.training import diffusion as TD
    draw = TD.draw_step_inputs
    k = tiny_bench.cell("towerruins.train-diffusion-tiny").config[
        "train"]["steps_per_call"]

    def reused(tcfg, state, batch, seed, step, num_timesteps, n=None):
        return draw(tcfg, state, batch, seed, step - step % k,
                    num_timesteps, n)
    monkeypatch.setattr(TD, "draw_step_inputs", reused)
    assert run(tiny_bench,
               "towerruins.train-diffusion-tiny")["correct"] is False
