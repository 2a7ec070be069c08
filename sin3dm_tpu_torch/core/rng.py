"""Seeding helpers (counterpart of `sin3dm_tpu/core/rng.py`).

`seed_all` seeds Python's, numpy's and torch's global generators.  The
port's random draws on the training and sampling paths come from explicit
`torch.Generator`s seeded per step or per sample, so the global seeds
touch only what draws without one.
"""

import random

import numpy as np
import torch


def seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def step_generator(seed: int, index: int, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, index) through numpy's
    SeedSequence: draws for step (or sample) `index` depend on nothing
    else."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def draw_scalar_field2D(field, vmin=None, vmax=None):
    """Matplotlib heatmap figure of a 2-D array, for TensorBoard."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure()
    ax = fig.add_subplot(111)
    im = ax.imshow(field, vmin=vmin, vmax=vmax)
    fig.colorbar(im, ax=ax)
    return fig
