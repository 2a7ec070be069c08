"""Seeding helpers (counterpart of `sin3dm_tpu/core/rng.py`).

`seed_all` seeds Python's, numpy's and torch's global generators.  The
port's random draws on the training and sampling paths come from explicit
`torch.Generator`s seeded per step or per sample, so the global seeds
touch only what draws without one.  `deterministic_algorithms` makes the
device's compute repeat bit for bit, which the JAX package is by
construction and the reference's `seed_all` asked of cuDNN.
"""

import contextlib
import os
import random

import numpy as np
import torch

# cuBLAS repeats its results only with a fixed workspace per stream; it
# reads the variable once, at the process's first cuBLAS call
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


@contextlib.contextmanager
def deterministic_algorithms():
    """The block with deterministic kernels only: `torch.use_deterministic_
    algorithms(True)` (an op without a deterministic kernel raises),
    cuDNN deterministic and not benchmarking, and `CUBLAS_WORKSPACE_CONFIG`
    set where it is unset (it takes effect only before the process's
    first cuBLAS call).  The caller's flags are restored after."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
        torch.backends.cudnn.deterministic = old[2]
        torch.backends.cudnn.benchmark = old[3]


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
