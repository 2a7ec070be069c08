"""Tracing helpers (counterpart of `sin3dm_tpu/core/profiling.py`).

`maybe_trace` records a `torch.profiler` trace (host and, on the card,
device activity) into `{log_dir}/profile` as a Chrome trace;
`step_annotation` marks a training step (`torch.profiler.record_function`),
visible in a trace and nearly free without one.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional

import torch


@contextmanager
def maybe_trace(log_dir: Optional[str], enabled: bool = False):
    """With `enabled`, profile the block into `{log_dir}/profile/
    trace.json` (open it in chrome://tracing or Perfetto)."""
    if not enabled or log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    out = os.path.join(log_dir, "profile")
    os.makedirs(out, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


def step_annotation(name: str, step: int):
    """Mark one training step in the trace."""
    return torch.profiler.record_function(f"{name}#{step}")
