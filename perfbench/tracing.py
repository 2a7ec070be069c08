"""The traced window: `torch.profiler` over the window, reduced to what
the per-layer readers and the result line need.

The profiler records the device's activity and the host's CUDA runtime
calls only.  Recording every host operation too (PyTorch's op events)
costs the host some 30 us an operation: on an H100 it made the traced
train step host-bound (301 against 139 ms a step, 58 % idle against
10 %) and the traced chain step 70.7 against 40.5 ms, so the per-layer
numbers would have described the tracer.

- busy: the union of the device's operation intervals (kernels, copies,
  fills), in seconds; the window: the traced interval on the host clock.
- device_ops: the device operations that took most time, by name.
- idle_gaps: the device's idle intervals between its first and last
  operation, each named by the host's CUDA runtime call in progress at
  its middle on the busiest thread ("host, outside CUDA calls" where
  none is: Python and eager dispatch), summed by that name.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch


class Trace:
    """The reduced trace of one window."""

    def __init__(self, device_events, host_events, t0_us: float,
                 t1_us: float, window_s: float):
        self.window_s = window_s
        self.t0_us, self.t1_us = t0_us, t1_us
        self.device = device_events          # [(start_us, end_us, name)]
        self.host = host_events              # [(start_us, end_us, name)]
        self.intervals = _union([(a, b) for a, b, _ in device_events])
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e6

    def kernel_seconds(self, *substrings: str) -> float:
        """Device seconds of the operations whose name holds any of
        `substrings`."""
        return sum(b - a for a, b, n in self.device
                   if any(s in n for s in substrings)) / 1e6

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for a, b, n in self.device:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return [[n[:160], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def gaps(self) -> List[Tuple[float, float]]:
        out, prev = [], self.t0_us
        for a, b in self.intervals:
            if a > prev:
                out.append((prev, a))
            prev = max(prev, b)
        if self.t1_us > prev:
            out.append((prev, self.t1_us))
        return out

    def idle_gaps(self, top: int = 10) -> List[List]:
        gaps = self.gaps()
        names = _innermost([0.5 * (a + b) for a, b in gaps], self.host)
        by: Dict[str, float] = {}
        for (a, b), n in zip(gaps, names):
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return [[n[:160], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(points, host) -> List[str]:
    """For each time point, the name of the innermost host event that
    covers it (events of one thread nest)."""
    order = sorted(range(len(points)), key=points.__getitem__)
    events = sorted(host, key=lambda e: (e[0], -e[1]))
    out = ["host, outside CUDA calls"] * len(points)
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for k in order:
        m = points[k]
        while i < len(events) and events[i][0] <= m:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= m:
            stack.pop()
        if stack:
            out[k] = stack[-1][2]
    return out


def _events(prof):
    """(device events, host events by thread) from the profiler's raw
    events, times in microseconds.  Spans that the profiler draws on the
    device's timeline (user annotations) are not device operations."""
    from torch.autograd import DeviceType
    dev, host = [], {}
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", lambda: False)():
                dev.append((a, b, e.name()))
        else:
            host.setdefault(e.start_thread_id(), []).append(
                (a, b, e.name()))
    return dev, host


@contextlib.contextmanager
def traced(enabled: bool, out: dict):
    """Profile the block when `enabled`; `out["trace"]` then holds its
    `Trace` (or None where the profiler recorded no device activity)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        yield
        out["trace"] = None
        return
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = _events(prof)
    if not dev:
        out["trace"] = None
        return
    busiest = max(host.values(), key=len) if host else []
    out["trace"] = Trace(dev, busiest, min(a for a, _, _ in dev),
                         max(b for _, b, _ in dev), window_s)
