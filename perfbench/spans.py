"""The program's spans laid on the traced window's device timeline.

The program (`sin3dm_tpu_torch/core/profiling.py`) records spans while a
`torch.profiler` trace runs around its entry points (`generate`, the
diffusion train step's function): in the traced run, the window.  A
span's stamps are Unix epoch nanoseconds, the trace's own clock, so a
span and the device's operations and idle intervals compare as they
are.  `of(ctx)` collects the window's spans once a run and keeps them on
the readers' context; a program without the recorder gives None, and
so do the readers.

The device's idle intervals are `Trace.gaps()` and the stretches
between the window's ends and the device's first and last operation:
the window opens and closes with a sync on the busiest thread, so its
first and last CUDA runtime call stand for its ends.  What lies outside
even those (Python before the opening sync) is idle that no span can
hold.  So the
located intervals plus that rest sum to `window_s - busy_s`, the idle
that `idle_share.*` reads.  A family of spans ("gen.chain", "decode": a
name or a name's first dotted parts) is the union of its spans on the
main thread; the idle inside it is the exact overlap of that union with
the located intervals, and the idle outside every family is the rest.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def of(ctx) -> Optional[List[Tuple[float, float, str, int]]]:
    """The window's spans as (start_us, end_us, name, thread), or None
    where the trace or the program's recorder is missing."""
    if getattr(ctx, "trace", None) is None:
        return None
    if not hasattr(ctx, "spans"):
        ctx.spans = _collect()
    return ctx.spans


def _collect():
    try:
        from sin3dm_tpu_torch.core import profiling
    except ImportError:
        return None
    collect = getattr(profiling, "collect", None)
    if collect is None:
        return None
    return [(s.start_ns / 1e3, s.end_ns / 1e3, s.name, s.thread)
            for s in collect()]


def in_family(name: str, family: str) -> bool:
    return name == family or name.startswith(family + ".")


def main_thread(spans, family: str) -> List[Interval]:
    """The family's spans on the main thread, as (start_us, end_us)."""
    main = threading.main_thread().ident
    return [(a, b) for a, b, n, t in spans
            if t == main and in_family(n, family)]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(xs: Sequence[Interval], ys: Sequence[Interval]) -> float:
    """The length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> List[Interval]:
    """The device's located idle intervals in the window, in us (see the
    module doc)."""
    calls = [(a, b) for a, b, n in trace.host if n.startswith("cuda")]
    end = max([trace.t1_us] + [b for _, b in calls])
    start = max(min([trace.t0_us] + [a for a, _ in calls]),
                end - 1e6 * trace.window_s)
    lead = [(start, trace.t0_us)] if trace.t0_us > start else []
    tail = [(trace.t1_us, end)] if end > trace.t1_us else []
    return lead + trace.gaps() + tail


def idle_split(trace, spans, families: Sequence[str]) -> Dict[str, float]:
    """Seconds of device idle inside each family's main-thread spans,
    and "outside" all of them (with the idle no interval locates)."""
    idle = idle_intervals(trace)
    out, every = {}, []
    for f in families:
        iv = main_thread(spans, f)
        every += iv
        out[f] = overlap(idle, union(iv)) / 1e6
    total = trace.window_s - trace.busy_s
    out["outside"] = total - overlap(idle, union(every)) / 1e6
    return out


def idle_share(ctx, family: str, families: Sequence[str]) -> Optional[float]:
    """The family's idle over the window, in percent; None where there
    is nothing to read or the family recorded no span."""
    spans = of(ctx)
    tr = ctx.trace
    if not spans or tr.window_s <= 0 or not main_thread(spans, family):
        return None
    return 100.0 * idle_split(tr, spans, families)[family] / tr.window_s


# the families whose idle the readers report, by cell kind
GEN = ("gen.chain", "decode", "gen.load")
DIFF = ("train.draw", "train.grads", "train.apply")
