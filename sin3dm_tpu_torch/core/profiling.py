"""Tracing of the port (counterpart of `sin3dm_tpu/core/profiling.py`):
one in-process recorder of spans, the kernels' counters, and
`maybe_trace`.

Spans. `span(name, **attrs)` is a context manager around a piece of host
work; `timed(name, **attrs)` is one whose duration the program needs
anyway (the chain's seconds), so it reads the clock even while recording
is off; `add(name, start_ns, end_ns, **attrs)` records a span from two
`time.perf_counter_ns()` reads the caller already takes (the decode's
stage log). Recording is off by default: `span` then returns one shared
no-op after a single test of a module boolean, reads no clock and
allocates nothing, and `add` returns at once. On (`record(True)`, inside
`maybe_trace`, or inside `follow_profiler` while a `torch.profiler`
trace runs), each span appends one `Span` to an in-memory list that
`collect()` hands over and clears; the list keeps the newest `KEEP`
spans, so a trace that nobody collects holds a bounded amount. A span's
`parent` is the innermost open span of its thread. No span synchronises
or reads the device: a span that ends in a sync ends where the program
syncs anyway.

The clock is the device trace's: `start_ns` and `end_ns` are Unix epoch
nanoseconds, `perf_counter_ns()` plus an offset taken when recording
turns on (the tightest of a few paired reads of both clocks), which is
how `torch.profiler` stamps its events, host and device.  So spans lay
on a trace's timeline as they are.

Inside `maybe_trace` (`cli.train --profile`) each span also opens a
`torch.profiler.record_function` of its name, so the Chrome trace shows
it; elsewhere it never does, and a trace of device activity alone pays
no host-op events for the spans.

The spans, and what reads them (perfbench/metrics/):

- `gen.load` (`cli/sample.py:generate`: the models' load and pack) and
  `gen.chain` (each chunk's reverse chain on the main thread, from its
  first launch to the end of its wait; its duration is the stage log's
  "chain" seconds): `idle_share.gen.load`, `idle_share.gen.chain`,
  `chain_ms_per_step`; with the decode worker's `decode.*` spans,
  `chain_hidden_share`.
- `chain.step` (each step of `ddim_sample_loop`, `p_sample_loop`,
  `ddim_graph_loop`, `p_graph_loop`: the host's launches only):
  `chain_launches_per_step`, `chain_graph_share`.
- `chain.replay` (each replay of the step's CUDA graph, inside its
  `chain.step`): `chain_graph_share`.
- `decode.<stage>` (`training/ae.py`, the stage log's clock reads, on
  the decode's thread: the decode worker's in `generate`), and on the
  main thread `decode.grid dispatch` and `decode.wait` (the wait for the
  decode worker, `AETrainer.pipelined_generate`):
  `idle_share.gen.decode` (the main thread's), `decode_s_per_sample`
  (the stage log's), `chain_hidden_share` (the worker's beside
  `gen.chain`).
- `export.<stage>` (the export tail's stages, `texel decode`, `texture
  assembly` and `export`, from the same clock reads, on the export
  worker's thread) and `export.png`, attr `map` (each map's PNG write of
  the PBR export, `geometry/meshio.py`, inside `export.export`):
  `export_s_per_sample`.
- `train.draw`, `train.grads`, `train.apply` (each diffusion train
  step's phases): `idle_share.diff.draw`, `.grads`, `.apply`;
  `train.call` (one `step_fn` call of `DiffusionTrainLoop.run`): the
  `--profile` trace.

`counters()` snapshots the counters that the modules keeping them name
with `counter` (the kernels' launches, `ops.fused_conv`,
`ops.fused_mlp`; the collectives, `parallel.mesh`; the chain's graph
captures and replays, `diffusion.sampling`).
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

_ON = False        # spans are recorded
_MARK = False      # and each opens a record_function (inside maybe_trace)
_OFFSET_NS = 0     # epoch ns - perf_counter ns, taken when recording starts
KEEP = 1 << 17     # spans kept until collect(), the newest
_records = collections.deque(maxlen=KEEP)
_ids = itertools.count(1)
_local = threading.local()   # .stack: this thread's open span ids
_COUNTERS: Dict[str, Callable[[], object]] = {}


class Span(NamedTuple):
    name: str
    start_ns: int      # Unix epoch ns, the device trace's clock
    end_ns: int
    thread: int        # threading.get_ident() of the recording thread
    id: int
    parent: Optional[int]
    attrs: Dict


class _Off:
    """The span returned while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _append(name, start, end, rid, parent, attrs) -> Span:
    rec = Span(name, start + _OFFSET_NS, end + _OFFSET_NS,
               threading.get_ident(), rid, parent, attrs)
    _records.append(rec)
    return rec


class _Span:
    """A block that reads the clock at both ends and, if recording was on
    when it opened, records itself (`span`, `timed`)."""
    __slots__ = ("name", "attrs", "on", "rid", "parent", "start", "mark",
                 "ns", "rec")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs
        self.rec = None

    def __enter__(self):
        self.on = _ON
        if self.on:
            st = _stack()
            self.parent = st[-1] if st else None
            self.rid = next(_ids)
            st.append(self.rid)
            self.mark = None
            if _MARK:
                self.mark = torch.profiler.record_function(self.name)
                self.mark.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.ns = end - self.start
        if self.on:
            if self.mark is not None:
                self.mark.__exit__(*exc)
            _stack().pop()
            self.rec = _append(self.name, self.start, end, self.rid,
                               self.parent, self.attrs)
        return False


def span(name: str, **attrs):
    """A context manager that records the block as a span (see the
    module doc); the shared no-op while recording is off."""
    if not _ON:
        return _OFF
    return _Span(name, attrs)


def timed(name: str, **attrs) -> _Span:
    """A span for a block whose duration the caller needs anyway: it
    always reads the clock (`.ns`, the block's nanoseconds, after it) and
    records while recording is on (`.rec`, the `Span`, else None)."""
    return _Span(name, attrs)


def add(name: str, start_ns: int, end_ns: int, **attrs) -> Optional[Span]:
    """Record a span from two `time.perf_counter_ns()` reads already
    taken, inside this thread's open span; returns it (None while
    recording is off)."""
    if not _ON:
        return None
    st = _stack()
    return _append(name, start_ns, end_ns, next(_ids),
                   st[-1] if st else None, attrs)


def stamps(rec: Optional[Span]) -> Dict:
    """{"start_ns", "end_ns"} of a recorded span; {} for None."""
    return {} if rec is None else {"start_ns": rec.start_ns,
                                   "end_ns": rec.end_ns}


def _clock_offset_ns(pairs: int = 5) -> int:
    """epoch ns - perf_counter ns from the tightest of `pairs` reads."""
    best = None
    for _ in range(pairs):
        a = time.perf_counter_ns()
        e = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, e - (a + b) // 2)
    return best[1]


def record(on: bool = True) -> bool:
    """Turn recording on or off; returns whether it was on."""
    global _ON, _OFFSET_NS
    was = _ON
    if on and not was:
        _OFFSET_NS = _clock_offset_ns()
    _ON = bool(on)
    return was


def collect() -> List[Span]:
    """The spans recorded so far, oldest first; clears them."""
    return [_records.popleft() for _ in range(len(_records))]


def _profiler_running() -> bool:
    # torch's own flag, set while any torch.profiler trace runs; read
    # without a default, so that a torch without it fails the tests
    # rather than leaving the spans' readers with nothing
    return bool(torch.autograd.profiler._is_profiler_enabled)


@contextmanager
def follow_profiler():
    """Record spans for the block while a `torch.profiler` trace runs
    around it (a caller's own trace of this call), so that they can be
    laid on that trace; otherwise leave the recorder as it is.  The spans
    stay in memory, the newest `KEEP`, until `collect()`."""
    turn = not _ON and _profiler_running()
    if turn:
        record(True)
    try:
        yield
    finally:
        if turn:
            record(False)


def counter(name: str, read: Callable[[], object]) -> None:
    """Name a counter for `counters()`; `read()` gives its value.  The
    module that keeps the counter names it when imported."""
    _COUNTERS[name] = read


def counters() -> Dict:
    """A snapshot of the named counters: {"k1.launches", "k1.forms" (by
    form), "k2.launches", "k2.shapes" ({(rows, cin, cout): n}),
    "collectives" (by kind), "chain.graph_captures",
    "chain.graph_replays"} once the kernels' wrappers, `parallel.mesh`
    and `diffusion.sampling` are imported."""
    return {name: read() for name, read in _COUNTERS.items()}


@contextmanager
def maybe_trace(log_dir: Optional[str], enabled: bool = False):
    """With `enabled`, profile the block into `{log_dir}/profile/
    trace.json` (open it in chrome://tracing or Perfetto), with the
    spans marked in it.  The spans it records only for the marks are
    dropped at its end."""
    global _MARK
    if not enabled or log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    out = os.path.join(log_dir, "profile")
    os.makedirs(out, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    was, marked = record(True), _MARK
    _MARK = True
    try:
        with profile(activities=acts) as prof:
            yield
    finally:
        _MARK = marked
        record(was)
        if not was:
            collect()
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
