"""The share of reverse-chain steps replayed from a CUDA graph: the main
thread's `chain.replay` spans over its `chain.step` spans, in percent.
The program's spans on the trace (perfbench/spans.py).  A program that
keeps no graph counter ("chain.graph_replays" in its profiling module's
`counters()`) has no such graph, and this reads nothing there."""

from perfbench import spans


def _has_graph() -> bool:
    try:
        from sin3dm_tpu_torch.core import profiling
    except ImportError:
        return False
    counters = getattr(profiling, "counters", None)
    return counters is not None and "chain.graph_replays" in counters()


def read(ctx):
    got = spans.of(ctx)
    if not got or not _has_graph():
        return None
    steps = len(spans.main_thread(got, "chain.step"))
    if not steps:
        return None
    return 100.0 * len(spans.main_thread(got, "chain.replay")) / steps
