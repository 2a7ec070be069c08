"""`chain_graph_share` on synthetic spans: the main thread's
`chain.replay` spans over its `chain.step` spans, in percent; nothing
where the trace, the steps or the program's graph counter are missing."""

import threading
from types import SimpleNamespace

import pytest

from perfbench import harness

MAIN = threading.main_thread().ident
OTHER = MAIN + 1


def read(ctx):
    return harness.Bench().reader("chain_graph_share")(ctx)


def ctx_of(spans):
    return SimpleNamespace(trace=object(), spans=spans, window={})


def steps(n, t0, replayed, thread=MAIN):
    """n chain steps of 1 ms from t0 (us); the first `replayed` hold a
    `chain.replay` span each."""
    out = []
    for i in range(n):
        a = t0 + 1e3 * i
        out.append((a, a + 1e3, "chain.step", thread))
        if i < replayed:
            out.append((a + 10, a + 20, "chain.replay", thread))
    return out


@pytest.fixture
def graph_counter():
    """The program's graph counters, named by the module that keeps
    them."""
    from sin3dm_tpu_torch.core import profiling
    from sin3dm_tpu_torch.diffusion import sampling  # noqa: F401
    assert "chain.graph_replays" in profiling.counters()
    return profiling


def test_replays_over_steps(graph_counter):
    # a first chain's eager first step, then 99 replays; a second chain
    # all replays; another thread's spans are not the chain's
    got = ([(0.0, 3e5, "gen.chain", MAIN)] + steps(100, 0.0, 0)[:1]
           + steps(99, 1e3, 99) + steps(100, 2e5, 100)
           + steps(5, 0.0, 5, OTHER))
    assert read(ctx_of(got)) == pytest.approx(100.0 * 199 / 200)
    assert read(ctx_of(steps(10, 0.0, 0))) == 0.0


def test_reads_nothing_without_steps_trace_or_graph(graph_counter,
                                                    monkeypatch):
    assert read(ctx_of([(0.0, 1e3, "gen.chain", MAIN)])) is None
    assert read(SimpleNamespace(trace=None, window={})) is None
    # a program without the graph (its profiling names no graph counter)
    monkeypatch.delitem(graph_counter._COUNTERS, "chain.graph_replays")
    assert read(ctx_of(steps(10, 0.0, 10))) is None
