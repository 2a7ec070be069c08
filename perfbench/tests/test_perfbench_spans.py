"""The program's spans on the trace (`perfbench/spans.py`) and the
readers that use them, on a synthetic trace and span list: each cell's
shares plus the idle outside them are its `idle_share.*`, the launches a
chain step count only what starts inside `gen.chain`, and the readers
load by name and read nothing where the trace or the recorder is
missing."""

import threading
from types import SimpleNamespace

import pytest

from perfbench import harness, spans, tracing

MAIN = threading.main_thread().ident
OTHER = MAIN + 1

GEN_METRICS = ["idle_share.gen.chain", "idle_share.gen.decode",
               "idle_share.gen.load", "chain_launches_per_step"]
DIFF_METRICS = ["idle_share.diff.draw", "idle_share.diff.grads",
                "idle_share.diff.apply"]


def read(name, ctx):
    return harness.Bench().reader(name)(ctx)


def gen_ctx():
    """A 1.02 s window: the opening sync at 0.01 s, the device busy
    0.1-0.2, 0.3-0.35 and 0.6-0.95 s, the closing sync to 1.0 s (0.52 s
    idle: 0.03 s outside the runtime calls, which nothing locates, and
    0.09 s between the opening sync and the first operation); the load
    over 0-0.15 s, a chain over 0.15-0.4 s (two steps), decode stages
    over 0.45-0.55 s; spans of another thread are not the main
    thread's."""
    tr = tracing.Trace([(1e5, 2e5, "conv3x3"), (3e5, 3.5e5, "copy"),
                        (6e5, 9.5e5, "mlp_bf16")],
                       [(1e4, 1.1e4, "cudaDeviceSynchronize"),
                        (2e4, 2.1e4, "Activity Buffer Request"),
                        (9.4e5, 1e6, "cudaDeviceSynchronize")],
                       1e5, 9.5e5, 1.02)
    got = [(0.0, 1.5e5, "gen.load", MAIN),
           (1.5e5, 4e5, "gen.chain", MAIN),
           (1.5e5, 2.5e5, "chain.step", MAIN),
           (2.5e5, 3.9e5, "chain.step", MAIN),
           (4.5e5, 5e5, "decode.sdf grid", MAIN),
           (5e5, 5.5e5, "decode.grid dispatch", MAIN),
           (5.5e5, 6e5, "decode.marching cubes", OTHER)]
    return SimpleNamespace(trace=tr, spans=got, window={})


def test_gen_shares_add_up_to_the_idle_share():
    ctx = gen_ctx()
    got = {m: read(m, ctx) for m in GEN_METRICS}
    assert got["idle_share.gen.load"] == pytest.approx(100 * 0.09 / 1.02)
    assert got["idle_share.gen.chain"] == pytest.approx(100 * 0.15 / 1.02)
    assert got["idle_share.gen.decode"] == pytest.approx(100 * 0.1 / 1.02)
    split = spans.idle_split(ctx.trace, ctx.spans, spans.GEN)
    # 0.4-0.45 and 0.55-0.6 between the spans, 0.95-1.0 in the closing
    # sync, 0.03 outside the runtime calls
    assert split["outside"] == pytest.approx(0.18)
    total = read("idle_share.gen", ctx)
    assert total == pytest.approx(100 * 0.52 / 1.02)
    assert sum(got[m] for m in GEN_METRICS[:3]) \
        + 100 * split["outside"] / 1.02 == pytest.approx(total, abs=1e-9)


def test_diff_shares_add_up_to_the_idle_share():
    """Two steps of draw, grads, apply in a 0.5 s window; idle between
    the steps and inside each phase."""
    tr = tracing.Trace([(0.02e6, 0.09e6, "k"), (0.1e6, 0.2e6, "k"),
                        (0.26e6, 0.34e6, "k"), (0.35e6, 0.5e6, "k")],
                       [], 0.02e6, 0.5e6, 0.5)
    got = []
    for t in (0.0, 0.25e6):
        got += [(t, t + 0.03e6, "train.draw", MAIN),
                (t + 0.03e6, t + 0.15e6, "train.grads", MAIN),
                (t + 0.15e6, t + 0.2e6, "train.apply", MAIN)]
    ctx = SimpleNamespace(trace=tr, spans=got, window={})
    shares = {m: read(m, ctx) for m in DIFF_METRICS}
    # idle (s): 0-0.02 before the first operation, which no runtime call
    # locates (outside); 0.09-0.1 (grads), 0.2-0.25 (between the steps),
    # 0.25-0.26 (draw), 0.34-0.35 (grads); apply none
    assert shares["idle_share.diff.draw"] == pytest.approx(100 * 0.01 / 0.5)
    assert shares["idle_share.diff.grads"] == pytest.approx(
        100 * 0.02 / 0.5)
    assert shares["idle_share.diff.apply"] == 0.0
    split = spans.idle_split(tr, got, spans.DIFF)
    assert split["outside"] == pytest.approx(0.05 + 0.02)
    total = read("idle_share.diff", ctx)
    assert total == pytest.approx(20.0)
    assert sum(shares.values()) + 100 * split["outside"] / 0.5 == \
        pytest.approx(total, abs=1e-9)


def test_chain_launches_count_only_inside_the_chain():
    tr = tracing.Trace([(0.5e5, 0.6e5, "before"), (1.5e5, 1.6e5, "a"),
                        (1.7e5, 4.5e5, "b"), (3.9e5, 4e5, "c"),
                        (4e5, 4.1e5, "edge"), (4.2e5, 4.3e5, "after"),
                        (6e5, 7e5, "second chain")], [], 0.5e5, 7e5, 0.7)
    got = [(1.5e5, 4e5, "gen.chain", MAIN),
           (1.5e5, 2.5e5, "chain.step", MAIN),
           (2.5e5, 3.9e5, "chain.step", MAIN),
           (5.5e5, 7e5, "gen.chain", MAIN),
           (5.5e5, 6.5e5, "chain.step", MAIN),
           (4.2e5, 4.5e5, "gen.chain", OTHER)]
    ctx = SimpleNamespace(trace=tr, spans=got, window={})
    # a, b, c and the operation starting at the chain's end; the second
    # chain's one; none before, between or on another thread
    assert read("chain_launches_per_step", ctx) == pytest.approx(5 / 3)


@pytest.mark.parametrize("name", GEN_METRICS + DIFF_METRICS)
def test_readers_load_by_name_and_read_nothing_without_spans(name,
                                                             monkeypatch):
    bench = harness.Bench()
    entry = bench.named("per_layer", name)
    cells = {w["name"] for w in bench.spec["workloads"]}
    assert entry["source"] == "program_span" and entry["workloads"]
    assert set(entry["workloads"]) <= cells, entry["workloads"]
    reader = bench.reader(name)
    assert reader(SimpleNamespace(trace=None, window={})) is None
    tr = tracing.Trace([(0.0, 1.0, "k")], [], 0.0, 1.0, 1e-6)
    assert reader(SimpleNamespace(trace=tr, spans=[], window={})) is None
    # a program without the recorder (an older checkout) gives no spans
    from sin3dm_tpu_torch.core import profiling
    monkeypatch.delattr(profiling, "collect")
    assert reader(SimpleNamespace(trace=tr, window={})) is None


def test_spans_are_collected_once_a_run():
    from sin3dm_tpu_torch.core import profiling
    profiling.collect()
    profiling.record(True)
    try:
        with profiling.span("gen.chain"):
            with profiling.span("chain.step"):
                pass
    finally:
        profiling.record(False)
    tr = tracing.Trace([(0.0, 1.0, "k")], [], 0.0, 1.0, 1e-6)
    ctx = SimpleNamespace(trace=tr, window={})
    first = spans.of(ctx)
    assert [s[2] for s in first] == ["chain.step", "gen.chain"]
    assert spans.of(ctx) is first and profiling.collect() == []
    assert all(s[3] == MAIN for s in first)
