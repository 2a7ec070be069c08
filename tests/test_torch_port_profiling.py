"""The port's recorder (`sin3dm_tpu_torch/core/profiling.py`): spans off
and on, their parents across nesting and threads, `collect` and the
bound on what it keeps, the clock
shared with `torch.profiler`, `counters()` against the attributes it
reads, `maybe_trace`'s marks, and the spans of a tiny `generate` on the
CPU against its stage log.  One test needs the card: the trace's
`cudaDeviceSynchronize` lies inside the span that made it (skips here;
on the card `python -m pytest --noconftest
tests/test_torch_port_profiling.py -q`)."""

import json
import os
import threading
import time

import pytest
import torch

from sin3dm_tpu_torch.core import profiling

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TAG = os.path.join(ROOT, "checkpoints", "towerruins")


@pytest.fixture
def recorder():
    """Recording on for the test, off and empty after it."""
    profiling.collect()
    profiling.record(True)
    yield
    profiling.record(False)
    profiling.collect()


def test_off_records_nothing_and_returns_the_shared_no_op():
    profiling.collect()
    a, b = profiling.span("x"), profiling.span("y", j=3)
    assert a is b
    with a as s:
        assert s is None
    assert profiling.add("z", 1, 2) is None
    assert profiling.collect() == []


def test_names_parents_and_attrs(recorder):
    with profiling.span("outer", j=4):
        with profiling.span("inner", t=9):
            pass
        t0 = time.perf_counter_ns()
        rec = profiling.add("added", t0, t0 + 1000, dir="d")
    spans = {s.name: s for s in profiling.collect()}
    assert set(spans) == {"outer", "inner", "added"}
    o, i, a = spans["outer"], spans["inner"], spans["added"]
    assert o.parent is None and o.attrs == {"j": 4}
    assert i.parent == o.id and i.attrs == {"t": 9}
    assert a.parent == o.id and a.attrs == {"dir": "d"} and a == rec
    assert a.end_ns - a.start_ns == 1000
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert len({o.id, i.id, a.id}) == 3
    assert {s.thread for s in spans.values()} == {threading.get_ident()}
    assert profiling.stamps(a) == {"start_ns": a.start_ns,
                                   "end_ns": a.end_ns}
    assert profiling.stamps(None) == {}


def test_each_thread_nests_its_own_spans(recorder):
    """A span opened on another thread while one is open here is no
    child of it, and carries its own thread's id."""
    def work():
        with profiling.span("worker"):
            with profiling.span("worker.inner"):
                pass
    with profiling.span("submit"):
        th = threading.Thread(target=work)
        th.start()
        th.join()
    spans = {s.name: s for s in profiling.collect()}
    w, i = spans["worker"], spans["worker.inner"]
    assert w.parent is None and i.parent == w.id
    assert w.thread == i.thread == th.ident != threading.get_ident()
    assert spans["submit"].thread == threading.get_ident()


def test_collect_clears(recorder):
    with profiling.span("a"):
        pass
    assert [s.name for s in profiling.collect()] == ["a"]
    assert profiling.collect() == []
    with profiling.span("b"):
        pass
    assert [s.name for s in profiling.collect()] == ["b"]


def test_records_keep_the_newest(recorder, monkeypatch):
    """Spans nobody collects are bounded: the list keeps the newest."""
    import collections
    assert profiling._records.maxlen == profiling.KEEP > 0
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=3))
    for k in range(5):
        profiling.add(f"s{k}", k, k + 1)
    assert [s.name for s in profiling.collect()] == ["s2", "s3", "s4"]


def test_follow_profiler_records_only_under_a_trace():
    from torch.profiler import ProfilerActivity, profile
    profiling.collect()

    @profiling.follow_profiler()
    def call():
        with profiling.span("inside"):
            pass
    call()
    assert profiling.collect() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling._profiler_running()
        call()
    assert not profiling._profiler_running()
    assert [s.name for s in profiling.collect()] == ["inside"]
    call()
    assert profiling.collect() == []   # off again after the trace


def test_counters_read_the_attributes(monkeypatch):
    from sin3dm_tpu_torch.diffusion import sampling
    from sin3dm_tpu_torch.ops import fused_conv, fused_mlp, tnorm
    from sin3dm_tpu_torch.parallel import mesh
    k1, k2 = fused_conv.conv3x3_rollout, fused_mlp.skip_mlp
    tn = tnorm.tnorm_silu
    monkeypatch.setattr(k1, "launches", 5, raising=False)
    monkeypatch.setattr(tn, "launches", 7, raising=False)
    monkeypatch.setattr(k1, "form_launches", {"plain": 5}, raising=False)
    monkeypatch.setattr(k2, "launches", 2, raising=False)
    monkeypatch.setattr(k2, "shape_launches", {(8, 4, 1): 2},
                        raising=False)
    monkeypatch.setitem(mesh.COUNTS, "all_reduce", 3)
    monkeypatch.setattr(sampling, "_graph_counts",
                        {"captures": 1, "replays": 99})

    def attrs():
        return {"k1.launches": k1.launches,
                "k1.forms": dict(k1.form_launches),
                "k2.launches": k2.launches,
                "k2.shapes": dict(k2.shape_launches),
                "collectives": dict(mesh.COUNTS),
                "chain.graph_captures": sampling._graph_counts["captures"],
                "chain.graph_replays": sampling._graph_counts["replays"],
                "tnorm.launches": tn.launches}
    before = profiling.counters()
    assert before == attrs()
    # the plain path (CPU tensors) launches no kernel and counts none
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 5, 8, generator=g)
    k1(x, torch.randn(3, 3, 8, 8, generator=g))
    head = {"first": [{"w": torch.randn(8, 16, generator=g),
                       "b": torch.zeros(16)},
                      {"w": torch.randn(16, 16, generator=g),
                       "b": torch.zeros(16)}],
            "second": [{"w": torch.randn(24, 16, generator=g),
                        "b": torch.zeros(16)},
                       {"w": torch.randn(16, 1, generator=g),
                        "b": torch.zeros(1)}]}
    k2(head, torch.randn(6, 8, generator=g))
    tn([torch.randn(1, 3, 2, 32, generator=g) for _ in range(3)],
       [torch.ones(32)] * 3, [torch.zeros(32)] * 3)
    assert profiling.counters() == before == attrs()
    # one launch of each, as the card's wrappers count it
    fused_conv._count(None, None, False)
    fused_mlp._count((6, 8, 1))
    tnorm._count()
    after = profiling.counters()
    assert after == attrs()
    assert after["k1.launches"] == 6 and after["k2.launches"] == 3
    assert after["tnorm.launches"] == 8
    assert after["k2.shapes"] == {(8, 4, 1): 2, (6, 8, 1): 1}
    assert sum(after["k1.forms"].values()) == 6
    assert (after["chain.graph_captures"],
            after["chain.graph_replays"]) == (1, 99)
    sampling._count_graph("replays")
    assert profiling.counters()["chain.graph_replays"] == 100


def test_spans_share_the_profiler_clock(recorder):
    """A span around a `record_function` holds that event's start and
    end on the profiler's (epoch) clock: in each of five, give or take
    50 us, and in the tightest within 50 us at each end (host jitter
    spreads single readings; a clock offset would move them all)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            pass
        for i in range(5):
            with profiling.span(f"outer{i}"):
                with torch.profiler.record_function(f"marked{i}"):
                    torch.ones(64).sum()
    spans = {x.name: x for x in profiling.collect()}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    lags = []
    for i in range(5):
        s, e = spans[f"outer{i}"], events[f"marked{i}"]
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        assert s.start_ns - 50_000 <= a <= b <= s.end_ns + 50_000
        lags.append(max(a - s.start_ns, s.end_ns - b))
    assert min(lags) < 50_000, lags


def test_span_marks_the_profile_trace(tmp_path):
    """Inside `maybe_trace` a span also marks the Chrome trace, and the
    spans recorded for the marks are dropped at its end; outside it no
    span opens a `record_function`."""
    from torch.profiler import ProfilerActivity, profile
    profiling.collect()
    with profiling.maybe_trace(str(tmp_path), True):
        with profiling.span("decode/heads"):
            torch.ones(4).sum()
    assert profiling.span("a") is profiling.span("b")   # off again
    assert profiling.collect() == []
    with open(tmp_path / "profile" / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "decode/heads" in names
    profiling.record(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("unmarked"):
                torch.ones(4).sum()
    finally:
        profiling.record(False)
    assert [s.name for s in profiling.collect()] == ["unmarked"]
    assert "unmarked" not in {e.key for e in prof.key_averages()}


def _generate(out, n, recording):
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core import config as cfgmod
    args = cfgmod.sample_args([
        "--tag", TAG, "--device", "cpu", "--output", str(out),
        "--n_samples", str(n), "--pipeline_chunk", "1",
        "--resize", "0.125", "0.125", "0.125", "--use_ddim", "true",
        "--timestep_respacing", "ddim4", "--reso", "32", "--texreso", "128",
        "--n_faces", "500"])
    profiling.collect()
    profiling.record(recording)
    try:
        _, stages = cli.generate(args)
    finally:
        profiling.record(False)
    return stages, profiling.collect()


TODAY = {"dir", "stage", "seconds", "dispatch", "texels", "launches"}
WORKER = {"texel decode", "texture assembly", "export"}   # its stages
DECODER = {"sdf grid", "voxel.npz", "marching cubes", "decimation",
           "uv atlas + raster", "texel dispatch"}   # the decode worker's


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("SIN3DM_SAMPLE_DTYPE", "train")
    mp.setenv("SIN3DM_DECODE_BF16", "0")
    try:
        on = _generate(tmp_path_factory.mktemp("on"), 2, True)
        off = _generate(tmp_path_factory.mktemp("off"), 1, False)
    finally:
        mp.undo()
    return on, off


def test_generate_spans(generated):
    """One `gen.load`, one `gen.chain` a chunk, chunks x steps
    `chain.step`s inside them, `decode.grid dispatch` and `decode.wait`
    (one a chunk) on the main thread and outside every `gen.chain`; the
    decode's stages, one set a sample, on one decode worker thread; the
    export worker's stages are `export.<stage>` spans, one set a sample,
    on its own thread."""
    (stages, spans), _ = generated
    main = threading.get_ident()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert len(by["gen.load"]) == 1
    chains = by["gen.chain"]
    assert sorted(s.attrs["j"] for s in chains) == [0, 1]
    assert len(by["chain.step"]) == 2 * 4
    ids = {s.id for s in chains}
    assert all(s.parent in ids for s in by["chain.step"])
    load = by["gen.load"][0]
    assert load.end_ns <= min(s.start_ns for s in chains)
    for s in chains:
        inside = [c for c in by["chain.step"] if c.parent == s.id]
        assert len(inside) == 4
        assert all(s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns
                   for c in inside)
    assert len(by["decode.grid dispatch"]) == 2
    assert len(by["decode.wait"]) == 2
    assert len(by["decode.texel dispatch"]) == 2
    worker = [s for s in spans if s.name.startswith("export.")]
    assert sorted(s.name for s in worker) == sorted(
        ["export." + w for w in WORKER] * 2)
    assert sorted(s.attrs["dir"] for s in worker) == sorted(
        [s.attrs["dir"] for s in by["decode.texel dispatch"]] * 3)
    assert all(s.thread != main for s in worker)
    on_main = {"decode.grid dispatch", "decode.wait"}
    decode = [s for s in spans if s.name.startswith("decode.")
              and s.name not in on_main]
    assert sorted(s.name for s in decode) == sorted(
        ["decode." + d for d in DECODER] * 2)
    assert sorted(s.attrs["dir"] for s in decode) == sorted(
        [s.attrs["dir"] for s in by["decode.texel dispatch"]]
        * len(DECODER))
    threads = {s.thread for s in decode}
    assert len(threads) == 1 and main not in threads
    assert not threads & {s.thread for s in worker}
    assert all(s.thread == main for s in spans
               if s not in worker and s not in decode)
    assert not set(by) & {"decode." + s for s in WORKER}
    for s in spans:
        if s.thread == main and s.name.startswith("decode."):
            assert all(s.end_ns <= c.start_ns or c.end_ns <= s.start_ns
                       for c in chains)


def test_generate_stage_log_reads_its_spans(generated):
    """Each stage-log entry's seconds is its span's duration (the chain's
    over the chunk's samples; the export worker's stages are `export.*`
    spans); with recording off the entries keep today's keys."""
    (stages, spans), (off_stages, off_spans) = generated
    names = {}
    for s in spans:
        names[(s.start_ns, s.end_ns)] = s
    worker = [e for e in stages if e["stage"] in WORKER]
    assert len(worker) == 2 * len(WORKER)
    for e in stages:
        s = names[(e["start_ns"], e["end_ns"])]
        family = "export." if e in worker else "decode."
        assert s.name in ("gen.chain", family + e["stage"])
        if s.name != "gen.chain":
            assert s.attrs["dir"] == e["dir"]
        assert e["seconds"] == (s.end_ns - s.start_ns) / 1e9
    chain = [e for e in stages if e["stage"] == "chain"]
    assert len(chain) == 2
    assert off_spans == []
    assert off_stages and all(set(e) <= TODAY for e in off_stages)
    assert {e["stage"] for e in off_stages} == {e["stage"] for e in stages}


def _syncs_in_spans(x, sync, n=3):
    """[(span start, end, cudaDeviceSynchronize start, end)] in us, of n
    syncs, each after a long matmul chain, under the benchmark's trace
    (each span overlaps exactly one such call)."""
    from perfbench import tracing
    profiling.collect()
    profiling.record(True)
    out = {}
    try:
        with tracing.traced(True, out):
            for _ in range(n):
                y = x
                for _ in range(40):
                    y = (y @ x) * 1e-3
                with profiling.span("sync"):
                    sync()
    finally:
        profiling.record(False)
    got = []
    for s in profiling.collect():
        a0, b0 = s.start_ns / 1e3, s.end_ns / 1e3
        calls = [(a, b) for a, b, n in out["trace"].host
                 if n == "cudaDeviceSynchronize" and b > a0 and a < b0]
        assert len(calls) == 1, calls
        got.append((a0, b0) + calls[0])
    return got


@pytest.mark.cuda
def test_sync_lies_inside_its_span_on_the_trace():
    """On the card, under the benchmark's CUDA-only trace
    (`perfbench/tracing.py:traced`): a long matmul chain queued, then a
    sync inside a span; the trace's `cudaDeviceSynchronize` lies inside
    that span.  Each end's margin is the host's time between the span's
    clock read and the call's own stamp, plus any offset of the two
    clocks, so the tightest margins bound that offset: through the bare
    binding (`torch._C._cuda_synchronize`) within 20 us at the start and
    40 us at the end, where CUPTI's handling of the call's exit comes
    before the span's last read.  `torch.cuda.synchronize()` adds its
    wrapper's own runtime calls at each end (50-70 us on an H100):
    inside, and printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import sys
    sys.path.insert(0, ROOT)
    x = torch.randn(4096, 4096, device="cuda")
    (x @ x).sum()
    torch.cuda.synchronize()
    got = {}
    for name, sync in (("torch.cuda.synchronize", torch.cuda.synchronize),
                       ("_cuda_synchronize", torch._C._cuda_synchronize)):
        got[name] = _syncs_in_spans(x, sync)
        for a0, b0, a, b in got[name]:
            print(f"{name}: span {b0 - a0:.1f} us; cudaDeviceSynchronize "
                  f"starts {a - a0:.1f} us after it, ends {b0 - b:.1f} us "
                  "before its end")
        assert all(a0 <= a <= b <= b0 for a0, b0, a, b in got[name])
    bare = got["_cuda_synchronize"]
    assert min(a - a0 for a0, b0, a, b in bare) <= 20
    assert min(b0 - b for a0, b0, a, b in bare) <= 40
