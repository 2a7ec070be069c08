"""The reverse chain's step replayed as a CUDA graph
(`diffusion/sampling.py`), on the CPU: when the sampler takes the graph,
K1's counters under capture and replay with a stand-in for the graph,
and the graph loops' chains (DDIM at eta 0 and 0.3, the ancestral DDPM
chain, whose steps read noise drawn into the graph's static buffers)
against the eager loops with a stand-in that replays by running the
step again.  The graph itself on the card:
`tests/test_torch_port_cuda.py`."""

import itertools
import threading

import pytest
import torch

from sin3dm_tpu_torch.core import profiling
from sin3dm_tpu_torch.core.triplane import Triplane
from sin3dm_tpu_torch.diffusion import gaussian as tg
from sin3dm_tpu_torch.diffusion import sampling as ts
from sin3dm_tpu_torch.diffusion import schedule as tsched
from sin3dm_tpu_torch.ops import fused_conv

torch.set_num_threads(2)
SIZES = (6, 5, 4)
C = 3


@pytest.mark.parametrize("device,use_ddim,eta,guided,spatial",
                         list(itertools.product(
                             ["cpu", "cuda"], [True, False], [0.0, 0.3],
                             [False, True], [False, True])))
def test_graph_engages(device, use_ddim, eta, guided, spatial):
    """Every unguided chain on whole planes on the card, DDPM or DDIM at
    any eta."""
    got = ts.graph_engages(torch.device(device), use_ddim, eta,
                           (lambda x, t: x) if guided else None,
                           object() if spatial else None)
    assert got == (device == "cuda" and not guided and not spatial)


def test_cpu_sampler_keeps_the_eager_chain(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the graph loop ran on the CPU")
    monkeypatch.setattr(ts, "ddim_graph_loop", refuse)
    monkeypatch.setattr(ts, "p_graph_loop", refuse)
    for use_ddim, respacing in ((True, "ddim4"), (False, "")):
        tables = tg.tables_to_device(tsched.make_schedule(
            "linear", 20, respacing).tables_f32(), "cpu")
        sample = ts.make_sampler(_model, tables, tg.DiffusionConfig(),
                                 use_ddim=use_ddim, device="cpu")
        assert sample(0, 0, 1, C, SIZES).sizes == SIZES


class StandInGraph:
    """`torch.cuda.CUDAGraph`'s capture and replay calls, recorded; a
    replay runs `fn` where one is set."""

    def __init__(self):
        self.calls, self.fn = [], None

    def capture_begin(self, capture_error_mode="global"):
        self.calls.append(("begin", capture_error_mode))

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        self.calls.append("replay")
        if self.fn is not None:
            self.fn()


def _k1_and_graph_counts():
    c = profiling.counters()
    return (c["k1.launches"], dict(c["k1.forms"]),
            c["chain.graph_captures"], c["chain.graph_replays"])


def test_k1_counts_a_captured_step_at_each_replay():
    """A step of 6 default and 2 act launches: the eager first step
    counts them; the capture counts none of its own, but another thread
    launching meanwhile counts; each replay counts the captured 8."""
    graph = StandInGraph()
    other = threading.Thread(target=fused_conv._count,
                             args=(None, None, False))

    def step(x, tb):
        for i in range(8):
            fused_conv._count(None if i < 6 else (1, 1), None, False)
        if graph.calls and graph.calls[-1][0] == "begin":
            other.start()
            other.join(timeout=10)
        return x.map(lambda p: p + 1)

    def diff(a, b):
        return {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}

    x = Triplane(*[torch.zeros(1, 2, 3, C) for _ in range(3)])
    k1, forms, caps, reps = _k1_and_graph_counts()
    g = ts.StepGraph(step, x, 9, graph=graph)
    assert not other.is_alive()
    k1_1, forms_1, caps_1, reps_1 = _k1_and_graph_counts()
    assert graph.calls == [("begin", "thread_local"), "end"]
    assert k1_1 - k1 == 9 and diff(forms_1, forms) == {"default": 7,
                                                       "act": 2}
    assert (caps_1 - caps, reps_1 - reps) == (1, 0)
    assert g.k1 == {"default": 6, "act": 2}
    assert all(torch.equal(s, torch.ones_like(s)) for s in g.state)
    assert g.tb.tolist() == [9]
    g.replay(8)
    g.replay(7)
    k1_2, forms_2, caps_2, reps_2 = _k1_and_graph_counts()
    assert graph.calls[2:] == ["replay", "replay"]
    assert k1_2 - k1_1 == 16 and diff(forms_2, forms_1) == {"default": 12,
                                                            "act": 4}
    assert (caps_2 - caps_1, reps_2 - reps_1) == (0, 2)
    assert g.tb.tolist() == [7]
    out = g.result()
    assert all(torch.equal(o, s) and o.data_ptr() != s.data_ptr()
               for o, s in zip(out, g.state))


def _model(x, t):
    s = 0.9 - 0.0004 * t.float()
    return x.map(lambda p: p * s[:, None, None, None] + 0.05)


PLANES = ((6, 5), (6, 4), (5, 4))


@pytest.mark.parametrize("chain,eta,batch,masked", [
    ("ddim", 0.0, 1, False), ("ddim", 0.0, 1, True), ("ddim", 0.3, 1, False),
    ("ddpm", 0.0, 1, False), ("ddpm", 0.0, 2, False)])
def test_graph_loop_equals_the_eager_loop(monkeypatch, chain, eta, batch,
                                          masked):
    """Three chains through one graph (x_T from the seed, then given
    noise, then another seed) equal the eager loop's bit for bit, with a
    stand-in that replays by running the captured step: DDIM-10 at eta 0
    (plain and masked) and 0.3, DDPM-30 at batch 1 and 2, whose steps
    read each step's draw from the graph's static noise.  One capture,
    every other step a replay, and the results are copies."""
    made, real = [], ts.StepGraph

    def stand_in(step, x, t, noise=None):
        graph = StandInGraph()
        g = real(step, x, t, noise, graph=graph)

        def run():
            for s, n in zip(g.state, step(*g.inputs)):
                s.copy_(n)
        graph.fn = run
        made.append((graph, g))
        return g

    monkeypatch.setattr(ts, "StepGraph", stand_in)
    ddim = chain == "ddim"
    tables = tg.tables_to_device(tsched.make_schedule(
        "linear", 100 if ddim else 30,
        "ddim10" if ddim else "").tables_f32(), "cpu")
    T = tables["betas"].shape[0]
    cfg = tg.DiffusionConfig()
    kw = {"eta": eta} if ddim else {}
    if masked:
        g = torch.Generator().manual_seed(3)
        kw.update({"y0": Triplane(*[torch.randn(1, *s, C, generator=g)
                                    for s in PLANES]),
                   "mask": ts.region_keep_masks(SIZES, (0, 0.5, 0, 1, 0, 1)),
                   "is_mask_t0": True})
    eager, graph_loop = ((ts.ddim_sample_loop, ts.ddim_graph_loop) if ddim
                         else (ts.p_sample_loop, ts.p_graph_loop))
    noise = Triplane(*[torch.randn(batch, *s, C, generator=torch.Generator()
                                   .manual_seed(7)) for s in PLANES])
    graphs, outs = {}, []
    for seed, given in ((1, None), (1, noise), (2, None)):
        gens = ts.sample_generators(seed, 0, batch, "cpu")
        want = eager(_model, tables, cfg, gens, batch, C, SIZES,
                     noise=given, device="cpu", **kw)
        gens = ts.sample_generators(seed, 0, batch, "cpu")
        got = graph_loop(_model, tables, cfg, gens, batch, C, SIZES,
                         graphs, noise=given, device="cpu", **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        outs.append(got)
    assert len(made) == 1 and len(graphs) == 1
    graph, g = made[0]
    assert graph.calls.count("replay") == (T - 1) + T + T
    assert (g.noise is None) == (ddim and eta == 0.0)
    # the results are not the graph's state, which the last chain wrote
    assert not all(torch.equal(a, b) for a, b in zip(outs[0], outs[2]))
