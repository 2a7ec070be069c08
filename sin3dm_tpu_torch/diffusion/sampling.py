"""Sampling loops (counterpart of `sin3dm_tpu/diffusion/sampling.py`).

The JAX package compiles the reverse chain into one `lax.scan`; here it
is a Python loop of steps on the device.  Where `graph_engages` (a CUDA
device, no guidance, whole planes), `make_sampler` captures the step
once as a CUDA graph (`StepGraph`) and replays it at every step of every
chain of its shapes (`p_graph_loop`, `ddim_graph_loop`), so that the
host issues one graph launch a step and not the step's ~1,400
operations.  The DDIM step at eta 0 draws nothing; the ancestral step
and the DDIM step at eta != 0 read each step's noise from a static
triplane that the host fills from the samples' generators before each
replay, so the generators advance as in the eager loops.  Everywhere
else the steps run eagerly.

Noise contract: sample j depends only on (seed, j).  Every sample owns
one `torch.Generator` on the device, seeded from (seed, j)
(`sample_generators`); its initial noise and then each step's noise are
drawn from that generator alone, so a sample is the same whatever the
batch it was drawn in.  The bits differ from JAX's threefry/rbg streams;
tests hand both sides the same numpy noise through `noise=`.

Several devices: data-parallel sampling needs nothing here, since a
rank that draws a contiguous block of the samples (`cli/sample.py`)
draws each from its own generators as above, so the split changes no
sample.  With a spatial group (`make_sampler`) every rank draws each
sample's whole noise from those generators and keeps its rows of each
plane (`noise_view`), so the sharded chain is the whole one.

The progressive loops keep the state after every `snapshot_every` steps
(and after the last), stacked `[S, B, ...]`; their last snapshot is the
plain loop's result bit for bit.  Every eager loop takes a `cond_fn`
(guidance, `gaussian.condition_mean` / `condition_score`).  Each step of
the plain loops is a `chain.step` span (`core.profiling`): the host's launches,
no sync; each replay of a graph is also a `chain.replay` span, and
`core.profiling.counters()` reads the captures and replays as
"chain.graph_captures" and "chain.graph_replays".
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import profiling
from ..core.rng import step_generator
from ..core.triplane import Triplane
from ..ops import fused_conv, tnorm
from ..parallel.halo import gather_plane, shard_plane
from .gaussian import CondFn, DiffusionConfig, ModelFn, ddim_sample_step, \
    p_sample_step


def sample_generators(seed: int, start: int, batch: int,
                      device) -> List[torch.Generator]:
    """One generator per global sample index start..start+batch-1, each
    seeded from (seed, index) through numpy's SeedSequence."""
    return [step_generator(seed, j, device)
            for j in range(start, start + batch)]


def randn_per_sample(gens: Sequence[torch.Generator], channels: int,
                     sizes: Tuple[int, int, int], device,
                     out: Optional[Triplane] = None) -> Triplane:
    """Batch of standard-normal triplanes; row j drawn from gens[j],
    plane by plane (xy, xz, yz).  `out`: draw into its planes (a graph's
    static noise) instead of new ones."""
    H, W, D = sizes
    shapes = ((H, W, channels), (H, D, channels), (W, D, channels))
    if out is None:
        out = Triplane(*[torch.empty((len(gens),) + shape, device=device)
                         for shape in shapes])
    for shape, plane in zip(shapes, out):
        for j, g in enumerate(gens):
            torch.randn(shape, generator=g, out=plane[j])
    return out


NoiseView = Optional[Callable[[Triplane], Triplane]]


def _draw(gens, channels, sizes, device, view: NoiseView) -> Triplane:
    t = randn_per_sample(gens, channels, sizes, device)
    return t if view is None else view(t)


def _init(gens, batch, channels, sizes, noise, device, step_noise: bool,
          view: NoiseView = None):
    """The initial x_T: `noise` if given, else drawn from `gens` (through
    `view`), which must hold one generator per sample where the steps
    draw noise too."""
    if (noise is None or step_noise) and (gens is None
                                          or len(gens) != batch):
        raise ValueError("pass one generator per sample (and, where the "
                         "steps draw no noise, it may be the initial "
                         "noise instead)")
    if noise is not None:
        return noise
    return _draw(gens, channels, sizes, device, view)


def _p_stepper(model, tables, cfg, gens, channels, sizes, clip_denoised,
               device, cond_fn=None, view: NoiseView = None):
    """step(x, t) of the ancestral chain: noise from `gens` (through
    `view`), one draw per step."""
    def step(x, t):
        tb = torch.full((len(gens),), t, dtype=torch.int64, device=device)
        step_noise = _draw(gens, channels, sizes, device, view)
        return p_sample_step(model, tables, cfg, x, tb, step_noise,
                             clip_denoised=clip_denoised, cond_fn=cond_fn)
    return step


def _ddim_stepper(model, tables, cfg, gens, batch, channels, sizes, eta,
                  clip_denoised, device, y0, mask, is_mask_t0,
                  cond_fn=None, view: NoiseView = None):
    """step(x, t) of the DDIM chain; with eta == 0 it draws nothing."""
    def step(x, t):
        tb = torch.full((batch,), t, dtype=torch.int64, device=device)
        step_noise = (_draw(gens, channels, sizes, device, view)
                      if eta != 0.0 else None)
        return ddim_sample_step(model, tables, cfg, x, tb, step_noise,
                                eta=eta, clip_denoised=clip_denoised, y0=y0,
                                mask=mask, is_mask_t0=is_mask_t0,
                                cond_fn=cond_fn)
    return step


def p_sample_loop(model: ModelFn, tables, cfg: DiffusionConfig,
                  gens: Optional[Sequence[torch.Generator]], batch: int,
                  channels: int, sizes: Tuple[int, int, int],
                  noise: Optional[Triplane] = None,
                  clip_denoised: bool = True, device="cuda",
                  cond_fn: Optional[CondFn] = None,
                  noise_view: NoiseView = None) -> Triplane:
    """Ancestral DDPM sampling.  `noise` replaces the initial draw; the
    per-step noise always comes from `gens`.  `cond_fn` guides every
    step (`condition_mean`).  `noise_view` maps every draw (of `sizes`)
    to the chain's state, e.g. this rank's rows of each plane."""
    T = tables["betas"].shape[0]
    x = _init(gens, batch, channels, sizes, noise, device, step_noise=True,
              view=noise_view)
    step = _p_stepper(model, tables, cfg, gens, channels, sizes,
                      clip_denoised, device, cond_fn, noise_view)
    for t in range(T - 1, -1, -1):
        with profiling.span("chain.step", t=t):
            x = step(x, t)
    return x


def ddim_sample_loop(model: ModelFn, tables, cfg: DiffusionConfig,
                     gens: Optional[Sequence[torch.Generator]], batch: int,
                     channels: int, sizes: Tuple[int, int, int],
                     noise: Optional[Triplane] = None, eta: float = 0.0,
                     clip_denoised: bool = True, device="cuda",
                     y0: Optional[Triplane] = None,
                     mask: Optional[Triplane] = None,
                     is_mask_t0: bool = False,
                     cond_fn: Optional[CondFn] = None,
                     noise_view: NoiseView = None) -> Triplane:
    """DDIM sampling over the (respaced) schedule, optionally masked (see
    `ddim_sample_step`) and guided (`cond_fn`, `condition_score`).  With
    eta == 0 the chain depends only on the initial noise and draws
    nothing more.  `noise_view` as in `p_sample_loop`."""
    T = tables["betas"].shape[0]
    x = _init(gens, batch, channels, sizes, noise, device,
              step_noise=eta != 0.0, view=noise_view)
    step = _ddim_stepper(model, tables, cfg, gens, batch, channels, sizes,
                         eta, clip_denoised, device, y0, mask, is_mask_t0,
                         cond_fn, noise_view)
    for t in range(T - 1, -1, -1):
        with profiling.span("chain.step", t=t):
            x = step(x, t)
    return x


def graph_engages(device, use_ddim: bool, eta: float,
                  cond_fn: Optional[CondFn], spatial_group) -> bool:
    """Whether the sampler replays its step as a CUDA graph
    (`StepGraph`): on a CUDA device, unguided (guidance runs autograd),
    on whole planes (the spatial chain's forward holds collectives).
    The chain does not decide it: DDPM, or DDIM at any eta, masked or
    not (`use_ddim` and `eta` pick the graph loop, not whether one
    engages)."""
    return (torch.device(device).type == "cuda" and cond_fn is None
            and spatial_group is None)


_graph_lock = threading.Lock()
_graph_counts = {"captures": 0, "replays": 0}


def _count_graph(kind: str) -> None:
    with _graph_lock:
        _graph_counts[kind] += 1


profiling.counter("chain.graph_captures", lambda: _graph_counts["captures"])
profiling.counter("chain.graph_replays", lambda: _graph_counts["replays"])


@contextlib.contextmanager
def _side_stream(device):
    """The block on a new stream of the card that follows the current
    one, which then waits for it (a graph is captured off the current
    stream); on the CPU (a test's stand-in graph), the block as it is."""
    if device.type != "cuda":
        yield
        return
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield
    main.wait_stream(side)


class StepGraph:
    """One chain step, `step(x, tb)` or, where the step draws noise,
    `step(x, tb, noise)`, captured as a CUDA graph over a static state
    triplane, a static `tb` `[batch]` int64 buffer and the static
    `noise` triplane (which the caller fills before each replay: the
    graph only reads it); the graph ends with its own copy of the new
    state into the static state.

    Construction makes the chain's first step at `t` eagerly (the warm-up
    that capture needs, on a side stream, with `noise` as the caller
    filled it; the state then holds its result) and then the capture, in
    `thread_local` mode, so that other threads' device work neither
    breaks it nor is refused.  K1's and the norm kernel's launches in the
    capture count at each replay (`ops.fused_conv.tallied`,
    `ops.tnorm.tallied`).  `graph`: a stand-in for
    `torch.cuda.CUDAGraph()` (tests)."""

    def __init__(self, step, x: Triplane, t: int,
                 noise: Optional[Triplane] = None, graph=None):
        device = x.xy.device
        self.graph = torch.cuda.CUDAGraph() if graph is None else graph
        self.state = x.map(lambda p: p.clone(
            memory_format=torch.contiguous_format))
        self.tb = torch.full((x.xy.shape[0],), t, dtype=torch.int64,
                             device=device)
        self.noise = noise
        self.inputs = ((self.state, self.tb) if noise is None
                       else (self.state, self.tb, noise))
        with _side_stream(device):
            first = step(*self.inputs)
            with fused_conv.tallied() as self.k1, \
                    tnorm.tallied() as self.tnorm:
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    for s, n in zip(self.state, step(*self.inputs)):
                        s.copy_(n)
                finally:
                    self.graph.capture_end()
            for s, f in zip(self.state, first):
                s.copy_(f)
        _count_graph("captures")

    def load(self, x: Triplane) -> None:
        """Set the state to x (the next chain's x_T)."""
        for s, p in zip(self.state, x):
            s.copy_(p)

    def replay(self, t: int) -> None:
        """One step at t: the state becomes step(state, t[, noise])."""
        self.tb.fill_(t)
        with profiling.span("chain.replay", t=t):
            self.graph.replay()
        fused_conv.count_launches(self.k1)
        tnorm.count_launches(self.tnorm)
        _count_graph("replays")

    def result(self) -> Triplane:
        """A copy of the state: the next chain writes over the state
        while the caller still reads this one."""
        return self.state.map(torch.clone)


def _graph_chain(step, x: Triplane, T: int, graphs: Dict,
                 draw: Optional[Callable[..., Triplane]]) -> Triplane:
    """The chain from x over t = T-1 .. 0, its steps replayed from one
    `StepGraph` a (batch, channels, sizes, dtype, device), kept in
    `graphs` (the caller's, for its lifetime) and made by the first
    chain of its key at that chain's first step.  `draw(out=None)`, where
    the step draws noise: each step's draw, into new planes for the
    capture's first step and into the graph's static noise before each
    replay, so the generators advance as in the eager loop.  One
    `chain.step` span a step."""
    key = (x.xy.shape[0], x.channels, tuple(x.sizes), x.dtype, x.xy.device)
    g = graphs.get(key)
    for t in range(T - 1, -1, -1):
        with profiling.span("chain.step", t=t):
            if g is None:
                g = graphs[key] = StepGraph(
                    step, x, t, None if draw is None else draw())
                continue
            if t == T - 1:
                g.load(x)
            if draw is not None:
                draw(g.noise)
            g.replay(t)
    return g.result()


def p_graph_loop(model: ModelFn, tables, cfg: DiffusionConfig,
                 gens: Optional[Sequence[torch.Generator]], batch: int,
                 channels: int, sizes: Tuple[int, int, int], graphs: Dict,
                 noise: Optional[Triplane] = None,
                 clip_denoised: bool = True, device="cuda") -> Triplane:
    """`p_sample_loop` (where `graph_engages`) on a graph
    (`_graph_chain`): the same draws in the same order, the same steps."""
    T = tables["betas"].shape[0]
    x = _init(gens, batch, channels, sizes, noise, device, step_noise=True)

    def step(x, tb, step_noise):
        return p_sample_step(model, tables, cfg, x, tb, step_noise,
                             clip_denoised=clip_denoised)
    return _graph_chain(step, x, T, graphs, functools.partial(
        randn_per_sample, gens, channels, sizes, device))


def ddim_graph_loop(model: ModelFn, tables, cfg: DiffusionConfig,
                    gens: Optional[Sequence[torch.Generator]], batch: int,
                    channels: int, sizes: Tuple[int, int, int],
                    graphs: Dict, noise: Optional[Triplane] = None,
                    eta: float = 0.0, clip_denoised: bool = True,
                    device="cuda", y0: Optional[Triplane] = None,
                    mask: Optional[Triplane] = None,
                    is_mask_t0: bool = False) -> Triplane:
    """`ddim_sample_loop` (where `graph_engages`) on a graph
    (`_graph_chain`); at eta 0 the step draws nothing and the graph reads
    no noise."""
    T = tables["betas"].shape[0]
    x = _init(gens, batch, channels, sizes, noise, device,
              step_noise=eta != 0.0)

    def step(x, tb, step_noise=None):
        return ddim_sample_step(model, tables, cfg, x, tb, step_noise,
                                eta=eta, clip_denoised=clip_denoised, y0=y0,
                                mask=mask, is_mask_t0=is_mask_t0)
    draw = (None if eta == 0.0 else functools.partial(
        randn_per_sample, gens, channels, sizes, device))
    return _graph_chain(step, x, T, graphs, draw)


def _progressive(step, x: Triplane, T: int,
                 snapshot_every: int) -> Triplane:
    """Run `step` for t = T-1 down to 0, keeping the state after every
    `snapshot_every` steps and after the last: a Triplane of planes
    stacked `[S, B, ...]`, S = ceil(T / snapshot_every).  Only the
    snapshots are kept."""
    k = max(1, min(int(snapshot_every), T))
    snaps = []
    for i, t in enumerate(range(T - 1, -1, -1)):
        x = step(x, t)
        if (i + 1) % k == 0 or i + 1 == T:
            snaps.append(x)
    return Triplane(*[torch.stack(planes, dim=0) for planes in zip(*snaps)])


def p_sample_loop_progressive(model: ModelFn, tables, cfg: DiffusionConfig,
                              gens: Optional[Sequence[torch.Generator]],
                              batch: int, channels: int,
                              sizes: Tuple[int, int, int],
                              noise: Optional[Triplane] = None,
                              clip_denoised: bool = True, device="cuda",
                              snapshot_every: int = 1,
                              cond_fn: Optional[CondFn] = None) -> Triplane:
    """`p_sample_loop` with snapshots (see `_progressive`): the last
    equals `p_sample_loop`'s result bit for bit, given the same
    generators and noise."""
    T = tables["betas"].shape[0]
    x = _init(gens, batch, channels, sizes, noise, device, step_noise=True)
    step = _p_stepper(model, tables, cfg, gens, channels, sizes,
                      clip_denoised, device, cond_fn)
    return _progressive(step, x, T, snapshot_every)


def ddim_sample_loop_progressive(model: ModelFn, tables,
                                 cfg: DiffusionConfig,
                                 gens: Optional[Sequence[torch.Generator]],
                                 batch: int, channels: int,
                                 sizes: Tuple[int, int, int],
                                 noise: Optional[Triplane] = None,
                                 eta: float = 0.0,
                                 clip_denoised: bool = True, device="cuda",
                                 y0: Optional[Triplane] = None,
                                 mask: Optional[Triplane] = None,
                                 is_mask_t0: bool = False,
                                 snapshot_every: int = 1,
                                 cond_fn: Optional[CondFn] = None
                                 ) -> Triplane:
    """`ddim_sample_loop` with snapshots; the same contract as
    `p_sample_loop_progressive`."""
    T = tables["betas"].shape[0]
    x = _init(gens, batch, channels, sizes, noise, device,
              step_noise=eta != 0.0)
    step = _ddim_stepper(model, tables, cfg, gens, batch, channels, sizes,
                         eta, clip_denoised, device, y0, mask, is_mask_t0,
                         cond_fn)
    return _progressive(step, x, T, snapshot_every)


def region_keep_masks(sizes: Tuple[int, int, int],
                      region: Tuple[float, float, float, float, float, float],
                      device="cpu") -> Triplane:
    """Per-plane keep-masks (1 = keep y0, 0 = regenerate) from a
    fractional 3D box `(x0, x1, y0, y1, z0, z1)` in [0, 1] of (H, W, D).

    A plane cell contributes to every point along the plane's missing
    axis, so it is regenerated only where its footprint lies inside the
    box AND the box spans that missing axis completely: with
    `is_mask_t0` the decode outside the box is kept exactly.  Index i of
    an axis of n cells is inside where round(a*n) <= i < round(b*n)
    (Python's round, half to even).  Shapes `[H, W, 1]`, `[H, D, 1]`,
    `[W, D, 1]` fp32, broadcasting over `[B, ., ., C]`."""
    H, W, D = sizes
    x0, x1, y0, y1, z0, z1 = region

    def seg(n, a, b):
        i = np.arange(n)
        return ((i >= int(round(a * n)))
                & (i < int(round(b * n)))).astype(np.float32)

    mx, my, mz = seg(H, x0, x1), seg(W, y0, y1), seg(D, z0, z1)
    fx, fy, fz = (float(m.all()) for m in (mx, my, mz))
    planes = (1.0 - mx[:, None] * my[None, :] * fz,
              1.0 - mx[:, None] * mz[None, :] * fy,
              1.0 - my[:, None] * mz[None, :] * fx)
    return Triplane(*[torch.as_tensor(m, dtype=torch.float32,
                                      device=device)[..., None]
                      for m in planes])


def make_sampler(model: ModelFn, tables, cfg: DiffusionConfig,
                 use_ddim: bool = False, eta: float = 0.0,
                 clip_denoised: bool = True, device="cuda",
                 y0: Optional[Triplane] = None,
                 mask: Optional[Triplane] = None,
                 is_mask_t0: bool = False, spatial_group=None):
    """Return `sample(seed, start, batch, channels, sizes, noise=None)`
    -> Triplane: the reverse chain for global samples start..start+batch-1
    (the port's `make_jit_sampler`).  `y0`/`mask` (DDIM only): masked
    generation, mask = 1 keeps y0.

    `spatial_group` (JAX's `spatial_mesh=`; pair it with a model whose
    `UNetConfig.spatial_group` is the same): the chain runs on this
    rank's rows of each plane (dim 1) and every rank gets the whole
    planes back; `noise`, `y0` and `mask` are whole."""
    if (y0 is not None or mask is not None) and not use_ddim:
        raise ValueError("masked generation (y0/mask) requires use_ddim")
    view = None
    if spatial_group is not None:
        def view(t: Triplane) -> Triplane:
            return t.map(lambda p: shard_plane(spatial_group, p))
        if y0 is not None:
            y0 = view(y0)
        if mask is not None:     # [H, W, 1] planes: no batch dim
            mask = mask.map(lambda p: shard_plane(spatial_group, p, 0))
    if graph_engages(device, use_ddim, eta, None, spatial_group):
        if use_ddim:
            loop = ddim_graph_loop
            kw = {"graphs": {}, "eta": eta, "y0": y0, "mask": mask,
                  "is_mask_t0": is_mask_t0}
        else:
            loop, kw = p_graph_loop, {"graphs": {}}
    elif use_ddim:
        loop = ddim_sample_loop
        kw = {"eta": eta, "y0": y0, "mask": mask, "is_mask_t0": is_mask_t0,
              "noise_view": view}
    else:
        loop, kw = p_sample_loop, {"noise_view": view}

    @torch.no_grad()
    def sample(seed: int, start: int, batch: int, channels: int,
               sizes: Tuple[int, int, int],
               noise: Optional[Triplane] = None) -> Triplane:
        gens = sample_generators(seed, start, batch, device)
        if view is not None and noise is not None:
            noise = view(noise)
        x = loop(model, tables, cfg, gens, batch, channels, sizes,
                 noise=noise, clip_denoised=clip_denoised, device=device,
                 **kw)
        if spatial_group is not None:
            x = x.map(lambda p: gather_plane(spatial_group, p))
        return x

    return sample
