"""Fused 3x3 rollout conv — the sampling chain's hot op (kernel K1, and
its act/skip/emit_stats forms K1′).

Counterpart of `sin3dm_tpu/ops/fused_conv.py:conv3x3_rollout_fused`, all
forms.  For a channels-last plane

    y = conv3x3_SAME(act(x)) + b + colvar + rowvar [+ skip]

with fp32 accumulation and one rounding to x's dtype.  `col3` is
`[B, W, 3, Co]` holding (s_top, s_full, s_bot) along dim 2: row 0 takes
s_top, row H-1 s_bot, the rest s_full.  `row3` is `[B, H, 3, Co]` holding
(r_left, r_full, r_right) for column 0, the interior and column W-1.  Top
and left win ties.  Both None: a plain 3x3 conv plus bias.

- `act=(A, B)`, each `[B, C]` fp32 (a folded GroupNorm32 [+ FiLM]): the
  input is `silu(float(x)*A + B)` in fp32, rounded to x's dtype, before
  the conv; the zero halo stays zero (it is padded after the activation).
- `skip` `[B, H, W, Co]`: cast to x's dtype and added in fp32 before the
  one rounding.
- `emit_stats`: also return `[B, 2, Co]` fp32 (sum, sum of squares) over
  H x W of the ROUNDED y, as the Pallas body reduces the written tile.

On a CUDA tensor `conv3x3_rollout` launches the hand-written kernel in
`csrc/fused_conv.cu` (bf16: each 2-D pixel tile's input staged once in
shared memory, activated there once, mma.sync on the tensor cores; fp32:
fp32 FMAs) and raises if it cannot; on a CPU tensor it computes the plain
version `conv3x3_rollout_reference`.  `conv3x3_rollout_triplane` takes a
triplane conv's three planes (each its own sizes and weights) in one
bf16 launch.  Unlike the TPU kernel both take C = 192 in one call, in
every form (the JAX package splits C > 128 into partial convs, rounds
each to bf16 before summing, and cannot emit stats there).  The bf16
kernel reads its weights in the layout of `pack_conv_weights`: callers
pass them packed once (`packed=`; `ops.pack_params` packs a parameter
tree where the model is built), else the wrapper packs them per call.
Each launch runs with the input's card as the current device, so the
kernel's attributes, the launch and the stream are that card's whatever
the caller's current device is.

`conv3x3_rollout.launches` counts every kernel launch of either wrapper
and `conv3x3_rollout.form_launches` counts them by form (`form_name`),
under one lock: launches from concurrent threads each count once.  A
launch captured into a CUDA graph counts at each replay of the graph
(`tallied`, `count_launches`), when the card runs it.
`core.profiling.counters()` reads them as "k1.launches" and "k1.forms".
"""

from __future__ import annotations

import contextlib
import ctypes
import struct
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core import profiling
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Act = Optional[Tuple[torch.Tensor, torch.Tensor]]


def form_name(act: bool, skip: bool, emit_stats: bool) -> str:
    """"default", or the '+'-joined epilogue features, e.g.
    "act+skip+stats"."""
    parts = [n for n, on in (("act", act), ("skip", skip),
                             ("stats", emit_stats)) if on]
    return "+".join(parts) or "default"


def _border_class(n: int, device) -> torch.Tensor:
    """0 at index 0, 2 at index n-1, 1 elsewhere (index 0 wins ties)."""
    cls = torch.ones(n, dtype=torch.int64, device=device)
    cls[-1] = 2
    cls[0] = 0
    return cls


def _stats(y: torch.Tensor) -> torch.Tensor:
    """(sum, sum of squares) over H x W of `[B, H, W, Co]`, fp32
    `[B, 2, Co]`."""
    yf = y.float()
    return torch.stack([yf.sum(dim=(1, 2)), (yf * yf).sum(dim=(1, 2))],
                       dim=1)


def conv3x3_rollout_reference(x: torch.Tensor, w: torch.Tensor,
                              b: Optional[torch.Tensor] = None,
                              col3: Optional[torch.Tensor] = None,
                              row3: Optional[torch.Tensor] = None,
                              act: Act = None,
                              skip: Optional[torch.Tensor] = None,
                              emit_stats: bool = False):
    """Plain PyTorch version of K1/K1′: upcast to fp32 (w, the activated
    input and skip rounded to x's dtype first, as the kernel sees them),
    F.conv2d, epilogue, one rounding; stats from the rounded output.
    Callers on the card turn TF32 off for it to be an fp32 reference."""
    dt = x.dtype
    B, H, W, C = x.shape
    xin = x.float()
    if act is not None:
        a = xin * act[0].float().reshape(B, 1, 1, C) \
            + act[1].float().reshape(B, 1, 1, C)
        xin = (a * torch.sigmoid(a)).to(dt).float()
    y = F.conv2d(xin.permute(0, 3, 1, 2),
                 w.to(dt).float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    if col3 is not None:
        colvar = col3.float()[:, :, _border_class(H, x.device)]  # [B,W,H,Co]
        y = y + colvar.permute(0, 2, 1, 3)
        y = y + row3.float()[:, :, _border_class(W, x.device)]   # [B,H,W,Co]
    if skip is not None:
        y = y + skip.to(dt).float()
    y = y.to(dt)
    return (y, _stats(y)) if emit_stats else y


KCH = 64   # input channels per staged chunk of the bf16 kernel


def block_n(Co: int) -> int:
    """Output channels per block of the bf16 kernel: 64 for Co <= 64, else
    128 (its blocks then take 8 x 8 pixels instead of 8 x 16)."""
    return 64 if Co <= 64 else 128


def pack_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's weight layout, a plain torch function (any
    device): w `[3, 3, C, Co]` -> bf16 `[ceil(C/64), 9, Co_pad, 64]` with
    element (cc, 3 i + j, n, k) = w[i, j, 64 cc + k, n], zero-padded in C
    and in Co up to a multiple of `block_n(Co)`: each tap's [Co_pad x 64]
    block is K-major, as the kernel's mma B operand reads it."""
    C, Co = w.shape[2], w.shape[3]
    n_cc = -(-C // KCH)
    co_pad = -(-Co // block_n(Co)) * block_n(Co)
    out = w.new_zeros((9, co_pad, n_cc * KCH), dtype=torch.bfloat16)
    out[:, :Co, :C] = w.to(torch.bfloat16).reshape(9, C, Co).transpose(1, 2)
    return out.reshape(9, co_pad, n_cc, KCH).permute(2, 0, 1, 3).contiguous()


def rollout_taps(kb: torch.Tensor, rows: bool):
    """The three 3-tap kernels `[3, C, Co]` of one broadcast block kb
    `[3, 3, C, Co]` of a rollout conv's weight: for an image constant
    along rows (a col-varying block, col3's (s_top, s_full, s_bot)) the
    sums of kb's rows 1-2, 0-2 and 0-1; along columns (row3's (r_left,
    r_full, r_right), `rows`) the same over its columns."""
    if rows:
        return kb[:, 1:].sum(1), kb.sum(1), kb[:, :2].sum(1)
    return kb[1:].sum(0), kb.sum(0), kb[:2].sum(0)


def pack_taps(k3s, dtype) -> torch.Tensor:
    """Three 3-tap kernels each `[3, C, Co]` in `dtype`, stacked `[3, C, 3,
    Co]`: the weight of one product of `stack3`'s `[., 3C]` lines
    (`models/unet.py:_conv1d3_packed`)."""
    return torch.stack([k.to(dtype) for k in k3s], dim=2)


def pack_rollout_taps(w: torch.Tensor, col_first: bool) -> torch.Tensor:
    """A rollout 3x3 conv's col3 and row3 kernels, bf16 `[2, 3, C, 3, Co]`
    (col, then row), from its weight w `[3, 3, 3C, Co]` whose input blocks
    are (own, col-varying, row-varying) where `col_first`, else (own,
    row-varying, col-varying): the weights' part of the rollout products,
    packed once (`ops.pack_params`)."""
    C = w.shape[2] // 3
    cs, rs = (C, 2 * C) if col_first else (2 * C, C)
    return torch.stack([
        pack_taps(rollout_taps(w[:, :, cs:cs + C], False), torch.bfloat16),
        pack_taps(rollout_taps(w[:, :, rs:rs + C], True), torch.bfloat16)])


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"conv3x3_rollout: {name} must be a contiguous "
                         f"{dtype} tensor of shape {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _refuse_grad(*args) -> None:
    """K1 has no backward: raise where autograd would record the call (a
    tensor that requires grad, outside `torch.no_grad`).  The UNet's
    training forward (`models.unet.unet_train_apply`) never comes here."""
    if not torch.is_grad_enabled():
        return
    stack = list(args)
    while stack:
        a = stack.pop()
        if isinstance(a, (list, tuple)):
            stack.extend(a)
        elif isinstance(a, torch.Tensor) and a.requires_grad:
            raise RuntimeError(
                "conv3x3_rollout: K1 has no backward; call it under "
                "torch.no_grad (train through models.unet.unet_train_apply)")


def conv3x3_rollout(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None,
                    col3: Optional[torch.Tensor] = None,
                    row3: Optional[torch.Tensor] = None,
                    act: Act = None,
                    skip: Optional[torch.Tensor] = None,
                    emit_stats: bool = False,
                    packed: Optional[torch.Tensor] = None):
    """K1/K1′.  x `[B, H, W, C]` bf16 or fp32; w `[3, 3, C, Co]` (cast to
    x's dtype); b `[Co]` (fp32) or None; col3/row3 as in the module doc,
    in x's dtype; act (A, B) each `[B, C]` (fp32); skip `[B, H, W, Co]`
    (cast to x's dtype); packed None or `pack_conv_weights(wf)`, where w is
    wf or its first C input channels `wf[:, :, :C]` (the bf16 kernel's
    weights; the CPU and fp32 ignore it).  Returns `[B, H, W, Co]` in x's
    dtype, and with `emit_stats` also its `[B, 2, Co]` fp32 (sum, sum of
    squares).  Raises where autograd would record the call."""
    _refuse_grad(x, w, b, col3, row3, act, skip, packed)
    if (col3 is None) != (row3 is None):
        raise ValueError("conv3x3_rollout: pass both col3 and row3 or "
                         "neither")
    if x.device.type == "cpu":
        return conv3x3_rollout_reference(x, w, b, col3, row3, act, skip,
                                         emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_rollout: unsupported device {x.device}")
    if x.dtype == torch.bfloat16:
        ys, stats = _launch_bf16([x], [w], [b], [col3], [row3], [act],
                                 [skip], emit_stats, [packed])
        return (ys[0], stats[0]) if emit_stats else ys[0]
    return _launch_f32(x, w, b, col3, row3, act, skip, emit_stats)


def _as(t: torch.Tensor, dtype, shape=None) -> torch.Tensor:
    """t in `dtype`, of `shape` where given, contiguous: converted only
    where it is not already (each conversion costs host time per call)."""
    if t.dtype != dtype:
        t = t.to(dtype)
    if shape is not None and t.shape != shape:
        t = t.reshape(shape)
    return t if t.is_contiguous() else t.contiguous()


def _operands(x, w, b, col3, row3, act, skip):
    """Checked, contiguous operands of one plane, in the kernels' types
    (w left as given); raises on what the kernels do not take."""
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError("conv3x3_rollout: x must be a 4-D bf16 or fp32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if (col3 is None) != (row3 is None):
        raise ValueError("conv3x3_rollout: pass both col3 and row3 or "
                         "neither")
    B, H, W, C = x.shape
    Co = w.shape[-1]
    dev = x.device
    if B * H * W == 0 or Co == 0:
        raise ValueError("conv3x3_rollout: empty input")
    _check("x", x, (B, H, W, C), x.dtype, dev)
    if tuple(w.shape) != (3, 3, C, Co) or w.device != dev:
        raise ValueError(f"conv3x3_rollout: w must be a (3, 3, {C}, Co) "
                         f"tensor on {dev}, got {tuple(w.shape)} on "
                         f"{w.device}")
    if b is not None:
        b = _as(b, torch.float32)
        _check("b", b, (Co,), torch.float32, dev)
    if col3 is not None:
        _check("col3", col3, (B, W, 3, Co), x.dtype, dev)
        _check("row3", row3, (B, H, 3, Co), x.dtype, dev)
    act_a = act_b = None
    if act is not None:
        act_a, act_b = (_as(a, torch.float32, (B, C)) for a in act)
        _check("act[0]", act_a, (B, C), torch.float32, dev)
        _check("act[1]", act_b, (B, C), torch.float32, dev)
    if skip is not None:
        skip = _as(skip, x.dtype)
        _check("skip", skip, (B, H, W, Co), x.dtype, dev)
    return b, act_a, act_b, skip


# concurrent requests launch from several threads: one lock keeps each
# count's read-modify-write whole
_count_lock = threading.Lock()
_local = threading.local()   # .tally: this thread's capture's launches


def _count(act, skip, emit_stats) -> None:
    form = form_name(act is not None, skip is not None, emit_stats)
    tally = getattr(_local, "tally", None)
    if tally is None:
        count_launches({form: 1})
    else:
        tally[form] = tally.get(form, 0) + 1


@contextlib.contextmanager
def tallied():
    """For the block, in this thread, the launches are being captured
    into a CUDA graph: they run nothing, so they are not counted but
    tallied by form into the dict this yields, which `count_launches`
    counts at each replay.  Other threads count as before."""
    tally = {}
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = None


def count_launches(forms) -> None:
    """Count launches that the card runs, {form: n}: one launch, or one
    replay of a graph whose capture `tallied()` tallied."""
    with _count_lock:
        for form, n in forms.items():
            conv3x3_rollout.launches += n
            conv3x3_rollout.form_launches[form] = \
                conv3x3_rollout.form_launches.get(form, 0) + n


def _launch_f32(x, w, b, col3, row3, act, skip, emit_stats):
    B, H, W, C = x.shape
    Co = w.shape[-1]
    b, act_a, act_b, skip = _operands(x, w, b, col3, row3, act, skip)
    w = w.float().contiguous()
    lib = _build.load("fused_conv")
    y = torch.empty((B, H, W, Co), dtype=x.dtype, device=x.device)
    partial = None
    if emit_stats:
        # one (sum, sum of squares) row per block of rows of each plane,
        # summed below in a fixed order: no atomics, the same every run
        rows = lib.sin3dm_conv3x3_rows_per_block
        rows.argtypes, rows.restype = [], ctypes.c_int
        partial = torch.empty((B, -(-H * W // rows()), 2, Co),
                              dtype=torch.float32, device=x.device)
    fn = lib.sin3dm_conv3x3_rollout
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(w), _ptr(b), _ptr(col3), _ptr(row3),
                 _ptr(act_a), _ptr(act_b), _ptr(skip), _ptr(y),
                 _ptr(partial), B, H, W, C, Co, ctypes.c_void_p(
                     torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"conv3x3_rollout: CUDA error {err} at launch")
    _count(act, skip, emit_stats)
    return (y, partial.sum(dim=1)) if emit_stats else y


def _bf16_lib():
    """The library with the bf16 entry points' ctypes signatures set."""
    lib = _build.load("fused_conv")
    if not getattr(lib, "sin3dm_bf16_bound", False):
        fn = lib.sin3dm_conv3x3_bf16_tiles
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
        fn = lib.sin3dm_conv3x3_bf16
        fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p] \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        lib.sin3dm_bf16_bound = True
    return lib


def _addr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _weights_bf16(w: torch.Tensor, packed: Optional[torch.Tensor], C: int,
                  Co: int) -> torch.Tensor:
    """One plane's weights in the bf16 kernel's layout: `packed`, checked
    against that layout, or w packed now.  `packed` may hold more input
    channels than w: the kernel reads the first ceil(C / 64) chunks and
    multiplies the staged zeros past C by the rest of a partial chunk."""
    if packed is None:
        return pack_conv_weights(w)
    co_pad = -(-Co // block_n(Co)) * block_n(Co)
    if packed.dtype != torch.bfloat16 or packed.dim() != 4 \
            or packed.shape[0] < -(-C // KCH) \
            or tuple(packed.shape[1:]) != (9, co_pad, KCH) \
            or packed.device != w.device or not packed.is_contiguous():
        raise ValueError("conv3x3_rollout: packed must be "
                         f"pack_conv_weights of [3, 3, >= {C}, {Co}] "
                         f"weights on {w.device}, got {packed.dtype} "
                         f"{tuple(packed.shape)} on {packed.device}")
    return packed


_tiles = {}        # (plane sizes, Co) -> the bf16 kernel's tiles per plane


def _launch_bf16(xs, ws, bs, col3s, row3s, acts, skips, emit_stats,
                 packed):
    """One bf16 launch over the planes; returns ([y], [stats or None])."""
    x0 = xs[0]
    B, C, Co, dev = x0.shape[0], x0.shape[3], ws[0].shape[-1], x0.device
    n = len(xs)
    lib = _bf16_lib()
    sizes = tuple((x.shape[1], x.shape[2]) for x in xs)
    planes, ys = [], []
    for i in range(n):
        x, w = xs[i], ws[i]
        if x.dtype != torch.bfloat16 or x.dim() != 4 \
                or (x.shape[0], x.shape[3], w.shape[-1]) != (B, C, Co) \
                or x.device != dev:
            raise ValueError("conv3x3_rollout_triplane: every plane must be "
                             "a bf16 [B, H, W, C] tensor of one batch, "
                             "channel count, output width and device")
        b, act_a, act_b, skip = _operands(x, w, bs[i], col3s[i], row3s[i],
                                          acts[i], skips[i])
        y = torch.empty((B,) + sizes[i] + (Co,), dtype=torch.bfloat16,
                        device=dev)
        planes.append([x, _weights_bf16(w, packed[i], C, Co), b, col3s[i],
                       row3s[i], act_a, act_b, skip, y])
        ys.append(y)
    ptrs = [[_addr(t) for t in p] for p in planes]
    cnt, stats = 0, [None] * n
    if emit_stats:
        tiles = _tiles.get((sizes, Co))
        if tiles is None:
            tiles = [lib.sin3dm_conv3x3_bf16_tiles(H, W, Co) for H, W in sizes]
            _tiles[(sizes, Co)] = tiles
        co_pad = -(-Co // block_n(Co)) * block_n(Co)
        n_part = B * sum(tiles) * 2 * co_pad
        # this launch's own scratch: each plane's per-tile partials [B,
        # tiles, 2, co_pad], the stats [n, B, 2, Co], then the int32
        # counters [n, B, co_pad / block_n] the entry point zeroes
        buf = torch.empty(n_part + n * B * (2 * Co + co_pad // block_n(Co)),
                          dtype=torch.float32, device=dev)
        part_at = buf.data_ptr()
        stats_at = part_at + 4 * n_part
        cnt = stats_at + 4 * n * B * 2 * Co
        off = 0
        for i in range(n):
            ptrs[i] += [stats_at + 4 * i * B * 2 * Co, part_at + 4 * off]
            off += B * tiles[i] * 2 * co_pad
        stats = list(buf[n_part:n_part + n * B * 2 * Co]
                     .view(n, B, 2, Co).unbind(0))
    else:
        for p in ptrs:
            p += [0, 0]
    flat = [a for p in ptrs for a in p]
    table = struct.pack(f"{len(flat)}Q", *flat)
    hw = struct.pack(f"{2 * n}i", *[v for hw_ in sizes for v in hw_])
    with torch.cuda.device(dev):
        err = lib.sin3dm_conv3x3_bf16(
            table, hw, n, B, C, Co, ctypes.c_void_p(cnt),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"conv3x3_rollout: CUDA error {err} at launch")
    _count(acts[0], skips[0], emit_stats)
    return ys, stats


def conv3x3_rollout_triplane(xs: Sequence[torch.Tensor],
                             ws: Sequence[torch.Tensor],
                             bs: Sequence[Optional[torch.Tensor]],
                             col3s: Sequence[Optional[torch.Tensor]],
                             row3s: Sequence[Optional[torch.Tensor]],
                             acts: Sequence[Act] = (None, None, None),
                             skips: Sequence[Optional[torch.Tensor]] =
                             (None, None, None),
                             emit_stats: bool = False,
                             packed: Optional[Sequence[
                                 Optional[torch.Tensor]]] = None):
    """K1/K1′ over a triplane conv's three planes: plane i is
    `conv3x3_rollout(xs[i], ws[i], bs[i], col3s[i], row3s[i], acts[i],
    skips[i], emit_stats, packed[i])` (packed None: none is packed).  The
    planes share B, C and Co (not H, W or the weights); every plane has
    act (skip) or none does.  bf16 on the card:
    ONE launch, whose outputs equal the three single-plane launches' bit
    for bit.  fp32 on the card: three launches.  CPU: the plain version.
    Returns the list of outputs, with `emit_stats` also the list of
    `[B, 2, Co]` stats.  Raises where autograd would record the call."""
    _refuse_grad(xs, ws, bs, col3s, row3s, acts, skips, packed)
    if not len(xs) == len(ws) == len(bs) == len(col3s) == len(row3s) \
            == len(acts) == len(skips) or not 1 <= len(xs) <= 3:
        raise ValueError("conv3x3_rollout_triplane: 1 to 3 planes, one "
                         "entry per plane in every argument")
    if len({a is None for a in acts}) > 1 \
            or len({s is None for s in skips}) > 1:
        raise ValueError("conv3x3_rollout_triplane: act and skip are given "
                         "for every plane or for none")
    packed = [None] * len(xs) if packed is None else list(packed)
    if len(packed) != len(xs):
        raise ValueError("conv3x3_rollout_triplane: one packed entry per "
                         "plane")
    args = list(zip(xs, ws, bs, col3s, row3s, acts, skips))
    if xs[0].device.type == "cuda" and xs[0].dtype == torch.bfloat16:
        ys, stats = _launch_bf16(xs, ws, bs, col3s, row3s, acts, skips,
                                 emit_stats, packed)
        return (ys, stats) if emit_stats else ys
    outs = [conv3x3_rollout(*a, emit_stats=emit_stats) for a in args]
    if emit_stats:
        return [o[0] for o in outs], [o[1] for o in outs]
    return outs


conv3x3_rollout.launches = 0
conv3x3_rollout.form_launches = {}
profiling.counter("k1.launches", lambda: conv3x3_rollout.launches)
profiling.counter("k1.forms", lambda: dict(conv3x3_rollout.form_launches))
