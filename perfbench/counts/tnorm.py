"""Bytes of the sampler's triplane norm (`ops/tnorm.py:tnorm_silu`, the
kernel `sin3dm_tnorm_kernel`), each input byte read once and each output
byte written once: the function's bytes, not the kernel's (which reads
each plane three times, the later two from L2, and writes each mean into
three taps of the stacked layout).  bf16 planes in and out, fp32 gamma,
beta and (A, B), the bf16 FiLM, the six bf16 axis means.  Its operations
(~12 a value, fp32, off the tensor cores) stay below the bytes' time at
the fp32 rate, so the bound is the bytes'."""

from __future__ import annotations

from typing import Iterable, Tuple

from .model import block_widths, plane_sizes


def tnorm_launch(B: int, planes: Iterable[Tuple[int, int]], C: int,
                 film: bool, means: bool) -> float:
    """Bytes of one launch over a triplane's planes [(R, S)] at batch B
    and C channels."""
    planes = list(planes)
    nbytes = (2.0 * 2 * B * C * sum(R * S for R, S in planes)   # x, y
              + 3 * 2 * 4.0 * C                                   # gamma, beta
              + 3 * 2 * 4.0 * B * C)                              # A, B
    if film:
        nbytes += 2.0 * B * 2 * C
    if means:
        nbytes += 2.0 * B * C * sum(R + S for R, S in planes)
    return nbytes


def tnorm_forward(unet: dict, sizes, B: int) -> Tuple[float, int]:
    """(bytes, launches) of one UNet forward's norms: each block's in norm
    (its input width) and out norm (its output width, with the FiLM where
    `use_scale_shift_norm`), both with the axis means a rollout conv
    reads (`unet_small`), then the final norm at level 0, without."""
    film = bool(unet.get("use_scale_shift_norm", True))
    means = unet.get("diff_net_type", "unet_small") != "unet_raw"
    nbytes, n = 0.0, 0
    for lv, cin, cout in block_widths(unet):
        planes = plane_sizes(sizes, lv)
        nbytes += tnorm_launch(B, planes, cin, False, means)
        nbytes += tnorm_launch(B, planes, cout, film, means)
        n += 2
    mult = [int(m) for m in str(unet["channel_mult"]).split(",")]
    nbytes += tnorm_launch(B, plane_sizes(sizes, 0),
                           mult[0] * unet["model_channels"], False, False)
    return nbytes, n + 1
