"""Operations and bytes of the port's hand-written kernels, each input
byte read once and each output byte written once.

K1, the rollout 3x3 conv (`ops/fused_conv.py`): one launch convolves a
triplane's three planes in bf16, adding the col- and row-varying
vectors of the other planes' means (fp32 out of the products, bf16
stored).  K2, the skip-MLP head (`ops/fused_mlp.py`): fp32 rows in,
bf16 weights, fp32 out.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from .model import block_widths, plane_sizes


def k1_launch(B: int, planes: Iterable[Tuple[int, int]], C: int, Co: int,
              form: str = "default") -> Tuple[float, float]:
    """(operations, bytes) of one triplane launch."""
    flops = nbytes = 0.0
    for H, W in planes:
        flops += 2.0 * B * H * W * 9 * C * Co
        nbytes += (2.0 * (B * H * W * C + 9 * C * Co + B * W * 3 * Co
                          + B * H * 3 * Co + B * H * W * Co) + 4.0 * Co
                   + (4.0 * 2 * B * C if "act" in form else 0.0)
                   + (2.0 * B * H * W * Co if "skip" in form else 0.0)
                   + (4.0 * B * 2 * Co if "stats" in form else 0.0))
    return flops, nbytes


def k1_forward(unet: dict, sizes, B: int) -> Tuple[float, float, int]:
    """(operations, bytes, launches) of one UNet forward's K1 launches in
    the default configuration: the in and out 3x3 convs of every block."""
    flops = nbytes = 0.0
    n = 0
    for lv, cin, cout in block_widths(unet):
        planes = plane_sizes(sizes, lv)
        for c in (cin, cout):
            f, b = k1_launch(B, planes, c, cout)
            flops, nbytes, n = flops + f, nbytes + b, n + 1
    return flops, nbytes, n


def k2_layers(cin: int, cout: int, hidden: int, n_hidden: int):
    """(in, out) of every linear of a skip head."""
    first = [cin] + [hidden] * (1 + n_hidden // 2)
    second = [cin + hidden] + [hidden] * (n_hidden // 2) + [cout]
    return ([(a, b) for a, b in zip(first, first[1:])]
            + [(a, b) for a, b in zip(second, second[1:])])


def k2_launch(rows: int, cin: int, cout: int, hidden: int,
              n_hidden: int) -> Tuple[float, float]:
    """(operations, bytes) of one launch over `rows` rows."""
    layers = k2_layers(cin, cout, hidden, n_hidden)
    flops = 2.0 * rows * sum(a * b for a, b in layers)
    nbytes = (4.0 * rows * (cin + cout)
              + sum(2.0 * a * b + 4.0 * b for a, b in layers))
    return flops, nbytes
