"""The model's operations per unit of work, counted from shapes: the
same whatever implements the work.  Convolutions and linears only;
norms, gathers and elementwise work are left out.

UNet (`unet` config keys model_channels, channel_mult, num_res_blocks,
in_channels, out_channels): a rollout 3x3 conv of C -> Co channels
costs its own-channel conv over the plane plus, per plane, two 3-tap
products of the other planes' mean vectors (3C -> 3Co over each of the
plane's H + W lines).  A train step is three forwards (the backward's
input and weight gradients each cost one).

Decode heads (`ae` config keys hidden_dim, n_hidden_layers): a row
through a skip head.
"""

from __future__ import annotations

from typing import List, Tuple


def plane_sizes(sizes, level: int) -> List[Tuple[int, int]]:
    H, W, D = (s >> level for s in sizes)
    return [(H, W), (H, D), (W, D)]


def block_widths(unet: dict) -> List[Tuple[int, int, int]]:
    """(level, in width, out width) of every resblock in forward order."""
    mc = unet["model_channels"]
    mult = [int(m) for m in str(unet["channel_mult"]).split(",")]
    n = unet["num_res_blocks"]
    ch = mult[0] * mc
    chans, out = [ch], []
    for lv, m in enumerate(mult):
        for _ in range(n):
            out.append((lv, ch, m * mc))
            ch = m * mc
        chans.append(ch)
    last = len(mult) - 1
    for lv in range(last, -1, -1):
        ich_level = chans.pop()
        for i in range(n):
            ich = ich_level if i == 0 and lv != last else 0
            out.append((lv, ch + ich, mult[lv] * mc))
            ch = mult[lv] * mc
    return out


def unet_forward(unet: dict, sizes, B: int) -> float:
    mc = unet["model_channels"]
    px0 = sum(h * w for h, w in plane_sizes(sizes, 0))
    flops = 2.0 * B * px0 * (unet["in_channels"] * mc
                             + mc * unet["out_channels"])
    for lv, cin, cout in block_widths(unet):
        px = sum(h * w for h, w in plane_sizes(sizes, lv))
        lines = 2 * sum(s >> lv for s in sizes)
        for c in (cin, cout):
            flops += 2.0 * B * px * 9 * c * cout
            flops += 2.0 * B * lines * 3 * c * 3 * cout
        if cin != cout:
            flops += 2.0 * B * px * cin * cout
    return flops


def unet_train_step(unet: dict, sizes, B: int) -> float:
    return 3.0 * unet_forward(unet, sizes, B)


def skip_head(cin: int, cout: int, hidden: int, n_hidden: int) -> float:
    """Operations of one row through a skip head."""
    from .kernels import k2_layers
    return 2.0 * sum(a * b for a, b in k2_layers(cin, cout, hidden,
                                                 n_hidden))

