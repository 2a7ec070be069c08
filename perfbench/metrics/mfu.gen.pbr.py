"""The whole PBR generation's share of the card's bf16 peak: the model's
operations in the traced window (UNet forwards x chain steps x samples,
the geometry head over every voxel centre of each sample's grid, and
the PBR net's three texture heads, of 3, 2 and 3 outputs, over every
texel baked; counts/model.py) over the window's seconds and the bf16
peak (989 TFLOP/s, at the 700 W limit)."""

from perfbench.counts import model, peaks

HEADS = (3, 2, 3)


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or tr.window_s <= 0 or not w.get("samples") or any(
            k not in w for k in ("plane_sizes", "chain_steps",
                                 "grid_points", "texels")):
        return None
    ae = ctx.config["ae"]

    def head(cout):
        return model.skip_head(ae["fdim_up"], cout, ae["hidden_dim"],
                               ae["n_hidden_layers"])
    flops = (w["samples"] * w["chain_steps"]
             * model.unet_forward(ctx.config["unet"], w["plane_sizes"], 1)
             + w["samples"] * w["grid_points"] * head(1)
             + w["texels"] * sum(head(c) for c in HEADS))
    return 100.0 * flops / tr.window_s / peaks.PEAK_FLOPS["bf16"]
