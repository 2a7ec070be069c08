"""The whole generation's share of the card's bf16 peak: the model's
operations in the traced window (UNet forwards x chain steps x samples,
the geometry head over every voxel centre of each sample's grid, the
texture head over every texel baked; counts/model.py) over the window's
seconds and the bf16 peak (989 TFLOP/s, at the 700 W limit)."""

from perfbench.counts import model, peaks


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or tr.window_s <= 0 or not w.get("samples") or any(
            k not in w for k in ("plane_sizes", "chain_steps",
                                 "grid_points", "texels")):
        return None
    ae = ctx.config["ae"]
    sizes = w["plane_sizes"]
    flops = (w["samples"] * w["chain_steps"]
             * model.unet_forward(ctx.config["unet"], sizes, 1)
             + w["samples"] * w["grid_points"]
             * model.skip_head(ae["fdim_up"], 1, ae["hidden_dim"],
                               ae["n_hidden_layers"])
             + w["texels"] * model.skip_head(ae["fdim_up"], 3,
                                             ae["hidden_dim"],
                                             ae["n_hidden_layers"]))
    return 100.0 * flops / tr.window_s / peaks.PEAK_FLOPS["bf16"]
