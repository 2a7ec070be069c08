"""The diffusion train step's share of the card's TF32 peak: three UNet
forwards a step at the batch (counts/model.py) x the traced window's
steps, over its seconds and the TF32 peak (495 TFLOP/s, at the 700 W
limit)."""

from perfbench.counts import model, peaks


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or tr.window_s <= 0 or not w.get("steps") or any(
            k not in w for k in ("plane_sizes", "batch")):
        return None
    flops = w["steps"] * model.unet_train_step(ctx.config["unet"],
                                               w["plane_sizes"], w["batch"])
    return 100.0 * flops / tr.window_s / peaks.PEAK_FLOPS["tf32"]
