"""K1's share of its roofline: the least time of the window's K1
launches (each UNet forward's 8 triplane 3x3 convs at the launch's
shapes, counted in counts/kernels.py, at the bf16 peak) over the K1
kernels' device time in the trace.  The launches are the program's
counter; the device time is the trace's `conv3x3` kernels."""

from perfbench.counts import kernels, peaks


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or not w.get("k1_launches") or any(
            k not in w for k in ("plane_sizes", "batch")):
        return None
    t = tr.kernel_seconds("conv3x3")
    if t <= 0:
        return None
    f, b, per = kernels.k1_forward(ctx.config["unet"], w["plane_sizes"],
                                   w["batch"])
    n = w["k1_launches"] / per
    ms, _ = peaks.bound_ms(f * n, b * n, "bf16")
    return 100.0 * ms / 1e3 / t
