"""The triplane norm kernel's share of its roofline: the least time of
the window's norm launches (each chain step's UNet forward makes 9, at
the window's batch; counts/tnorm.py, bytes at 3.35 TB/s) over the
`sin3dm_tnorm` kernels' device time in the trace.  The launches are
counted from the window's samples, chain steps, batch and plane sizes;
nothing is read where the trace holds no such kernel."""

from perfbench.counts import peaks, tnorm


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or not w.get("samples") or not w.get("batch") or any(
            k not in w for k in ("plane_sizes", "chain_steps")):
        return None
    t = tr.kernel_seconds("sin3dm_tnorm")
    if t <= 0:
        return None
    nbytes, _ = tnorm.tnorm_forward(ctx.config["unet"], w["plane_sizes"],
                                    w["batch"])
    forwards = w["samples"] * w["chain_steps"] / w["batch"]
    ms, _ = peaks.bound_ms(0.0, nbytes * forwards, "bf16")
    return 100.0 * ms / 1e3 / t
