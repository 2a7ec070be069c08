"""K2's share of its roofline: the least time of the window's K2
launches (each launch's rows, input and output widths from the
program's per-shape counter, the head's hidden widths from the
configuration; counts/kernels.py at the bf16 peak) over the K2 kernels'
device time in the trace (`mlp_bf16`, `mlp_f32`)."""

from perfbench.counts import kernels, peaks


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or not w.get("k2_shapes"):
        return None
    t = tr.kernel_seconds("mlp_bf16", "mlp_f32")
    if t <= 0:
        return None
    ae = ctx.config["ae"]
    f = b = 0.0
    for (rows, cin, cout), n in w["k2_shapes"].items():
        ff, bb = kernels.k2_launch(rows, cin, cout, ae["hidden_dim"],
                                   ae["n_hidden_layers"])
        f, b = f + n * ff, b + n * bb
    ms, _ = peaks.bound_ms(f, b, "bf16")
    return 100.0 * ms / 1e3 / t
