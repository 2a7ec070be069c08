"""Device milliseconds a diffusion train step: the union of the device's
operation intervals in the traced window over its steps."""


def read(ctx):
    tr, n = ctx.trace, ctx.window.get("steps", 0)
    return 1e3 * tr.busy_s / n if tr is not None and n else None
