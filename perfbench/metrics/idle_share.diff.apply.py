"""Device idle inside the diffusion train step's `train.apply` phase
(`apply_grads`: AdamW, the NaN guard and the EMA): the share of the
traced window in which no operation ran on the device while the main
thread was inside a `train.apply` span, in percent. The program's spans
on the trace (perfbench/spans.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_share(ctx, "train.apply", spans.DIFF)
