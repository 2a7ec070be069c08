"""Device idle inside the diffusion train step's `train.grads` phase
(`compute_grads`: the forward's and backward's launches): the share of
the traced window in which no operation ran on the device while the main
thread was inside a `train.grads` span, in percent. The program's spans
on the trace (perfbench/spans.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_share(ctx, "train.grads", spans.DIFF)
