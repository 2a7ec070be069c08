"""Device idle inside the diffusion train step's `train.draw` phase
(`draw_step_inputs`: the step's timesteps and noise): the share of the
traced window in which no operation ran on the device while the main
thread was inside a `train.draw` span, in percent. The program's spans
on the trace (perfbench/spans.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_share(ctx, "train.draw", spans.DIFF)
