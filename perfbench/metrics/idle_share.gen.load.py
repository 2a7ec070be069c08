"""Device idle inside the models' load: the share of the traced window in
which no operation ran on the device while the main thread was inside
`gen.load` (the sampler's and the decoder's models read, moved and
packed, on every `generate` call), in percent. The program's spans on
the trace (perfbench/spans.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_share(ctx, "gen.load", spans.GEN)
