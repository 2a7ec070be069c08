"""Device idle inside the reverse chain: the share of the traced window in
which no operation ran on the device while the main thread was inside a
`gen.chain` span (a chunk's chain, its launches and its closing sync),
in percent. The program's spans on the trace (perfbench/spans.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_share(ctx, "gen.chain", spans.GEN)
