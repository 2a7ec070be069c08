"""Device idle inside the mesh decode: the share of the traced window in
which no operation ran on the device while the main thread was inside a
`decode.*` span (the grid dispatch and each host stage of the decode),
in percent. The program's spans on the trace (perfbench/spans.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_share(ctx, "decode", spans.GEN)
