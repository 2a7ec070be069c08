"""Seconds of the export tail a sample: the union of the program's
`export.*` spans (the export worker's texel decode, texture assembly
and export, with each map's PNG write inside it) over the window's
samples.  The program's spans on the trace (perfbench/spans.py); a
program that records no such span reads nothing."""

from perfbench import spans


def read(ctx):
    got = spans.of(ctx)
    n = ctx.window.get("samples", 0)
    if not got or not n:
        return None
    iv = spans.union([(a, b) for a, b, name, _ in got
                      if spans.in_family(name, "export")])
    return sum(b - a for a, b in iv) / 1e6 / n if iv else None
