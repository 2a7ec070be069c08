"""The reverse chain hidden under the mesh decode: the share of the main
thread's `gen.chain` span time during which another thread was inside
a `decode.*` span (the decode worker's stages), in percent.  The
program's spans on the trace (perfbench/spans.py).  0 where every
decode span is on the main thread; nothing without a `gen.chain`
span."""

import threading

from perfbench import spans


def read(ctx):
    got = spans.of(ctx)
    if not got:
        return None
    chain = spans.union(spans.main_thread(got, "gen.chain"))
    total = sum(b - a for a, b in chain)
    if total <= 0:
        return None
    main = threading.main_thread().ident
    decode = spans.union([(a, b) for a, b, n, t in got
                          if t != main and spans.in_family(n, "decode")])
    return 100.0 * spans.overlap(chain, decode) / total
