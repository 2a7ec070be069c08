"""Device operations a reverse-chain step: the trace's operations
(kernels, copies, fills) that start inside the main thread's `gen.chain`
spans, over the `chain.step` spans (one a step of each chunk's chain).
The program's spans on the trace (perfbench/spans.py); the decode's work
queued before a chain and run inside it counts too (a few operations a
sample)."""

from perfbench import spans


def read(ctx):
    got = spans.of(ctx)
    if not got:
        return None
    steps = len(spans.main_thread(got, "chain.step"))
    chains = spans.union(spans.main_thread(got, "gen.chain"))
    if not steps or not chains:
        return None
    starts = sorted(a for a, _, _ in ctx.trace.device)
    n, i = 0, 0
    for a, b in chains:
        while i < len(starts) and starts[i] < a:
            i += 1
        while i < len(starts) and starts[i] <= b:
            n, i = n + 1, i + 1
    return n / steps
