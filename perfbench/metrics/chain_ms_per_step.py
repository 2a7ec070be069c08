"""Milliseconds a reverse-chain step: the program's stage log's "chain"
seconds (host clock to a sync, each sample's share of its chunk's
chain) over the chain steps the window ran."""


def read(ctx):
    w = ctx.window
    s = sum(e["seconds"] for e in w.get("stages", ()) if e["stage"] == "chain")
    n = w.get("samples", 0) * w.get("chain_steps", 0)
    return 1e3 * s / n if s > 0 and n else None
