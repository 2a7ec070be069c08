"""Seconds of mesh decode a sample: every stage of the program's stage
log but the chain (grid dispatch and fetch, voxel.npz, marching cubes,
decimation, UV atlas and raster, texel dispatch and decode, texture
assembly, export), over the window's samples.  Work that overlaps the
next chain, not time the sample waited."""


def read(ctx):
    w = ctx.window
    s = sum(e["seconds"] + e.get("dispatch", 0.0)
            for e in w.get("stages", ()) if e["stage"] != "chain")
    n = w.get("samples", 0)
    return s / n if s > 0 and n else None
