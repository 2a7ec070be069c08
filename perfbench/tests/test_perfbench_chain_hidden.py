"""`chain_hidden_share` on synthetic spans: the share of the main
thread's `gen.chain` time inside another thread's `decode.*` spans, in
percent; 0 with every decode span on the main thread; nothing without a
`gen.chain` span or a trace."""

import threading
from types import SimpleNamespace

import pytest

from perfbench import harness

MAIN = threading.main_thread().ident
WORKER = MAIN + 1
EXPORT = MAIN + 2


def read(ctx):
    return harness.Bench().reader("chain_hidden_share")(ctx)


def ctx_of(spans):
    return SimpleNamespace(trace=object(), spans=spans, window={})


# two chains of 300 us, the second with its steps inside it
CHAINS = [(0.0, 300.0, "gen.chain", MAIN), (1000.0, 1300.0, "gen.chain", MAIN),
          (1000.0, 1100.0, "chain.step", MAIN)]


def test_every_decode_span_on_the_main_thread_reads_zero():
    got = CHAINS + [(300.0, 1000.0, "decode.marching cubes", MAIN),
                    (1300.0, 1400.0, "decode.wait", MAIN),
                    (0.0, 1300.0, "export.export", EXPORT)]
    assert read(ctx_of(got)) == 0.0


def test_the_exact_overlap_with_another_threads_decode():
    # the worker's stages cover 120 us of the first chain (two stages
    # that overlap each other count once, one that starts before the
    # chain its part inside it) and 250 us of the second; the main
    # thread's own decode spans, the export worker's and a name outside
    # the family do not count
    got = CHAINS + [(200.0, 280.0, "decode.sdf grid", WORKER),
                    (220.0, 320.0, "decode.voxel.npz", WORKER),
                    (-50.0, 20.0, "decode.uv atlas + raster", WORKER),
                    (1050.0, 1400.0, "decode.marching cubes", WORKER),
                    (0.0, 300.0, "decode.wait", MAIN),
                    (0.0, 1300.0, "export.texel decode", EXPORT),
                    (0.0, 1300.0, "decoder", WORKER)]
    assert read(ctx_of(got)) == pytest.approx(100.0 * 370.0 / 600.0)


def test_reads_nothing_without_a_chain_or_a_trace():
    assert read(ctx_of([(0.0, 9.0, "decode.sdf grid", WORKER)])) is None
    assert read(ctx_of([])) is None
    assert read(SimpleNamespace(trace=None, window={})) is None
