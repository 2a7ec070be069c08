"""The benchmark of sin3dm_tpu_torch (see harness.py and PERF.md)."""
