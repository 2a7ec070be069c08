"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12        # HBM3


def bound_ms(flops: float, nbytes: float, precision: str):
    """(least milliseconds, "operations" or "bytes"): the larger of the
    operations over the peak rate and the bytes over the peak bandwidth."""
    t_ops = flops / PEAK_FLOPS[precision]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
