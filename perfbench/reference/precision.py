"""The operand precision of the reference's products.

The reference computes in float32 with TF32 off.  Its control rounds
the operands of the products to the precision below the one that the
configuration states, and sums in float32: bfloat16 where the
configuration states float32 with TF32 (training), fp8 (e4m3) where it
states bfloat16 (sampling), each fp8 operand scaled by its largest
magnitude over 448 (e4m3's largest finite value), rounded and scaled
back.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def fp32(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest)."""
    return x.to(torch.bfloat16).to(x.dtype)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale for the tensor."""
    amax = x.detach().abs().max().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def rounding(name: str):
    """The operand rounding of a precision name: "fp32", "bf16" or
    "fp8"."""
    return {"fp32": fp32, "bf16": bf16, "fp8": fp8}[name]


@contextlib.contextmanager
def exact_fp32():
    """The block with TF32 off for matmuls and cuDNN convolutions and
    with nondeterministic kernels allowed (the reference's setting);
    the caller's flags are restored after.  The deterministic setting is
    switched only where the caller has it on: the switch imports
    `torch._dynamo` on first use, ~10 s on the H100 machine."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.are_deterministic_algorithms_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if old[2]:
        torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        if old[2]:
            torch.use_deterministic_algorithms(True)
