"""Mesh generation through the ancestral DDPM chain (`cli.sample`'s and
the reference's default: no respacing, `--use_ddim false`), the eager
chain that no CUDA graph replays: `generate.py`'s window, set-up and
check with the DDPM chain in place of DDIM's.

The mix's `respacing` is "ddpm<T>", T the configuration's
`diffusion_steps` (the CLI runs DDPM over the whole schedule); the
warm-up is `generate.py`'s short DDIM chain and one decode at the
window's shapes (the chain's eager step runs the same kernels).  The
check is `generate.py`'s, with each sample's reference chain
`reference/ddpm.py`'s: x_T and every step's noise from the sample's
(seed, j) generator, in the sampler's order.
"""

from __future__ import annotations

import os

from perfbench.harness import load_module
from perfbench.reference import ddpm
from perfbench.reference import diffusion as RD
from perfbench.reference.precision import fp32

generate = load_module(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "generate.py"), "perfbench_driver_generate")


class _Chain:
    """`generate.py`'s view of the reference chain (its module's `RD`)
    for one check: `initial_noise` notes the block's samples, and
    `ddim_chain` runs their DDPM chain from their generators."""

    def __init__(self, seed: int):
        self.seed = seed

    def initial_noise(self, seed, samples, sizes, channels, device):
        self.block = (list(samples), sizes, channels, device)
        return RD.initial_noise(seed, samples, sizes, channels, device)

    def ddim_chain(self, P, x, steps, respaced, q=fp32):
        samples, sizes, channels, device = self.block
        if respaced != steps:
            raise ValueError(f"DDPM over {respaced} of {steps} steps")
        return ddpm.ddpm_chain(P, self.seed, samples, sizes, channels, steps,
                               device, q)


class Driver(generate.Driver):
    def argv(self, n: int, respacing: str, out: str):
        a = super().argv(n, respacing, out)
        if respacing.startswith("ddpm"):
            a[a.index("--use_ddim") + 1] = "false"
            a[a.index("--timestep_respacing") + 1] = ""
        return a

    def readings(self, control: str = None) -> dict:
        chain, generate.RD = generate.RD, _Chain(self.seed)
        try:
            return super().readings(control)
        finally:
            generate.RD = chain
