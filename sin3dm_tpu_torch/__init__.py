"""sin3dm_tpu_torch — the PyTorch/CUDA port of `sin3dm_tpu`, for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package `sin3dm_tpu` stays the reference; this package mirrors its
layout module for module so each counterpart is easy to find, and imports
nothing of it (nor `jax`).  What it needs from a JAX-free module there it
keeps as its own copy.

Conventions shared with the reference:

* planes are channels-last `[B, H, W, C]` tensors in a
  :class:`~sin3dm_tpu_torch.core.triplane.Triplane`,
* parameters are nested dicts of tensors in JAX's layouts (conv
  `[kh, kw, Cin, Co]`, linear `[in, out]`), so carrying weights over is a
  rename (`compat/from_jax.py`),
* every entry point takes an explicit `device` and runs on the card
  unless the caller asks for the CPU; every random draw takes an
  explicit `torch.Generator`.

The two Pallas TPU kernels of the reference are hand-written CUDA C++
kernels here (`csrc/`), bound with ctypes (`ops/`).  On a CPU tensor each
wrapper computes its plain PyTorch version instead.

The port covers the pipeline from a textured OBJ to scored samples:
data preparation (`dataio/mesh_sampler.py`), AE and diffusion training
(`cli/train.py`), generation to meshes or voxel grids (`cli/sample.py`),
rendering (`rendering/softraster.py`) and evaluation
(`evaluation/eval_full.py`); what remains is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
