"""clsr_tpu_torch — the PyTorch/CUDA port of clsr_tpu for one NVIDIA H100.

The JAX package `clsr_tpu` stays the reference; this package mirrors its
layout and names and imports nothing from it.  The first slice serves
CLSR: `serving.ScoringService.score` runs the eval forward of
`models.clsr.CLSRModel`, whose two hand-written CUDA kernels live in
`csrc/` (the fused eval scorer and the three-cell recurrence).

Entry points run on the card by default and raise when there is none,
unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
