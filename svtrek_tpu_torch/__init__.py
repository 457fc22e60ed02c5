"""svtrek_tpu_torch — the PyTorch + CUDA port of svtrek_tpu.

Runs `audt` (refine imprecise SV breakpoints of a VCF against long-read
BAM evidence) with its device step on an NVIDIA Hopper card.  The host
half is shared with `svtrek_tpu` where that package's modules are free of
JAX (config, constants, emit, io, native, oracle, the CLI parser); the
rest is ported here:

- device.py   the device policy (`--device cuda|cpu`)
- csrc/       hand-written CUDA kernels; kernels/ builds and binds them
- ops/        the consensus op: kernel K1 on CUDA tensors, plain PyTorch
              on CPU tensors
- pipeline/   the host-extract window packer and the `audt` pipeline
- cli.py      `python -m svtrek_tpu_torch.cli audt ...`

This package imports `torch` and never `jax`.
"""

__version__ = "0.1.0"
