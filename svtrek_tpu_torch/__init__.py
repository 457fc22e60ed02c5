"""svtrek_tpu_torch — the PyTorch + CUDA port of svtrek_tpu.

Runs `audt` (refine imprecise SV breakpoints of a VCF against long-read
BAM evidence, optionally with the insertion consensus), `scan` (windowed
INS discovery over a BAM region) and `disc` (SV discovery on graph
alignments) with their device steps on an NVIDIA Hopper card.  It stands alone: the host modules it shares semantics with are its
own copies of the JAX package's, under the same module names.

- config.py, constants.py, emit.py, io/, native/, oracle/
              copies of the JAX package's host modules (the native C
              library builds into `_build/`)
- device.py   the device policy (`--device cuda|cpu`)
- csrc/       hand-written CUDA kernels; kernels/ builds and binds them
- ops/        the device ops: a CUDA kernel on CUDA tensors where the op
              has one, plain PyTorch on CPU tensors
- pipeline/   the `audt`, `scan` and `disc` pipelines and the window
              packer
- cli.py      `python -m svtrek_tpu_torch.cli {audt,scan,disc} ...`

This package imports `torch` and never `jax`, nor anything of the JAX
package.
"""

__version__ = "0.1.0"
