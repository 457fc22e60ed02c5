"""The step-overhead probe: the reduction that tools/pallas_step_overhead.py
runs as a Pallas kernel of N / rows_per sequential grid steps.

`step_probe` sends CUDA tensors to kernel K4 (csrc/step_probe.cu through
`kernels.step_probe_cuda`) and CPU tensors to the plain PyTorch version
`step_probe_reference`; the choice is made by the tensor's device, with no
fallback from one to the other.  tools/torch_step_overhead.py times both.
"""
from __future__ import annotations

import torch

COLS = 128  # the width of the TPU kernel's accumulator block

# Calls of the plain version through `step_probe` (the CPU route).
plain_calls: dict[str, int] = {"step_probe": 0}


def _check(ptr: torch.Tensor, rows_per: int) -> None:
    if ptr.dim() != 3 or ptr.dtype != torch.int8:
        raise ValueError(f"ptr must be int8 [N, B, WP], got {ptr.dtype} "
                         f"{tuple(ptr.shape)}")
    if rows_per < 1 or ptr.shape[0] % rows_per:
        raise ValueError(f"rows_per {rows_per} must divide N = "
                         f"{ptr.shape[0]}")


def step_probe_reference(ptr: torch.Tensor, rows_per: int) -> torch.Tensor:
    """ptr [N, B, WP] int8 -> out [B, 128] int32 with out[:, 0] the int32
    sum of ptr over N and WP and the other columns 0 (rows_per, which only
    cuts the walk into steps, must divide N)."""
    _check(ptr, rows_per)
    out = torch.zeros((ptr.shape[1], COLS), dtype=torch.int32,
                      device=ptr.device)
    out[:, 0] = ptr.to(torch.int32).sum((0, 2)).to(torch.int32)
    return out


def step_probe(ptr: torch.Tensor, rows_per: int, *,
               per_step_launches: bool = False) -> torch.Tensor:
    """The probe on the tensor's device.  On CUDA, K4 walks all N /
    rows_per steps in one launch, or with ``per_step_launches`` in one
    launch per step; on the CPU, the plain version."""
    if ptr.device.type == "cuda":
        from ..kernels import step_probe_cuda

        _check(ptr, rows_per)
        steps = ptr.shape[0] // rows_per
        out = torch.empty((ptr.shape[1], COLS), dtype=torch.int32,
                          device=ptr.device)
        if not per_step_launches or steps == 0:
            return step_probe_cuda(ptr, rows_per, 0, steps, out)
        for s in range(steps):
            step_probe_cuda(ptr, rows_per, s, s + 1, out)
        return out
    if ptr.device.type != "cpu":
        raise ValueError(f"no step probe path for device {ptr.device}")
    plain_calls["step_probe"] += 1
    return step_probe_reference(ptr, rows_per)
