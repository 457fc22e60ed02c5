"""Device policy: which device a run uses.

`AudtConfig.device` is "" or "cuda" for the card and "cpu" for the plain
PyTorch path.  Asking for the card where none is visible raises; nothing
drops to the CPU on its own.
"""
from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist in this process."""


def resolve_device(name: str) -> torch.device:
    if name in ("", "cuda"):
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "--device cuda: no CUDA device is visible to PyTorch "
                f"(torch {torch.__version__}); pass --device cpu to run "
                "the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}; expected 'cuda' or 'cpu'")
