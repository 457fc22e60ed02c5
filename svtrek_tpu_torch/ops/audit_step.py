"""The consensus-only audit device step for host-extracted batches.

Port of svtrek_tpu/ops/audit_step.py::audit_consensus_step.  It is also
the conversion of the state the two packages share: the host packer's
numpy [B, K] batch becomes tensors on the run's device here.
"""
from __future__ import annotations

import numpy as np
import torch

from svtrek_tpu import constants as C

from .consensus import consensus_pos_batch


def audit_consensus_step(
    locs: np.ndarray,
    counts: np.ndarray,
    imprecise_pos: np.ndarray,
    *,
    device: torch.device,
    min_count: int = C.CONSENSUS_MIN_COUNT,
    interval: int = C.CONSENSUS_INTERVAL,
    range_: int = C.CONSENSUS_INTERVAL_RANGE,
    sweep_width: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """locs [B, K] int32 sorted with INT32_MAX padding, counts [B] (<= K),
    imprecise_pos [B].  Returns device tensors (refined [B] int32,
    sweep overflow [B] bool); the launch is asynchronous on CUDA."""
    def to_dev(a):
        a = np.ascontiguousarray(a, dtype=np.int32)
        return torch.from_numpy(a).to(device, non_blocking=True)

    return consensus_pos_batch(
        to_dev(locs), to_dev(counts), to_dev(imprecise_pos),
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width,
    )
