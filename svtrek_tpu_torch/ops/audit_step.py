"""The consensus-only audit device step for host-extracted batches, and the
CSR-to-padded scatter of per-read run arrays.

Port of svtrek_tpu/ops/audit_step.py::audit_consensus_step and
csr_to_padded.  It is also the conversion of the state the two packages
share: the host packer's numpy [B, K] batch becomes tensors on the run's
device here.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants as C

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


def csr_to_padded(ops_flat: torch.Tensor, lens_flat: torch.Tensor,
                  n_ops: torch.Tensor, *, O: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter flat CSR runs into padded [N, O] op/len matrices on the
    tensors' device (svtrek_tpu/ops/audit_step.py::csr_to_padded).

    ops_flat [T] uint8/int8 and lens_flat [T] int32 hold the rows' runs
    back to back; n_ops [N] int32 the run count of each row (sum <= T).
    Returns (ops [N, O] int8, lens [N, O] int32).  Slots at or past the
    runs' total and columns >= O are dropped; unwritten cells stay op 0 /
    len 0.  Plain PyTorch ops (the JAX function is XLA, not a Pallas
    kernel), and free of host syncs: each slot's row comes from a
    searchsorted over the exclusive row starts, where jnp.repeat's
    total_repeat_length would need the sum on the host."""
    T, N = ops_flat.shape[0], n_ops.shape[0]
    dev = ops_flat.device
    ends = torch.cumsum(n_ops.long(), 0)
    starts = ends - n_ops.long()
    slot = torch.arange(T, dtype=torch.int64, device=dev)
    row = (torch.searchsorted(starts, slot, right=True) - 1).clamp_(0, N - 1)
    col = slot - starts[row]
    valid = (slot < ends[-1]) & (col < O)
    idx = torch.where(valid, row * O + col, N * O)
    ops = torch.zeros(N * O + 1, dtype=torch.int8, device=dev)
    lens = torch.zeros(N * O + 1, dtype=torch.int32, device=dev)
    ops.scatter_(0, idx, ops_flat.to(torch.int8))
    lens.scatter_(0, idx, lens_flat.to(torch.int32))
    return ops[:-1].view(N, O), lens[:-1].view(N, O)
