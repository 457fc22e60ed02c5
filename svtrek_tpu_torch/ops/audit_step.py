"""The audit device steps: the consensus-only step for host-extracted
batches, the fused refinement step (evidence walk -> grouping -> consensus)
for packed CIGARs, dense or CSR, and the CSR-to-padded scatter.

Port of svtrek_tpu/ops/audit_step.py (`AuditBatch`, `AuditBatchCSR`,
`audit_consensus_step`, `audit_refine_step`, `csr_to_padded`,
`audit_refine_step_csr`).  It is also the conversion of the state the two
packages share: the host packer's numpy batches become tensors on the
run's device here (`to_device`).  The consensus of every step is
`ops.consensus.consensus_pos_batch`, so on the card it launches kernel K1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C

from .cigar import extract_read_candidates, group_candidates_by_window
from .consensus import consensus_pos_batch


@dataclasses.dataclass
class AuditBatch:
    """Host-packed, fixed-shape batch of refine tasks.

    reads axis N: ops/lens [N, O], pos/n_ops/window_id [N]
    window axis B: kind/inter_start/inter_end/imprecise_pos [B]
    Padding reads have n_ops == 0 and window_id == B.
    """

    ops: np.ndarray
    lens: np.ndarray
    pos: np.ndarray
    n_ops: np.ndarray
    window_id: np.ndarray
    kind: np.ndarray
    inter_start: np.ndarray
    inter_end: np.ndarray
    imprecise_pos: np.ndarray

    @property
    def num_reads(self) -> int:
        return int(self.ops.shape[0])

    @property
    def num_windows(self) -> int:
        return int(self.kind.shape[0])


@dataclasses.dataclass
class AuditBatchCSR:
    """Flat (CSR) layout of a packed batch: the host ships only the real
    CIGAR ops and the device scatters them into the padded layout itself.

    flat ops axis T: ops_flat [T] uint8, lens_flat [T] int32 (the tail
    beyond sum(n_ops) is not read)
    reads axis N: pos/n_ops/window_id [N] (padding rows: n_ops == 0,
    window_id == B)
    window axis B: kind/inter_start/inter_end/imprecise_pos [B]
    """

    ops_flat: np.ndarray
    lens_flat: np.ndarray
    pos: np.ndarray
    n_ops: np.ndarray
    window_id: np.ndarray
    kind: np.ndarray
    inter_start: np.ndarray
    inter_end: np.ndarray
    imprecise_pos: np.ndarray
    ops_width: int              # O bucket for the device-side layout

    @property
    def num_reads(self) -> int:
        return int(self.pos.shape[0])

    @property
    def num_windows(self) -> int:
        return int(self.kind.shape[0])


def to_device(a: np.ndarray, device: torch.device,
              dtype=np.int32) -> torch.Tensor:
    """A host array as a tensor on ``device`` (asynchronous on CUDA)."""
    a = np.ascontiguousarray(a, dtype=dtype)
    return torch.from_numpy(a).to(device, non_blocking=True)


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
    return consensus_pos_batch(
        to_device(locs, device), to_device(counts, device),
        to_device(imprecise_pos, device),
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


def audit_refine_step(ops: torch.Tensor, lens: torch.Tensor,
                      pos: torch.Tensor, n_ops: torch.Tensor,
                      window_id: torch.Tensor, kind: torch.Tensor,
                      inter_start: torch.Tensor, inter_end: torch.Tensor,
                      imprecise_pos: torch.Tensor, *, num_windows: int,
                      K: int, min_count: int = C.CONSENSUS_MIN_COUNT,
                      interval: int = C.CONSENSUS_INTERVAL,
                      range_: int = C.CONSENSUS_INTERVAL_RANGE,
                      sweep_width: int = 128
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine a packed batch of tasks on the tensors' device (the layout of
    `AuditBatch`).

    Returns (refined [B] int32 with -1 = NA, counts [B] int32 candidate
    counts, overflow [B] bool).  A window whose count exceeds K, one of
    whose reads has more candidates than the grouping keeps, or whose
    consensus sweep overflowed must be recomputed by the host oracle."""
    # Per-read window attributes (windows beyond B are padding reads).
    wid_c = window_id.to(torch.int64).clamp(0, num_windows - 1)
    cand, _ = extract_read_candidates(
        ops, lens, pos, n_ops, kind[wid_c], inter_start[wid_c],
        inter_end[wid_c])
    locs, counts, read_ovf = group_candidates_by_window(
        cand, window_id, num_windows, K)
    refined, sweep_ovf = consensus_pos_batch(
        locs, counts.clamp(max=K), imprecise_pos.to(torch.int32),
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width)
    overflow = sweep_ovf | read_ovf | (counts > K)
    return refined, counts, overflow


def audit_refine_step_csr(ops_flat: torch.Tensor, lens_flat: torch.Tensor,
                          pos: torch.Tensor, n_ops: torch.Tensor,
                          window_id: torch.Tensor, kind: torch.Tensor,
                          inter_start: torch.Tensor, inter_end: torch.Tensor,
                          imprecise_pos: torch.Tensor, *, num_windows: int,
                          K: int, O: int, **kw
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """audit_refine_step fed the flat CSR layout of `AuditBatchCSR`: the
    padded [N, O] matrices are built on the device (`csr_to_padded`)."""
    ops, lens = csr_to_padded(ops_flat, lens_flat, n_ops, O=O)
    return audit_refine_step(ops, lens, pos, n_ops, window_id, kind,
                             inter_start, inter_end, imprecise_pos,
                             num_windows=num_windows, K=K, **kw)
