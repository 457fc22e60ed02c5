"""The audit device steps: the consensus-only step for host-extracted
batches, the fused refinement step (evidence walk -> grouping -> consensus)
for packed CIGARs, dense or CSR, and the CSR-to-padded scatter.

Port of svtrek_tpu/ops/audit_step.py (`AuditBatch`, `AuditBatchCSR`,
`audit_consensus_step`, `audit_refine_step`, `csr_to_padded`,
`audit_refine_step_csr`).  It is also the conversion of the state the two
packages share: the host packer's numpy batches become tensors on the
run's device here (`to_device`).  The consensus of every step is
`ops.consensus.consensus_pos_batch`, so on the card it launches kernel K1.

Both refine steps walk the runs where they lie (`ops.cigar.walk_runs`):
the CSR step builds no padded matrix, so a read of any op count stays on
the device, and the grouping keeps every candidate of a read, so a window
overflows only past K candidates or in the consensus sweep.  Such a
window takes a second pass on the batch's device at the width it needs
(`audit_refine_wide` over the walk a step kept in a `WalkState`, and for
host-extracted rows `audit_consensus_wide`): the full sweep of
`ops.consensus.consensus_pos_full`, which cannot overflow.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C

from .cigar import group_walk, walk_runs
from .consensus import consensus_pos_batch, consensus_pos_full


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

    The JAX package's batch also carries the O bucket of its device-side
    padded layout; the port's walk reads the flat streams as they are.
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


def audit_consensus_wide(locs: np.ndarray, counts: np.ndarray,
                         imprecise_pos: np.ndarray, rows=None, *,
                         device: torch.device,
                         min_count: int = C.CONSENSUS_MIN_COUNT,
                         interval: int = C.CONSENSUS_INTERVAL,
                         range_: int = C.CONSENSUS_INTERVAL_RANGE
                         ) -> torch.Tensor:
    """The second pass of host-extracted windows: the full sweep
    (`consensus_pos_full`) on ``device`` over rows ``rows`` (default all)
    of locs [B, K] (sorted, INT32_MAX padding).  Returns their refined
    values [b] int32 on ``device`` (asynchronous on CUDA)."""
    if rows is not None:
        locs, counts, imprecise_pos = (locs[rows], counts[rows],
                                       imprecise_pos[rows])
    return consensus_pos_full(
        to_device(locs, device), to_device(counts, device),
        to_device(imprecise_pos, device), min_count=min_count,
        interval=interval, range_=range_)[0]


@dataclasses.dataclass
class WalkState:
    """A device-walk batch's grouping inputs (`group_walk`'s), kept on its
    device from the step to the batch's collect for `audit_refine_wide`."""

    op_cand: torch.Tensor
    row: torch.Tensor
    clip: torch.Tensor
    window_id: torch.Tensor
    imprecise_pos: torch.Tensor
    num_windows: int


def audit_refine_wide(state: WalkState, rows: np.ndarray, width: int, *,
                      min_count: int = C.CONSENSUS_MIN_COUNT,
                      interval: int = C.CONSENSUS_INTERVAL,
                      range_: int = C.CONSENSUS_INTERVAL_RANGE
                      ) -> torch.Tensor:
    """The second pass of a device-walk batch on its device: windows
    ``rows`` (past the first pass's K, or whose sweep overflowed)
    regrouped at ``width``, at least their largest candidate count, so
    that each row is the window's whole candidate set, then the full
    sweep.  Returns their refined values [b] int32 on the batch's device
    (asynchronous on CUDA)."""
    rows = to_device(rows, state.clip.device, np.int64)
    locs, n = group_walk(state.op_cand, state.row, state.clip,
                         state.window_id, state.num_windows, width,
                         rows=rows)
    return consensus_pos_full(
        locs, n, state.imprecise_pos[rows], min_count=min_count,
        interval=interval, range_=range_)[0]


def _refine(walk, window_id: torch.Tensor, imprecise_pos: torch.Tensor, *,
            num_windows: int, K: int, min_count: int, interval: int,
            range_: int, sweep_width: int, keep: list | None = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group a walk's candidates by window and run the consensus; with
    ``keep``, append the batch's `WalkState` to it."""
    op_cand, _, clip, _, row = walk
    locs, counts = group_walk(op_cand, row, clip, window_id, num_windows, K)
    pos = imprecise_pos.to(torch.int32)
    refined, sweep_ovf = consensus_pos_batch(
        locs, counts.clamp(max=K), pos,
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width)
    if keep is not None:
        keep.append(WalkState(op_cand, row, clip, window_id, pos,
                              num_windows))
    return refined, counts, sweep_ovf | (counts > K)


def _read_attrs(window_id, num_windows: int, *attrs):
    """Per-read window attributes (windows beyond B are padding reads)."""
    wid_c = window_id.to(torch.int64).clamp(0, num_windows - 1)
    return [a[wid_c] for a in attrs]


def audit_refine_step(ops: torch.Tensor, lens: torch.Tensor,
                      pos: torch.Tensor, n_ops: torch.Tensor,
                      window_id: torch.Tensor, kind: torch.Tensor,
                      inter_start: torch.Tensor, inter_end: torch.Tensor,
                      imprecise_pos: torch.Tensor, *, num_windows: int,
                      K: int, min_count: int = C.CONSENSUS_MIN_COUNT,
                      interval: int = C.CONSENSUS_INTERVAL,
                      range_: int = C.CONSENSUS_INTERVAL_RANGE,
                      sweep_width: int = 128, keep: list | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine a packed batch of tasks on the tensors' device (the layout of
    `AuditBatch`).

    Returns (refined [B] int32 with -1 = NA, counts [B] int32 candidate
    counts, overflow [B] bool).  A window whose count exceeds K or whose
    consensus sweep overflowed takes a second pass (`audit_refine_wide`
    on the `WalkState` appended to ``keep``) or, past the widest one, the
    host oracle."""
    walk = walk_runs(ops.reshape(-1), lens.reshape(-1), pos, n_ops,
                     *_read_attrs(window_id, num_windows, kind, inter_start,
                                  inter_end), width=ops.shape[1])
    return _refine(walk, window_id, imprecise_pos, num_windows=num_windows,
                   K=K, min_count=min_count, interval=interval,
                   range_=range_, sweep_width=sweep_width, keep=keep)


def audit_refine_step_csr(ops_flat: torch.Tensor, lens_flat: torch.Tensor,
                          pos: torch.Tensor, n_ops: torch.Tensor,
                          window_id: torch.Tensor, kind: torch.Tensor,
                          inter_start: torch.Tensor, inter_end: torch.Tensor,
                          imprecise_pos: torch.Tensor, *, num_windows: int,
                          K: int, min_count: int = C.CONSENSUS_MIN_COUNT,
                          interval: int = C.CONSENSUS_INTERVAL,
                          range_: int = C.CONSENSUS_INTERVAL_RANGE,
                          sweep_width: int = 128, keep: list | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """audit_refine_step fed the flat CSR layout of `AuditBatchCSR`: the
    walk reads the flat streams where they lie, with no padded matrix."""
    walk = walk_runs(ops_flat, lens_flat, pos, n_ops,
                     *_read_attrs(window_id, num_windows, kind, inter_start,
                                  inter_end))
    return _refine(walk, window_id, imprecise_pos, num_windows=num_windows,
                   K=K, min_count=min_count, interval=interval,
                   range_=range_, sweep_width=sweep_width, keep=keep)
