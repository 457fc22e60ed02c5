"""Batched CIGAR evidence walk and per-window grouping of its candidates.

Port of svtrek_tpu/ops/cigar.py: `extract_read_candidates` re-derives the
reference's per-read CIGAR walks (refinement.c:103-325) as prefix-sum
programs, and `group_candidates_by_window` gathers each window's
candidates into one sorted row.  The JAX functions are XLA programs, not
Pallas kernels, so these are plain PyTorch ops on the tensors' device (the
card on `--device cuda`), with no read back to the host.

Every output equals the JAX one bit for bit:

- the running reference position wraps in int32 as JAX's int32 cumsum
  does: it is summed in int64 and wrapped explicitly, so the CPU and CUDA
  agree whatever `torch.cumsum` does with int32;
- the j-th valid candidate of a read is found by `torch.searchsorted` on
  the read's inclusive rank row (non-decreasing, so the left search gives
  the count of ranks below j, JAX's broadcast compare count) without the
  [N, read_cap, Cw] intermediate;
- JAX's `mode="drop"` scatter writes to one extra dump slot instead, as
  `ops.audit_step.csr_to_padded` does.
"""
from __future__ import annotations

import torch

from ..constants import (
    CIGAR_D, CIGAR_I, CIGAR_S, I32_MAX, KIND_DEL_END, KIND_DEL_START,
    KIND_INS, KIND_INV_END, SV_MIN_LENGTH,
)

from .sweep import wrap_i32

PAD = I32_MAX

# Calls of extract_read_candidates by the device type of its tensors.
walk_calls: dict[str, int] = {"cuda": 0, "cpu": 0}


def _i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped to int32 (two's complement)."""
    return wrap_i32(x).to(torch.int32)


def extract_read_candidates(ops: torch.Tensor, lens: torch.Tensor,
                            pos: torch.Tensor, n_ops: torch.Tensor,
                            kind: torch.Tensor, inter_start: torch.Tensor,
                            inter_end: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-read candidate positions.

    ops [N, O] int8 BAM op codes (columns at or past n_ops are padding),
    lens [N, O] int32, pos [N] int32 0-based alignment start, n_ops [N]
    int32 (0 = padding read), kind [N] int32 task kind per read (KIND_*),
    inter_start / inter_end [N] int32 interval bounds (1-based, as passed).
    Returns (cand [N, O+1] int32 with PAD sentinels, count [N] int32);
    column O holds the (at most one) soft-clip candidate."""
    dev = ops.device
    walk_calls[dev.type] = walk_calls.get(dev.type, 0) + 1
    i32, i64 = torch.int32, torch.int64
    N, O = ops.shape
    col = torch.arange(O, device=dev)[None, :]
    is_real = col < n_ops[:, None]
    op = ops.to(i32)
    ln = lens.to(i32)
    pos = pos.to(i32)
    kind = kind.to(i32)
    inter_start = inter_start.to(i32)
    inter_end = inter_end.to(i32)

    adv = torch.where(is_real & (op != CIGAR_I) & (op != CIGAR_S), ln, 0)
    after64 = pos.to(i64)[:, None] + torch.cumsum(adv, 1, dtype=i64)
    ref_after = _i32(after64)                   # position after op i
    ref_before = _i32(after64 - adv)            # position before op i

    ie = inter_end[:, None]
    # Op i is evaluated iff no earlier op pushed reference_pos past the
    # interval end (the break at refinement.c:141-144 / 205-208 / 316-318).
    prev_after = torch.cat([pos[:, None], ref_after[:, :-1]], 1)
    processed = is_real & ((col == 0) | (prev_after <= ie))

    kd = kind[:, None]
    del_kind = (kd == KIND_DEL_START) | (kd == KIND_DEL_END) | \
        (kd == KIND_INV_END)
    op_cand_val = torch.where((kd == KIND_DEL_END) | (kd == KIND_INV_END),
                              _i32(after64 + 1), ref_before)
    op_cand_mask = processed & torch.where(
        del_kind, (op == CIGAR_D) & (ln > SV_MIN_LENGTH),
        (kd == KIND_INS) & (op == CIGAR_I) & (ln >= SV_MIN_LENGTH))
    op_cand = torch.where(op_cand_mask, op_cand_val, PAD)

    # --- soft-clip evidence ---------------------------------------------
    last_idx = (n_ops.to(i64) - 1).clamp(0, O - 1)[:, None]
    last_op = op.gather(1, last_idx)[:, 0]
    first_op = op[:, 0]
    final_rp = ref_after.gather(1, last_idx)[:, 0]
    exceeded = is_real & (ref_after > ie)
    no_break = ~exceeded.any(1)
    # The first reference position past the interval end: the min of the
    # exceeding positions, as the JAX program takes it; where none, the
    # final position.
    first_exceed = torch.where(exceeded, ref_after, PAD).amin(1)
    stop_rp = torch.where(no_break, final_rp, first_exceed)

    has_ops = n_ops > 0
    # refine_start: a trailing soft clip whose unbroken alignment end lies
    # in the interval records that end (refinement.c:120, 147-159).
    sc_start_ok = has_ops & (last_op == CIGAR_S) & no_break & \
        (inter_start <= final_rp) & (final_rp <= inter_end)
    # refine_end: a leading soft clip whose alignment start lies in the
    # interval records the post-walk position + 1 (refinement.c:210-221);
    # --refine-inv's KIND_INV_END records the alignment start itself.
    sc_end_ok = has_ops & (first_op == CIGAR_S) & \
        (inter_start <= pos) & (pos <= inter_end)
    sc_val = torch.where(
        kind == KIND_DEL_START, final_rp,
        torch.where(kind == KIND_DEL_END, _i32(stop_rp.to(i64) + 1),
                    torch.where(kind == KIND_INV_END, pos, PAD)))
    sc_ok = torch.where(
        kind == KIND_DEL_START, sc_start_ok,
        ((kind == KIND_DEL_END) | (kind == KIND_INV_END)) & sc_end_ok)
    sc_col = torch.where(sc_ok, sc_val, PAD)

    cand = torch.cat([op_cand, sc_col[:, None]], 1)
    count = op_cand_mask.sum(1, dtype=i32) + sc_ok.to(i32)
    return cand, count


def group_candidates_by_window(cand: torch.Tensor, window_id: torch.Tensor,
                               num_windows: int, K: int, read_cap: int = 8
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Group per-read candidates into per-window sorted rows.

    cand [N, Cw] int32 with PAD padding; window_id [N] (>= num_windows is
    a padding read).  Reads must be grouped contiguously by window,
    ascending, padding reads last, as every packer lays them out.

    Returns (locs [B, K] int32 sorted ascending with PAD padding, counts
    [B] int32 true per-window candidate counts, which may exceed K, ovf [B]
    bool: some read had more than `read_cap` candidates, so `locs` is
    incomplete).  Windows with counts > K or ovf must go to the host
    oracle."""
    dev = cand.device
    i32, i64 = torch.int32, torch.int64
    N, Cw = cand.shape
    B = num_windows
    valid = (cand < PAD) & (window_id[:, None] < B)
    rank_incl = torch.cumsum(valid, 1, dtype=i32)            # [N, Cw]
    c_read = rank_incl[:, -1]
    read_ovf = c_read > read_cap
    c_eff = c_read.clamp(max=read_cap)

    # Rank-select: the column of the j-th (1-based) valid candidate is the
    # count of columns whose inclusive rank is below j.
    j = torch.arange(1, read_cap + 1, dtype=i32, device=dev)
    col_j = torch.searchsorted(rank_incl, j.expand(N, read_cap).contiguous())
    small = cand.gather(1, col_j.clamp(max=Cw - 1))
    jj = torch.arange(read_cap, device=dev)[None, :]
    keep = jj < c_eff[:, None]

    # A gap-free global slot per surviving candidate; slot N * read_cap
    # takes every dropped write.
    read_off = torch.cumsum(c_eff, 0, dtype=i64) - c_eff
    gidx = torch.where(keep, read_off[:, None] + jj, N * read_cap)
    flat = torch.full((N * read_cap + 1,), PAD, dtype=i32, device=dev)
    flat.scatter_(0, gidx.reshape(-1), small.reshape(-1))

    wid_c = window_id.to(i64).clamp(max=B)
    seg = torch.zeros((2, B + 1), dtype=i64, device=dev)
    seg.scatter_add_(1, wid_c.expand(2, N),
                     torch.stack([c_read, c_eff]).to(i64))
    counts, counts_eff = seg[0, :B].to(i32), seg[1, :B]
    ovf = torch.zeros(B + 1, dtype=i32, device=dev).scatter_reduce_(
        0, wid_c, read_ovf.to(i32), "amax")[:B] > 0
    w_off = torch.cumsum(counts_eff, 0) - counts_eff

    kk = torch.arange(K, device=dev)[None, :]
    gather_idx = (w_off[:, None] + kk).clamp(0, N * read_cap - 1)
    locs = torch.where(kk < counts_eff[:, None], flat[gather_idx], PAD)
    return torch.sort(locs, 1).values, counts, ovf
