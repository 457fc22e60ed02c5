"""Batched CIGAR evidence walk and per-window grouping of its candidates.

Port of svtrek_tpu/ops/cigar.py: the reference's per-read CIGAR walks
(refinement.c:103-325) as prefix-sum programs, and the grouping of each
window's candidates into one sorted row.  The JAX functions are XLA
programs, not Pallas kernels, so these are plain PyTorch ops on the
tensors' device (the card on `--device cuda`), with no read back to the
host.

The walk (`walk_runs`) runs over a batch's runs laid end to end, in the
padded [N, O] layout or the flat CSR one, so a read's length sets no
matrix width: each read's reference position is a segmented cumsum (a
cumsum over the whole stream less its value at the read's first run), and
the per-read reductions are differences of stream cumsums, or a scatter
min over the runs of the few reads that need it.  The
grouping (`group_walk`) ranks every candidate of the stream in (read,
run) order, each read's soft-clip candidate after its runs, so it keeps
every candidate of a read where the JAX grouping keeps `read_cap` of them
and flags the rest.  `extract_read_candidates` and
`group_candidates_by_window` are the JAX package's functions on top of
these two, bit for bit.

Every output equals the JAX one bit for bit:

- the running reference position wraps in int32 as JAX's int32 cumsum
  does: it is summed in int64 and wrapped explicitly, so the CPU and CUDA
  agree whatever `torch.cumsum` does with int32;
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

# Calls of walk_runs by the device type of its tensors.
walk_calls: dict[str, int] = {"cuda": 0, "cpu": 0}


def _i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped to int32 (two's complement)."""
    return wrap_i32(x).to(torch.int32)


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """[T + 1]: the sums of x's first t entries (a leading 0); a run of
    slots [a, b) sums to out[b] - out[a]."""
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])


def walk_runs(ops: torch.Tensor, lens: torch.Tensor, pos: torch.Tensor,
              n_ops: torch.Tensor, kind: torch.Tensor,
              inter_start: torch.Tensor, inter_end: torch.Tensor, *,
              width: int | None = None) -> tuple[torch.Tensor, ...]:
    """The evidence walk of every read of a batch.

    ops [T] int8/uint8 BAM op codes and lens [T] int32 hold the reads'
    runs end to end: read r's n_ops[r] runs start at slot r * width (the
    padded layout, ``width`` = O; runs past O are not read) or, with
    ``width`` None, at the sum of the earlier reads' n_ops (the CSR layout;
    slots past the total are not read).  pos [N] int32 0-based alignment
    start, n_ops [N] int32 (0 = padding read), kind [N] int32 task kind
    per read (KIND_*), inter_start / inter_end [N] int32 interval bounds
    (1-based, as passed).

    Returns (op_cand [T] int32 with PAD where a slot holds no candidate,
    op_mask [T] bool, clip [N] int32 the read's soft-clip candidate or PAD,
    clip_ok [N] bool, row [T] int64 the read of each slot)."""
    dev = ops.device
    walk_calls[dev.type] = walk_calls.get(dev.type, 0) + 1
    i32, i64 = torch.int32, torch.int64
    T, N = ops.shape[0], n_ops.shape[0]
    n = n_ops.to(i64)
    slot = torch.arange(T, device=dev)
    if width is None:
        off = torch.cumsum(n, 0) - n
        row = (torch.searchsorted(off, slot, right=True) - 1).clamp_(0, N - 1)
    else:
        n = n.clamp(max=width)
        off = torch.arange(N, device=dev) * width
        row = slot // width
    col = slot - off[row]
    real = col < n[row]
    op = ops.to(i32)
    ln = lens.to(i32)
    pos = pos.to(i32)
    kind = kind.to(i32)
    inter_start = inter_start.to(i32)
    inter_end = inter_end.to(i32)
    kd, ie = kind[row], inter_end[row]

    adv = torch.where(real & (op != CIGAR_I) & (op != CIGAR_S), ln,
                      0).to(i64)
    # sums[t]: the advances of the slots before t; a read's running sum
    # is the stream's less its value at the read's first run.
    sums = _prefix(adv)
    first, end = off.clamp(max=T), (off + n).clamp(max=T)
    base = pos.to(i64) - sums[first]
    after64 = base[row] + sums[1:]
    ref_after = _i32(after64)                   # position after the run
    ref_before = _i32(after64 - adv)            # position before the run

    # A run is evaluated iff no earlier run pushed reference_pos past the
    # interval end (the break at refinement.c:141-144 / 205-208 /
    # 316-318); the position after run i - 1 is the one before run i.
    processed = real & ((col == 0) | (ref_before <= ie))

    del_kind = (kd == KIND_DEL_START) | (kd == KIND_DEL_END) | \
        (kd == KIND_INV_END)
    op_cand_val = torch.where((kd == KIND_DEL_END) | (kd == KIND_INV_END),
                              _i32(after64 + 1), ref_before)
    op_mask = processed & torch.where(
        del_kind, (op == CIGAR_D) & (ln > SV_MIN_LENGTH),
        (kd == KIND_INS) & (op == CIGAR_I) & (ln >= SV_MIN_LENGTH))
    op_cand = torch.where(op_mask, op_cand_val, PAD)

    # --- soft-clip evidence ---------------------------------------------
    has_ops = n > 0
    last_op = op[(off + n - 1).clamp(0, T - 1)]
    first_op = op[first.clamp(max=T - 1)]
    final_rp = _i32(base + sums[end])
    exceeded = real & (ref_after > ie)
    exc = _prefix(exceeded.to(i32))
    no_break = exc[end] == exc[first]

    # refine_start: a trailing soft clip whose unbroken alignment end lies
    # in the interval records that end (refinement.c:120, 147-159).
    sc_start_ok = has_ops & (last_op == CIGAR_S) & no_break & \
        (inter_start <= final_rp) & (final_rp <= inter_end)
    # refine_end: a leading soft clip whose alignment start lies in the
    # interval records the post-walk position + 1 (refinement.c:210-221);
    # --refine-inv's KIND_INV_END records the alignment start itself.
    sc_end_ok = has_ops & (first_op == CIGAR_S) & \
        (inter_start <= pos) & (pos <= inter_end)
    # The first reference position past the interval end: the min of the
    # exceeding positions, as the JAX program takes it; where none, the
    # final position.  Only a DEL_END read's clip records it, so only such
    # reads' runs take part in the min; every other run writes a slot of
    # its own past N, so no two runs of different reads meet.
    part = exceeded & ((kind == KIND_DEL_END) & sc_end_ok)[row]
    first_exceed = torch.full((N + T,), PAD, dtype=i32, device=dev) \
        .scatter_reduce_(0, torch.where(part, row, N + slot), ref_after,
                         "amin")[:N]
    stop_rp = torch.where(no_break, final_rp, first_exceed)
    sc_val = torch.where(
        kind == KIND_DEL_START, final_rp,
        torch.where(kind == KIND_DEL_END, _i32(stop_rp.to(i64) + 1),
                    torch.where(kind == KIND_INV_END, pos, PAD)))
    clip_ok = torch.where(
        kind == KIND_DEL_START, sc_start_ok,
        ((kind == KIND_DEL_END) | (kind == KIND_INV_END)) & sc_end_ok)
    clip = torch.where(clip_ok, sc_val, PAD)
    return op_cand, op_mask, clip, clip_ok, row


def group_walk(op_cand: torch.Tensor, row: torch.Tensor, clip: torch.Tensor,
               window_id: torch.Tensor, num_windows: int, K: int,
               rows: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Group a walk's candidates (`walk_runs`) into per-window sorted rows.

    op_cand [T] and row [T] as walk_runs returns them, clip [N];
    window_id [N] (>= num_windows is a padding read).  Reads must be
    grouped contiguously by window, ascending, padding reads last, as
    every packer lays them out.  A value below PAD is a candidate.

    Returns (locs [B, K] int32 sorted ascending with PAD padding, counts
    [B] int32 per-window candidate counts, which may exceed K).  Every
    candidate of every read counts: the stream's candidates get gap-free
    slots in (read, run) order, each read's clip after its runs, so a
    window's are contiguous and its row takes the first K.  A window with
    counts > K takes a second pass at a K past its count.  With ``rows``
    (int64 window indices [b]), only those windows' rows and counts are
    returned, [b, K] and [b]: the second pass's layout."""
    dev = clip.device
    i64 = torch.int64
    T, N, B = op_cand.shape[0], clip.shape[0], num_windows
    in_batch = window_id < B
    v_op = (op_cand < PAD) & in_batch[row]
    v_clip = (clip < PAD) & in_batch
    vc = v_clip.to(i64)
    # ops_before[t]: the candidate runs before slot t; a read's slots
    # [bounds[r], bounds[r + 1]) (row is sorted) hold its runs.
    ops_before = _prefix(v_op.to(i64))
    bounds = ops_before[torch.searchsorted(
        row, torch.arange(N + 1, device=dev))]
    clips_before = torch.cumsum(vc, 0) - vc
    dump = T + N
    flat = torch.full((dump + 1,), PAD, dtype=torch.int32, device=dev)
    flat.scatter_(0, torch.where(
        v_op, ops_before[:-1] + clips_before[row], dump), op_cand)
    flat.scatter_(0, torch.where(
        v_clip, bounds[1:] + clips_before, dump), clip)

    counts = torch.zeros(B + 1, dtype=i64, device=dev).index_add_(
        0, window_id.to(i64).clamp(max=B), bounds[1:] - bounds[:-1] + vc)[:B]
    w_off = torch.cumsum(counts, 0) - counts
    if rows is not None:
        counts, w_off = counts[rows], w_off[rows]
    kk = torch.arange(K, device=dev)[None, :]
    idx = (w_off[:, None] + kk).clamp(0, dump - 1)
    locs = torch.where(kk < counts[:, None], flat[idx], PAD)
    return torch.sort(locs, 1).values, counts.to(torch.int32)


def extract_read_candidates(ops: torch.Tensor, lens: torch.Tensor,
                            pos: torch.Tensor, n_ops: torch.Tensor,
                            kind: torch.Tensor, inter_start: torch.Tensor,
                            inter_end: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-read candidate positions (svtrek_tpu's function): `walk_runs`
    of the padded layout.

    ops [N, O] int8 BAM op codes (columns at or past n_ops are padding),
    lens [N, O] int32, pos [N] int32 0-based alignment start, n_ops [N]
    int32 (0 = padding read), kind [N] int32 task kind per read (KIND_*),
    inter_start / inter_end [N] int32 interval bounds (1-based, as passed).
    Returns (cand [N, O+1] int32 with PAD sentinels, count [N] int32);
    column O holds the (at most one) soft-clip candidate."""
    N, O = ops.shape
    op_cand, op_mask, clip, clip_ok, _ = walk_runs(
        ops.reshape(-1), lens.reshape(-1), pos, n_ops, kind, inter_start,
        inter_end, width=O)
    cand = torch.cat([op_cand.view(N, O), clip[:, None]], 1)
    count = op_mask.view(N, O).sum(1, dtype=torch.int32) + \
        clip_ok.to(torch.int32)
    return cand, count


def group_candidates_by_window(cand: torch.Tensor, window_id: torch.Tensor,
                               num_windows: int, K: int, read_cap: int = 8
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """svtrek_tpu's grouping of per-read candidate rows: `group_walk` of
    the first ``read_cap`` candidates of each row.

    cand [N, Cw] int32 with PAD padding; window_id [N] (>= num_windows is
    a padding read), reads contiguous by window as for group_walk.

    Returns (locs [B, K] int32 sorted ascending with PAD padding, counts
    [B] int32 true per-window candidate counts, which may exceed K, ovf [B]
    bool: some read had more than `read_cap` candidates, so `locs` is
    incomplete)."""
    i32 = torch.int32
    N, Cw = cand.shape
    B = num_windows
    valid = (cand < PAD) & (window_id[:, None] < B)
    rank = torch.cumsum(valid, 1, dtype=i32)
    c_read = rank[:, -1]
    kept = torch.where(valid & (rank <= read_cap), cand, PAD)
    row = torch.arange(N, device=cand.device).repeat_interleave(Cw)
    locs, _ = group_walk(kept.reshape(-1), row,
                         torch.full((N,), PAD, dtype=i32, device=cand.device),
                         window_id, B, K)
    wid_c = window_id.to(torch.int64).clamp(max=B)
    counts = torch.zeros(B + 1, dtype=i32, device=cand.device).index_add_(
        0, wid_c, c_read)[:B]
    ovf = torch.zeros(B + 1, dtype=i32, device=cand.device).index_add_(
        0, wid_c, (c_read > read_cap).to(i32))[:B] > 0
    return locs, counts, ovf
