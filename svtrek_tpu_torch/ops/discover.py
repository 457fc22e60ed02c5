"""Batched run-length SV scan for disc mode.

Port of svtrek_tpu/ops/discover.py: `scan_projected_runs`, its on-device
compaction `scan_projected_runs_compact` and the flat-CSR feed
`scan_projected_runs_compact_csr`.  The JAX functions are XLA programs, not
Pallas kernels, so these are plain PyTorch ops that run on the tensors'
device (the card on `--device cuda`).  Every returned array equals the JAX
one bit for bit, the filler past `total` included: the coordinates wrap
in int32 as JAX's int32 cumsum does, and the compaction keeps the first
`cap` hits in row-major order as JAX's `top_k` does, and a later page
(`first`) the hits that follow in the same order.  Nothing here reads a
value back to the host, so a caller can keep several batches in flight.
"""
from __future__ import annotations

import torch

from ..constants import (
    CIGAR_D, CIGAR_EQ, CIGAR_I, CIGAR_M, CIGAR_S, CIGAR_X,
)

from .audit_step import csr_to_padded

BP_NONE, BP_INS, BP_DEL, BP_CLIP = 0, 1, 2, 3

# Calls of scan_projected_runs_compact by the device type of its tensors.
scan_calls: dict[str, int] = {"cuda": 0, "cpu": 0}


def scan_projected_runs(ops: torch.Tensor, lens: torch.Tensor,
                        n_runs: torch.Tensor, ref_start: torch.Tensor, *,
                        min_len: int = 50
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ops [N, O] int8 run op codes (9 = padding), lens [N, O] int32,
    n_runs [N] int32, ref_start [N] int32 backbone coordinate of the first
    reference op.  Returns (bp_type, ref_pos, read_pos), each [N, O] int32:
    bp_type is BP_NONE except where a run is an INS/DEL >= min_len or a
    leading/trailing soft clip >= min_len; ref_pos/read_pos are the 0-based
    backbone / normalized-read offsets of each run's start, wrapped to
    int32."""
    N, O = ops.shape
    i32 = torch.int32
    col = torch.arange(O, dtype=i32, device=ops.device)[None, :]
    n = n_runs.to(i32)[:, None]
    real = col < n
    op = ops.to(i32)
    ln = lens.to(i32)

    is_ref = (op == CIGAR_M) | (op == CIGAR_D) | (op == CIGAR_EQ) | \
        (op == CIGAR_X)
    is_que = (op == CIGAR_M) | (op == CIGAR_I) | (op == CIGAR_S) | \
        (op == CIGAR_EQ) | (op == CIGAR_X)

    zero = torch.zeros((), dtype=i32, device=ops.device)
    ref_adv = torch.where(real & is_ref, ln, zero)
    que_adv = torch.where(real & is_que, ln, zero)
    # torch.cumsum of int32 is int64; the JAX program wraps in int32, and
    # the int64 sum cut back to int32 is the same value modulo 2^32.
    ref_pos = (ref_start.to(torch.int64)[:, None]
               + torch.cumsum(ref_adv, 1) - ref_adv).to(i32)
    read_pos = (torch.cumsum(que_adv, 1) - que_adv).to(i32)

    big = real & (ln >= min_len)
    edge = (col == 0) | (col == n - 1)
    bp_type = torch.where(
        big & (op == CIGAR_I), BP_INS,
        torch.where(big & (op == CIGAR_D), BP_DEL,
                    torch.where(big & (op == CIGAR_S) & edge, BP_CLIP,
                                BP_NONE))).to(i32)
    return bp_type, ref_pos, read_pos


def scan_projected_runs_compact(ops: torch.Tensor, lens: torch.Tensor,
                                n_runs: torch.Tensor, ref_start: torch.Tensor,
                                *, min_len: int = 50, cap: int = 2048,
                                first: int = 0) -> tuple[torch.Tensor, ...]:
    """scan_projected_runs and on-device compaction of its sparse hits.

    Returns (total [] int32, row, bp_type, ref_pos, read_pos, length), each
    selection array [cap] int32 in row-major (read, run) order: the hits
    of rank ``first`` to ``first + cap - 1`` of the batch's row-major
    ranking, so pages laid end to end equal one page of their total size.
    Slots past the last hit hold row -1, type 0 and the coordinates and
    length of the last cell, N*O-1, as the JAX program's clamped gather
    gives them.  total > first + cap means the caller needs a further page
    (the JAX package rescans the batch on the host).

    The page's hits are selected by rank: an exclusive cumsum of the hit
    mask, then a scatter of the hits whose rank falls in the page into a
    buffer prefilled with N*O.  With ``first`` 0, slots past min(cap, N*O)
    keep N*O, as the JAX program pads its top_k of cap_eff = min(cap,
    N*O)."""
    scan_calls[ops.device.type] = scan_calls.get(ops.device.type, 0) + 1
    bp_type, ref_pos, read_pos = scan_projected_runs(
        ops, lens, n_runs, ref_start, min_len=min_len)
    N, O = ops.shape
    NO = N * O
    dev = ops.device
    flat_t = bp_type.reshape(-1)
    hit = flat_t > 0
    hit64 = hit.to(torch.int64)
    total = hit64.sum().to(torch.int32)
    rank = torch.cumsum(hit64, 0) - hit64
    idx = torch.arange(NO, dtype=torch.int64, device=dev)
    page = rank - first
    dest = torch.where(hit & (page >= 0) & (page < cap), page, cap)
    sel = torch.full((cap + 1,), NO, dtype=torch.int64, device=dev)
    sel.scatter_(0, dest, idx)
    sel = sel[:cap]
    valid = sel < NO
    sel_c = sel.clamp(max=NO - 1)
    i32 = torch.int32
    return (
        total,
        torch.where(valid, sel_c // O, -1).to(i32),
        torch.where(valid, flat_t[sel_c], 0).to(i32),
        ref_pos.reshape(-1)[sel_c],
        read_pos.reshape(-1)[sel_c],
        lens.to(i32).reshape(-1)[sel_c],
    )


def scan_projected_runs_compact_csr(ops_flat: torch.Tensor,
                                    lens_flat: torch.Tensor,
                                    n_runs: torch.Tensor,
                                    ref_start: torch.Tensor, *, O: int,
                                    min_len: int = 50, cap: int = 2048,
                                    first: int = 0
                                    ) -> tuple[torch.Tensor, ...]:
    """scan_projected_runs_compact fed the flat CSR layout of the C GAF
    projector: ops_flat [T] int8, lens_flat [T] int32, n_runs [N] int32
    (sum <= T), ref_start [N] int32.  The device scatters the runs into
    the padded [N, O] layout itself (`csr_to_padded`); unwritten cells are
    op 0 / len 0, which the scan masks by n_runs, so the result equals the
    padded path's."""
    ops, lens = csr_to_padded(ops_flat, lens_flat, n_runs, O=O)
    return scan_projected_runs_compact(ops, lens, n_runs, ref_start,
                                       min_len=min_len, cap=cap, first=first)
