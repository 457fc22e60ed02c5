"""The consensus sweeps as a plain PyTorch fold (refinement.c:58-100).

The plain counterpart of the TPU kernel svtrek_tpu/ops/sweep_pallas.py
(`sweep_fold_pallas`) and of `svtrek_tpu.ops.consensus._sweep_scan`: a
Python loop over the W anchor steps of [B] elementwise ops.  On the card
the whole consensus, this fold included, is kernel K1
(csrc/consensus.cu); this version serves CPU tensors and is what K1 is
checked against.

Values are carried in int64 holding int32 values, and every difference is
wrapped back to int32, so the fold sees the same numbers as the int32 XLA
program.
"""
from __future__ import annotations

import torch

_BIG = 0x7FFFFFFF  # C int distance sentinel (refinement.c:49)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Reduce an int64 tensor to the int32 value two's-complement wrap gives
    (still int64)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def abs_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 abs of an int32 value held in int64: |INT32_MIN| wraps to
    INT32_MIN, as in XLA."""
    return wrap_i32(x.abs())


def _fold(pos, cand, count, active, allow, min_count: int, interval: int):
    """One sweep direction (refinement.c:58-76 / 80-98).  pos/allow [B];
    cand/count/active [B, W].  Returns (returned, ret_val, best_val,
    best_dist), each [B]."""
    B, W = cand.shape
    max_count = torch.full((B,), min_count - 1, dtype=torch.int64,
                           device=pos.device)
    best_dist = torch.full_like(max_count, _BIG)
    best_val = torch.full_like(max_count, -1)
    ret_val = torch.full_like(max_count, -1)
    returned = torch.zeros(B, dtype=torch.bool, device=pos.device)
    dist = abs_i32(wrap_i32(pos[:, None] - cand))
    for k in range(W):
        c_k, n_k, d_k = cand[:, k], count[:, k], dist[:, k]
        live = active[:, k] & allow & ~returned
        bigger = live & (n_k > max_count)
        ret_now = bigger & (d_k < interval)           # refinement.c:68-69
        upd = bigger & ~ret_now & (d_k < best_dist)   # refinement.c:70-74
        returned = returned | ret_now
        ret_val = torch.where(ret_now, c_k, ret_val)
        max_count = torch.where(upd, n_k, max_count)
        best_val = torch.where(upd, c_k, best_val)
        best_dist = torch.where(upd, d_k, best_dist)
    return returned, ret_val, best_val, best_dist


def sweep_fold(pos: torch.Tensor, cand_l: torch.Tensor, count_l: torch.Tensor,
               act_l: torch.Tensor, cand_r: torch.Tensor,
               count_r: torch.Tensor, act_r: torch.Tensor, *, min_count: int,
               interval: int) -> torch.Tensor:
    """Both sweeps and the final pick; the signature of
    `sweep_fold_pallas`.  pos [B]; the rest [B, W].  Returns refined [B]
    int32, before the invalid-count mask."""
    pos = pos.long()
    cand_l, count_l, cand_r, count_r = (
        x.long() for x in (cand_l, count_l, cand_r, count_r))
    act_l, act_r = act_l.bool(), act_r.bool()
    always = torch.ones(pos.shape, dtype=torch.bool, device=pos.device)
    ret_l, retv_l, best_l, dist_l = _fold(
        pos, cand_l, count_l, act_l, always, min_count, interval)
    # The right sweep runs only if the left did not return (the C returns
    # out of consensus_pos; refinement.c:68-69).
    ret_r, retv_r, best_r, dist_r = _fold(
        pos, cand_r, count_r, act_r, ~ret_l, min_count, interval)
    # Left wins only on a strictly smaller distance (refinement.c:100).
    final = torch.where(dist_l < dist_r, best_l, best_r)
    out = torch.where(ret_l, retv_l, torch.where(ret_r, retv_r, final))
    return out.to(torch.int32)
