"""Batched position-clustering consensus (refinement.c:41-101).

Port of svtrek_tpu/ops/consensus.py::consensus_pos_batch.
`consensus_pos_batch` is the dispatch: a CUDA tensor goes to kernel K1
(csrc/consensus.cu, through `kernels.consensus_pos_cuda`), a CPU tensor to
`consensus_pos_batch_reference`, the plain PyTorch version.  The choice is
made by the tensor's device; there is no fallback from one to the other.

The plain version follows the JAX program step by step: searchsorted for
the sweep start points, gathers for the anchors, a masked reduce chunked
at 2048 for the cluster stats, and the fold of `ops.sweep`.  Its cluster
totals are int64 sums (the reference sums in uint64, refinement.c:59),
where the JAX program recovers them from wrapping int32 sums; both give
the same candidate at every anchor a sweep uses, and may differ at unused
padding anchors, which no output reads.
"""
from __future__ import annotations

import torch

from .. import constants as C

from .sweep import abs_i32, sweep_fold, wrap_i32

_I32_BIG = 0x7FFFFFFF
_CHUNK = 2048

# Calls of the plain version through `consensus_pos_batch` (the CPU route).
plain_calls: dict[str, int] = {"consensus_pos": 0}


def _cumulative_and(ok: torch.Tensor) -> torch.Tensor:
    return ok.to(torch.int32).cummin(dim=1).values.bool()


def _anchor_stats(locs, n, anchor_idx, loc_a, interval: int):
    """Cluster (candidate, count) at the anchors, one direction each.

    locs [B, K] int64, sorted rows; anchor_idx/loc_a [B, W] int64.  Left
    cluster of anchor i = {j <= i : locs[j] >= L - interval}, right =
    {i <= j < n : locs[j] <= L + interval} (refinement.c:61-64, 83-86).
    Anchors within `interval` of INT32_MAX are padding and keep the JAX
    program's clamped bounds (consensus.py:100-101)."""
    near_max = loc_a >= _I32_BIG - interval
    q_lo = torch.where(near_max, loc_a, wrap_i32(loc_a - interval))
    q_hi = torch.where(near_max, loc_a, wrap_i32(loc_a + interval))
    K = locs.shape[1]
    a3 = anchor_idx[:, :, None]
    zero = torch.zeros((), dtype=torch.int64, device=locs.device)
    count_l = sum_l = count_r = sum_r = zero
    for c0 in range(0, K, _CHUNK):
        c1 = min(c0 + _CHUNK, K)
        jidx = torch.arange(c0, c1, device=locs.device)[None, None, :]
        lrow = locs[:, None, c0:c1]
        in_l = (jidx <= a3) & (lrow >= q_lo[:, :, None])
        count_l = count_l + in_l.sum(2)
        sum_l = sum_l + torch.where(in_l, lrow, zero).sum(2)
        in_r = (jidx >= a3) & (jidx < n[:, None, None]) & \
            (lrow <= q_hi[:, :, None])
        count_r = count_r + in_r.sum(2)
        sum_r = sum_r + torch.where(in_r, lrow, zero).sum(2)

    # Rounded cluster mean floor((total + count/2) / count), written around
    # the anchor as in consensus.py:126-131.
    s_l = count_l * loc_a - sum_l
    cand_l = wrap_i32(loc_a + torch.div(count_l // 2 - s_l,
                                        count_l.clamp(min=1),
                                        rounding_mode="floor"))
    s_r = sum_r - count_r * loc_a
    cr = count_r.clamp(min=1)
    cand_r = wrap_i32(loc_a + torch.div(s_r + cr // 2, cr,
                                        rounding_mode="floor"))
    return cand_l, count_l, cand_r, count_r


def consensus_pos_batch_reference(
    locs: torch.Tensor,
    n: torch.Tensor,
    pos: torch.Tensor,
    *,
    min_count: int = C.CONSENSUS_MIN_COUNT,
    interval: int = C.CONSENSUS_INTERVAL,
    range_: int = C.CONSENSUS_INTERVAL_RANGE,
    sweep_width: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch consensus_pos_batch.

    locs [B, K] int32 sorted ascending per row, INT32_MAX padding; n [B]
    valid counts (<= K); pos [B] imprecise positions.  Returns (refined [B]
    int32 with -1 = NA, overflow [B] bool: the sweep window was exceeded,
    recompute those rows on the host)."""
    B, K = locs.shape
    dev = locs.device
    locs32 = locs.to(torch.int32).contiguous()
    locs = locs32.long()
    n = n.long()
    pos = pos.long()
    half = C.SV_MIN_LENGTH // 2
    W = min(sweep_width, K)
    k_idx = torch.arange(W, device=dev)[None, :]
    last = (n - 1).clamp(min=0)

    # point = lower_bound(locs, pos + 25): last index <= query, clamped
    # (refinement.c:3-10, 56).
    q = wrap_i32(pos + half).to(torch.int32)[:, None].contiguous()
    sr = torch.searchsorted(locs32, q, right=True)[:, 0]
    point_l = torch.minimum((sr - 1).clamp(min=0), last)

    idx_l = point_l[:, None] - k_idx                      # descending walk
    idx_l_c = idx_l.clamp(0, K - 1)
    loc_at_l = torch.gather(locs, 1, idx_l_c)
    ok_l = (idx_l >= 0) & (abs_i32(wrap_i32(pos[:, None] - loc_at_l)) < range_)
    active_l = _cumulative_and(ok_l)
    ovf_l = active_l[:, -1] & (point_l - (W - 1) > 0)

    # point = upper_bound(locs, pos - 25): 0 if locs[0] < query else n-1
    # (refinement.c:12-19, 78) — the reference's quirk.
    point_r = torch.where(locs[:, 0] < wrap_i32(pos - half),
                          torch.zeros_like(last), last)
    idx_r = point_r[:, None] + k_idx                      # ascending walk
    idx_r_c = idx_r.clamp(0, K - 1)
    loc_at_r = torch.gather(locs, 1, idx_r_c)
    ok_r = (idx_r < n[:, None]) & \
        (abs_i32(wrap_i32(pos[:, None] - loc_at_r)) < range_)
    active_r = _cumulative_and(ok_r)
    ovf_r = active_r[:, -1] & (point_r + (W - 1) < n - 1)

    cand_l, count_l, _, _ = _anchor_stats(locs, n, idx_l_c, loc_at_l,
                                          interval)
    _, _, cand_r, count_r = _anchor_stats(locs, n, idx_r_c, loc_at_r,
                                          interval)
    out = sweep_fold(pos, cand_l, count_l, active_l, cand_r, count_r,
                     active_r, min_count=min_count, interval=interval)

    invalid = (n < min_count) | (n <= 0)
    out = torch.where(invalid, torch.full_like(out, -1), out)
    return out, (ovf_l | ovf_r) & ~invalid


def consensus_pos_batch(
    locs: torch.Tensor,
    n: torch.Tensor,
    pos: torch.Tensor,
    *,
    min_count: int = C.CONSENSUS_MIN_COUNT,
    interval: int = C.CONSENSUS_INTERVAL,
    range_: int = C.CONSENSUS_INTERVAL_RANGE,
    sweep_width: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched consensus_pos on the tensors' device: kernel K1 for CUDA
    tensors, the plain version for CPU tensors.  Same contract as
    `consensus_pos_batch_reference`."""
    kw = dict(min_count=min_count, interval=interval, range_=range_,
              sweep_width=sweep_width)
    if locs.device.type == "cuda":
        from ..kernels import consensus_pos_cuda

        return consensus_pos_cuda(locs, n, pos, **kw)
    if locs.device.type != "cpu":
        raise ValueError(f"no consensus_pos path for device {locs.device}")
    plain_calls["consensus_pos"] += 1
    return consensus_pos_batch_reference(locs, n, pos, **kw)
