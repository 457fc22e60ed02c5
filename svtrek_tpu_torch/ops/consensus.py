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

`consensus_pos_full` is the second pass of a window past a first pass's
width: the same consensus at ``sweep_width = K``, where neither sweep can
overflow (``point_l - (K-1) > 0`` and ``point_r + (K-1) < n-1`` are both
false for ``point_l, point_r < n <= K``).  On the card it is K1 at W = K
(K <= kernels.CONSENSUS_MAX_K); its plain version finds the clusters as
K1 does, by searches on the sorted row and differences of int64 prefix
sums, a few rows at a time, so that its memory stays bounded at K =
16,384.
"""
from __future__ import annotations

import torch

from .. import constants as C

from .sweep import abs_i32, sweep_fold, wrap_i32

_I32_BIG = 0x7FFFFFFF
_CHUNK = 2048
# The full sweep's plain version takes rows in blocks of at most
# _FULL_BLOCK // K rows, so that each [rows, K] int64 tensor it holds
# stays at 4 MiB.
_FULL_BLOCK = 1 << 19

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


def _sweep_anchors(locs32, locs, n, pos, W: int, range_: int):
    """Both sweeps' anchors (refinement.c:56-57, 78-79): for each side
    (clamped anchor index [B, W], anchor value [B, W], active [B, W],
    overflow [B]), active being the cumulative AND of the in-row and
    in-range tests."""
    B, K = locs.shape
    dev = locs.device
    half = C.SV_MIN_LENGTH // 2
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
    return ((idx_l_c, loc_at_l, active_l, ovf_l),
            (idx_r_c, loc_at_r, active_r, ovf_r))


def _finish(out, overflow, n, min_count: int):
    """NA for rows with too few candidates; their overflow flags drop."""
    invalid = (n < min_count) | (n <= 0)
    out = torch.where(invalid, torch.full_like(out, -1), out)
    return out, overflow & ~invalid


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
    K = locs.shape[1]
    locs32 = locs.to(torch.int32).contiguous()
    locs = locs32.long()
    n = n.long()
    pos = pos.long()
    (idx_l, loc_l, active_l, ovf_l), (idx_r, loc_r, active_r, ovf_r) = \
        _sweep_anchors(locs32, locs, n, pos, min(sweep_width, K), range_)
    cand_l, count_l, _, _ = _anchor_stats(locs, n, idx_l, loc_l, interval)
    _, _, cand_r, count_r = _anchor_stats(locs, n, idx_r, loc_r, interval)
    out = sweep_fold(pos, cand_l, count_l, active_l, cand_r, count_r,
                     active_r, min_count=min_count, interval=interval)
    return _finish(out, ovf_l | ovf_r, n, min_count)


def _cluster_sorted(locs32, prefix, n, anchor_idx, loc_a, interval: int,
                    left: bool):
    """`_anchor_stats` of one side, on the sorted row: the left cluster
    of anchor i is [lower_bound(L - interval), i], the right one [i,
    min(upper_bound(L + interval), n)), and a cluster's total is a
    difference of the row's int64 prefix sums (K1's form).  Returns
    (candidate, count), [B, W] int64."""
    near_max = loc_a >= _I32_BIG - interval
    if left:
        bound = torch.where(near_max, loc_a, wrap_i32(loc_a - interval))
        first = torch.searchsorted(locs32, bound.to(torch.int32).contiguous())
        first = torch.minimum(first, anchor_idx + 1)
        count = anchor_idx + 1 - first
        s = count * loc_a - (prefix.gather(1, anchor_idx + 1) -
                             prefix.gather(1, first))
        return wrap_i32(loc_a + torch.div(count // 2 - s, count.clamp(min=1),
                                          rounding_mode="floor")), count
    bound = torch.where(near_max, loc_a, wrap_i32(loc_a + interval))
    end = torch.searchsorted(locs32, bound.to(torch.int32).contiguous(),
                             right=True)
    end = torch.maximum(torch.minimum(end, n[:, None]), anchor_idx)
    count = end - anchor_idx
    s = prefix.gather(1, end) - prefix.gather(1, anchor_idx) - \
        count * loc_a
    cr = count.clamp(min=1)
    return wrap_i32(loc_a + torch.div(s + cr // 2, cr,
                                      rounding_mode="floor")), count


def _full_rows(locs32, n, pos, *, min_count: int, interval: int,
               range_: int):
    """The full sweep of one block of rows (`consensus_pos_full_reference`).
    Anchors past a side's last active one change nothing, so the clusters
    and the fold take only the columns some row's sweep reaches."""
    locs = locs32.long()
    (idx_l, loc_l, active_l, ovf_l), (idx_r, loc_r, active_r, ovf_r) = \
        _sweep_anchors(locs32, locs, n, pos, locs.shape[1], range_)
    reach = max(int(torch.maximum(active_l.sum(1), active_r.sum(1)).max()),
                1)
    idx_l, loc_l, active_l, idx_r, loc_r, active_r = (
        x[:, :reach] for x in (idx_l, loc_l, active_l, idx_r, loc_r,
                               active_r))
    prefix = torch.nn.functional.pad(torch.cumsum(locs, 1), (1, 0))
    cand_l, count_l = _cluster_sorted(locs32, prefix, n, idx_l, loc_l,
                                      interval, True)
    cand_r, count_r = _cluster_sorted(locs32, prefix, n, idx_r, loc_r,
                                      interval, False)
    out = sweep_fold(pos, cand_l, count_l, active_l, cand_r, count_r,
                     active_r, min_count=min_count, interval=interval)
    return _finish(out, ovf_l | ovf_r, n, min_count)


def consensus_pos_full_reference(
    locs: torch.Tensor,
    n: torch.Tensor,
    pos: torch.Tensor,
    *,
    min_count: int = C.CONSENSUS_MIN_COUNT,
    interval: int = C.CONSENSUS_INTERVAL,
    range_: int = C.CONSENSUS_INTERVAL_RANGE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch `consensus_pos_full`: consensus_pos_batch_reference at
    sweep_width = K, equal to it on every row, in bounded memory.

    Rows go in blocks of b = max(1, 2**19 // K), and a block holds no
    [b, W, *] tensor: its anchors, their cluster bounds, counts, sums and
    candidates are [b, K] tensors of at most 2**19 int64 values (4 MiB)
    each, so the peak is a block's, whatever B: near 120 MiB (112-118 MiB
    of resident growth measured on a CPU at (32, 16,384) and (128,
    4,096)), under 256 MiB at any B <= 512 and K <= 16,384.  The overflow
    flags it returns are all false."""
    B, K = locs.shape
    locs32 = locs.to(torch.int32).contiguous()
    n, pos = n.long(), pos.long()
    rows = max(1, _FULL_BLOCK // K)
    parts = [_full_rows(locs32[i:i + rows], n[i:i + rows], pos[i:i + rows],
                        min_count=min_count, interval=interval,
                        range_=range_)
             for i in range(0, B, rows)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


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


def consensus_pos_full(
    locs: torch.Tensor,
    n: torch.Tensor,
    pos: torch.Tensor,
    *,
    min_count: int = C.CONSENSUS_MIN_COUNT,
    interval: int = C.CONSENSUS_INTERVAL,
    range_: int = C.CONSENSUS_INTERVAL_RANGE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """consensus_pos_batch at sweep_width = K, on the tensors' device: K1
    at W = K for CUDA tensors (K <= kernels.CONSENSUS_MAX_K), the bounded
    plain version for CPU tensors.  No row's sweep can overflow, so every
    refined value is final."""
    kw = dict(min_count=min_count, interval=interval, range_=range_)
    if locs.device.type == "cuda":
        from ..kernels import consensus_pos_cuda

        return consensus_pos_cuda(locs, n, pos, sweep_width=locs.shape[1],
                                  **kw)
    if locs.device.type != "cpu":
        raise ValueError(f"no consensus_pos path for device {locs.device}")
    plain_calls["consensus_pos"] += 1
    return consensus_pos_full_reference(locs, n, pos, **kw)
