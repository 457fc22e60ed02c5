"""Batched sliding-window INS cluster scan (scan mode).

Port of svtrek_tpu/ops/window_scan.py::window_scan_batch, the reference's
dead sliding-window insertion discovery made a feature
(sliding_window.c:8-97).  Over each row's sorted evidence, anchors every
``slide_size`` indices open a cluster [anchor, last value <= anchor value
+ window_size] (sliding_window.c:70-75); the best-supported anchor
(ascending scan, strictly-greater updates, support >= min_count;
sliding_window.c:76-83) wins and reports the rounded cluster mean.

The JAX function is an XLA program, not a Pallas kernel, so this is plain
PyTorch on the tensors' device, bit-identical to it: the C sums the mean
in a plain ``int`` (sliding_window.c:78-82), so the prefix sums wrap in
int32 (summed in int64, wrapped explicitly), the division truncates toward
zero as C's does (`rounding_mode="trunc"`, never `//`), and the winner is
the first anchor of maximal support.
"""
from __future__ import annotations

import torch

from .. import constants as C

from .sweep import wrap_i32

_I32_BIG = 0x7FFFFFFF

# Calls of window_scan_batch by the device type of its tensors.
scan_calls: dict[str, int] = {"cuda": 0, "cpu": 0}


def window_scan_batch(locs: torch.Tensor, n: torch.Tensor, *,
                      min_count: int = C.CONSENSUS_MIN_COUNT,
                      window_size: int = 1000, slide_size: int = 1
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """locs [B, K] int32 sorted ascending with INT32_MAX padding, n [B]
    valid counts.  Returns (best_pos [B] int32 with -1 = no hit,
    best_support [B] int32, 0 when no hit): the per-sub-window candidate and
    support of sliding_window.c:67-84."""
    dev = locs.device
    scan_calls[dev.type] = scan_calls.get(dev.type, 0) + 1
    i64 = torch.int64
    B, K = locs.shape
    locs = locs.to(i64)
    n = n.to(i64)[:, None]
    idx = torch.arange(K, device=dev)[None, :]

    # Wrapping int32 prefix sums (C sums into int; sliding_window.c:78-81).
    masked = torch.where(locs >= _I32_BIG, 0, locs)
    prefix = torch.cat([torch.zeros((B, 1), dtype=i64, device=dev),
                        wrap_i32(torch.cumsum(masked, 1))], 1)

    # Cluster end per anchor: the first index whose value exceeds
    # locs[i] + window_size (sliding_window.c:72-74); on a sorted row the
    # right search counts every value <= the bound.
    q = torch.where(locs >= _I32_BIG - window_size, locs, locs + window_size)
    end = torch.minimum(torch.searchsorted(locs, q, right=True), n)
    support = end - idx

    eligible = (idx < n) & (idx % slide_size == 0) & (support >= min_count)
    sup_m = torch.where(eligible, support, 0)
    best_support = sup_m.amax(1)
    # The ascending scan with strictly-greater updates keeps the FIRST
    # anchor of maximal support (sliding_window.c:76).
    best_anchor = torch.where(sup_m == best_support[:, None], idx, K).amin(1)

    a1 = best_anchor[:, None]
    ssum = prefix.gather(1, end.gather(1, a1)) - prefix.gather(1, a1)
    sup = best_support.clamp(min=1)
    # (sum + support/2) / support with C int semantics: wrapping sum,
    # truncating division (sliding_window.c:82).
    cand = torch.div(wrap_i32(ssum[:, 0] + sup // 2), sup,
                     rounding_mode="trunc")

    hit = best_support > 0
    return (torch.where(hit, cand, -1).to(torch.int32),
            torch.where(hit, best_support, 0).to(torch.int32))
