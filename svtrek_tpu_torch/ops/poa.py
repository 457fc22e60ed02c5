"""Host half of the star-MSA consensus for insertion clusters.

A JAX-free copy of svtrek_tpu/ops/poa.py's host functions: importing that
module runs svtrek_tpu/ops/__init__.py, which imports every JAX op, and the
machine with the card has no JAX (ROADMAP queue 1 item 12 removes the
copy).  Held equal to the original by tests/test_torch_poa.py.

The algorithm (see svtrek_tpu/ops/poa.py for the whole story): pick the
majority length mode of the members, align every member to the mode's
length-medoid with a banded global DP that also collects the query bases
inserted at each column boundary, vote per column and per boundary, and
realign to the new consensus until it stops changing.  `banded_align_ins`
is the scalar DP, used here for the pairs whose band is too wide for the
batched path (ops/poa_batch.py); the vote is `ops.poa_dp.vote`.
"""
from __future__ import annotations

import numpy as np

_BASES = "ACGTN-"
# Byte -> base code: A C G T (either case) = 0..3, anything else 4 (N).
_ENC = np.full(256, 4, np.int8)
for _i, _c in enumerate("ACGT"):
    _ENC[ord(_c)] = _ENC[ord(_c.lower())] = _i
_DEC = np.frombuffer(_BASES.encode(), np.uint8)

MATCH = 2
MISMATCH = -4
GAP = -2


def encode(seq: str) -> np.ndarray:
    return _ENC[np.frombuffer(seq.encode("ascii", "replace"), np.uint8)]


def decode(codes: np.ndarray) -> str:
    """Base codes 0..5 back to "ACGTN-" text."""
    return _DEC[codes].tobytes().decode("ascii")


def banded_align_ins(target: np.ndarray, query: np.ndarray, band: int):
    """Global banded alignment; returns (cols, ins) where cols is the
    per-target-column query base (-1 = gap) and ins[j] is the encoded
    query segment inserted before target column j (j in 0..m).
    O(len(t)·band) cells."""
    cols, ptr, n, m = _banded_dp(target, query, band)
    ins: list[list[int]] = [[] for _ in range(m + 1)]
    i, j = n, m
    while i > 0 or j > 0:
        p = ptr[i, j]
        if i > 0 and j > 0 and p == 0:
            cols[j - 1] = query[i - 1]
            i -= 1
            j -= 1
        elif i > 0 and p == 1:
            ins[j].append(int(query[i - 1]))
            i -= 1
        else:
            j -= 1
    for seg in ins:
        seg.reverse()
    return cols, ins


def _banded_dp(target: np.ndarray, query: np.ndarray, band: int):
    """Shared DP fill; returns (cols placeholder, ptr, n, m)."""
    n, m = len(query), len(target)
    band = max(band, abs(n - m) + 1)
    NEG = -(10 ** 9)
    # score[i, j] over query i 0..n, target j 0..m, banded |i-j| <= band
    score = np.full((n + 1, m + 1), NEG, np.int64)
    ptr = np.zeros((n + 1, m + 1), np.int8)  # 0 diag, 1 up (insert), 2 left
    score[0, : min(m, band) + 1] = GAP * np.arange(min(m, band) + 1)
    ptr[0, :] = 2
    for i in range(1, n + 1):
        lo = max(1, i - band)
        hi = min(m, i + band)
        if i - band <= 0:
            score[i, 0] = GAP * i
            ptr[i, 0] = 1
        qi = query[i - 1]
        for j in range(lo, hi + 1):
            sub = MATCH if qi == target[j - 1] else MISMATCH
            best = score[i - 1, j - 1] + sub
            p = 0
            up = score[i - 1, j] + GAP
            if up > best:
                best, p = up, 1
            left = score[i, j - 1] + GAP
            if left > best:
                best, p = left, 2
            score[i, j] = best
            ptr[i, j] = p
    cols = np.full(m, -1, np.int8)
    return cols, ptr, n, m


def majority_length_mode(seqs: list[str]) -> list[str]:
    """Single-linkage cluster member lengths (link when consecutive
    sorted lengths differ by <= max(10, 10% of the shorter)); return the
    members of the largest cluster."""
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    clusters: list[list[int]] = [[order[0]]]
    for prev, cur in zip(order, order[1:]):
        lp, lc = len(seqs[prev]), len(seqs[cur])
        if lc - lp <= max(10, lp // 10):
            clusters[-1].append(cur)
        else:
            clusters.append([cur])
    best = max(clusters, key=len)
    return [seqs[i] for i in sorted(best)]


def decode_ins(ins: list[list[int]]) -> list[str]:
    return [decode(np.asarray(seg, np.int64)) for seg in ins]
