#!/usr/bin/env python
"""Independent scalar `scan`: BAM + region -> the scan mode's result lines.

A short restatement of the windowed INS discovery of `svtrek_tpu`'s scan
mode in plain Python, for holding a port's output to it (`chip_smoke.py`
holds the PyTorch port's to it on the card).  It shares no code with
`svtrek_tpu` or `svtrek_tpu_torch`; it builds on the benchmark's plain
reference, portbench/reference/audt_scalar.py:

- reads: audt_scalar's whole-BAM gzip decode; a tile's reads are those
  with pos < end and endpos > beg for beg = start - 1, end = tile end - 1
  in uint32 (the reference's region fetch, sliding_window.c:27), none when
  beg >= end;
- evidence: audt_scalar's refine_ins walk, the start position of every
  I op >= 50 bp the walk reaches before it passes the tile's end;
- the sliding-window rule of sliding_window.c:67-84 as
  svtrek_tpu/ops/window_scan.py:1-26 states it: tiles of `window` bp from
  start, the last one clipped at end; over a tile's sorted evidence,
  every `slide`-th anchor opens a cluster of the values <= anchor +
  window; the first anchor of the largest support >= min_count wins and
  reports (sum + support / 2) / support with the sum wrapping in int32
  and the division truncating, as C's int arithmetic does;
- the lines `INS Discovery in window [S, E] at position P with support
  N` for every tile with a hit, then `(SCAN INS) best position: P,
  support: N`, the first tile of the largest support.

    python tools/scan_scalar.py BAM CHROM START END [WINDOW [SLIDE]]

CHROM is numeric (tid = CHROM - 1); the reference's defaults hold
(min_count 3, window 1000, slide 1).
"""
from __future__ import annotations

import bisect
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "portbench", "reference"))

from audt_scalar import INS, MIN_COUNT, Bam, evidence, i32, u32  # noqa: E402


def _c_div(num: int, den: int) -> int:
    q = abs(num) // abs(den)
    return -q if (num < 0) != (den < 0) else q


def window_scan(locs, min_count: int = MIN_COUNT, window: int = 1000,
                slide: int = 1) -> tuple[int, int]:
    """(best position or -1, support or 0) of one tile's evidence."""
    a = sorted(locs)
    best, best_sup = -1, 0
    for i in range(0, len(a), slide):
        j = bisect.bisect_right(a, a[i] + window)
        sup = j - i
        if sup >= min_count and sup > best_sup:
            best_sup = sup
            best = _c_div(i32(sum(a[i:j]) + sup // 2), sup)
    return best, best_sup


class TileReads:
    """A Bam's reads of one tid, fetched by region with the longest read's
    span bounding the search."""

    def __init__(self, bam: Bam, tid: int):
        self.starts, self.ends, self.reads = bam.reads.get(
            tid, (np.empty(0, np.int64), np.empty(0, np.int64), []))
        self.span = int((self.ends - self.starts).max()) if len(
            self.reads) else 0

    def fetch(self, beg: int, end: int):
        if beg >= end or not len(self.reads):
            return []
        lo = int(np.searchsorted(self.starts, beg - self.span, "right"))
        hi = int(np.searchsorted(self.starts, end, "left"))
        return [self.reads[lo + i]
                for i in np.flatnonzero(self.ends[lo:hi] > beg)]


def scan_lines(bam_path: str, chrom: int, start: int, end: int,
               window: int = 1000, slide: int = 1,
               min_count: int = MIN_COUNT) -> list[str]:
    reads = TileReads(Bam(bam_path), chrom - 1)
    lines = []
    best, best_sup = -1, 0
    s = u32(start)
    while s < u32(end):
        e = min(u32(s + window), u32(end))
        locs = [c for rpos, _, ops, lens in reads.fetch(u32(s - 1),
                                                       u32(e - 1))
                for c in evidence(INS, rpos, ops, lens, s, e)]
        bp, sup = window_scan(locs, min_count, window, slide)
        if bp != -1:
            lines.append(f"INS Discovery in window [{s}, {e}] at position "
                         f"{bp} with support {sup}")
            if sup > best_sup:
                best, best_sup = bp, sup
        s = u32(s + window)
    lines.append(f"(SCAN INS) best position: {best}, support: {best_sup}")
    return lines


if __name__ == "__main__":
    if not 5 <= len(sys.argv) <= 7:
        sys.exit("usage: scan_scalar.py BAM CHROM START END [WINDOW [SLIDE]]")
    print("\n".join(scan_lines(sys.argv[1], *map(int, sys.argv[2:]))))
