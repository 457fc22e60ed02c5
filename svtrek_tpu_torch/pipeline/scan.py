"""`scan` mode: windowed INS discovery over a BAM region, the device steps
in PyTorch.

Port of svtrek_tpu/pipeline/scan.py, the reference's dead sliding-window
discovery made a mode (sliding_window.c:8-97).  [start, end) is tiled into
``window_size``-wide sub-windows, one batch row each, and each tile's
reads are those of the reference's region fetch (tid = chrom-1, 1-based
bounds, sliding_window.c:27).  Two paths, as in the JAX package:

- native (the default): one C merged fetch and one C `extract_batch` per
  chunk of ``batch_windows`` tiles on a pool of ``thread_number`` workers,
  each with its own reader; the strided cluster scan
  (`ops.window_scan.window_scan_batch`) runs on the device with up to 3
  chunks in flight;
- `--no-native-io`: the Python reader fetches each tile, and the device
  runs the evidence walk (`ops.cigar.extract_read_candidates`, the
  refine_ins rule), the grouping and the scan.

Tiles whose evidence overflows the device capacity are scanned by the
scalar oracle, so no tile is approximate.  Output mirrors the reference's
per-window print (sliding_window.c:87) plus the JAX package's overall-best
summary line.
"""
from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import constants as C
from ..config import ScanConfig
from ..constants import KIND_INS
from ..device import resolve_device
from ..ops.audit_step import to_device
from ..ops.cigar import extract_read_candidates, group_candidates_by_window
from ..ops.window_scan import window_scan_batch
from ..oracle import extract_candidates, window_scan
from .audit import open_native_reader, open_reader, python_fetch, reader_tid
from .pack import PAD_OP, PackedReads, _fill_reads, as_packed


def _next_pow2(n: int, lo: int = 16) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def scan_tiles(cfg: ScanConfig) -> list[tuple[int, int]]:
    """[start, end) tiling: sub_start += window_size, last tile clipped
    (sliding_window.c:12-15)."""
    tiles = []
    s = C.u32(cfg.start)
    while s < C.u32(cfg.end):
        e = min(C.u32(s + cfg.window_size), C.u32(cfg.end))
        tiles.append((s, e))
        s = C.u32(s + cfg.window_size)
    return tiles


def resolve_scan_tid(cfg: ScanConfig, reader=None) -> int:
    """tid for the scan region: the reference's numeric tid = chrom-1
    (sliding_window.c:27 via refinement.c:114), or with --chrom-by-name
    the name resolved against the BAM header."""
    if cfg.chrom_by_name:
        return -1 if reader is None else reader_tid(reader, cfg.chrom_name)
    return cfg.chrom - 1


def _oracle_tile(reads, s: int, e: int, cfg: ScanConfig) -> tuple[int, int]:
    """The exact scalar scan of one tile's reads (the overflow fallback)."""
    return window_scan(extract_candidates(KIND_INS, reads, s, e),
                       cfg.consensus_min_count, cfg.window_size,
                       cfg.slide_size)


def _count(stats: dict | None, key: str, n: int = 1) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def run_scan_tiles(tiles: list[tuple[int, int]], fetch, cfg: ScanConfig,
                   tid: int | None = None, *,
                   device: torch.device = torch.device("cpu"),
                   stats: dict | None = None) -> list[tuple[int, int]]:
    """The scan over pre-built tiles, the evidence walk on ``device``.

    ``fetch(tid, beg, end)`` → [(pos, [(op, len), ...]), ...] or
    PackedReads.  Returns [(best_pos or -1, support)] per tile."""
    results: list[tuple[int, int]] = [(-1, 0)] * len(tiles)
    K = _next_pow2(min(cfg.max_candidates, 8192), 64)
    if tid is None:
        tid = cfg.chrom - 1

    for base in range(0, len(tiles), cfg.batch_windows):
        chunk = tiles[base:base + cfg.batch_windows]
        prs = [as_packed([] if tid < 0 else
                         fetch(tid, C.u32(s - 1), C.u32(e - 1)))
               for s, e in chunk]
        counts = np.fromiter((p.num_reads for p in prs), np.int64, len(prs))
        max_ops = max([1] + [p.max_ops for p in prs])
        B = len(chunk)
        O = _next_pow2(max_ops, 16)
        N = max(int(counts.sum()), 1)
        ops = np.full((N, O), PAD_OP, np.int8)
        lens = np.zeros((N, O), np.int32)
        pos = np.zeros(N, np.int32)
        n_ops = np.zeros(N, np.int32)
        wid = np.full(N, B, np.int32)
        _fill_reads(ops, lens, pos, n_ops, wid, prs,
                    np.cumsum(counts) - counts, np.arange(B), O)
        istart = np.array([s for s, _ in chunk], np.int64).astype(np.int32)
        iend = np.array([e for _, e in chunk], np.int64).astype(np.int32)
        wid_c = np.clip(wid, 0, B - 1)

        cand, _ = extract_read_candidates(
            to_device(ops, device, np.int8), to_device(lens, device),
            to_device(pos, device), to_device(n_ops, device),
            torch.full((N,), KIND_INS, dtype=torch.int32, device=device),
            to_device(istart[wid_c], device), to_device(iend[wid_c], device))
        locs, dcounts, read_ovf = group_candidates_by_window(
            cand, to_device(wid, device), B, K)
        best, support = window_scan_batch(
            locs, dcounts.clamp(max=K), min_count=cfg.consensus_min_count,
            window_size=cfg.window_size, slide_size=cfg.slide_size)
        best, support, dcounts, read_ovf = (
            x.cpu().numpy() for x in (best, support, dcounts, read_ovf))
        _count(stats, "batches")
        for b, (s, e) in enumerate(chunk):
            if read_ovf[b] or dcounts[b] > K:
                _count(stats, "fallbacks")
                results[base + b] = _oracle_tile(prs[b].to_list(), s, e, cfg)
            else:
                results[base + b] = (int(best[b]), int(support[b]))
    return results


def bounded_map(ex: ThreadPoolExecutor, fn, items, window: int):
    """ex.map with at most ``window`` futures outstanding, results in
    order.  When a call raises, or the consumer stops early, the futures
    not yet started are cancelled (a started one runs to its end)."""
    it = iter(items)
    pending = deque(ex.submit(fn, c) for c in itertools.islice(it, window))
    try:
        while pending:
            result = pending.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(ex.submit(fn, nxt))
            yield result
    finally:
        for fut in pending:
            fut.cancel()


def run_scan_tiles_native(tiles: list[tuple[int, int]], reader,
                          cfg: ScanConfig, tid: int | None = None,
                          make_reader=None, *,
                          device: torch.device = torch.device("cpu"),
                          stats: dict | None = None
                          ) -> list[tuple[int, int]]:
    """The scan over pre-built tiles with the host stages in C: one C
    merged fetch + one C extract_batch per chunk (GIL released
    throughout), the strided cluster scan batched on ``device``.  Tiles
    whose evidence overflows K are re-fetched and scanned by the scalar
    oracle.

    With ``make_reader``, the chunks' host stages run on a
    cfg.thread_number worker pool, one private reader per worker, while
    this thread scans completed chunks in order."""
    results: list[tuple[int, int]] = [(-1, 0)] * len(tiles)
    K = _next_pow2(min(cfg.max_candidates, 8192), 64)
    if tid is None:
        tid = cfg.chrom - 1
    chunks = [(base, tiles[base:base + cfg.batch_windows])
              for base in range(0, len(tiles), cfg.batch_windows)]

    def host_stage(chunk, rd):
        """Fetch + extract one chunk on reader `rd`; the reads of overflow
        tiles are fetched HERE (the handle belongs to this worker)."""
        n = len(chunk)
        tids = np.full(n, tid if tid >= 0 else -1, np.int32)
        begs = np.fromiter((int(C.u32(s - 1)) for s, _ in chunk),
                           np.int64, n)
        ends = np.fromiter((int(C.u32(e - 1)) for _, e in chunk),
                           np.int64, n)
        # Adjacent tiles merge into one region fetch per chunk (each read
        # decoded once; per-tile read sets identical).
        if cfg.merge_fetch_gap > 0:
            _, win_counts = rd.fetch_batch_merged(tids, begs, ends,
                                                  cfg.merge_fetch_gap)
        else:
            _, win_counts = rd.fetch_batch(tids, begs, ends)
        istart = np.fromiter((int(C.u32(s)) for s, _ in chunk), np.int64, n)
        iend = np.fromiter((int(C.u32(e)) for _, e in chunk), np.int64, n)
        locs, counts, _ = rd.extract_batch(
            np.full(n, KIND_INS, np.int32), istart, iend,
            np.zeros(n, np.int64), win_counts, K,
            cfg.consensus_min_count, cfg.consensus_interval,
            cfg.consensus_interval_range,
        )
        overflow = {int(b): rd.fetch_packed(int(tids[b]), int(begs[b]),
                                            int(ends[b]))
                    for b in np.nonzero(counts > K)[0]}
        return locs, counts, overflow

    n_workers = max(1, min(cfg.thread_number, len(chunks)))
    ex = None
    if n_workers > 1 and make_reader is not None:
        tls = threading.local()

        def work(chunk):
            if not hasattr(tls, "rd"):
                tls.rd = make_reader()
            return host_stage(chunk, tls.rd)

        ex = ThreadPoolExecutor(n_workers, thread_name_prefix="svtrek-scan")
        staged = bounded_map(ex, work, (c for _, c in chunks), n_workers + 2)
    else:
        staged = (host_stage(c, reader) for _, c in chunks)

    def apply(base, chunk, counts, overflow, best, support):
        best, support = best.cpu().numpy(), support.cpu().numpy()
        for b, (s, e) in enumerate(chunk):
            if counts[b] > K:
                _count(stats, "fallbacks")
                results[base + b] = _oracle_tile(
                    PackedReads(*overflow[b]).to_list(), s, e, cfg)
            else:
                results[base + b] = (int(best[b]), int(support[b]))

    in_flight: deque = deque()
    try:
        for (base, chunk), (locs, counts, overflow) in zip(chunks, staged):
            n = len(chunk)
            B = max(cfg.batch_windows, n)
            locs_p = np.full((B, K), 0x7FFFFFFF, np.int32)
            locs_p[:n] = locs
            counts_p = np.zeros(B, np.int32)
            counts_p[:n] = np.minimum(counts, K)
            best, support = window_scan_batch(
                to_device(locs_p, device), to_device(counts_p, device),
                min_count=cfg.consensus_min_count,
                window_size=cfg.window_size, slide_size=cfg.slide_size)
            _count(stats, "batches")
            in_flight.append((base, chunk, counts, overflow, best, support))
            if len(in_flight) > 3:
                apply(*in_flight.popleft())
        while in_flight:
            apply(*in_flight.popleft())
    finally:
        if ex is not None:
            staged.close()
            ex.shutdown(wait=True, cancel_futures=True)
    return results


def run_scan(cfg: ScanConfig, out=None, err=None, *,
             device: torch.device | str = "cuda",
             stats: dict | None = None) -> tuple[int, list[str]]:
    """Full scan pipeline on ``device`` ("cuda", "cpu" or a torch.device).
    Returns (overall_best_pos or -1, lines); the lines also go to ``out``
    and cfg.output_file.  ``stats``, when given, receives tiles, batches,
    fallbacks (tiles the scalar oracle scanned) and total_s.

    Raises device.DeviceUnavailable when the card is asked for and
    absent, and NativeReaderUnavailable when the native reader is asked
    for (the default) and does not build or load."""
    out = out or sys.stdout
    if not isinstance(device, torch.device):
        device = resolve_device(device)
    t0 = time.perf_counter()
    reader = open_reader(cfg)
    tiles = scan_tiles(cfg)
    tid = resolve_scan_tid(cfg, reader)
    if cfg.use_native_io:
        results = run_scan_tiles_native(
            tiles, reader, cfg, tid=tid,
            make_reader=lambda: open_native_reader(cfg.bam_file),
            device=device, stats=stats)
    else:
        results = run_scan_tiles(tiles, python_fetch(reader), cfg, tid=tid,
                                 device=device, stats=stats)

    lines = []
    best_overall, support_overall = -1, 0
    for (s, e), (bp, sup) in zip(tiles, results):
        if bp != -1:
            # Per-window report (sliding_window.c:87).
            lines.append(
                f"INS Discovery in window [{s}, {e}] at position {bp} "
                f"with support {sup}"
            )
            if sup > support_overall:
                support_overall = sup
                best_overall = bp
    lines.append(
        f"(SCAN INS) best position: {best_overall}, "
        f"support: {support_overall}"
    )
    for line in lines:
        print(line, file=out)

    if cfg.output_file:
        with open(cfg.output_file, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    if stats is not None:
        stats["tiles"] = len(tiles)
        stats["total_s"] = time.perf_counter() - t0
    return best_overall, lines
