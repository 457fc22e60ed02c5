#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (svtrek_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero before the
last line:

1. environment: torch version, the card's name and power limit; no CUDA
   device is a failure;
2. build: kernels K1 (svtrek_tpu_torch/csrc/consensus.cu), K2 and K3
   (csrc/poa.cu) and K4 (csrc/step_probe.cu), nvcc for sm_90a, one
   process per source, from the sources in this checkout, with ptxas's
   register report;
3. kernel: K1 against its plain PyTorch version on the card at the bench
   shapes, the main path's shape and edge rows, exact integer equality,
   plus 256 rows against tools/audt_scalar.py's scalar consensus;
   CUDA-event times of both;
4. POA kernels: K2 (banded DP pointers: its strip kernel and its chunked
   kernel) and K3 (traceback) against their plain PyTorch versions on the
   card, on seeded pair batches (the bench's 256-pair call, 4,096 short
   pairs, a flush-like mix of insert lengths, bands of 256 and 512,
   degenerate pairs, the query that overruns its target by 37 bases, bands
   of 513-2,048 that take both K2 kernels): pointers, cols and ins exactly
   equal; CUDA-event times of both, of K2's launch plan alone, of K2's
   replaced design (the chunked kernel over every pair, through its C
   entry point) and the bounds of K2 and K3, and the profiler's time of
   the kernels alone, without the wrappers' host work;
5. step probe: K4 against its plain version on the default input of
   tools/torch_step_overhead.py (1280 x 256 x 256) and on int8 over its
   whole range at 1000 x 100 x WP, with WP and base alignments that take
   each of K4's 16-, 4- and 1-byte loads, and at rows of more than the
   1,024 vectors a block reads at a time with each load width, every
   rows_per in 1, 2, 4, 8, in one launch and in one launch per step,
   exactly equal, and K4's replaced design (one warp per b row, through
   its C entry point) too; then the probe's own path
   (tools/torch_step_overhead.py's measure, K4 in both launch modes beside
   the plain version and the one library call, CUDA-event medians), which
   must launch K4, and K4's replaced design and bound beside it;
6. main path: `python -m svtrek_tpu_torch.cli audt --device cuda` (run in
   this process, so the launch counts can be read) on the 5,000-record
   synthetic long-read benchmark fixture of tools/bench_e2e.py (built by
   its copy on the port's BAM writer, tools/torch_fixtures.py); its result
   lines must be byte-identical to those of tools/audt_scalar.py (an
   independent scalar audt that decodes the BAM itself), K1 must have run
   once per batch or more, the plain path never, and the refined
   breakpoints must land within 5 bp of the planted truth;
7. ins-consensus path: `audt --ins-consensus --device cuda --verbose` on
   the 2,000-site fixture of tools/ins_fixture.py; K1 must have run once
   per batch and K2 and K3 once per DP batch of every consensus flush, the
   plain paths never; every line must equal an in-process `--device cpu`
   run, the part before `, seq:` must be byte-identical to
   tools/audt_scalar.py, and the `seq:` field equal to its scalar star
   consensus on a subset of sites from every insert-length class;
8. disc path: `disc --device cuda` (svtrek_tpu_torch.pipeline.discover,
   in this process, configured by the CLI's parser) on the 500,000-read
   fixture of tools/bench_disc.py; the scan must run on the card in every
   batch, K2 and K3 once per DP batch of the insertion consensus, the
   plain paths never; every line must equal an in-process `--device cpu`
   run, the part before `, seq:` must be byte-identical to
   tools/disc_scalar.py (an independent scalar disc on the Python GAF
   projection) and the `seq:` field equal to its scalar star consensus on
   8 insertion clusters, the largest among them;
9. standalone: the script refuses every import of `jax`, `jaxlib` and the
   JAX package `svtrek_tpu` from its first line on, and checks at the end
   that none was loaded.

The line before the last two is {"kernels": [...]}: each kernel's launches
on its path (K1 the ins-consensus audt, K2 and K3 disc, K4 the probe), its
largest difference from the plain version, its CUDA-event time beside the
plain version's, its bound (`bound_ms`, `bound_by`: the larger of its bytes
over 3.35 TB/s and its int32 operations over 16.7 Tops/s), the one library
call's time where one computes the same function (`library_ms`, K4's
torch.sum) and the time of the design this one replaced (`ms_before`, K2
and K4).  Those are CUDA-event times of one wrapper call, which also hold
the host's work inside it (the K2/K3 plan, the ctypes call);
`device_ms` and `device_ms_before` are torch.profiler's time of the
kernels alone.  Then the card's nvidia-smi name and power limit, then
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time


# The port stands alone: it runs where there is no JAX, and it imports
# nothing of the JAX package.
BLOCKED = ("jax", "jaxlib", "svtrek_tpu")


class _Blocked:
    """Refuses jax, jaxlib and svtrek_tpu (not svtrek_tpu_torch)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in chip_smoke.py")
        return None


sys.meta_path.insert(0, _Blocked())

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
# The 5,000-record fixture of tools/bench_e2e.py (10 supporting + 5 noise
# reads per record, 800 CIGAR ops per read); all-'A' SEQ, which changes
# only BGZF decode time, never a candidate.
RECORDS, DEPTH, OPS_PER_READ = 5000, 10, 800
BIG = 0x7FFFFFFF
# (B, K, sweep_width): the bench refine shape B=8192 (bench.py:33) over the
# K buckets the packer ships, K=1024 at B=1024 (the plain version holds a
# [B, W, K] int64 intermediate), sweep_width 8 to raise overflow flags, and
# the main path's own shape (512 windows, K=16).
KERNEL_SHAPES = [
    (512, 16, 128),
    (8192, 16, 128), (8192, 64, 128), (8192, 128, 128), (8192, 128, 8),
    (8192, 64, 8), (1024, 1024, 128), (1024, 1024, 8),
]
MAIN_SHAPE = (512, 16, 128)
# The ins-consensus fixture (tools/ins_fixture.py): sites, seed.
INS_SITES, INS_SEED = 2000, 0
# Sites per insert-length class whose consensus tools/audt_scalar.py
# recomputes (its DP is a Python loop over n*(2*band+1) cells).
SCALAR_SEQ_PER_CLASS = 2
# K4's checks (N, B, WP, fill, byte offset of the base from a 16-byte
# boundary): tools/torch_step_overhead.py's default input
# (tools/pallas_step_overhead.py's, integers in [0, 3)), which takes the
# 16-byte loads; then int8 over its whole range [-128, 127], at a WP that
# takes the 4-byte loads (200), at one that takes the 1-byte loads (203),
# and at WP 256 on a base 4 and 1 bytes off the boundary, which take the
# 4-byte and the 1-byte loads; last, rows wider than the 1,024 vectors a
# block reads at a time (WP / load bytes > 1,024: one b row a tile, read in
# more than one pass) at each load width.
PROBE_CHECKS = [
    (1280, 256, 256, "tool", 0), (1000, 100, 200, "full", 0),
    (1000, 100, 203, "full", 0), (1000, 100, 256, "full", 4),
    (1000, 100, 256, "full", 1), (16, 5, 2049, "full", 0),
    (16, 5, 4100, "full", 0), (16, 3, 16400, "full", 0),
]
# The disc fixture (tools/bench_disc.py): reads, seed; and how many
# insertion clusters tools/disc_scalar.py recomputes the consensus of.
DISC_READS, DISC_SEED = 500_000, 0
SCALAR_SEQ_CLUSTERS = 8
# Rows that lead each kernel batch: n = 0, n < min_count, values near
# INT32_MAX and INT32_MIN (where pos +- 25 and pos - loc wrap in int32, as
# in the JAX program, and the scalar consensus, which does not wrap, may
# differ), the early-return tie.  K1 and its plain version must agree on
# them exactly: tolerance 0.
EDGE_ROWS = [
    ([], 1000),
    ([5000, 5001], 5000),
    ([BIG - 10, BIG - 9, BIG - 8, BIG - 3], BIG - 9),
    ([BIG - 100, BIG - 99, BIG - 98], BIG - 5),
    ([995, 996, 997, 1004, 1005, 1006], 1000),
    ([1, 2, 3], -2**31 + 3),
    ([-2**31, -2**31 + 1, -2**31 + 2], 2**31 - 1),
]


# The card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet, at
# its 700 W limit): HBM3 at 3.35 TB/s, and int32 at 132 SMs x 64 int32
# lanes x 1.98 GHz boost (the clock of the data sheet's 67 TFLOP/s
# float32: 132 x 128 lanes x 2 x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take for a kernel's work: the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its int32 operations over the integer rate;
    and which of the two it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def device_ms(fn, kernel: str, reps: int = 5) -> float | None:
    """The card's time (ms) in the kernels whose name holds ``kernel``, per
    fn() call, from torch.profiler (a wrapper's CUDA-event time also holds
    the host work between its launches); None where the profiler records
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # The kernels' own spans, from the trace as tools/torch_audt_measure.py
    # reads it (the event table can leave out a kernel launched through
    # ctypes).
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    us = sum(e.get("dur", 0) for e in events
             if e.get("cat") == "kernel" and kernel in e.get("name", ""))
    return us / reps / 1e3 if us > 0 else None


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_environment():
    import torch

    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[env] nvidia-smi: {smi}", flush=True)
    return smi


def phase_build():
    from svtrek_tpu_torch.kernels import build as kbuild, load_library

    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stderr(report):
        kbuild.build(force=True, verbose=True)
    load_library()
    print(f"[build] K1 K2 K3 K4 {kbuild.LIB} "
          f"{time.perf_counter() - t0:.3f}s",
          flush=True)
    for line in report.getvalue().splitlines():
        if any(w in line for w in ("registers", "spill", "entry function")):
            print(f"[build] {line.strip()}", flush=True)


def kernel_rows(rng, B: int, K: int):
    """Sorted candidate rows: tight clusters, +-600 bp noise and
    duplicates (tests/test_consensus.py:48-75), led by EDGE_ROWS."""
    locs = np.full((B, K), BIG, np.int32)
    n = rng.integers(0, K + 1, B).astype(np.int32)
    pos = np.zeros(B, np.int32)
    for b in range(B):
        center = int(rng.integers(1000, 100_000_000))
        mode = rng.integers(0, 3, n[b])
        vals = center + np.where(
            mode == 0, rng.integers(-4, 5, n[b]),
            np.where(mode == 1, rng.integers(-600, 600, n[b]),
                     rng.integers(-30, 30, n[b])))
        locs[b, :n[b]] = np.sort(vals)
        pos[b] = center + int(rng.integers(-100, 100))
    for i, (vals, p) in enumerate(EDGE_ROWS[:B]):
        locs[i] = BIG
        locs[i, :len(vals)] = vals
        n[i] = len(vals)
        pos[i] = p
    return locs, n, pos


def phase_kernel():
    import torch

    from audt_scalar import consensus_pos
    from svtrek_tpu_torch.kernels import consensus_pos_cuda
    from torch_step_overhead import cuda_ms
    from svtrek_tpu_torch.ops.consensus import consensus_pos_batch_reference

    rng = np.random.default_rng(2026)
    max_err = 0
    main_times = None
    for B, K, sw in KERNEL_SHAPES:
        locs, n, pos = kernel_rows(rng, B, K)
        args = [torch.from_numpy(a).cuda() for a in (locs, n, pos)]
        kw = dict(min_count=3, interval=5, range_=500, sweep_width=sw)
        got, got_ovf = consensus_pos_cuda(*args, **kw)
        want, want_ovf = consensus_pos_batch_reference(*args, **kw)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want) or not torch.equal(got_ovf, want_ovf):
            fail(f"K1 differs from the plain version at B={B} K={K} "
                 f"sweep_width={sw}: max_abs_err={err}, overflow flags "
                 f"equal={torch.equal(got_ovf, want_ovf)}")
        ms = cuda_ms(lambda: consensus_pos_cuda(*args, **kw), 50)
        plain_ms = cuda_ms(lambda: consensus_pos_batch_reference(*args, **kw),
                           5)
        print(f"[kernel] B={B} K={K} sweep_width={sw}: equal, "
              f"overflow_rows={int(got_ovf.sum())} "
              f"refined_rows={int((got >= 0).sum())} K1 {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms", flush=True)
        if (B, K, sw) == MAIN_SHAPE:
            # Bytes: locs [B, K], n, pos in, refined [B] int32 and
            # overflow [B] bool out.  Operations: one int32 compare per
            # candidate, the least a consensus over them takes.
            alone = device_ms(lambda: consensus_pos_cuda(*args, **kw),
                              "consensus_pos_kernel", 20)
            print(f"[kernel] main shape: K1 alone (profiler) "
                  f"{fmt_ms(alone)}", flush=True)
            main_times = (ms, plain_ms, alone,
                          *bound(B * K * 4 + B * 13, B * K))
        if (B, K, sw) == (8192, 64, 128):
            got_h, ovf_h = got.cpu().numpy(), got_ovf.cpu().numpy()
            checked = 0
            for b in range(len(EDGE_ROWS), len(EDGE_ROWS) + 256):
                if ovf_h[b]:
                    continue
                o = consensus_pos(locs[b, :n[b]].tolist(), int(pos[b]))
                if o != int(got_h[b]):
                    fail(f"K1 differs from the scalar consensus at row {b}: "
                         f"{int(got_h[b])} vs {o}")
                checked += 1
            print(f"[kernel] {checked} rows equal audt_scalar.consensus_pos",
                  flush=True)
    return max_err, main_times


def poa_batches(rng):
    """Seeded (name, targets, queries, band) pair batches of base codes for
    K2 and K3: the bench's POA call (bench.py:54-56), 4,096 short pairs, a
    mix of the ins fixture's insert lengths at flush size, bands of up to
    256 and 512, degenerate pairs, the m = 1011, n = 1048 pair whose
    query overruns its target's bucket (tests/test_poa_batch.py:96), and
    bands of 513-2,048 on both sides of kernels.POA_STRIP_MAX_BAND (both of
    K2's kernels), degenerate pairs and bands above m + n among them.  A
    band is one per batch or one per pair."""
    from ins_fixture import LENGTH_CLASSES, mutate

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    def mutated(ts, **kw):
        return [mutate(rng, t, **kw) for t in ts]

    ts = [rand(1024) for _ in range(256)]
    yield "bench", ts, mutated(ts, sub=0.05, ins=0.02, dele=0.02), 64
    ts = [rand(int(rng.integers(50, 401))) for _ in range(4096)]
    yield "short", ts, mutated(ts), 64
    shares = np.array([c[0] for c in LENGTH_CLASSES[:4]])
    cls = rng.choice(4, 2048, p=shares / shares.sum())
    ts = [rand(int(rng.integers(LENGTH_CLASSES[c][1],
                                LENGTH_CLASSES[c][2] + 1))) for c in cls]
    yield "flush", ts, mutated(ts), 64
    ts = [rand(int(rng.integers(300, 701))) for _ in range(64)]
    qs = [np.insert(q, len(q) // 2, rand(int(rng.integers(*span))))
          for q, span in zip(mutated(ts), [(190, 250), (420, 500)] * 32)]
    yield "wide", ts, qs, 64
    shapes = [(40, 0), (0, 40), (10, 50), (60, 55), (0, 0), (20, 400),
              (1, 1), (5, 300)]
    yield "degenerate", [rand(m) for m, _ in shapes], \
        [rand(n) for _, n in shapes], 8
    t = rand(1011)
    yield "overrun", [t], [np.insert(t, 505, rand(37))], 64
    shapes = [(300, 310), (0, 50), (60, 0), (400, 380), (5, 9), (0, 0),
              (250, 260), (120, 90)] * 3
    ts = [rand(m) for m, _ in shapes]
    qs = [mutate(rng, t)[:n] if n <= m else
          np.concatenate([mutate(rng, t), rand(n)])[:n]
          for t, (m, n) in zip(ts, shapes)]
    wide = [513, 520, 527, 528, 600, 1024, 1500, 2048]
    yield "wide2k", ts, qs, np.array(
        wide + rng.integers(513, 2049, len(shapes) - len(wide)).tolist())


def poa_bounds(ms, ns, bands, M, N, cols=None):
    """K2's and, with its outputs, K3's bound (ms, resource) on a batch.

    K2 reads tpad [B, M], qpad [B, N] and ms, ns, bands [B] int32, writes
    the pointers, sum of n*(2*band+1) bytes, and does 12 int32 operations a
    cell: diag (add, base compare, select), up (add), the pointer's
    compare, the max, the left gap's prefix max (subtract, max, add), its
    compare, the score's and the code's selects.  K3 reads qpad, ms, ns,
    bands, the offsets [B+1] int64 and one pointer a step of its walk
    (n + m - matches steps a pair), writes cols [B, M] int8 and ins
    [B, M+1] int32, and does 4 int32 operations a step (index, compare,
    two updates)."""
    B = len(ms)
    cells = int((ns.astype(np.int64) * (2 * bands.astype(np.int64) + 1))
                .sum())
    k2 = bound(B * M + B * N + 12 * B + cells, 12 * cells)
    if cols is None:
        return k2, None
    steps = int(ns.sum()) + int(ms.sum()) - int((cols >= 0).sum())
    k3 = bound(B * N + 12 * B + 8 * (B + 1) + steps + B * M
               + 4 * B * (M + 1), 4 * steps)
    return k2, k3


def launch_failed(name: str, lib, rc: int) -> None:
    if rc != 0:
        fail(f"{name} launch failed: "
             f"{lib.svtrek_cuda_error_string(rc).decode()} ({rc})")


def k2_before(tpad, ms, qpad, ns, bands, max_band: int):
    """K2's replaced design: its chunked kernel over every pair in input
    order, in one launch, through the library's C entry point (the port's
    wrapper gives it only the pairs whose band is above
    POA_STRIP_MAX_BAND).  Returns the pointers."""
    import torch

    from svtrek_tpu_torch.kernels import load_library, poa_ptr_offsets

    (B, M), dev = tpad.shape, tpad.device
    offsets = poa_ptr_offsets(ns, bands)
    ptr = torch.empty(int(offsets[-1]), dtype=torch.int8, device=dev)
    order = torch.arange(B, dtype=torch.int32, device=dev)
    lib = load_library()
    launch_failed("K2's chunked kernel", lib, lib.svtrek_poa_dp_ptr_chunked(
        tpad.data_ptr(), M, ms.data_ptr(), qpad.data_ptr(), qpad.shape[1],
        ns.data_ptr(), bands.data_ptr(), offsets.data_ptr(), ptr.data_ptr(),
        order.data_ptr(), B, max_band,
        torch.cuda.current_stream(dev).cuda_stream))
    return ptr


def k4_before(ptr, rows_per: int, out):
    """K4's replaced design (one warp per b row) over all steps in one
    launch, through the library's C entry point svtrek_step_probe_warp (the
    port's wrapper never launches it).  Returns out."""
    import torch

    from svtrek_tpu_torch.kernels import load_library

    N, B, WP = ptr.shape
    lib = load_library()
    launch_failed("K4's replaced design", lib, lib.svtrek_step_probe_warp(
        ptr.data_ptr(), B, WP, rows_per, 0, N // rows_per, out.data_ptr(),
        torch.cuda.current_stream(ptr.device).cuda_stream))
    return out


def phase_poa_kernels():
    """K2 and K3 against their plain versions on the card, and K2's
    replaced design (its chunked kernel over every pair) beside it."""
    import torch

    from svtrek_tpu_torch.kernels import (
        POA_STRIP_MAX_BAND, poa_dp_plan, poa_dp_ptr_cuda, poa_traceback_cuda,
    )
    from svtrek_tpu_torch.ops.poa_dp import (
        dp_ptr_reference, pointers_by_pair, traceback_reference,
    )
    from torch_step_overhead import cuda_ms

    rng = np.random.default_rng(2027)
    err = {"dp": 0, "tb": 0}
    times = {}
    for name, ts, qs, band in poa_batches(rng):
        B = len(ts)
        ms = np.array([len(t) for t in ts], np.int32)
        ns = np.array([len(q) for q in qs], np.int32)
        bands = np.maximum(band, np.abs(ns - ms) + 1).astype(np.int32)
        tpad = np.full((B, max(int(ms.max()), 1)), 5, np.int8)
        qpad = np.full((B, max(int(ns.max()), 1)), 5, np.int8)
        for b in range(B):
            tpad[b, :ms[b]] = ts[b]
            qpad[b, :ns[b]] = qs[b]
        args = [torch.from_numpy(a).cuda()
                for a in (tpad, ms, qpad, ns, bands)]
        _, m_d, q_d, n_d, b_d = args
        W = int(bands.max())
        M = tpad.shape[1]

        def plain_dp():
            return pointers_by_pair(dp_ptr_reference(*args, W=W), n_d, b_d,
                                    W=W)

        ptr, offsets = poa_dp_ptr_cuda(*args)
        before = k2_before(*args, W)
        want_ptr = plain_dp()
        cols, ins = poa_traceback_cuda(ptr, offsets, q_d, m_d, n_d, b_d,
                                       M=M)
        want_cols, want_ins = traceback_reference(ptr, offsets, q_d, m_d,
                                                  n_d, b_d, M=M)
        torch.cuda.synchronize()
        e_dp = int((ptr.int() - want_ptr.int()).abs().max()) \
            if ptr.numel() else 0
        e_tb = max(int((cols.int() - want_cols.int()).abs().max()),
                   int((ins - want_ins).abs().max()))
        err["dp"], err["tb"] = max(err["dp"], e_dp), max(err["tb"], e_tb)
        if not torch.equal(ptr, want_ptr):
            fail(f"K2 pointers differ from the plain version on {name}: "
                 f"max_abs_err={e_dp}")
        if not torch.equal(before, want_ptr):
            fail(f"K2's chunked kernel differs from the plain version on "
                 f"{name}")
        if not (torch.equal(cols, want_cols) and torch.equal(ins, want_ins)):
            fail(f"K3 differs from the plain version on {name}: "
                 f"max_abs_err={e_tb}")
        n_wide = int((bands > POA_STRIP_MAX_BAND).sum())
        if name == "wide2k" and not 0 < n_wide < B:
            fail(f"wide2k takes one of K2's kernels only: {n_wide} of {B} "
                 f"pairs above band {POA_STRIP_MAX_BAND}")
        line = (f"[poa] {name}: B={B} m {int(ms.min())}-{int(ms.max())} "
                f"n {int(ns.min())}-{int(ns.max())} band "
                f"{int(bands.min())}-{W} ({B - n_wide} strip, {n_wide} "
                f"chunked) pointer_bytes={ptr.numel()}: equal")
        if name in ("bench", "flush"):
            reps, plain_reps = 20, 2
            k2b, k3b = poa_bounds(ms, ns, bands, M, qpad.shape[1],
                                  cols=cols.cpu().numpy())
            def k2():
                return poa_dp_ptr_cuda(*args)

            def k2_chunked():
                return k2_before(*args, W)

            def k3():
                return poa_traceback_cuda(ptr, offsets, q_d, m_d, n_d, b_d,
                                          M=M)

            t = {"k2": cuda_ms(k2, reps),
                 "k2_plan": cuda_ms(lambda: poa_dp_plan(
                     M, qpad.shape[1], m_d, n_d, b_d), reps),
                 "k2_before": cuda_ms(k2_chunked, reps),
                 "k2_plain": cuda_ms(plain_dp, plain_reps),
                 "k3": cuda_ms(k3, reps),
                 "k3_plain": cuda_ms(lambda: traceback_reference(
                     ptr, offsets, q_d, m_d, n_d, b_d, M=M), plain_reps),
                 "k2_bound": k2b, "k3_bound": k3b}
            dev = {"K2": device_ms(k2, "poa_dp_ptr"),
                   "K2 before": device_ms(k2_chunked, "poa_dp_ptr"),
                   "K3": device_ms(k3, "poa_traceback")}
            t["k2_device"], t["k2_before_device"], t["k3_device"] = \
                dev.values()
            times[name] = t
            line += (f"; K2 {t['k2']:.4f} ms (its plan alone "
                     f"{t['k2_plan']:.4f} ms; before: chunked "
                     f"{t['k2_before']:.4f} ms), plain {t['k2_plain']:.4f} "
                     f"ms, bound {k2b[0]:.4f} ms ({k2b[1]}); K3 "
                     f"{t['k3']:.4f} ms, plain {t['k3_plain']:.4f} ms, "
                     f"bound {k3b[0]:.4f} ms ({k3b[1]}); kernel time alone "
                     f"(profiler): " + ", ".join(
                         f"{k} {fmt_ms(v)}" for k, v in dev.items()))
        print(line, flush=True)
    return err, times


def probe_check_input(N: int, B: int, WP: int, fill: str, offset: int):
    """A K4 check's int8 [N, B, WP] input on the card, its base `offset`
    bytes past a 16-byte boundary; returns (ptr, the bytes K4 loads at a
    time, as csrc/step_probe.cu chooses them)."""
    import torch

    from torch_step_overhead import probe_input

    if fill == "tool":
        src = probe_input(N, B, WP)
    else:
        src = torch.from_numpy(np.random.default_rng(2028).integers(
            -128, 127, (N, B, WP), dtype=np.int8, endpoint=True)).cuda()
    buf = torch.empty(N * B * WP + 16, dtype=torch.int8, device="cuda")
    skip = (offset - buf.data_ptr()) % 16
    ptr = buf[skip:skip + N * B * WP].view(N, B, WP)
    ptr.copy_(src)
    addr = ptr.data_ptr()
    if addr % 16 != offset:
        fail(f"K4 check input: base at {addr % 16} bytes, wanted {offset}")
    vec = 16 if WP % 16 == 0 and addr % 16 == 0 else \
        4 if WP % 4 == 0 and addr % 4 == 0 else 1
    return ptr, vec


def phase_step_probe():
    """K4 against its plain version, then the probe's own path, and K4's
    replaced design (one warp per b row) beside it."""
    import torch

    from svtrek_tpu_torch.kernels import (
        launch_counts, reset_launch_counts, step_probe_cuda,
    )
    from svtrek_tpu_torch.ops.step_probe import (
        COLS, step_probe, step_probe_reference,
    )
    from torch_step_overhead import cuda_ms, measure, probe_input, report

    max_err = 0
    loads = set()
    for N, B, WP, fill, offset in PROBE_CHECKS:
        ptr, vec = probe_check_input(N, B, WP, fill, offset)
        loads.add(vec)
        for rp in (1, 2, 4, 8):
            if N % rp:
                continue
            want = step_probe_reference(ptr, rp)
            for per_step in (False, True):
                got = step_probe(ptr, rp, per_step_launches=per_step)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    fail(f"K4 differs from the plain version at N={N} B={B} "
                         f"WP={WP} fill={fill} offset={offset} rows_per={rp} "
                         f"per_step_launches={per_step}: max_abs_err={err}")
            old = k4_before(ptr, rp, torch.empty(
                (B, COLS), dtype=torch.int32, device="cuda"))
            if not torch.equal(old, want):
                fail(f"K4's replaced design differs from the plain version "
                     f"at N={N} B={B} WP={WP} rows_per={rp}")
        print(f"[probe] N={N} B={B} WP={WP} fill={fill} base offset "
              f"{offset} ({vec}-byte loads): K4 equal to the plain version "
              f"at rows_per 1, 2, 4, 8, one launch and per-step launches",
              flush=True)
    if loads != {1, 4, 16}:
        fail(f"the K4 checks took the {sorted(loads)}-byte loads only")
    N, B, WP = PROBE_CHECKS[0][:3]
    reset_launch_counts()
    rows = measure(N, B, WP)
    launches = launch_counts["step_probe"]
    if launches < 1:
        fail("the step probe's path never launched K4")
    for line in report(N, rows):
        print(f"[probe] {line}", flush=True)
    ptr = probe_input(N, B, WP)
    out = torch.empty((B, COLS), dtype=torch.int32, device="cuda")
    one = rows[0]  # rows_per 1: N steps in one launch
    one["ms_before"] = cuda_ms(lambda: k4_before(ptr, 1, out), 20)
    one["device_ms"] = device_ms(lambda: step_probe_cuda(ptr, 1, 0, N, out),
                                 "step_probe_kernel", 20)
    one["device_ms_before"] = device_ms(lambda: k4_before(ptr, 1, out),
                                        "step_probe_warp_kernel", 20)
    # Bytes: ptr read once, out [B, 128] int32 written; one add a byte.
    one["bound_ms"], one["bound_by"] = bound(N * B * WP + B * COLS * 4,
                                             N * B * WP)
    print(f"[probe] rows_per 1, one launch: K4 {one['one_ms']:.4f} ms, "
          f"before (one warp per b row) {one['ms_before']:.4f} ms, library "
          f"torch.sum {one['library_ms']:.4f} ms, plain "
          f"{one['plain_ms']:.4f} ms, bound {one['bound_ms']:.4f} ms "
          f"({one['bound_by']}, {N * B * WP} bytes); kernel time alone "
          f"(profiler): K4 {fmt_ms(one['device_ms'])}, before "
          f"{fmt_ms(one['device_ms_before'])}", flush=True)
    return max_err, launches, one


def concordance(lines) -> float:
    """bench.py:364-381: share of DEL/INS lines whose every diff is within
    5 bp of the planted truth (INV excluded)."""
    hits = total = 0
    for line in lines:
        if line.startswith("(INV)"):
            continue
        total += 1
        diffs = [int(d) for d in
                 re.findall(r"diff(?: pos| end)?: (-?\d+)", line)]
        if diffs and all(abs(d) <= 5 for d in diffs):
            hits += 1
    return hits / total if total else 0.0


def fixture() -> tuple[str, str]:
    from torch_fixtures import build_fixture

    d = os.path.join(tempfile.gettempdir(),
                     f"svtrek_smoke_r{RECORDS}_d{DEPTH}_o{OPS_PER_READ}_alla")
    marker = os.path.join(d, "done")
    if not os.path.exists(marker):
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        _, _, n_reads, n_ops = build_fixture(d, RECORDS, DEPTH, OPS_PER_READ,
                                             realistic_seq=False)
        open(marker, "w").close()
        print(f"[fixture] {RECORDS} records, {n_reads} reads, {n_ops} CIGAR "
              f"ops, built in {time.perf_counter() - t0:.1f}s", flush=True)
    return os.path.join(d, "bench.bam"), os.path.join(d, "bench.vcf")


def run_cli(argv, tag: str):
    """svtrek_tpu_torch.cli with --verbose in this process (so the launch
    counts can be read); prints its [VERBOSE] lines and returns (lines of
    the output file, the [VERBOSE] stats by name, wall seconds)."""
    from svtrek_tpu_torch import cli

    out_path = os.path.join(tempfile.gettempdir(),
                            f"svtrek_smoke_out_{os.getpid()}.txt")
    stderr = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(stderr):
        rc = cli.main([*argv, "-o", out_path, "--verbose"])
    wall = time.perf_counter() - t0
    verbose = [l for l in stderr.getvalue().splitlines()
               if l.startswith("[VERBOSE]")]
    for l in verbose:
        print(f"[{tag}] {l}", flush=True)
    if rc != 0:
        fail(f"svtrek_tpu_torch.cli {' '.join(argv)} exited {rc}: "
             f"{stderr.getvalue()[-2000:]}")
    with open(out_path) as fh:
        lines = [l.rstrip("\n") for l in fh if l.startswith("(")]
    os.remove(out_path)
    stats = dict(re.findall(r"(\w+(?:\+\w+)?)=([\d.]+)s?", " ".join(verbose)))
    return lines, stats, wall


def phase_main_path() -> None:
    from audt_scalar import audt_lines
    from svtrek_tpu_torch.kernels import launch_counts, reset_launch_counts
    from svtrek_tpu_torch.ops.consensus import plain_calls
    from svtrek_tpu_torch.pipeline.audit import open_native_reader

    bam, vcf = fixture()
    t0 = time.perf_counter()
    open_native_reader(bam)  # builds the native C BAM library at first use
    print(f"[build] native C BAM library {time.perf_counter() - t0:.3f}s",
          flush=True)
    reset_launch_counts()
    plain_calls["consensus_pos"] = 0
    got, stats, wall = run_cli(["audt", "-b", bam, "-v", vcf, "--device",
                                "cuda"], "main")
    launches = launch_counts["consensus_pos"]
    plain = plain_calls["consensus_pos"]
    batches = int(stats["batches"])

    t0 = time.perf_counter()
    want = audt_lines(bam, vcf)
    print(f"[main] tools/audt_scalar.py: {len(want)} lines in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if got != want:
        bad = [(a, b) for a, b in zip(want, got) if a != b][:3]
        fail(f"result lines differ from the scalar audt: {len(got)} vs "
             f"{len(want)} lines; first differences {bad}")
    if launches < batches:
        fail(f"K1 launched {launches} times for {batches} batches")
    if plain != 0:
        fail(f"the plain consensus path ran {plain} times on --device cuda")
    conc = concordance(got)
    if conc < 0.99:
        fail(f"concordance_within_5bp {conc:.4f} < 0.99")
    print(f"[main] {len(got)} result lines byte-identical to the scalar "
          f"audt; records/s={len(got) / wall:.1f} wall={wall:.3f}s "
          f"windows={stats['windows']} batches={batches} "
          f"K1_launches={launches} plain_calls={plain} "
          f"fallbacks kovf={stats['kovf']} sweep={stats['sweep']} "
          f"concordance_within_5bp={conc:.4f}", flush=True)
    print(f"[main] split parse={stats['parse']}s "
          f"fetch+pack={stats['fetch+pack']}s (worker-seconds) "
          f"device_wait={stats['device_wait']}s emit={stats['emit']}s "
          f"total={stats['total']}s", flush=True)


def ins_fixture():
    """The 2,000-site ins-consensus fixture, built once and cached under
    the temp dir; returns (bam, vcf, sites)."""
    from ins_fixture import build_ins_fixture

    d = os.path.join(tempfile.gettempdir(),
                     f"svtrek_smoke_ins{INS_SITES}_s{INS_SEED}")
    marker = os.path.join(d, "done")
    if not os.path.exists(marker):
        t0 = time.perf_counter()
        build_ins_fixture(d, INS_SITES, INS_SEED)
        open(marker, "w").close()
        print(f"[fixture] {INS_SITES} INS sites built in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    with open(os.path.join(d, "sites.json")) as fh:
        sites = json.load(fh)
    return os.path.join(d, "ins.bam"), os.path.join(d, "ins.vcf"), sites


def scalar_subset(sites) -> set[int]:
    """SCALAR_SEQ_PER_CLASS sites of every insert-length class with one
    allele, the cheapest first (reads x length), plus the cheapest
    two-allele site and the first site with 2 reads."""
    picked = set()
    for cls in sorted({s["class"] for s in sites}):
        ids = sorted((i for i, s in enumerate(sites)
                      if s["class"] == cls and s["alleles"] == 1
                      and s["reads"] > 2),
                     key=lambda i: sites[i]["reads"] * sites[i]["length"])
        picked.update(ids[:SCALAR_SEQ_PER_CLASS])
    two = sorted((i for i, s in enumerate(sites) if s["alleles"] == 2),
                 key=lambda i: sites[i]["reads"] * sites[i]["length"])
    picked.update(two[:1])
    picked.update([i for i, s in enumerate(sites) if s["reads"] == 2][:1])
    return picked


def phase_ins_path():
    """`audt --ins-consensus` on the card: launch counts, the --device cpu
    run, and tools/audt_scalar.py."""
    from audt_scalar import audt_lines
    from svtrek_tpu_torch.kernels import launch_counts, reset_launch_counts
    from svtrek_tpu_torch.ops import consensus, poa_dp

    bam, vcf, sites = ins_fixture()
    argv = ["audt", "-b", bam, "-v", vcf, "--ins-consensus"]
    reset_launch_counts()
    for calls in (consensus.plain_calls, poa_dp.plain_calls):
        for k in calls:
            calls[k] = 0
    got, stats, wall = run_cli([*argv, "--device", "cuda"], "ins")
    launches = dict(launch_counts)
    plain = sum(consensus.plain_calls.values()) + \
        sum(poa_dp.plain_calls.values())
    batches = int(stats["batches"])
    dp_calls, flushes = (int(stats.get(k, 0)) for k in ("dp_calls", "flushes"))
    if launches["consensus_pos"] < batches:
        fail(f"K1 launched {launches['consensus_pos']} times for {batches} "
             f"batches")
    if dp_calls < max(flushes, 1) or min(
            launches["poa_dp_ptr"], launches["poa_traceback"]) < dp_calls:
        fail(f"K2/K3 launched {launches['poa_dp_ptr']}/"
             f"{launches['poa_traceback']} times for {dp_calls} DP batches "
             f"in {flushes} consensus flushes")
    if plain != 0:
        fail(f"a plain path ran {plain} times on --device cuda")
    cons_sites, cons_s = int(stats["sites"]), float(stats["time"])
    print(f"[ins] {len(got)} lines, records/s={len(got) / wall:.1f} "
          f"wall={wall:.3f}s; consensus sites={cons_sites} "
          f"cons_s={cons_s:.3f}s sites/s={cons_sites / cons_s:.1f}; "
          f"launches K1={launches['consensus_pos']} "
          f"K2={launches['poa_dp_ptr']} K3={launches['poa_traceback']} "
          f"plain_calls={plain}", flush=True)

    cpu, _, cpu_wall = run_cli([*argv, "--device", "cpu"], "ins cpu")
    if cpu != got:
        bad = [(a, b) for a, b in zip(cpu, got) if a != b][:2]
        fail(f"--device cuda and --device cpu lines differ: {bad}")
    print(f"[ins] --device cpu: {len(cpu)} lines equal, wall "
          f"{cpu_wall:.3f}s", flush=True)

    subset = scalar_subset(sites)
    t0 = time.perf_counter()
    want = audt_lines(bam, vcf, ins_consensus=True, seq_lines=subset)
    if [l.split(", seq:")[0] for l in got] != \
            [l.split(", seq:")[0] for l in want]:
        fail("the lines before ', seq:' differ from tools/audt_scalar.py")
    bad = [i for i in subset if got[i] != want[i]]
    if bad:
        fail(f"seq differs from the scalar consensus at sites {bad[:5]}: "
             f"{got[bad[0]][:200]} vs {want[bad[0]][:200]}")
    classes = sorted({sites[i]["class"] for i in subset})
    print(f"[ins] tools/audt_scalar.py: {len(want)} lines byte-identical "
          f"before ', seq:'; seq equal on {len(subset)} sites (classes "
          f"{classes}) in {time.perf_counter() - t0:.1f}s", flush=True)
    return launches


def disc_fixture() -> list[str]:
    """tools/bench_disc.py's fixture at DISC_READS reads, built once and
    cached under the temp dir; returns the CLI's input flags."""
    from bench_disc import build_fixture

    d = os.path.join(tempfile.gettempdir(),
                     f"svtrek_smoke_disc{DISC_READS}_s{DISC_SEED}")
    marker = os.path.join(d, "done")
    if not os.path.exists(marker):
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        build_fixture(d, DISC_READS, seed=DISC_SEED)
        open(marker, "w").close()
        print(f"[fixture] disc: {DISC_READS} reads built in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return ["-r", os.path.join(d, "bench.gfa"), "-a",
            os.path.join(d, "bench.gaf"), "-q", os.path.join(d, "bench.fq")]


def run_disc(inputs: list[str], device: str):
    """`disc --device <device>` in this process through the port's CLI
    parser; returns (lines, stats, wall seconds)."""
    from svtrek_tpu_torch import cli
    from svtrek_tpu_torch.pipeline.discover import run_discover

    out_path = os.path.join(tempfile.gettempdir(),
                            f"svtrek_smoke_disc_{os.getpid()}.txt")
    args = cli.build_parser().parse_args(
        ["disc", *inputs, "-o", out_path, "--device", device])
    stats: dict = {}
    t0 = time.perf_counter()
    lines = run_discover(cli.disc_config_from_args(args), out=io.StringIO(),
                         err=io.StringIO(), device=args.device, stats=stats)
    wall = time.perf_counter() - t0
    with open(out_path) as fh:
        if fh.read().splitlines() != lines:
            fail(f"disc --device {device}: the output file differs from "
                 f"the returned lines")
    for p in (out_path, out_path + ".ckpt.npz"):
        os.remove(p)
    return lines, stats, wall


def scalar_clusters(cl) -> set[int]:
    """SCALAR_SEQ_CLUSTERS insertion clusters: the largest, and the others
    spread evenly over the support ranking."""
    ins = sorted((i for i, c in enumerate(cl) if c[0] == "INS"),
                 key=lambda i: (cl[i][3], i))
    k = min(SCALAR_SEQ_CLUSTERS, len(ins))
    return {ins[-1]} | {ins[(j * (len(ins) - 1)) // max(k - 1, 1)]
                        for j in range(k)}


def phase_disc():
    """`disc` on the card: where the scan ran, the K2/K3 launches, the
    --device cpu run, and tools/disc_scalar.py."""
    import disc_scalar
    from svtrek_tpu_torch.kernels import launch_counts, reset_launch_counts
    from svtrek_tpu_torch.ops import discover, poa_dp

    inputs = disc_fixture()
    reset_launch_counts()
    for calls in (discover.scan_calls, poa_dp.plain_calls):
        for k in calls:
            calls[k] = 0
    got, st, wall = run_disc(inputs, "cuda")
    launches = dict(launch_counts)
    scans = dict(discover.scan_calls)
    plain = sum(poa_dp.plain_calls.values())
    batches, dp_calls = st["scan_batches"], st["dp_calls"]
    if batches < 1 or scans.get("cuda", 0) != batches or \
            sum(scans.values()) != batches:
        fail(f"the disc scan ran {scans} for {batches} batches")
    if dp_calls < 1 or min(launches["poa_dp_ptr"],
                           launches["poa_traceback"]) < dp_calls:
        fail(f"K2/K3 launched {launches['poa_dp_ptr']}/"
             f"{launches['poa_traceback']} times for {dp_calls} DP batches")
    if plain != 0:
        fail(f"the plain POA path ran {plain} times on --device cuda")
    print(f"[disc] {len(got)} lines ({st['clusters']} clusters, "
          f"{st['ins_clusters']} INS), reads={st['reads']} "
          f"reads/s={st['reads'] / wall:.1f} wall={wall:.3f}s; "
          f"scan_batches={batches} on cuda, rescans={st['rescans']} "
          f"host_reads={st['host_reads']} breakpoints={st['breakpoints']}; "
          f"launches K2={launches['poa_dp_ptr']} "
          f"K3={launches['poa_traceback']} for dp_calls={dp_calls}, "
          f"plain_calls={plain}", flush=True)
    print(f"[disc] split detect={st['detect_s']:.3f}s (scan_wait="
          f"{st['scan_wait_s']:.3f}s) cluster={st['cluster_s']:.3f}s "
          f"consensus={st['consensus_s']:.3f}s emit={st['emit_s']:.3f}s "
          f"total={st['total_s']:.3f}s", flush=True)

    cpu, cst, cpu_wall = run_disc(inputs, "cpu")
    if cpu != got:
        bad = [(a, b) for a, b in zip(cpu, got) if a != b][:2]
        fail(f"disc --device cuda and --device cpu lines differ: "
             f"{len(got)} vs {len(cpu)} lines; {bad}")
    print(f"[disc] --device cpu: {len(cpu)} lines equal, wall "
          f"{cpu_wall:.3f}s (consensus {cst['consensus_s']:.3f}s)",
          flush=True)

    gfa, gaf, fq = inputs[1::2]
    t0 = time.perf_counter()
    cl = disc_scalar.clusters(disc_scalar.signals(gfa, gaf))
    t_proj = time.perf_counter() - t0
    subset = scalar_clusters(cl)
    want = disc_scalar.disc_lines(fq, cl, seq_clusters=subset)
    prefix = [l.split(", seq:")[0] for l in got]
    if prefix != [l.split(", seq:")[0] for l in want]:
        bad = [(a, b) for a, b in zip(want, prefix)
               if a.split(", seq:")[0] != b][:2]
        fail(f"the lines before ', seq:' differ from tools/disc_scalar.py: "
             f"{len(got)} vs {len(want)} lines; {bad}")
    bad = [i for i in subset if got[i] != want[i]]
    if bad or len(subset) < min(SCALAR_SEQ_CLUSTERS, st["ins_clusters"]):
        fail(f"seq differs from the scalar consensus at clusters {bad[:5]} "
             f"of {sorted(subset)}")
    print(f"[disc] tools/disc_scalar.py: {len(want)} lines byte-identical "
          f"before ', seq:' (Python projection {t_proj:.1f}s); seq equal on "
          f"{len(subset)} INS clusters of support "
          f"{sorted(cl[i][3] for i in subset)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return launches


def phase_jax_check() -> None:
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    print(f"[jax] {len(loaded)} modules of jax, jaxlib or svtrek_tpu loaded",
          flush=True)
    if loaded:
        fail(f"modules of jax, jaxlib or svtrek_tpu were loaded: {loaded}")


def main() -> int:
    smi = phase_environment()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    import torch

    phase_build()
    max_err, (ms, plain_ms, k1_alone, k1_bound, k1_by) = phase_kernel()
    poa_err, poa_times = phase_poa_kernels()
    probe_err, probe_launches, probe = phase_step_probe()
    phase_main_path()
    launches = phase_ins_path()
    disc_launches = phase_disc()
    phase_jax_check()

    flush = poa_times["flush"]
    print(json.dumps({"kernels": [{
        "name": "consensus_pos",
        "route": "cuda",
        "source": "svtrek_tpu_torch/csrc/consensus.cu",
        "replaces": "svtrek_tpu/ops/sweep_pallas.py:113",
        "launches": launches["consensus_pos"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
        "ms_before": None,
        "device_ms": k1_alone,
        "device_ms_before": None,
    }, {
        "name": "poa_dp_ptr",
        "route": "cuda",
        "source": "svtrek_tpu_torch/csrc/poa.cu",
        "replaces": "svtrek_tpu/ops/poa_pallas.py:165",
        "launches": disc_launches["poa_dp_ptr"],
        "max_abs_err": poa_err["dp"],
        "ms": flush["k2"],
        "plain_ms": flush["k2_plain"],
        "bound_ms": flush["k2_bound"][0],
        "bound_by": flush["k2_bound"][1],
        "library_ms": None,
        "ms_before": flush["k2_before"],
        "device_ms": flush["k2_device"],
        "device_ms_before": flush["k2_before_device"],
    }, {
        "name": "poa_traceback",
        "route": "cuda",
        "source": "svtrek_tpu_torch/csrc/poa.cu",
        "replaces": "svtrek_tpu/ops/poa_pallas.py:319",
        "launches": disc_launches["poa_traceback"],
        "max_abs_err": poa_err["tb"],
        "ms": flush["k3"],
        "plain_ms": flush["k3_plain"],
        "bound_ms": flush["k3_bound"][0],
        "bound_by": flush["k3_bound"][1],
        "library_ms": None,
        "ms_before": None,
        "device_ms": flush["k3_device"],
        "device_ms_before": None,
    }, {
        "name": "step_probe",
        "route": "cuda",
        "source": "svtrek_tpu_torch/csrc/step_probe.cu",
        "replaces": "tools/pallas_step_overhead.py:55",
        "launches": probe_launches,
        "max_abs_err": probe_err,
        "ms": probe["one_ms"],
        "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"],
        "bound_by": probe["bound_by"],
        "library_ms": probe["library_ms"],
        "ms_before": probe["ms_before"],
        "device_ms": probe["device_ms"],
        "device_ms_before": probe["device_ms_before"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
