#!/usr/bin/env python
"""Measure the per-step and per-launch overhead of the port's CUDA kernels
on the card: the counterpart of tools/pallas_step_overhead.py, with kernel
K4 (svtrek_tpu_torch/csrc/step_probe.cu) in place of its Pallas kernel.

The probe reduces an int8 [N, B, WP] pointer array, read as N / rows_per
steps of [rows_per, B, WP], into a [B, 128] int32 accumulator.  For each
rows_per in 1, 2, 4, 8 that divides N it times, as CUDA-event medians:

- one launch that walks all N / rows_per steps, a block barrier ending
  each step: the cost of a step;
- N / rows_per launches of one step each, through the same ctypes wrapper
  that K2 and K3 are called by: the cost of a launch on their path;
- the plain PyTorch version of the same reduction;
- one PyTorch call that computes the same sums,
  `torch.sum(ptr, dim=(0, 2), dtype=torch.int32)` (`library_ms`), as a
  yardstick: the port never calls it.

It prints ms/call and us/row (per row of N) of each, after the card's name
and power limit.  The input is the Pallas tool's: seed-0 integers in
[0, 3).  It needs a CUDA card and fails without one.

Usage: python tools/torch_step_overhead.py [N B WP]
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

ROWS_PER = (1, 2, 4, 8)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() in milliseconds, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def probe_input(N: int, B: int, WP: int):
    """The Pallas tool's input, on the card."""
    import torch

    return torch.from_numpy(np.random.default_rng(0).integers(
        0, 3, (N, B, WP)).astype(np.int8)).cuda()


def measure(N: int, B: int, WP: int, reps: int = 20) -> list[dict]:
    """One dict per rows_per dividing N: ms/call of the one-launch walk
    (`one_ms`), of the per-step launches (`per_step_ms`, `launches` of
    them), of the plain version (`plain_ms`) and of the one library call
    (`library_ms`, which does not depend on rows_per)."""
    import torch

    from svtrek_tpu_torch.ops.step_probe import (
        step_probe, step_probe_reference,
    )

    ptr = probe_input(N, B, WP)
    rows = []
    for rp in ROWS_PER:
        if N % rp:
            continue
        rows.append({
            "rows_per": rp,
            "launches": N // rp,
            "one_ms": cuda_ms(lambda: step_probe(ptr, rp), reps),
            "per_step_ms": cuda_ms(
                lambda: step_probe(ptr, rp, per_step_launches=True), reps),
            "plain_ms": cuda_ms(lambda: step_probe_reference(ptr, rp), reps),
            "library_ms": cuda_ms(lambda: torch.sum(
                ptr, dim=(0, 2), dtype=torch.int32), reps),
        })
    return rows


def report(N: int, rows: list[dict]) -> list[str]:
    def us_row(ms):
        return ms * 1e3 / N

    return [
        f"rows_per {r['rows_per']}: one launch {r['one_ms']:.4f} ms/call "
        f"({us_row(r['one_ms']):.4f} us/row); {r['launches']} per-step "
        f"launches {r['per_step_ms']:.4f} ms/call "
        f"({us_row(r['per_step_ms']):.4f} us/row); plain "
        f"{r['plain_ms']:.4f} ms/call ({us_row(r['plain_ms']):.4f} us/row); "
        f"library torch.sum {r['library_ms']:.4f} ms/call"
        for r in rows
    ]


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_step_overhead.py: no CUDA device; the probe times "
                 "the card")
    N, B, WP = (int(x) for x in (sys.argv[1:4] or (1280, 256, 256)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{smi}; N={N} B={B} WP={WP} ({N * B * WP} bytes)")
    for line in report(N, measure(N, B, WP)):
        print(line)


if __name__ == "__main__":
    main()
