#!/usr/bin/env python
"""End-to-end split of the PyTorch port's `audt` and `disc` runs on one
card.

    python tools/torch_audt_measure.py [--ins-consensus | --disc] [--graph] [--trace-dir DIR]

On chip_smoke.py's 5,000-record fixture (built there, or reused from the
temp dir), runs `python -m svtrek_tpu_torch.cli audt --verbose` in this
process with --device cuda and --device cpu alternating, then twice with
`-t 8`, printing each run's wall time and `AuditStats` split.  With
`--ins-consensus` it runs chip_smoke.py's 2,000-site ins-consensus
fixture instead, with `--ins-consensus --device cuda` twice (a
`--device cpu` run takes minutes; chip_smoke.py makes one).  With
`--disc` it runs `disc` on chip_smoke.py's 500,000-read disc fixture,
--device cuda, cpu, cuda, printing each run's wall time and stats.  With
`--graph` either of those runs the graph POA engine (`--poa-engine
graph`), the ins-consensus runs on chip_smoke.py's graph sub-VCF (the
first 400 sites whose insert is at most 700 bases).  A last run under
`--trace-dir` writes a torch.profiler trace and prints its summary:
the traced window, the events and time per category, the device events by
name, and the card's busy and idle share of the window.  A trace slows the
run several times, so it reads the device's share, not the wall time.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import chip_smoke  # noqa: E402  (blocks jax imports, builds the fixture)

RUNS = [["--device", "cuda"], ["--device", "cpu"],
        ["--device", "cuda"], ["--device", "cpu"],
        ["--device", "cuda", "-t", "8"], ["--device", "cuda", "-t", "8"]]
INS_RUNS = [["--ins-consensus", "--device", "cuda"]] * 2
DISC_RUNS = ["cuda", "cpu", "cuda"]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def run_cli(bam: str, vcf: str, flags: list[str]) -> None:
    from svtrek_tpu_torch import cli

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = cli.main(["audt", "-b", bam, "-v", vcf, "-o", os.devnull,
                       "--verbose", *flags])
    wall = time.perf_counter() - t0
    verbose = " ".join(l for l in err.getvalue().splitlines()
                       if l.startswith("[VERBOSE]"))
    print(f"{' '.join(flags)}: rc {rc} wall {wall:.4f}s {verbose}",
          flush=True)
    if rc != 0:
        sys.exit(f"audt failed: {err.getvalue()[-2000:]}")


def measure_disc(trace_dir: str, flags: list[str]) -> None:
    import torch

    inputs = chip_smoke.disc_fixture()
    for device in DISC_RUNS:
        lines, st, wall = chip_smoke.run_disc(inputs, device, flags)
        split = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                         f"{k}={v}" for k, v in sorted(st.items()))
        print(f"disc --device {device}: {len(lines)} lines, wall "
              f"{wall:.4f}s {split}", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, _, wall = chip_smoke.run_disc(inputs, "cuda", flags)
    print(f"disc --device cuda under torch.profiler: wall {wall:.4f}s",
          flush=True)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "disc_trace.json")
    prof.export_chrome_trace(path)
    summarize_trace(path)


def summarize_trace(path: str) -> None:
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    t0 = min(e["ts"] for e in events)
    window = max(e["ts"] + e["dur"] for e in events) - t0
    by_cat, by_dev = defaultdict(lambda: [0, 0.0]), defaultdict(
        lambda: [0, 0.0])
    for e in events:
        c = by_cat[e.get("cat", "")]
        c[0] += 1
        c[1] += e["dur"]
        if e.get("cat") in DEVICE_CATS:
            d = by_dev[e["name"][:80]]
            d[0] += 1
            d[1] += e["dur"]
    print(f"[trace] window {window:.1f} us", flush=True)
    for cat, (n, us) in sorted(by_cat.items(), key=lambda kv: -kv[1][1]):
        print(f"[trace] category {cat}: {n} events, {us:.1f} us", flush=True)
    busy = sum(us for _, us in by_dev.values())
    for name, (n, us) in sorted(by_dev.items(), key=lambda kv: -kv[1][1]):
        print(f"[trace] device {n} x {name}: {us:.1f} us", flush=True)
    print(f"[trace] device busy {busy:.1f} us of {window:.1f} us, idle "
          f"{100 * (1 - busy / window):.4f} %", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "chiprun_out",
                                                         "trace"))
    ap.add_argument("--ins-consensus", action="store_true",
                    help="measure the ins-consensus path on its fixture")
    ap.add_argument("--disc", action="store_true",
                    help="measure disc on chip_smoke.py's disc fixture")
    ap.add_argument("--graph", action="store_true",
                    help="with --ins-consensus or --disc: the graph POA "
                         "engine")
    args = ap.parse_args()
    engine = ["--poa-engine", "graph"] if args.graph else []
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    if args.disc:
        measure_disc(args.trace_dir, engine)
        return
    if args.ins_consensus:
        bam, vcf, sites = chip_smoke.ins_fixture()
        if args.graph:
            vcf = chip_smoke.graph_sub_vcf(vcf, sites,
                                           chip_smoke.GRAPH_SITES)[0]
        runs = [[*flags, *engine] for flags in INS_RUNS]
        traced = runs[0]
    else:
        bam, vcf = chip_smoke.fixture()
        runs, traced = RUNS, ["--device", "cuda"]
    for flags in runs:
        run_cli(bam, vcf, flags)
    run_cli(bam, vcf, [*traced, "--trace-dir", args.trace_dir])
    summarize_trace(os.path.join(args.trace_dir, "audt_trace.json"))


if __name__ == "__main__":
    main()
