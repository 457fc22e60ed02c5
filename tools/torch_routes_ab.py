#!/usr/bin/env python3
"""The routes of the JAX package's static shapes, timed on the card in two
trees of the PyTorch port: this checkout and an earlier one.

    python3 tools/torch_routes_ab.py [BEFORE_DIR]

Builds chip_smoke.py's two route fixtures (tools/torch_fixtures.py:
the dense disc fixture of 24,576 reads and the device-walk route BAM of
64 records; synthetic shapes that reach a route, not user traffic), then
runs, each in its own process that imports `svtrek_tpu_torch` from its
tree, BEFORE_DIR, this checkout, this checkout, BEFORE_DIR (or this
checkout twice without BEFORE_DIR).  Each process runs, on cuda and twice
(the first run builds the tree's kernels and native library; the second
is timed): `disc` on the dense fixture (reads/s, `rescans`,
`scan_pages2`), and `audt --extract device` and `audt --no-native-io` on
the route BAM (records/s, `long_ops`, `dev_ovf`); where the tree's scan
takes a second page, the CUDA-event time of the first dense batch's
first and second pages; and, for the walk that this change rewrote, the
CUDA-event time of one 512-window `--extract device` batch's device step
(`audit_refine_step_csr`: the walk, the grouping, K1) on the audt cell's
read shape (tools/torch_fixtures.py's `build_fixture` at 400 records,
10 reads a record and 800 ops a read, all under 16,384 ops).  On the
deep BAM (tools/torch_fixtures.py's `build_deep_bam`, 64 records whose
windows pass the first passes' widths; also synthetic), each process
runs `audt` on the host path, `--extract device` and `--no-native-io`
(records/s and the route counters: `kovf`, `sweep`, `dev_ovf`, and where
the tree has them `wide_k`, `sweep_full`) and `scan` of its deep region
on the native and the Python path (tiles/s, `fallbacks`, `wide_k`);
where the tree has the second pass, the CUDA-event and profiler times of
K1 on the host path's second batch (every deep window at K' = 4,096).
Every process's lines must equal the first one's.  Prints one JSON object a run, the card's name and power limit,
and writes them to chiprun_out/routes_ab.json.  BEFORE_DIR is a checkout
of the earlier tree (`git archive REV | tar -x -C DIR`) inside a
directory that .gitignore lists, such as scratch_checkout/.
"""
from __future__ import annotations

import contextlib
import inspect
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

DISC_READS, RECORDS, SEED = 24_576, 64, 0
DISC_BATCH, DISC_PAGE = 8192, 2048
# The step timing's audt fixture: records, reads a record, ops a read.
STEP_FIXTURE = (400, 10, 800)
# The deep BAM's scan regions, 1-based [start, end): the native path's
# holds a first-tier and a second-tier INS record, the Python path's the
# second one's tiles (chip_smoke.py's DEEP_SCAN).
DEEP_SCAN = {"native": (3_195_000, 3_605_000),
             "python": (3_598_000, 3_603_000)}


def fixtures() -> str:
    """The two route fixtures and the step timing's audt fixture, built
    once under the temp dir."""
    from torch_fixtures import (
        build_deep_bam, build_dense_disc_fixture, build_fixture,
        build_route_bam,
    )

    d = os.path.join(tempfile.gettempdir(),
                     f"svtrek_routes_ab_d{DISC_READS}_r{RECORDS}_s{SEED}_deep")
    if not os.path.exists(os.path.join(d, "done")):
        os.makedirs(d, exist_ok=True)
        build_dense_disc_fixture(d, DISC_READS, seed=SEED)
        build_route_bam(d, RECORDS, seed=SEED)
        build_fixture(d, *STEP_FIXTURE)
        build_deep_bam(d, seed=SEED)
        open(os.path.join(d, "done"), "w").close()
    return d


def _disc(cli, d: str) -> tuple[list[str], dict, float]:
    from svtrek_tpu_torch.pipeline.discover import run_discover

    out_path = os.path.join(tempfile.gettempdir(),
                            f"svtrek_routes_ab_{os.getpid()}.disc")
    args = cli.build_parser().parse_args(
        ["disc", "-r", f"{d}/bench.gfa", "-a", f"{d}/bench.gaf", "-q",
         f"{d}/bench.fq", "--device", "cuda", "-o", out_path])
    stats: dict = {}
    t0 = time.perf_counter()
    lines = run_discover(cli.disc_config_from_args(args), out=io.StringIO(),
                         err=io.StringIO(), device="cuda", stats=stats)
    wall = time.perf_counter() - t0
    for p in (out_path, out_path + ".ckpt.npz"):
        os.remove(p)
    return lines, stats, wall


def _audt(cli, d: str, flags: list[str], name: str = "route"
          ) -> tuple[list[str], dict, float]:
    out_path = os.path.join(tempfile.gettempdir(),
                            f"svtrek_routes_ab_{os.getpid()}.txt")
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = cli.main(["audt", "-b", f"{d}/{name}.bam", "-v",
                       f"{d}/{name}.vcf", "--device", "cuda", "--verbose",
                       "-o", out_path, *flags])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"audt {flags} exited {rc}: {err.getvalue()[-2000:]}")
    with open(out_path) as fh:
        lines = [l.rstrip("\n") for l in fh if l.startswith("(")]
    os.remove(out_path)
    stats = dict(re.findall(r"(\w+)=(\d+)\b", err.getvalue()))
    return lines, stats, wall


def _pages(d: str):
    """CUDA-event times of the first dense batch's first and second pages,
    or None where the tree's scan has no second page."""
    import numpy as np
    import torch

    from svtrek_tpu_torch.io.gaf_native import NativeGafReader
    from svtrek_tpu_torch.io.gfa import parse_gfa
    from svtrek_tpu_torch.ops.discover import scan_projected_runs_compact_csr
    from torch_step_overhead import cuda_ms

    if "first" not in inspect.signature(
            scan_projected_runs_compact_csr).parameters:
        return None
    reader = NativeGafReader(f"{d}/bench.gaf", parse_gfa(f"{d}/bench.gfa"))
    try:
        b = reader.next_batch(DISC_BATCH)
        args = [torch.from_numpy(np.ascontiguousarray(a, dt)).to("cuda")
                for a, dt in ((b.flat_ops, np.int8), (b.flat_lens, np.int32),
                              (b.n_runs, np.int32), (b.ref_start, np.int32))]
        O = int(b.n_runs.max())
    finally:
        reader.close()

    def page(cap, first=0):
        return scan_projected_runs_compact_csr(*args, O=O, min_len=50,
                                               cap=cap, first=first)

    total = int(page(DISC_PAGE)[0])
    return {"hits": total,
            "page1_ms": cuda_ms(lambda: page(DISC_PAGE), 20),
            "page2_ms": cuda_ms(lambda: page(total - DISC_PAGE, DISC_PAGE),
                                20)}


def _scan(d: str, native: bool) -> tuple[list[str], dict, float]:
    from svtrek_tpu_torch.config import ScanConfig
    from svtrek_tpu_torch.pipeline.scan import run_scan

    start, end = DEEP_SCAN["native" if native else "python"]
    stats: dict = {}
    t0 = time.perf_counter()
    _, lines = run_scan(ScanConfig(bam_file=f"{d}/deep.bam", start=start,
                                   end=end, use_native_io=native),
                        out=io.StringIO(), device="cuda", stats=stats)
    return lines, stats, time.perf_counter() - t0


def _profiled_ms(fn, kernel: str, reps: int = 10):
    """torch.profiler's device time (ms) a call in the kernels whose name
    holds ``kernel``; None where it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(tempfile.gettempdir(),
                        f"svtrek_routes_ab_{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    us = sum(e.get("dur", 0) for e in events
             if e.get("cat") == "kernel" and kernel in e.get("name", ""))
    return us / reps / 1e3 if us > 0 else None


def _second_pass(d: str):
    """K1 on the deep BAM's host-path second batch (every window past
    --cand-width 128, laid out at K'): its shape, CUDA-event time (median
    of 20) and profiler time alone; None where the tree has no second
    pass."""
    import numpy as np
    import torch

    from svtrek_tpu_torch.config import AudtConfig
    from svtrek_tpu_torch.io.vcf import VcfTask, iter_vcf_tasks
    from svtrek_tpu_torch.pipeline import pack
    from svtrek_tpu_torch.pipeline.audit import open_native_reader
    from torch_step_overhead import cuda_ms

    if not hasattr(pack.PackedCandBatch, "wide_batch"):
        return None
    from svtrek_tpu_torch.ops.consensus import consensus_pos_full

    bam, vcf = f"{d}/deep.bam", f"{d}/deep.vcf"
    cfg = AudtConfig(bam_file=bam, vcf_file=vcf)
    wins = []
    with open(vcf) as fh:
        for task in iter_vcf_tasks(fh):
            if isinstance(task, VcfTask):
                wins += pack.windows_for_task(task, cfg)[0]
    packed = pack.pack_chunk_cand(wins, open_native_reader(bam), cfg)
    locs, n, pos = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                    for a in packed.wide_batch())

    def call():
        return consensus_pos_full(locs, n, pos)

    return {"rows": int(locs.shape[0]), "K": int(locs.shape[1]),
            "candidates": int(n.sum()), "ms": cuda_ms(call, 20),
            "device_ms": _profiled_ms(call, "consensus_pos_kernel")}


def _step(d: str) -> dict:
    """CUDA-event time (median of 20) of the device step of the audt
    fixture's first 512-window `--extract device` batch."""
    import numpy as np

    from svtrek_tpu_torch.config import AudtConfig
    from svtrek_tpu_torch.io.vcf import VcfTask, iter_vcf_tasks
    from svtrek_tpu_torch.ops.audit_step import (
        audit_refine_step_csr, to_device,
    )
    from svtrek_tpu_torch.pipeline.audit import open_native_reader
    from svtrek_tpu_torch.pipeline.pack import (
        pack_chunk_native, windows_for_task,
    )
    from torch_step_overhead import cuda_ms

    bam, vcf = f"{d}/bench.bam", f"{d}/bench.vcf"
    cfg = AudtConfig(bam_file=bam, vcf_file=vcf)
    wins = []
    with open(vcf) as fh:
        for task in iter_vcf_tasks(fh):
            if isinstance(task, VcfTask):
                wins += windows_for_task(task, cfg)[0]
    b = pack_chunk_native(wins[:cfg.batch_windows], open_native_reader(bam),
                          cfg).batch
    args = [to_device(b.ops_flat, "cuda", np.uint8),
            to_device(b.lens_flat, "cuda")] + [to_device(a, "cuda") for a in (
                b.pos, b.n_ops, b.window_id, b.kind, b.inter_start,
                b.inter_end, b.imprecise_pos)]
    kw = dict(num_windows=b.num_windows, K=1024)
    if hasattr(b, "ops_width"):     # trees whose CSR step pads to O
        kw["O"] = b.ops_width
    return {"windows": len(wins[:cfg.batch_windows]), "N": len(b.pos),
            "T": len(b.ops_flat), "max_ops": int(b.n_ops.max()),
            "step_ms": cuda_ms(lambda: audit_refine_step_csr(*args, **kw),
                               20)}


def worker(tree: str, d: str, out: str) -> None:
    """One tree's runs; writes {"result": ..., "lines": ...} to ``out``."""
    sys.path.insert(0, os.path.abspath(tree))
    from svtrek_tpu_torch import cli

    result, lines = {"tree": tree}, {}
    for _ in range(2):
        got, st, wall = _disc(cli, d)
    lines["disc"] = got
    result["disc"] = {"reads_per_s": st["reads"] / wall, "wall_s": wall,
                      "scan_batches": st["scan_batches"],
                      "rescans": st["rescans"],
                      "scan_pages2": st.get("scan_pages2", 0),
                      "breakpoints": st["breakpoints"],
                      "dp_calls": st["dp_calls"]}
    for name, flags in (("extract_device", ["--extract", "device"]),
                        ("no_native_io", ["--no-native-io"])):
        for _ in range(2):
            got, st, wall = _audt(cli, d, flags)
        lines[name] = got
        result[name] = {"records_per_s": len(got) / wall, "wall_s": wall,
                        "long_ops": int(st["long_ops"]),
                        "dev_ovf": int(st["dev_ovf"]),
                        "batches": int(st["batches"])}
    for name, flags in (("deep_host", []),
                        ("deep_extract_device", ["--extract", "device"]),
                        ("deep_no_native_io", ["--no-native-io"])):
        for _ in range(2):
            got, st, wall = _audt(cli, d, flags, "deep")
        lines[name] = got
        result[name] = {"records_per_s": len(got) / wall, "wall_s": wall,
                        "batches": int(st["batches"]),
                        **{k: int(st[k]) for k in (
                            "kovf", "sweep", "dev_ovf", "wide_k",
                            "sweep_full") if k in st}}
    for name, native in (("deep_scan_native", True),
                         ("deep_scan_python", False)):
        for _ in range(2):
            got, st, wall = _scan(d, native)
        lines[name] = got
        result[name] = {"tiles_per_s": st["tiles"] / wall, "wall_s": wall,
                        "tiles": st["tiles"],
                        "fallbacks": st.get("fallbacks", 0),
                        "wide_k": st.get("wide_k")}
    result["pages"] = _pages(d)
    result["extract_step"] = _step(d)
    result["second_pass_k1"] = _second_pass(d)
    result["module"] = os.path.dirname(os.path.abspath(cli.__file__))
    with open(out, "w") as fh:
        json.dump({"result": result, "lines": lines}, fh)


def main() -> int:
    before = sys.argv[1] if len(sys.argv) > 1 else ROOT
    d = fixtures()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    runs, first_lines = [], None
    for tree in (before, ROOT, ROOT, before):
        out = os.path.join(tempfile.gettempdir(),
                           f"svtrek_routes_ab_{len(runs)}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", tree, d, out], check=True)
        with open(out) as fh:
            rec = json.load(fh)
        if first_lines is None:
            first_lines = rec["lines"]
        elif rec["lines"] != first_lines:
            raise SystemExit(f"the lines of {tree} differ from the first "
                             f"run's")
        runs.append(rec["result"])
        print(json.dumps(rec["result"]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "routes_ab.json"), "w") as fh:
        json.dump({"card": smi.strip(), "runs": runs}, fh, indent=1)
    print(smi.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:5])
        sys.exit(0)
    sys.exit(main())
