"""One run of one cell: set-up, the measured window, the check, the line.

Everything that belongs to one configuration, traffic mix, mode or metric
is a file of its own, found by the name BENCHMARK.json gives it:

- the cell's configuration: the `file` of its `configs` entry, whose
  `generator` key names `gen/<generator>.py` (its `build` writes the
  cell's inputs: for the hg002 kind the BAM, the window's VCF and the VCF
  of the distinct loci);
- the cell's traffic: `traffic/<traffic>.json`, whose `mode` names
  `modes/<mode>.py` (the program's entry a pass drives, and the plain
  reference that decides `correct`) and whose other keys that mode reads;
- each metric: `metrics/<name before the first dot>.py`, whose
  `read(run)` returns the value or None.

Set-up: the inputs from the seed into a fresh directory under TMPDIR, the
mode's start (the port's libraries, built once into the checkout's
svtrek_tpu_torch/_build/), and one warm pass.  `setup_s` runs from the
first line of run.py to the window.  The window runs whole passes until
--seconds have passed; with --trace 1 torch.profiler records it.  Then the
import guard is checked again, the mode's reference decides `correct`,
and the last line of standard output is the result.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import guard

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
EXIT_NO_DEVICE, EXIT_REFUSED_IMPORT, EXIT_ERROR = 3, 4, 1


@dataclasses.dataclass
class Pass:
    seconds: float
    operations: int           # what the pass attempted (audt: VCF records)
    outputs: list | None      # what it produced; None where it raised
    stats: dict               # the program's own numbers (audt: --verbose)
    cpu_seconds: float = 0.0  # the process's CPU time over the pass


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    passes: list
    trace: object = None      # devtrace.Trace with --trace 1
    work: dict = dataclasses.field(default_factory=dict)


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, pb: str = HERE):
    """The reader of metric ``name``: metrics/<the part of the name before
    its first dot>.py under the portbench directory ``pb``."""
    mdir = os.path.join(pb, "metrics")
    if mdir not in sys.path:
        sys.path.insert(0, mdir)  # the readers' shared modules
    stem = name.split(".", 1)[0]
    path = os.path.join(mdir, stem + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reader for metric {name!r} under {mdir}")
    return load_module(path, "portbench_metric_" + stem.replace("-", "_"))


def load_mode(name: str, pb: str = HERE):
    """modes/<name>.py under the portbench directory ``pb``."""
    return load_module(os.path.join(pb, "modes", name + ".py"),
                       "portbench_mode_" + name.replace("-", "_"))


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: with --trace 0 the end-to-end ones
    whose `workloads` name it (every cell where there is no such list),
    with --trace 1 the per-layer ones, whose `workloads` list names it."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(torch, device: str) -> dict:
    if device == "cpu":  # only the tests run on the CPU
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def main(argv, t_start: float, *, root: str = ROOT,
         device: str = "cuda", out=None) -> int:
    """One run; returns the exit code.  ``device="cpu"`` and ``root`` are
    for the tests alone: the command always asks for the card."""
    out = out or sys.stdout
    args = parse_args(argv)
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    pb = os.path.join(root, "portbench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return EXIT_ERROR
    cell = cells[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(pb, "traffic", cell["traffic"] + ".json"))

    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()} "
              f"(is_available={torch.cuda.is_available()})", file=sys.stderr)
        return EXIT_NO_DEVICE
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(args, bench, cell, config, traffic, torch, device,
                    tmp, t_start, root, pb, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, bench, cell, config, traffic, torch, device, tmp, t_start,
         root, pb, out) -> int:
    sys.path.insert(0, os.path.join(pb, "gen"))
    gen = load_module(os.path.join(pb, "gen", config["generator"] + ".py"),
                      "portbench_gen_" + config["generator"])
    fx = gen.build(config, args.seed, tmp)
    sizes = {k: v for k, v in fx.items() if isinstance(v, (int, dict))}
    print(f"[portbench] inputs ({time.perf_counter() - t_start:.3f} s): "
          f"{sizes}", file=sys.stderr)

    mode = load_mode(traffic["mode"], pb)
    driver = mode.start(fx, traffic, root, device)

    def timed(run_pass):
        t0, c0 = time.perf_counter(), time.process_time()
        outputs, stats = run_pass()
        if device == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t0, time.process_time() - c0, outputs,
                stats)

    timed(driver.warm)
    prof = None
    if args.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    passes = []
    w0 = time.perf_counter()
    with torch.profiler.record_function("portbench.window"):
        while not passes or time.perf_counter() - w0 < args.seconds:
            with torch.profiler.record_function("portbench.pass"):
                sec, cpu, outputs, stats = timed(driver.step)
            passes.append(Pass(sec, driver.operations, outputs, stats, cpu))
            print(f"[portbench] pass {len(passes)}: {sec:.3f} s, "
                  f"cpu {cpu:.3f} s, {stats}", file=sys.stderr)
    if prof is not None:
        prof.__exit__(None, None, None)
    window_s = time.perf_counter() - w0
    dev = device_info(torch, device)

    bad = guard.loaded()
    if bad:
        print(f"portbench: refused modules loaded during the run: {bad}",
              file=sys.stderr)
        return EXIT_REFUSED_IMPORT

    t_ref = time.perf_counter()
    checks, missing, work = mode.check(fx, config, traffic, args.seed,
                                       [p.outputs for p in passes],
                                       bool(args.trace))
    run = Run(cell, config, traffic, setup_s, passes, work=work)
    if args.trace and device == "cuda":
        import devtrace

        run.trace = devtrace.from_profiler(prof)
    ref_s = time.perf_counter() - t_ref

    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(args.trace)):
        value = metric_reader(m["name"], pb).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
    attempted = driver.operations * len(passes)
    failed = min(attempted, missing)
    correct = passed(checks)
    print(f"[portbench] {len(passes)} passes, {attempted} operations in "
          f"{window_s:.3f} s; reference {ref_s:.3f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"[portbench] check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
