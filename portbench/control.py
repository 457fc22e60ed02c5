"""The control of `correct`: the plain reference put in the program's place
with the one guarantee it breaks, judged as a run's lines are.

audt guarantees each refined position to be the exact integer mean of its
cluster (the reference's sum in uint64, refinement.c:41-101).  The control
sums the cluster in float32, the next precision below, and keeps the rest
of the reference as it is: its lines, repeated as the window's passes
repeat them, go through the audt mode's comparison against the exact
reference, at the cell's own size.  `correct` must come out false.

    python3 portbench/control.py --workload CELL --seeds N [N ...]

prints one JSON line a seed with the numbers compared.  The benchmark's
runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import guard  # noqa: E402

guard.install()

import harness  # noqa: E402

audt = harness.load_mode("audt")


def f32_sum(values) -> int:
    """A cluster's sum accumulated in float32, as an integer."""
    return int(np.array(list(values), np.float32).sum(dtype=np.float32))


def control_reference():
    """The reference with its cluster sums in float32: the one builtin
    `sum` in audt_scalar is the cluster mean's."""
    ref = audt.load_reference("portbench_audt_scalar_control")
    ref.sum = f32_sum
    return ref


def judge_control(fx: dict, config: dict, traffic: dict, seed: int) -> dict:
    ins = bool(traffic.get("options", {}).get("ins_consensus"))
    n_seq = traffic.get("seq_sample", 0)
    expected, sample = audt.reference(fx["bam"], fx["loci_vcf"], fx["loci"],
                                       ins, n_seq, seed)
    got = control_reference().audt_lines(fx["bam"], fx["loci_vcf"], ins,
                                         seq_lines=sample)
    return audt.compare([got * config["replays"]], expected,
                         config["replays"], sample)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    root = os.path.dirname(HERE)
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[a.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = harness.load_json(os.path.join(root, conf["file"]))
    traffic = harness.load_json(os.path.join(HERE, "traffic",
                                             cell["traffic"] + ".json"))
    sys.path.insert(0, os.path.join(HERE, "gen"))
    gen = harness.load_module(
        os.path.join(HERE, "gen", config["generator"] + ".py"),
        "portbench_gen_" + config["generator"])
    for seed in a.seeds:
        tmp = tempfile.mkdtemp(prefix="portbench-control-")
        try:
            t0 = time.perf_counter()
            fx = gen.build(config, seed, tmp)
            checks = judge_control(fx, config, traffic, seed)
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "correct": harness.passed(checks),
                              "checks": checks,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
