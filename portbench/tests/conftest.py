"""Fixtures of the benchmark's own tests (python -m pytest portbench/tests).

`tiny_root` is a temporary checkout holding BENCHMARK.json, a copy of
portbench/ and a link to the port, with two tiny configurations (6 loci,
2 copies) and a cell of each traffic mix on them, so that a whole run fits
in seconds on the CPU.  Tests that need the card take the `card` fixture,
which skips where torch sees none.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)
sys.path.insert(0, PB)

TINY = {"tiny-hifi": "hg002-hifi", "tiny-ont": "hg002-ont"}
TINY_CELLS = {"tiny-hifi-audt": ("tiny-hifi", "audt"),
              "tiny-hifi-ins-star": ("tiny-hifi", "ins-star"),
              "tiny-ont-audt-devwalk": ("tiny-ont", "audt-devwalk")}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none here")


def make_root(dst: str) -> str:
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(PB, os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "svtrek_tpu_torch"),
               os.path.join(dst, "svtrek_tpu_torch"))
    bench = json.load(open(os.path.join(dst, "BENCHMARK.json")))
    for name, src in TINY.items():
        cfg = json.load(open(os.path.join(PB, "configs", src + ".json")))
        cfg.update(name=name, loci=6, replays=2)
        path = f"portbench/configs/{name}.json"
        json.dump(cfg, open(os.path.join(dst, path), "w"))
        bench["configs"].append({"name": name, "source": "test", "file": path,
                                 "reduced": list(cfg["reduced"]),
                                 "why": "test"})
    for cell, (conf, traffic) in TINY_CELLS.items():
        bench["workloads"].append(dict(name=cell, config=conf,
                                       traffic=traffic, chips=1, why="test"))
        kind = "cons" if traffic == "ins-star" else "audt"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and m.get("moves", m["name"]).startswith(kind):
                m["workloads"].append(cell)
    json.dump(bench, open(os.path.join(dst, "BENCHMARK.json"), "w"))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path))


def run_cell(root: str, cell: str, seed: int = 11, trace: int = 0,
             device: str = "cpu", seconds: float = 0.5):
    """One run of ``cell`` through harness.main; (exit code, result)."""
    import io
    import time

    import harness

    out = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)],
                      time.perf_counter(), root=root, device=device, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
