"""Whole runs of tiny cells on the CPU, through the switch only the tests
set; the command itself asks for the card and fails without one."""
import json
import os
import subprocess
import sys

import pytest

from conftest import PB, REPO, make_root, run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell,trace", [("tiny-hifi-audt", 0),
                                        ("tiny-hifi-ins-star", 1),
                                        ("tiny-ont-audt-devwalk", 1)])
def test_tiny_cell_prints_the_contract_line(tiny_root, cell, trace):
    rc, res = run_cell(tiny_root, cell, trace=trace)
    assert rc == 0
    assert KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    import harness

    want = {m["name"] for m in harness.cell_metrics(bench, cell, trace)}
    # the device trace's readers find nothing on the CPU and stay silent
    got = set(res["metrics"])
    assert got <= want
    if not trace:
        assert got == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_new_files_alone_add_a_cell_traffic_mode_and_metric(tiny_root):
    """A mode, a traffic mix, a metric reader and a cell added as files
    (and BENCHMARK.json entries) are found by name; no harness file
    changes."""
    pb = os.path.join(tiny_root, "portbench")
    open(os.path.join(pb, "modes", "audt-once.py"), "w").write(
        "import os\nimport sys\n\n"
        "sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))\n"
        "from audt import check, start  # noqa: E402,F401\n")
    json.dump({"name": "audt-t2", "mode": "audt-once",
               "why": "two producer threads",
               "options": {"thread_number": 2}, "seq_sample": 0},
              open(os.path.join(pb, "traffic", "audt-t2.json"), "w"))
    open(os.path.join(pb, "metrics", "windows_per_record.py"), "w").write(
        "from _common import total\n\n\ndef read(run):\n"
        "    return total(run, 'windows') / total(run, 'records')\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["workloads"].append({"name": "tiny-hifi-t2", "config": "tiny-hifi",
                               "traffic": "audt-t2", "chips": 1, "why": "t"})
    bench["end_to_end"][0]["workloads"].append("tiny-hifi-t2")
    bench["per_layer"].append({
        "name": "windows_per_record", "unit": "windows/record",
        "better": "lower", "source": "program_counter", "layer": "x",
        "moves": "audt_records_per_s", "workloads": ["tiny-hifi-t2"]})
    json.dump(bench, open(path, "w"))
    rc, res = run_cell(tiny_root, "tiny-hifi-t2", trace=1)
    assert rc == 0 and res["correct"]
    assert 1.0 <= res["metrics"]["windows_per_record"]["value"] <= 2.0


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hifi-audt",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/."""
    root = make_root(str(tmp_path))
    os.unlink(os.path.join(root, "svtrek_tpu_torch"))
    code = ("import sys, time; sys.path.insert(0, 'portbench'); "
            "import guard; guard.install(); import harness; "
            "sys.exit(harness.main(['--workload', 'tiny-hifi-audt', "
            "'--seed', '1', '--seconds', '1'], time.perf_counter(), "
            "root='.', device='cpu'))")
    out = subprocess.run([sys.executable, "-I", "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert "svtrek_tpu_torch" in out.stderr
    assert not [x for x in out.stdout.splitlines() if x.startswith("{")]


@pytest.mark.card
def test_tiny_cell_on_the_card(card, tmp_path):
    rc, res = run_cell(make_root(str(tmp_path)), "tiny-hifi-ins-star",
                       trace=1, device="cuda")
    assert rc == 0 and res["correct"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["device_idle_pct.cons"]["value"] < 100
