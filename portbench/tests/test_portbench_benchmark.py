"""BENCHMARK.json keeps to the contract's shapes, and every name in it
finds its file."""
import json
import os
import re

import pytest

from conftest import PB, REPO

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(TEXT.match(w) for w in BENCH["command"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key]), entry[key]


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source", "workloads"}
    if m in BENCH["end_to_end"]:
        assert set(m) <= keys | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) == keys | {"layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    import harness

    assert harness.metric_reader(m["name"]).read is not None


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert os.path.exists(os.path.join(REPO, conf["file"]))
    traffic = json.load(open(os.path.join(PB, "traffic",
                                          w["traffic"] + ".json")))
    assert os.path.exists(os.path.join(PB, "modes", traffic["mode"] + ".py"))
    assert w["chips"] == 1
    import harness

    e2e = harness.cell_metrics(BENCH, w["name"], False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, w["name"], True)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config(c):
    cfg = json.load(open(os.path.join(REPO, c["file"])))
    assert cfg["name"] == c["name"]
    assert os.path.exists(os.path.join(PB, "gen", cfg["generator"] + ".py"))
    assert set(c["reduced"]) == set(cfg["reduced"]) and len(c["reduced"]) <= 16
    assert all(NAME.match(k) for k in c["reduced"])
