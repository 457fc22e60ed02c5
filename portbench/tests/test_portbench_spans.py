"""The readers of the program's stage spans and counters: each reads a
number in every tiny cell it is attached to, and nothing from a program
that prints no stage tokens (the parent of the change that added them)."""
import json
import os

import pytest

from conftest import TINY_CELLS, run_cell

STAGE_READERS = ("queue_wait_pct", "put_wait_pct", "sync_wait_pct",
                 "inflate_ms_per_rec", "inflate_mb_per_rec",
                 "extract_ms_per_rec", "cons_seq_ms_per_site",
                 "cons_vote_ms_per_site", "cons_dp_ms_per_site")


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_every_program_counter_metric_of_a_tiny_cell_reads_a_number(
        tiny_root, cell):
    import harness

    rc, res = run_cell(tiny_root, cell, trace=1)
    assert rc == 0 and res["correct"]
    bench = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    counters = [m["name"] for m in harness.cell_metrics(bench, cell, True)
                if m["source"] == "program_counter"]
    assert counters
    for name in counters:
        value = res["metrics"][name]["value"]
        assert isinstance(value, (int, float)) and value >= 0, name
    if cell == "tiny-ont-audt-devwalk":  # the device walk: no C extract
        assert res["metrics"]["extract_ms_per_rec.audt"]["value"] == 0


@pytest.mark.parametrize("stem", STAGE_READERS)
def test_stage_readers_read_nothing_without_their_tokens(stem):
    import harness

    # the numbers a program before the stage spans printed
    stats = {"records": 10.0, "fetch+pack": 0.5, "device_wait": 0.1,
             "emit": 0.05, "total": 1.0, "cons_sites": 4.0,
             "cons_time": 0.2}
    run = harness.Run({}, {}, {}, 1.0,
                      [harness.Pass(1.0, 10, [], dict(stats))])
    assert harness.metric_reader(stem).read(run) is None
    stats.update(queue_wait=0.25, put_wait=0.5, sync_wait=0.01,
                 inflate=0.2, inflated_mb=30.0, extract=0.1,
                 cons_seq_time=0.04, cons_vote_time=0.08, cons_dp_time=0.02)
    run.passes.append(harness.Pass(1.0, 10, [], stats))
    assert harness.metric_reader(stem).read(run) > 0
