"""`correct` comes out false when the timed path is broken underneath, and
for the control (the reference with its cluster sums in float32)."""
import json
import os

import numpy as np
import pytest
import torch

from conftest import PB, run_cell

import svtrek_tpu_torch.pipeline.audit as audit  # noqa: E402

NA32 = 0xFFFFFFFF


def unchanged_step(locs, counts, ipos, *, device, **kw):
    """A consensus step that returns its state: each window's imprecise
    position, as if nothing were refined."""
    return (torch.as_tensor(np.asarray(ipos, np.int32), device=device),
            torch.zeros(len(ipos), dtype=torch.bool, device=device))


def half_batch_step(locs, counts, ipos, *, device, **kw):
    """Half of the batch left out: the second half of the windows that hold
    candidates see none."""
    counts = np.array(counts, copy=True)
    live = np.flatnonzero(counts)
    counts[live[len(live) // 2:]] = 0
    return STEP(locs, counts, ipos, device=device, **kw)


def altered_answers(packed, dev, cfg, stats=None):
    """Each refined position moved by one where it is produced."""
    return [(w, v if v == NA32 or v < 0 else v + 1)
            for w, v in COLLECT(packed, dev, cfg, stats)]


def altered_seqs(clusters, *a, **kw):
    """Each consensus sequence loses its last base."""
    return [s[:-1] for s in SEQS(clusters, *a, **kw)]


STEP = audit.audit_consensus_step
COLLECT = audit.collect_refinement
SEQS = audit.consensus_sequence_batch
FAULTS = [("tiny-hifi-audt", "audit_consensus_step", unchanged_step),
          ("tiny-hifi-audt", "audit_consensus_step", half_batch_step),
          ("tiny-hifi-audt", "collect_refinement", altered_answers),
          ("tiny-ont-audt-devwalk", "collect_refinement", altered_answers),
          ("tiny-hifi-ins-star", "consensus_sequence_batch", altered_seqs)]


@pytest.mark.parametrize("cell,name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, name, fault):
    monkeypatch.setattr(audit, name, fault)
    rc, res = run_cell(tiny_root, cell, seed=2**31 + 3)
    assert rc == 0
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["tiny-hifi-audt", "tiny-hifi-ins-star"])
def test_sound_run_is_correct(tiny_root, cell):
    rc, res = run_cell(tiny_root, cell, seed=2**31 + 3)
    assert rc == 0 and res["correct"] is True


def test_control_is_not_correct(tmp_path):
    """The control at a size a test holds: 12 loci placed past 150 Mbp,
    where a float32 sum of a cluster's positions rounds."""
    import sys

    sys.path.insert(0, os.path.join(PB, "gen"))
    import control
    import hg002

    cfg = json.load(open(os.path.join(PB, "configs", "hg002-hifi.json")))
    cfg.update(loci=12, replays=2)
    cfg["callset"]["first_pos"] = 150_000_000
    traffic = json.load(open(os.path.join(PB, "traffic", "audt.json")))
    fx = hg002.build(cfg, 5, str(tmp_path), threads=2)
    checks = control.judge_control(fx, cfg, traffic, 5)
    assert checks["mismatched_lines"]["value"] > 0
