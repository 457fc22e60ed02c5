"""The star consensus's vote, `ops.poa_dp.vote` (kernel K5 on the card,
`vote_reference` on the CPU), against the JAX package's host vote
(svtrek_tpu/ops/poa.py `accumulate_votes` and `assemble_consensus`) on
rounds written out as alignments (tests/poa_cases.py `VOTE_CASES`), and
`consensus_sequence_batch` against the JAX package's and the scalar
consensus on clusters that meet the same edges (`EDGE_CLUSTERS`): ties of
bases and of a base with the gap, insert support at n_members // 2 and
one above, two segments of one length and count at a boundary, inserts
at the first and last boundary, a cluster of members equal to its seed
but one, and pairs on the host DP.  Tolerance 0 throughout.

The JAX package is imported inside the tests that use it, so that the
card's tests (marker `card`, skipped where torch sees no card) run on a
machine without it: `python -m pytest --noconftest
tests/test_torch_poa_vote.py -m card`."""
from __future__ import annotations

import functools
import os
import sys

import numpy as np
import pytest
import torch

from svtrek_tpu_torch import kernels
from svtrek_tpu_torch.ops import poa_batch, poa_dp

# tests/poa_cases.py by its directory: where this runs without the repo's
# conftest, `tests` may name another installed package.
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import poa_cases  # noqa: E402

# A band cap that sends host_dp_band_cap's longest and shortest members
# to the host DP at its sizes (kernels.POA_MAX_BAND needs 2,048 bases of
# length difference).
SMALL_BAND_CAP = 80


def _jax_vote(clusters) -> list[str]:
    from svtrek_tpu.ops import poa as jpoa

    out = []
    for c in clusters:
        target = jpoa.encode(c["target"])
        m = len(target)
        votes, ins_votes = jpoa.new_vote_state(target)
        for _ in range(c["n_equal"]):
            votes[np.arange(m), target] += 1
        for row, segs in c["pairs"]:
            cols = np.array([-1 if b == "-" else "ACGTN".index(b)
                             for b in row], np.int8)
            jpoa.accumulate_votes(votes, ins_votes, cols,
                                  [segs.get(j, "") for j in range(m + 1)])
        out.append(jpoa.assemble_consensus(votes, ins_votes,
                                           c["n_members"]))
    return out


def _small_band_cap(monkeypatch) -> None:
    monkeypatch.setattr(poa_batch, "dp_pairs", functools.partial(
        poa_batch.dp_pairs, band_cap=SMALL_BAND_CAP))


@pytest.mark.parametrize("case", sorted(poa_cases.VOTE_CASES))
def test_plain_vote_equals_jax_host_vote(case):
    clusters = poa_cases.VOTE_CASES[case]
    args = poa_cases.vote_inputs(clusters)
    before = poa_dp.plain_calls["poa_vote"]
    got = poa_cases.vote_strings(poa_dp.vote(*args), args[3])
    assert poa_dp.plain_calls["poa_vote"] == before + 1
    assert got == _jax_vote(clusters)


@pytest.mark.parametrize("case", sorted(poa_cases.EDGE_CLUSTERS))
def test_consensus_batch_edges_match_jax(case, monkeypatch):
    from svtrek_tpu.ops import poa as jpoa
    from svtrek_tpu.ops import poa_batch as jbatch

    clusters = poa_cases.EDGE_CLUSTERS[case]
    if case == "host_dp_band_cap":
        _small_band_cap(monkeypatch)
    counts = {}
    got = poa_batch.consensus_sequence_batch(clusters, counts=counts)
    assert got == jbatch.consensus_sequence_batch(clusters)
    assert got == [jpoa.consensus_sequence(c) for c in clusters]
    assert counts["vote_rounds"] >= len(clusters)
    assert counts.get("vote_card", 0) == 0  # no K5 launch on the CPU
    if case.startswith("host_dp"):  # a cluster of both routes
        assert counts["band_scalar"] > 0 and counts["dp_calls"] > 0


def test_vote_dispatch_by_device():
    args = poa_cases.vote_inputs(poa_cases.VOTE_CASES["all"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.poa_vote_cuda(*args)
    with pytest.raises(ValueError, match="no POA vote path"):
        poa_dp.vote(args[0].to("meta"), *args[1:])


# ---- on the card ------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none here")


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(poa_cases.VOTE_CASES))
def test_k5_equals_plain_vote(card, case):
    clusters = poa_cases.VOTE_CASES[case]
    args = poa_cases.vote_inputs(clusters)
    want = poa_cases.vote_strings(poa_dp.vote(*args), args[3])
    dev = poa_cases.vote_inputs(clusters, "cuda")
    before = kernels.launch_counts["poa_vote"]
    got = poa_cases.vote_strings(poa_dp.vote(*dev), dev[3])
    assert kernels.launch_counts["poa_vote"] == before + 1
    assert got == want


@pytest.mark.card
@pytest.mark.parametrize("source", ["random_0", "random_1", "random_2",
                                    "edges"])
def test_k5_on_every_round_of_the_consensus(card, source, monkeypatch):
    """Every round's vote on the card equals the plain vote of the same
    inputs, and the consensus equals the CPU's."""
    if source == "edges":
        clusters = [c for cs in poa_cases.EDGE_CLUSTERS.values() for c in cs]
        _small_band_cap(monkeypatch)
    else:
        clusters = poa_cases.random_clusters(int(source[-1]))
    want = poa_batch.consensus_sequence_batch(clusters)
    voted = []

    def checked(cols, ins, qpad, meta, targets, total, counts=None):
        out = poa_dp.vote(cols, ins, qpad, meta, targets, total,
                          counts=counts)
        plain = poa_dp.vote_reference(
            *(t.cpu() for t in (cols, ins, qpad, meta, targets)), total)
        assert poa_cases.vote_strings(out, meta) == \
            poa_cases.vote_strings(plain, meta)
        voted.append(meta.shape[0])
        return out

    monkeypatch.setattr(poa_batch, "vote", checked)
    counts = {}
    got = poa_batch.consensus_sequence_batch(clusters, device="cuda",
                                             counts=counts)
    assert got == want
    assert counts["vote_card"] == counts["vote_rounds"] == sum(voted) > 0
