"""The port's JAX-free copy of the host-extract packer
(svtrek_tpu_torch.pipeline.pack) against the original
(svtrek_tpu.pipeline.pack): the same windows and the same packed arrays
on planted fixtures."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from svtrek_tpu.config import AudtConfig
from svtrek_tpu.io.vcf import VcfSkip, iter_vcf_tasks
from svtrek_tpu.native import native_bam_reader
from svtrek_tpu.pipeline import pack as jpack
from svtrek_tpu_torch.native import native_bam_reader as torch_bam_reader
from svtrek_tpu_torch.ops.consensus import consensus_pos_full
from svtrek_tpu_torch.pipeline import pack as tpack
from tests.fixtures import PlantedSV, write_fixture

SVS = [
    PlantedSV(1, 50_000, 50_400, "DEL", 400),
    PlantedSV(1, 120_000, 120_001, "INS", 120),
    PlantedSV(1, 200_000, 203_000, "INV", 3000),
    PlantedSV(2, 80_000, 80_070, "DEL", 70),
    PlantedSV(2, 160_000, 160_001, "INS", 65),
    PlantedSV(1, 300_000, 300_050, "DEL", 50),   # emits nothing
    PlantedSV(2, 300_000, 300_400, "INV", 400),
]

CONFIGS = {
    "default": {},
    "refine_inv": dict(refine_inv=True),
    "narrow": dict(cand_width=16, batch_windows=3),
    "no_merge": dict(merge_fetch_gap=0, batch_windows=64),
}


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pack")
    return write_fixture(str(d), SVS, {1: 500_000, 2: 400_000}, seed=4,
                         depth=24, noise=40)


def _windows(module, vcf, cfg):
    wins, emits = [], []
    with open(vcf) as fh:
        for task in iter_vcf_tasks(fh):
            if isinstance(task, VcfSkip):
                continue
            w, e = module.windows_for_task(task, cfg)
            wins.extend(w)
            emits.append(e)
    return wins, emits


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_windows_for_task_matches(planted, name):
    _, vcf = planted
    cfg = AudtConfig(**CONFIGS[name])
    jw, je = _windows(jpack, vcf, cfg)
    tw, te = _windows(tpack, vcf, cfg)
    assert je == te
    assert [dataclasses.astuple(w) for w in tw] == \
        [dataclasses.astuple(w) for w in jw]
    assert [tpack.window_tid(w) for w in tw] == \
        [jpack.window_tid(w) for w in jw]


def resolved_refined_c(packed) -> np.ndarray:
    """The port's batch resolved as the JAX package's `refined_c`: the
    C scalar consensus of a window past pack.WIDE_MAX_K as it is, and a
    window past K but within it (the side CSR) refined by the full sweep
    of its whole candidate row; INT64_MIN elsewhere."""
    out = packed.refined_c.copy()
    if len(packed.wide_win):
        locs, counts, ipos = (torch.from_numpy(a)
                              for a in packed.wide_batch())
        out[packed.wide_win] = consensus_pos_full(locs, counts,
                                                  ipos)[0].numpy()
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pack_chunk_cand_matches(planted, name):
    """The same batches, each with the port's native reader (whose
    extractor hands the windows past K over in a side CSR); `refined_c`
    compared resolved (`resolved_refined_c`)."""
    bam, vcf = planted
    cfg = AudtConfig(bam_file=bam, **CONFIGS[name])
    jw, _ = _windows(jpack, vcf, cfg)
    tw, _ = _windows(tpack, vcf, cfg)
    reader = native_bam_reader(bam)
    treader = torch_bam_reader(bam)
    assert reader is not None
    bw = cfg.batch_windows
    n_batches = n_wide = 0
    for lo in range(0, len(jw), bw):
        want = jpack.pack_chunk_cand(jw[lo:lo + bw], reader, cfg)
        got = tpack.pack_chunk_cand(tw[lo:lo + bw], treader, cfg)
        for f in ("locs", "counts", "imprecise_pos"):
            a, b = getattr(got.batch, f), getattr(want.batch, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        np.testing.assert_array_equal(got.true_counts, want.true_counts)
        np.testing.assert_array_equal(resolved_refined_c(got),
                                      want.refined_c)
        assert got.num_reads == want.num_reads
        assert [dataclasses.astuple(w) for w in got.windows] == \
            [dataclasses.astuple(w) for w in want.windows]
        n_batches += 1
        n_wide += len(got.wide_win)
    assert n_batches == -(-len(jw) // bw)
    if name == "narrow":
        # cand_width 16 with 24-read support: some window overflowed K and
        # arrived in the side CSR, where the JAX package's came refined by
        # the C scalar consensus.
        assert n_wide > 0
