"""The hg002-ont deployment on the port's main path, on the CPU: `audt`
over a tiny build of the benchmark's ONT configuration (25 kb reads of
some 2,400 CIGAR ops, cut in loci and depth only) against the plain
reference (portbench/reference/audt_scalar.py), and the counters the
`[VERBOSE] stages` line gives the deployment: `walk_ops` (the ops the C
extract hands its windows' walks), `walked_mb` (the bytes the walk of the
staged fetches reads) and `workers` / `pool_tail` (the pool's idle end).
"""
from __future__ import annotations

import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

from svtrek_tpu_torch import constants as C
from svtrek_tpu_torch.config import AudtConfig
from svtrek_tpu_torch.io.vcf import VcfTask, iter_vcf_tasks
from svtrek_tpu_torch.native import native_bam_reader
from svtrek_tpu_torch.native.bamlib import ReaderCounters
from svtrek_tpu_torch.pipeline import audit as taudit
from svtrek_tpu_torch.pipeline.pack import (
    KIND_POINT, pack_chunk_cand, window_tid, windows_for_task,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "portbench")
sys.path[:0] = [os.path.join(PB, "gen")]

import hg002  # noqa: E402


def _load(tag: str, *path: str):
    spec = importlib.util.spec_from_file_location(tag, os.path.join(PB, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reference = _load("portbench_audt_scalar_for_ont", "reference",
                  "audt_scalar.py")
audt_mode = _load("portbench_mode_audt_for_ont", "modes", "audt.py")

WORKERS = [1, 4]
BATCH = 2  # windows a chunk: several chunks, so -t 4 runs them in parallel


@pytest.fixture(scope="module")
def ont(tmp_path_factory):
    """hg002-ont at 6 loci, depth 6, twice over: the configuration's
    reads (25 kb, sd 9 kb, 10-50 kb; M runs of mean 20 between indels)."""
    cfg = json.load(open(os.path.join(PB, "configs", "hg002-ont.json")))
    cfg.update(loci=6, replays=2)
    cfg["reads"]["depth"] = 6
    fx = hg002.build(cfg, 2**31 + 5, str(tmp_path_factory.mktemp("ont")),
                     threads=2)
    assert fx["cigar_ops"] / fx["reads"] > 1500  # ONT's walk, not HiFi's
    return fx


def _audit(fx, workers: int):
    """(lines, the [VERBOSE] numbers as the benchmark parses them) of the
    default path: the C fetch staged on the run's device (here zlib on the
    CPU), the host walk, the consensus."""
    err = io.StringIO()
    lines = taudit.run_audit(
        AudtConfig(bam_file=fx["bam"], vcf_file=fx["vcf"], device="cpu",
                   verbose=True, thread_number=workers, batch_windows=BATCH),
        out=io.StringIO(), err=err)
    return lines, audt_mode.parse_verbose(err.getvalue())


def _walked_windows(vcf: str):
    """(tid, beg, end) of each window of ``vcf`` the C extract walks, as
    `pack_chunk_cand` fetches it (refine_point windows fetch nothing)."""
    cfg = AudtConfig(bam_file="", vcf_file=vcf)
    out = []
    with open(vcf) as fh:
        for task in iter_vcf_tasks(fh):
            if not isinstance(task, VcfTask):
                continue
            for w in windows_for_task(task, cfg)[0]:
                if w.kind != KIND_POINT and window_tid(w) >= 0:
                    out.append((window_tid(w), int(C.u32(w.inter_start - 1)),
                                int(C.u32(w.inter_end - 1))))
    return out


def _ops_of_fetch_packed(fx) -> int:
    reader = native_bam_reader(fx["bam"])
    return sum(int(reader.fetch_packed(*w)[1].sum())
               for w in _walked_windows(fx["vcf"]))


@pytest.mark.parametrize("workers", WORKERS)
def test_ont_lines_equal_the_plain_reference(ont, workers):
    want = reference.audt_lines(ont["bam"], ont["vcf"])
    lines, st = _audit(ont, workers)
    assert want and lines == want
    assert st["card_inflated_mb"] == 0.0 and st["inflated_mb"] > 0


@pytest.mark.parametrize("workers", WORKERS)
def test_walk_ops_are_the_ops_fetch_packed_returns(ont, workers):
    _, st = _audit(ont, workers)
    assert st["walk_ops"] == _ops_of_fetch_packed(ont) > 0


def test_walk_ops_count_the_extract_alone(ont):
    """A batch fetch walks no evidence; the extract over it counts each
    window's reads' ops, a read once for each window it falls in, and the
    call zeroes the counter."""
    cfg = AudtConfig(bam_file=ont["bam"], vcf_file=ont["loci_vcf"],
                     batch_windows=1 << 20)
    wins = []
    with open(ont["loci_vcf"]) as fh:
        for task in iter_vcf_tasks(fh):
            if isinstance(task, VcfTask):
                wins += windows_for_task(task, cfg)[0]
    reader = native_bam_reader(ont["bam"])
    reader.stage_inflate("cpu")
    tids = np.array([window_tid(w) for w in wins], np.int32)
    begs = np.array([C.u32(w.inter_start - 1) for w in wins], np.int64)
    ends = np.array([C.u32(w.inter_end - 1) for w in wins], np.int64)
    reader.fetch_batch_merged(tids, begs, ends, cfg.merge_fetch_gap)
    assert reader.take_counters().walk_ops == 0
    pack_chunk_cand(wins, reader, cfg)
    ops = reader.take_counters().walk_ops
    assert ops == _ops_of_fetch_packed(dict(ont, vcf=ont["loci_vcf"])) > 0
    assert reader.take_counters() == ReaderCounters()


@pytest.mark.parametrize("workers", WORKERS)
def test_walked_bytes_lie_within_the_inflated(ont, workers):
    """The walk reads each record's length, fixed fields, name and CIGAR
    out of the staged blocks: more than 4 bytes an op, less than the
    blocks inflated (on a card `card_inflated_mb`; here zlib's)."""
    _, st = _audit(ont, workers)
    assert 0 < st["walked_mb"] <= st["inflated_mb"]
    assert st["walked_mb"] * 1e6 > 4 * st["walk_ops"] / 2  # DEL: 2 windows


@pytest.mark.parametrize("staged", [False, True])
def test_walked_bytes_count_staged_fetches_alone(ont, staged):
    reader = native_bam_reader(ont["bam"])
    if staged:
        reader.stage_inflate("cpu")
    wins = _walked_windows(ont["loci_vcf"])
    tids, begs, ends = (np.array(c, dt) for c, dt in
                        zip(zip(*wins), (np.int32, np.int64, np.int64)))
    reader.fetch_batch(tids, begs, ends)
    reader.fetch_packed(*wins[0])  # a lazy fetch counts nothing
    walked = reader.take_counters().walked_bytes
    assert (walked > 0) == staged


@pytest.mark.parametrize("workers", WORKERS)
def test_pool_tail_is_the_idle_end_of_the_pool(ont, workers):
    _, st = _audit(ont, workers)
    assert st["workers"] == workers and st["batches"] > workers
    if workers == 1:
        assert st["pool_tail"] == 0
    else:
        # each worker idles at most the pool's time
        assert 0 <= st["pool_tail"] <= workers * st["total"]
