"""The port's scan mode against the JAX package on the CPU:
`window_scan_batch` (svtrek_tpu_torch.ops.window_scan) bit-identical to
svtrek_tpu.ops.window_scan's, the wrapping mean, truncating division and
first-maximum ties included; `run_scan` on the native and the Python path
giving svtrek_tpu's lines, --chrom-by-name and the overflow fallbacks
included; `bounded_map` cancelling what it has not started when a call
fails; and tools/scan_scalar.py, the independent scalar scan chip_smoke.py
holds the port to, equal to svtrek_tpu's run_scan."""
from __future__ import annotations

import dataclasses
import io
import os
import random
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from svtrek_tpu import constants as C
from svtrek_tpu.config import ScanConfig
from svtrek_tpu.io.bam import BamRecord, BamWriter
from svtrek_tpu.ops.window_scan import window_scan_batch as jax_scan
from svtrek_tpu.oracle import window_scan
from svtrek_tpu.pipeline.scan import run_scan as jax_run_scan
from svtrek_tpu_torch.config import ScanConfig as TScanConfig
from svtrek_tpu_torch.ops import window_scan as twin
from svtrek_tpu_torch.pipeline import scan as tscan
from tests.fixtures import PlantedSV, simulate_reads_for_sv, write_fixture
from tests.test_window_scan import _pack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import scan_scalar  # noqa: E402

PAD = C.I32_MAX


def _both(locs, n, **kw):
    want = [np.asarray(x) for x in jax_scan(locs, n, **kw)]
    got = [x.numpy() for x in twin.window_scan_batch(
        torch.from_numpy(locs), torch.from_numpy(n), **kw)]
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("slide", [1, 2, 5])
def test_window_scan_matches_jax(seed, slide):
    """tests/test_window_scan.py's random rows, and the scalar oracle."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(64):
        k = int(rng.integers(0, 50))
        base = int(rng.integers(1000, 10_000_000))
        cases.append([base + int(rng.integers(0, 3000)) for _ in range(k)])
    locs, n = _pack(cases, 64)
    best, sup = _both(locs, n, min_count=3, window_size=1000,
                      slide_size=slide)
    for b, vals in enumerate(cases):
        assert (int(best[b]), int(sup[b])) == \
            window_scan(vals, 3, 1000, slide)
    assert (sup > 0).sum() > 10


def test_window_scan_wrapping_mean_and_truncation():
    """The int32 sum that wraps (tests/test_window_scan.py:64), negative
    sums where truncation and floor differ, two equal clusters (the first
    wins), rows with n = 0 and n below min_count, values near both int32
    ends, and non-default parameters."""
    cases = [
        [2_000_000_000, 2_000_000_100, 2_000_000_200],
        [-1_000, -1_000, -1_001, -1_002],
        [-2**31, -2**31 + 1, -2**31 + 7, -2**31 + 9],
        [100, 110, 120, 5000, 5010, 5020],
        [],
        [7, 8],
        [PAD - 20, PAD - 10, PAD - 5, PAD - 1],
        [2**31 - 900, 2**31 - 800, 2**31 - 700, 5, 6, 7, 8],
    ]
    locs, n = _pack(cases, 16)
    for kw in [dict(min_count=3, window_size=1000, slide_size=1),
               dict(min_count=2, window_size=7, slide_size=2),
               dict(min_count=1, window_size=0, slide_size=3)]:
        best, sup = _both(locs, n, **kw)
    best, sup = _both(locs, n, min_count=3, window_size=1000, slide_size=1)
    want = window_scan(cases[0], 3, 1000, 1)
    assert (int(best[0]), int(sup[0])) == want and want[0] != 2_000_000_100
    assert (int(best[1]), int(sup[1])) == (-1000, 4)   # floor gives -1001
    assert int(best[3]) == 110 and int(sup[4]) == 0 and int(best[5]) == -1


def test_scan_calls_count_by_device():
    before = twin.scan_calls["cpu"]
    locs, n = _pack([[1, 2, 3]], 16)
    twin.window_scan_batch(torch.from_numpy(locs), torch.from_numpy(n))
    assert twin.scan_calls["cpu"] == before + 1


# ---- run_scan ----------------------------------------------------------

@pytest.fixture(scope="module")
def ins_fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_scan")
    svs = [PlantedSV(1, 50_000, 50_000, "INS", 120),
           PlantedSV(1, 52_400, 52_400, "INS", 300),
           PlantedSV(1, 80_000, 80_001, "INS", 60),
           PlantedSV(1, 90_000, 90_400, "DEL", 400),
           PlantedSV(2, 30_000, 30_001, "INS", 200)]
    bam, _ = write_fixture(str(d), svs, {1: 200_000, 2: 100_000}, seed=7,
                           depth=10, noise=20)
    return bam


def _scan_both(cfg_kw):
    want = jax_run_scan(ScanConfig(**cfg_kw), out=io.StringIO())
    stats: dict = {}
    got = tscan.run_scan(TScanConfig(**cfg_kw), out=io.StringIO(),
                         device="cpu", stats=stats)
    return want, got, stats


SCAN_CASES = {
    "native": dict(start=40_000, end=95_000),
    "native_chrom2_slide3": dict(chrom=2, start=1, end=60_000,
                                 slide_size=3, window_size=700),
    "native_one_thread_small_batches": dict(start=45_000, end=85_000,
                                            batch_windows=7,
                                            thread_number=1),
    "native_no_merge": dict(start=45_000, end=85_000, merge_fetch_gap=0,
                            batch_windows=5, thread_number=3),
    "native_min_count_5": dict(start=45_000, end=85_000,
                               consensus_min_count=5),
    "python": dict(start=40_000, end=95_000, use_native_io=False),
    "python_chrom2_slide3": dict(chrom=2, start=1, end=60_000,
                                 slide_size=3, window_size=700,
                                 use_native_io=False),
    "python_small_batches": dict(start=45_000, end=85_000,
                                 batch_windows=7, use_native_io=False),
    "start_zero_and_missing_tid": dict(chrom=5, start=0, end=3_000),
}


@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_run_scan_matches_jax(ins_fixture, name):
    want, got, stats = _scan_both(dict(bam_file=ins_fixture,
                                       **SCAN_CASES[name]))
    assert got == want
    assert stats["tiles"] >= 1
    if name.startswith(("native", "python")):
        assert len(got[1]) >= 2 and got[0] != -1


def test_run_scan_output_file(ins_fixture, tmp_path):
    path = str(tmp_path / "scan.txt")
    kw = dict(bam_file=ins_fixture, start=48_000, end=56_000)
    _, lines = tscan.run_scan(TScanConfig(output_file=path, **kw),
                              out=io.StringIO(), device="cpu")
    with open(path) as fh:
        assert fh.read().splitlines() == lines
    assert lines == jax_run_scan(ScanConfig(**kw), out=io.StringIO())[1]


@pytest.fixture(scope="module")
def dense_ins_bam(tmp_path_factory):
    """One tile with 150 INS candidates (past K = 64) and one read with 10
    INS ops in one tile (past the device walk's read_cap of 8)."""
    d = tmp_path_factory.mktemp("dense_ins")
    bam = str(d / "dense.bam")
    reads = [(50_000 + 2 * i, [(0, 400 - 2 * i + i % 5), (1, 70),
                               (0, 300)]) for i in range(150)]
    reads.append((60_000, [(0, 40), (1, 60)] * 10 + [(0, 500)]))
    reads += [(60_010 + i, [(0, 200 - i), (1, 55), (0, 900)])
              for i in range(4)]
    reads.sort()
    with BamWriter(bam, [("1", 200_000)]) as w:
        for i, (s, cig) in enumerate(reads):
            qlen = sum(l for op, l in cig if op in (0, 1, 4))
            w.write(BamRecord(name=f"r{i}", flag=0, tid=0, pos=s, mapq=60,
                              cigar=cig, seq="A" * qlen))
    return bam


@pytest.mark.parametrize("native", [True, False])
def test_run_scan_overflow_fallbacks_match_jax(dense_ins_bam, native):
    kw = dict(bam_file=dense_ins_bam, start=48_000, end=64_000,
              max_candidates=64, use_native_io=native)
    want, got, stats = _scan_both(kw)
    assert got == want
    assert stats["fallbacks"] >= (1 if native else 2)
    assert any("support 150" in l for l in got[1])


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", ["chrX", "X"])
def test_run_scan_chrom_by_name_matches_jax(tmp_path_factory, native, name):
    """test_chrom_by_name.py:108-121: scan -c chrX --chrom-by-name on a
    BAM whose only reference is 'chrX', chr-prefix tolerant both ways."""
    bam = _chrx_bam(tmp_path_factory)
    kw = dict(bam_file=bam, chrom_by_name=True, chrom_name=name,
              start=45_000, end=55_000, window_size=1000,
              use_native_io=native)
    want, got, _ = _scan_both(kw)
    assert got == want and abs(got[0] - 50_000) <= 5


def test_run_scan_numeric_parity_misses(tmp_path_factory):
    """Without --chrom-by-name, chrom 9 is tid 8: no such tid, best -1."""
    bam = _chrx_bam(tmp_path_factory)
    for native in (True, False):
        want, got, _ = _scan_both(dict(bam_file=bam, chrom=9, start=45_000,
                                       end=55_000, use_native_io=native))
        assert got == want and got[0] == -1


_CHRX: dict = {}


def _chrx_bam(tmp_path_factory) -> str:
    if "bam" not in _CHRX:
        d = tmp_path_factory.mktemp("chrx_scan")
        bam = str(d / "xi.bam")
        rng = random.Random(5)
        sv = PlantedSV(1, 50_000, 50_001, "INS", 120)
        reads = sorted((s, c) for s, c, _ in simulate_reads_for_sv(sv, rng))
        with BamWriter(bam, [("chrX", 500_000)]) as w:
            for i, (start0, cigar) in enumerate(reads):
                qlen = sum(l for op, l in cigar if op in (0, 1, 4))
                w.write(BamRecord(name=f"r{i}", flag=0, tid=0, pos=start0,
                                  mapq=60, cigar=cigar, seq="A" * qlen))
        _CHRX["bam"] = bam
    return _CHRX["bam"]


def test_bounded_map_cancels_pending_on_error():
    """A failing call stops the map: the futures not yet started are
    cancelled, not left running (the JAX version's hazard)."""
    started = []
    gate = threading.Event()

    def fn(i):
        started.append(i)
        if i == 0:
            gate.wait(5)
            raise ValueError("boom")
        time.sleep(0.05)
        return i

    with ThreadPoolExecutor(1) as ex:
        it = tscan.bounded_map(ex, fn, range(100), 4)
        threading.Timer(0.2, gate.set).start()
        with pytest.raises(ValueError, match="boom"):
            list(it)
    # The one worker may take item 1 between item 0's failure and the
    # cancel; items 2-4 stay queued and are cancelled.
    assert started in ([0], [0, 1])


def test_bounded_map_keeps_order_and_window():
    with ThreadPoolExecutor(3) as ex:
        assert list(tscan.bounded_map(ex, lambda i: i * i, range(20), 4)) \
            == [i * i for i in range(20)]


def test_scan_workers_failure_cancels_chunks(ins_fixture, monkeypatch):
    """run_scan_tiles_native with a worker whose reader fails: the error
    reaches the caller and no chunk past the window is fetched."""
    calls = []

    def make_reader():
        calls.append(1)
        raise OSError("reader failed")

    cfg = TScanConfig(bam_file=ins_fixture, start=1, end=200_000,
                      window_size=100, batch_windows=10, thread_number=2)
    tiles = tscan.scan_tiles(cfg)
    with pytest.raises(OSError, match="reader failed"):
        tscan.run_scan_tiles_native(tiles, None, cfg, tid=0,
                                    make_reader=make_reader)
    assert len(calls) <= 4


# ---- tools/scan_scalar.py ----------------------------------------------

@pytest.mark.parametrize("region", [
    (1, 1, 200_000, 1000, 1),
    (1, 40_000, 95_000, 700, 3),
    (2, 1, 100_000, 1000, 1),
    (3, 1, 5_000, 1000, 1),
])
def test_scan_scalar_matches_jax(ins_fixture, region):
    chrom, start, end, window, slide = region
    want = jax_run_scan(ScanConfig(bam_file=ins_fixture, chrom=chrom,
                                   start=start, end=end, window_size=window,
                                   slide_size=slide), out=io.StringIO())[1]
    got = scan_scalar.scan_lines(ins_fixture, chrom, start, end, window,
                                 slide)
    assert got == want
    if chrom != 3:
        assert len(got) >= 2


def test_scan_scalar_dense_matches_jax(dense_ins_bam):
    want = jax_run_scan(ScanConfig(bam_file=dense_ins_bam, start=1,
                                   end=100_000), out=io.StringIO())[1]
    assert scan_scalar.scan_lines(dense_ins_bam, 1, 1, 100_000) == want


def test_scan_scalar_imports_neither_package():
    import ast

    with open(os.path.join(ROOT, "tools", "scan_scalar.py")) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.startswith(("svtrek", "jax"))]
    assert dataclasses.is_dataclass(TScanConfig)
