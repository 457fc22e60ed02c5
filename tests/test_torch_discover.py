"""disc mode in the port (svtrek_tpu_torch.ops.discover,
ops.audit_step.csr_to_padded and pipeline.discover on the CPU) against the
JAX package on the same seeded inputs, all exact: the scan and its
compaction on every returned array (the filler past `total` and int32
wrap-around included), the CSR scatter, breakpoint detection on the
Python-parse (the JAX package's padded feed), native and host paths (ragged tail, a read of more than 8,192 runs, a
batch over the compaction cap), clustering, run_discover's lines with
`seq:` on the disc fixtures and on a small tools/bench_disc.py fixture, and
the detection checkpoint restored across the two packages.  The JAX side
runs with data_shards=1 (the single-device path)."""
from __future__ import annotations

import io
import os
import sys

import numpy as np
import pytest
import torch

from svtrek_tpu.config import DiscConfig
from svtrek_tpu.io.gaf import Breakpoint, ProjectedRead
from svtrek_tpu.io.gaf_native import NativeGafReader as JaxNativeGafReader
from svtrek_tpu.io.gfa import parse_gfa
from svtrek_tpu.ops import discover as jops
from svtrek_tpu.ops.audit_step import csr_to_padded as jax_csr_to_padded
from svtrek_tpu.pipeline import discover as jpipe
from svtrek_tpu_torch.io.gaf_native import NativeGafReader
from svtrek_tpu_torch.ops import discover as tops
from svtrek_tpu_torch.ops.audit_step import csr_to_padded
from svtrek_tpu_torch.pipeline import discover as tpipe
from svtrek_tpu_torch.refusals import Unsupported
from tests.fixtures_disc import gaf_line, make_backbone_gfa, write_fastq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from bench_disc import build_fixture  # noqa: E402

OPS = np.array([0, 1, 2, 4, 7, 8], np.int8)  # M I D S = X


def _padded(rng, N: int, O: int, *, max_runs: int | None = None,
            big_share: float = 0.2, ref_hi: int = 1 << 24):
    """A seeded padded batch: ops (9 = padding), lens with big runs around
    the 50 bp threshold, n_runs in [0, max_runs], ref_start."""
    max_runs = O if max_runs is None else max_runs
    n_runs = rng.integers(0, max_runs + 1, N).astype(np.int32)
    ops = np.full((N, O), 9, np.int8)
    lens = np.zeros((N, O), np.int32)
    for r in range(N):
        k = min(int(n_runs[r]), O)
        ops[r, :k] = rng.choice(OPS, k)
        lens[r, :k] = np.where(rng.random(k) < big_share,
                               rng.choice([49, 50, 51, 300], k),
                               rng.integers(1, 40, k))
    ref_start = rng.integers(-5, ref_hi, N).astype(np.int32)
    return ops, lens, n_runs, ref_start


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_all_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert np.array_equal(g, w), (i, np.flatnonzero(g != w)[:10])


@pytest.mark.parametrize("seed", range(3))
def test_scan_projected_runs(seed):
    rng = np.random.default_rng(seed)
    args = _padded(rng, 48, 32)
    want = jops.scan_projected_runs(*args, min_len=50)
    got = tops.scan_projected_runs(*_torch(*args), min_len=50)
    _assert_all_equal(got, want)
    assert (np.asarray(want[0]) > 0).sum() > 10


# cap below the batch's hit count, equal to it, and above N*O (the JAX
# program pads its top_k of min(cap, N*O) there).
@pytest.mark.parametrize("case", ["below_total", "at_total", "above_NO"])
def test_scan_compact(case):
    rng = np.random.default_rng(10)
    N, O = 40, 32
    args = _padded(rng, N, O)
    total = int((np.asarray(jops.scan_projected_runs(*args)[0]) > 0).sum())
    cap = {"below_total": total // 3, "at_total": total,
           "above_NO": N * O + 77}[case]
    want = jops.scan_projected_runs_compact(*args, min_len=50, cap=cap)
    got = tops.scan_projected_runs_compact(*_torch(*args), min_len=50,
                                           cap=cap)
    _assert_all_equal(got, want)
    assert int(got[0]) == total > 0


def _csr(ops, lens, n_runs, T: int):
    """The rows' runs back to back in [T] arrays, zeros after them."""
    of = np.zeros(T, np.int8)
    lf = np.zeros(T, np.int32)
    pos = 0
    for r in range(len(n_runs)):
        k = int(n_runs[r])
        of[pos:pos + k] = ops[r, :k]
        lf[pos:pos + k] = lens[r, :k]
        pos += k
    return of, lf


def test_scan_compact_csr():
    rng = np.random.default_rng(3)
    N, O = 64, 32
    ops, lens, n_runs, ref_start = _padded(rng, N, O)
    of, lf = _csr(ops, lens, n_runs, 4096)
    for cap in (256, 40):
        want = jops.scan_projected_runs_compact_csr(
            of, lf, n_runs, ref_start, O=O, min_len=50, cap=cap)
        got = tops.scan_projected_runs_compact_csr(
            *_torch(of, lf, n_runs, ref_start), O=O, min_len=50, cap=cap)
        _assert_all_equal(got, want)
        pad = tops.scan_projected_runs_compact(
            *_torch(ops, lens, n_runs, ref_start), min_len=50, cap=cap)
        _assert_all_equal(got, [p.numpy() for p in pad])


# T well past the runs' total, and rows with more runs than O (their cells
# past O are dropped); a zero-run row at the end.
@pytest.mark.parametrize("case", ["t_above_total", "rows_over_O"])
def test_csr_to_padded(case):
    rng = np.random.default_rng(5)
    N, O = 24, 16
    n_runs = rng.integers(0, O + 1 if case == "t_above_total" else 3 * O,
                          N).astype(np.int32)
    n_runs[-1] = 0
    total = int(n_runs.sum())
    T = total + 1000 if case == "t_above_total" else total
    of = np.zeros(T, np.uint8)
    of[:total] = rng.integers(0, 9, total)
    lf = np.zeros(T, np.int32)
    lf[:total] = rng.integers(1, 1000, total)
    want = jax_csr_to_padded(of, lf, n_runs, O=O)
    got = csr_to_padded(*_torch(of, lf, n_runs), O=O)
    _assert_all_equal(got, want)
    assert (n_runs > O).any() == (case == "rows_over_O")


def test_int32_wraparound():
    """ref_start near 2^31 with long reference runs: the coordinates wrap
    in int32, as the JAX program's int32 cumsum does."""
    rng = np.random.default_rng(8)
    N, O = 16, 32
    ops, lens, n_runs, ref_start = _padded(rng, N, O, big_share=0.5)
    lens[:, :] = np.where(ops == 9, 0, lens * 1000)
    ops[0, :4], lens[0, :4], n_runs[0] = [0, 2, 1, 0], \
        [2_000_000_000, 400_000_000, 60, 5], 4
    ref_start[:4] = [2**31 - 10, 2**31 - 1, -2**31, 2**31 - 3_000_000]
    want = jops.scan_projected_runs(ops, lens, n_runs, ref_start)
    got = tops.scan_projected_runs(*_torch(ops, lens, n_runs, ref_start))
    _assert_all_equal(got, want)
    ref = np.asarray(want[1]).astype(np.int64)
    assert (ref < 0).any() and ref[0, 2] == \
        ((2**31 - 10 + 2_400_000_000 + 2**31) % 2**32) - 2**31
    want = jops.scan_projected_runs_compact(ops, lens, n_runs, ref_start,
                                            cap=64)
    got = tops.scan_projected_runs_compact(
        *_torch(ops, lens, n_runs, ref_start), cap=64)
    _assert_all_equal(got, want)


def _projected(seed: int, n: int):
    """ProjectedReads: a ragged count, one read of 8,200 runs (over the
    largest bucket: host scan) and a dense block that pushes one batch
    over the compaction cap of 2,048 hits."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 40))
        runs = [(int(o), int(l)) for o, l in zip(
            rng.choice(OPS, k),
            np.where(rng.random(k) < 0.15, rng.choice([49, 50, 120], k),
                     rng.integers(1, 30, k)))]
        if i == n // 3:
            runs = [(0, 3), (1, 60)] * 4100
        if 140 <= i < 240:
            runs = [(0, 10), (1, 55), (2, 70)] * 15
        out.append(ProjectedRead(
            read_name=f"r{i}", read_len=5000, read_start=0, read_end=5000,
            rc=bool(i % 3 == 0),
            reference_start=int(rng.integers(-1, 1 << 22)), runs=runs))
    return out


def _dicts(bps):
    return [b.__dict__ for b in bps]


# "padded": the Python parse through the device scan (the JAX package's
# padded feed; the port ships it in the CSR layout).
@pytest.mark.parametrize("path", ["padded", "host_scan"])
def test_detect_breakpoints(path):
    prs = _projected(1, 301)
    stats = {}
    device_scan = path == "padded"
    want = jpipe.detect_breakpoints(iter(prs), 50, batch_reads=128,
                                    n_shards=1, device=device_scan)
    got = tpipe.detect_breakpoints(iter(prs), 50, batch_reads=128,
                                   device="cpu",
                                   use_device_scan=device_scan, stats=stats)
    assert _dicts(got) == _dicts(want)
    if device_scan:
        assert stats["scan_batches"] == 3 and stats["rescans"] == 1
        assert stats["host_reads"] == 1 and stats["reads"] == 301


def _native_gaf(tmp_path, n_reads: int, seed: int = 2):
    """A GFA of three 20 kb backbone segments and a GAF whose reads carry
    I/D/clip runs around 50 bp, a read of 8,200 runs and a block of dense
    reads (over the compaction cap in a batch of 64)."""
    rng = np.random.default_rng(seed)
    gfa = str(tmp_path / "n.gfa")
    make_backbone_gfa(gfa, [20_000, 20_000, 20_000])
    lines = []
    for i in range(n_reads):
        if i == n_reads // 2:
            cig = "1=1X" * 4100
        elif 64 <= i < 128:
            cig = "10=55I70D" * 20 + "10="
        else:
            parts = []
            for _ in range(int(rng.integers(1, 25))):
                op = str(rng.choice(list("=XID")))
                ln = int(rng.choice([49, 50, 51, 90])) if rng.random() < 0.2 \
                    else int(rng.integers(1, 30))
                parts.append(f"{ln}{op}")
            cig = "".join(parts) + "5="
        q = sum(int(x[:-1]) for x in _cig_ops(cig) if x[-1] in "=XI")
        r = sum(int(x[:-1]) for x in _cig_ops(cig) if x[-1] in "=XD")
        clip = int(rng.choice([0, 0, 20, 60]))
        seg = int(rng.integers(1, 4))
        off = int(rng.integers(0, 20_000 - r - 1))
        path = f">{seg}" if i % 5 else f"<{seg}"
        lines.append(gaf_line(f"q{i}", q + clip, clip, q + clip, path,
                              20_000, off, off + r, cig))
    gaf = str(tmp_path / "n.gaf")
    with open(gaf, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return gfa, gaf


def _cig_ops(cig: str) -> list[str]:
    import re

    return re.findall(r"\d+[=XIDS]", cig)


def test_detect_breakpoints_native(tmp_path):
    gfa_path, gaf = _native_gaf(tmp_path, 211)
    gfa = parse_gfa(gfa_path)
    ja, ta = JaxNativeGafReader(gaf, gfa), NativeGafReader(gaf, gfa)
    stats = {}
    try:
        want = jpipe.detect_breakpoints_native(ja, 50, batch_reads=64,
                                               n_shards=1)
        got = tpipe.detect_breakpoints_native(ta, 50, batch_reads=64,
                                              device="cpu", stats=stats)
    finally:
        ja.close()
        ta.close()
    assert _dicts(got) == _dicts(want)
    assert len(got) > 2048
    assert stats["scan_batches"] == 4 and stats["rescans"] == 1
    assert stats["host_reads"] == 1 and stats["reads"] == 211


def test_cluster_breakpoints():
    rng = np.random.default_rng(4)
    bps = [Breakpoint(f"r{i}", str(rng.choice(["INS", "DEL", "CLIP"])),
                      int(rng.integers(0, 3000)), int(rng.integers(0, 900)),
                      int(rng.integers(50, 400)), bool(i % 2))
           for i in range(400)]
    for min_count, window in ((3, 100), (2, 30), (5, 250)):
        want = jpipe.cluster_breakpoints(bps, min_count, window)
        got = tpipe.cluster_breakpoints(bps, min_count, window)
        assert [(c.type, c.ref_pos, c.length, c.support,
                 _dicts(c.members)) for c in got] == \
            [(c.type, c.ref_pos, c.length, c.support, _dicts(c.members))
             for c in want]
        assert [c.line() for c in got] == [c.line() for c in want]


def _disc_triple(tmp_path):
    """tests/test_discover.py's end-to-end fixture: 4 reads through a
    120 bp alt segment (INS), 3 skipping a backbone segment (DEL), a
    mapq-0 read, a reverse-complement INS read and a read on a missing
    node."""
    gfa = str(tmp_path / "g.gfa")
    seqs = make_backbone_gfa(gfa, [1000, 1000, 1000],
                             alt={(1, 2): (10, 120)})
    gaf, fq = str(tmp_path / "a.gaf"), str(tmp_path / "r.fq")
    reads, lines = {}, []
    for i in range(4):
        off = 300 + i * 17
        pre = 1000 - off
        lines.append(gaf_line(f"ins{i}", pre + 520, 0, pre + 520, ">1>10>2",
                              2120, off, off + pre + 520,
                              f"{pre}=120=400="))
        reads[f"ins{i}"] = seqs[1][off:] + seqs[10] + seqs[2][:400]
    for i in range(3):
        off = 400 + i * 23
        pre = 1000 - off
        lines.append(gaf_line(f"del{i}", pre + 500, 0, pre + 500, ">1>3",
                              2000, off, off + pre + 500, f"{pre + 500}="))
        reads[f"del{i}"] = seqs[1][off:] + seqs[3][:500]
    lines.append(gaf_line("junk", 100, 0, 100, ">1", 1000, 0, 100, "100=",
                          qual=0))
    lines.append(gaf_line("lost", 100, 0, 100, ">1>99", 1000, 0, 100,
                          "100="))
    with open(gaf, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    write_fastq(fq, reads)
    return gfa, gaf, fq


def _lines(mod, cfg: DiscConfig, **kw):
    err = io.StringIO()
    lines = mod.run_discover(cfg, out=io.StringIO(), err=err, **kw)
    return lines, err.getvalue()


# The native projector (the default), the Python parse with the device
# scan, and the host scalar scan.
PATHS = {"native": {}, "python_parse": {"use_native_parse": False},
         "host_scan": {"use_device_scan": False}}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_run_discover_triple(tmp_path, path):
    gfa, gaf, fq = _disc_triple(tmp_path)
    cfg = dict(gfa_file=gfa, gaf_file=gaf, fq_file=fq, **PATHS[path])
    want, jerr = _lines(jpipe, DiscConfig(data_shards=1, **cfg))
    got, terr = _lines(tpipe, DiscConfig(**cfg), device="cpu")
    assert got == want
    assert terr == jerr and "Read lost has an invalid path" in terr
    assert len(got) == 2 and "seq: NA" not in got[0]


def test_run_discover_bench_fixture(tmp_path):
    """tools/bench_disc.py's fixture at 20,000 reads: INS clusters whose
    members differ (so the POA DP runs), every line with its seq."""
    gfa, gaf, fq = build_fixture(str(tmp_path), 20_000, seed=0)
    want, _ = _lines(jpipe, DiscConfig(gfa_file=gfa, gaf_file=gaf,
                                       fq_file=fq, data_shards=1))
    stats = {}
    got, _ = _lines(tpipe, DiscConfig(gfa_file=gfa, gaf_file=gaf,
                                      fq_file=fq), device="cpu", stats=stats)
    assert got == want
    assert stats["scan_batches"] == 3 and stats["reads"] == 20_000
    assert stats["ins_clusters"] == len(got) >= 40
    assert stats["dp_calls"] >= 1 and stats["rescans"] == 0


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_interop(tmp_path, writer):
    """A detection checkpoint written by either package restores in the
    other: the reader skips the projection and prints the same lines."""
    gfa, gaf, fq = _disc_triple(tmp_path)
    cfg = DiscConfig(gfa_file=gfa, gaf_file=gaf, fq_file=fq,
                     output_file=str(tmp_path / "d.out"), data_shards=1,
                     resume=True)
    first, _ = (_lines(jpipe, cfg) if writer == "jax"
                else _lines(tpipe, cfg, device="cpu"))
    assert os.path.exists(cfg.output_file + ".ckpt.npz")
    got, err = (_lines(tpipe, cfg, device="cpu") if writer == "jax"
                else _lines(jpipe, cfg))
    assert "Resume: 7 breakpoint(s) restored" in err
    assert got == first and len(got) == 2


def test_missing_native_gaf_raises(tmp_path, monkeypatch):
    """No quiet switch to the Python parse when the C library is
    unavailable; use_native_parse=False still runs it."""
    gfa, gaf, fq = _disc_triple(tmp_path)

    def no_lib(*a, **k):
        raise OSError("native library unavailable")

    monkeypatch.setattr(NativeGafReader, "__init__", no_lib)
    cfg = DiscConfig(gfa_file=gfa, gaf_file=gaf, fq_file=fq)
    with pytest.raises(Unsupported, match="native GAF reader"):
        tpipe.run_discover(cfg, out=io.StringIO(), err=io.StringIO(),
                           device="cpu")
    cfg.use_native_parse = False
    assert len(_lines(tpipe, cfg, device="cpu")[0]) == 2
