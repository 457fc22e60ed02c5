"""The port's multi-device layer on CPU shards against the JAX package on
the 8 virtual devices of tests/conftest.py, with tolerance 0: the
shard-blockwise packers (every array and `window_slots`), the four sharded
steps of svtrek_tpu_torch.parallel.mesh (against JAX's sharded steps and
against the port's dense step), and `run_audit` / `run_discover` at
data_shards 2 and 8 (each path, and batches over the per-shard disc cap,
which the JAX package rescans on the host and the port pages on the
device) against JAX's at the same count and the port's own data_shards=1
run."""
from __future__ import annotations

import dataclasses
import io
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from svtrek_tpu.config import AudtConfig, DiscConfig
from svtrek_tpu.io.gaf_native import NativeGafReader as JaxNativeGafReader
from svtrek_tpu.io.gfa import parse_gfa
from svtrek_tpu.native import native_bam_reader
from svtrek_tpu.parallel import mesh as jmesh
from svtrek_tpu.pipeline import discover as jdisc
from svtrek_tpu.pipeline import pack as jpack
from svtrek_tpu.pipeline.audit import run_audit as jax_run_audit
from svtrek_tpu_torch.io.gaf_native import NativeGafReader
from svtrek_tpu_torch.native import native_bam_reader as torch_bam_reader
from svtrek_tpu_torch.ops import audit_step as tstep
from svtrek_tpu_torch.ops import consensus as tconsensus
from svtrek_tpu_torch.ops import discover as tops
from svtrek_tpu_torch.parallel import mesh as tmesh
from svtrek_tpu_torch.pipeline import audit as taudit
from svtrek_tpu_torch.pipeline import discover as tdisc
from svtrek_tpu_torch.pipeline import pack as tpack
from tests.fixtures import write_fixture
from tests.test_torch_audit import SVS
from tests.test_torch_audit_device import (  # noqa: F401
    _only_jax_fields, _second_pass, long_read_fixture, many_cand_fixture,
)
from tests.test_torch_discover import _dicts, _native_gaf, _projected
from tests.test_torch_pack import _windows, resolved_refined_c

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from bench_disc import build_fixture as build_disc_fixture  # noqa: E402

SHARDS = [2, 8]


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sharding")
    bam, vcf = write_fixture(str(d), SVS, {1: 500_000, 2: 400_000}, seed=2,
                             depth=24, noise=40)
    return str(d), bam, vcf


def _jax_mesh(n: int):
    devs = jax.devices()[:n]
    assert len(devs) == n
    return jmesh.make_mesh(devs)


def _cpu_mesh(n: int):
    return tmesh.make_mesh(["cpu"], n)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))


# ---- the packers --------------------------------------------------------

def _same_sharded_batch(got, want):
    _only_jax_fields(got.batch, want.batch)
    for f in dataclasses.fields(got.batch):
        a, b = getattr(got.batch, f.name), getattr(want.batch, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert [dataclasses.astuple(w) for w in got.windows] == \
        [dataclasses.astuple(w) for w in want.windows]
    assert got.n_shards == want.n_shards
    assert getattr(got, "window_slots", None) == \
        getattr(want, "window_slots", None)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("layout", ["cand", "native", "python"])
def test_sharded_packers_match_jax(planted, layout, n):
    """pack_chunk_cand, pack_chunk_native and pack_chunk with n_shards
    equal svtrek_tpu.pipeline.pack's: every array, the windows, the
    window slots (a ragged tail batch included)."""
    _, bam, vcf = planted
    cfg = AudtConfig(bam_file=bam, batch_windows=6, refine_inv=True)
    jw, _ = _windows(jpack, vcf, cfg)
    tw, _ = _windows(tpack, vcf, cfg)
    assert len(jw) % 6
    reader = native_bam_reader(bam)
    treader = torch_bam_reader(bam)
    py = taudit.python_fetch(taudit.BamReader(bam))
    for lo in range(0, len(jw), 6):
        jc, tc = jw[lo:lo + 6], tw[lo:lo + 6]
        if layout == "cand":
            want = jpack.pack_chunk_cand(jc, reader, cfg, n_shards=n)
            got = tpack.pack_chunk_cand(tc, treader, cfg, n_shards=n)
            assert got.batch.num_windows % n == 0
            np.testing.assert_array_equal(got.true_counts, want.true_counts)
            np.testing.assert_array_equal(resolved_refined_c(got),
                                          want.refined_c)
            assert got.num_reads == want.num_reads
        elif layout == "native":
            want = jpack.pack_chunk_native(jc, reader, cfg, n_shards=n)
            got = tpack.pack_chunk_native(tc, reader, cfg, n_shards=n)
        else:
            want = jpack.pack_chunk(jc, py, cfg, n_shards=n)
            got = tpack.pack_chunk(tc, py, cfg, n_shards=n)
            assert [tpack.as_read_list(r) for r in got.reads_per_window] \
                == [jpack.as_read_list(r) for r in want.reads_per_window]
        _same_sharded_batch(got, want)
        if layout != "cand":
            b = got.batch
            assert len(b.window_id) % n == 0 and b.num_windows % n == 0


# ---- the sharded steps --------------------------------------------------

def _global_ids(wid, n: int, b_per: int):
    g = np.asarray(wid).copy()
    per = len(g) // n
    for s in range(n):
        g[s * per:(s + 1) * per] += s * b_per
    return g


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_step_matches_jax_and_dense(n):
    """sharded_audit_step on CPU shards equals JAX's on n virtual devices
    and the port's dense step with global window ids (the counterpart of
    tests/test_sharding.py::test_sharded_step_matches_single)."""
    b_per = 4
    B = n * b_per
    args = tmesh.make_sharded_demo_batch(n, b_per_shard=b_per,
                                         reads_per_window=6, O=16, seed=1)
    _equal(args, jmesh.make_sharded_demo_batch(
        n, b_per_shard=b_per, reads_per_window=6, O=16, seed=1))
    got = tmesh.sharded_audit_step(_cpu_mesh(n), num_windows=B,
                                   K=64)(*args).gather()
    want = jmesh.sharded_audit_step(_jax_mesh(n), num_windows=B,
                                    K=64)(*args)
    _equal(got, want)
    assert not got[2].any()
    ops, lens, pos, n_ops, wid, *win = args
    dense = tstep.audit_refine_step(
        *_t(ops, lens, pos, n_ops, _global_ids(wid, n, b_per), *win),
        num_windows=B, K=64)
    _equal(got, [d.numpy() for d in dense])


def _demo_csr(args, n: int):
    """The demo batch in the shard-blockwise CSR layout of
    pack._pack_native_sharded: each shard's runs back to back in its own
    block of the flat streams."""
    ops, lens, pos, n_ops, wid, *win = args
    per = ops.shape[0] // n
    blocks = []
    for s in range(n):
        rows = range(s * per, (s + 1) * per)
        blocks.append((np.concatenate([ops[r, :n_ops[r]] for r in rows]),
                       np.concatenate([lens[r, :n_ops[r]] for r in rows])))
    t_loc = 256
    while t_loc < max(len(o) for o, _ in blocks):
        t_loc *= 2
    ops_flat = np.zeros(n * t_loc, np.uint8)
    lens_flat = np.zeros(n * t_loc, np.int32)
    for s, (o, ln) in enumerate(blocks):
        ops_flat[s * t_loc:s * t_loc + len(o)] = o
        lens_flat[s * t_loc:s * t_loc + len(ln)] = ln
    return (ops_flat, lens_flat, pos, n_ops, wid, *win)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_csr_step_matches_jax_and_dense(n):
    """sharded_audit_step_csr equals JAX's and the padded sharded step."""
    b_per = 3
    B = n * b_per
    args = tmesh.make_sharded_demo_batch(n, b_per_shard=b_per,
                                         reads_per_window=5, O=16, seed=5)
    csr = _demo_csr(args, n)
    got = tmesh.sharded_audit_step_csr(_cpu_mesh(n), num_windows=B,
                                       K=64)(*csr).gather()
    want = jmesh.sharded_audit_step_csr(_jax_mesh(n), num_windows=B, K=64,
                                        O=16)(*csr)
    _equal(got, want)
    padded = tmesh.sharded_audit_step(_cpu_mesh(n), num_windows=B,
                                      K=64)(*args).gather()
    _equal(got, padded)


def _consensus_problem(B: int, K: int, seed: int):
    rng = np.random.default_rng(seed)
    base = rng.integers(10_000, 1_000_000, B).astype(np.int64)
    counts = rng.integers(0, K + 1, B).astype(np.int32)
    locs = np.full((B, K), 0x7FFFFFFF, np.int32)
    for i in range(B):
        locs[i, :counts[i]] = np.sort(
            (base[i] + rng.integers(-400, 401, counts[i])).astype(np.int32))
    return locs, counts, base.astype(np.int32)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_consensus_step_matches_jax_and_dense(n):
    locs, counts, ipos = _consensus_problem(32, 32, 7)
    got = tmesh.sharded_consensus_step(_cpu_mesh(n), num_windows=32)(
        locs, counts, ipos).gather()
    want = jmesh.sharded_consensus_step(_jax_mesh(n), num_windows=32)(
        locs, counts, ipos)
    _equal(got, want)
    dense = tconsensus.consensus_pos_batch(*_t(locs, counts, ipos))
    _equal(got, [d.numpy() for d in dense])
    with pytest.raises(ValueError, match="not divisible by mesh size"):
        tmesh.sharded_consensus_step(_cpu_mesh(n), num_windows=33)


def _disc_problem(N: int, seed: int):
    rng = np.random.default_rng(seed)
    O = 16
    ops = np.full((N, O), 9, np.int8)
    lens = np.zeros((N, O), np.int32)
    n_runs = rng.integers(0, O, N).astype(np.int32)
    ref_start = rng.integers(1_000, 500_000, N).astype(np.int32)
    for i in range(N):
        k = n_runs[i]
        ops[i, :k] = rng.choice([0, 1, 2, 4], k)
        lens[i, :k] = np.where(rng.random(k) < 0.3, rng.integers(50, 200, k),
                               rng.integers(1, 45, k))
    return ops, lens, n_runs, ref_start


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_disc_step_matches_jax_and_dense(n):
    """sharded_disc_step equals JAX's (every slot, the filler past each
    shard's total included), and its rows shifted by s * N/S are the dense
    compact scan's hits."""
    N, cap = 64, 96
    args = _disc_problem(N, 11)
    got = tmesh.sharded_disc_step(_cpu_mesh(n), min_len=50, cap=cap)(
        *args).gather()
    want = jmesh.sharded_disc_step(_jax_mesh(n), min_len=50, cap=cap)(*args)
    _equal(got, want)
    totals, *res = got
    assert (totals <= cap).all() and totals.sum() > 0
    rows = []
    for s, t in enumerate(totals.tolist()):
        sl = slice(s * cap, s * cap + t)
        rows += zip(res[0][sl] + s * (N // n), *(a[sl] for a in res[1:]))
    total, *dense = tops.scan_projected_runs_compact(*_t(*args), cap=N * 16)
    t = int(total)
    assert rows == list(zip(*(d.numpy()[:t] for d in dense)))


def test_make_global_array_offsets():
    mesh = _cpu_mesh(4)
    g = tmesh.make_global_array(np.arange(8, dtype=np.int32), mesh)
    assert g.offsets == [0, 2, 4, 6]
    assert [s.tolist() for s in g.shards] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.make_global_array(np.arange(6), mesh)


# ---- run_audit ------------------------------------------------------------

def _fallbacks(err: str, key: str) -> tuple[int, ...]:
    m = re.search(r"kovf=(\d+) sweep=(\d+) long_ops=(\d+) " + key
                  + r"=(\d+)", err)
    assert m, err
    return tuple(int(x) for x in m.groups())


AUDIT_PATHS = {
    "host": {},
    "host_overflow": dict(cand_width=16, sweep_width=4),
    "device": dict(extract="device"),
    "device_overflow": dict(extract="device", sweep_width=2),
    "python": dict(use_native_io=False),
}


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("path", sorted(AUDIT_PATHS))
def test_run_audit_sharded_matches_jax(planted, path, n):
    """run_audit at data_shards n: the JAX package's lines and fallback
    counts at the same count, and the port's own data_shards=1 lines
    (batch_windows 4: several batches and a ragged tail)."""
    _, bam, vcf = planted
    kw = dict(bam_file=bam, vcf_file=vcf, batch_windows=4, max_candidates=64,
              verbose=True, **AUDIT_PATHS[path])
    jerr, terr = io.StringIO(), io.StringIO()
    want = jax_run_audit(AudtConfig(data_shards=n, **kw), out=io.StringIO(),
                         err=jerr)
    got = taudit.run_audit(AudtConfig(data_shards=n, device="cpu", **kw),
                           out=io.StringIO(), err=terr)
    dense = taudit.run_audit(AudtConfig(data_shards=1, device="cpu", **kw),
                             out=io.StringIO(), err=io.StringIO())
    assert got == want == dense and len(got) >= 4
    # The JAX package's host routes are the port's second passes on the
    # shards' devices: kovf and sweep are wide_k and sweep_full on the
    # host path, and `device` their sum on the device walk.
    jf = _fallbacks(jerr.getvalue(), "device")
    second = _second_pass(terr.getvalue())
    assert _fallbacks(terr.getvalue(), "dev_ovf") == (0, 0, 0, 0)
    assert second == jf[:2] if path.startswith("host") else \
        sum(second) == jf[3]
    assert f"device=cpu data_shards={n}" in terr.getvalue()
    if path.endswith("overflow"):
        assert sum(second) > 0


@pytest.mark.parametrize("path", ["device", "python"])
@pytest.mark.parametrize("route", ["long_read_fixture", "many_cand_fixture"])
def test_run_audit_sharded_routes(request, route, path):
    """The device walk's two routes at data_shards 2: a read past the top
    ops bucket, and reads past the JAX walk's read_cap.  The lines equal
    svtrek_tpu's at 2 shards (which sends those windows to the host
    oracle) and the port's own one-shard run, with no window on the
    oracle."""
    bam, vcf = request.getfixturevalue(route)
    kw = dict(bam_file=bam, vcf_file=vcf, batch_windows=4, verbose=True,
              **AUDIT_PATHS[path])
    jerr, terr = io.StringIO(), io.StringIO()
    want = jax_run_audit(AudtConfig(data_shards=2, **kw), out=io.StringIO(),
                         err=jerr)
    got = taudit.run_audit(AudtConfig(data_shards=2, device="cpu", **kw),
                           out=io.StringIO(), err=terr)
    dense = taudit.run_audit(AudtConfig(data_shards=1, device="cpu", **kw),
                             out=io.StringIO(), err=io.StringIO())
    assert got == want == dense and len(got) == 2
    jf = _fallbacks(jerr.getvalue(), "device")
    assert jf[2] + jf[3] >= 1
    assert _fallbacks(terr.getvalue(), "dev_ovf") == (0, 0, 0, 0)
    assert "data_shards=2" in terr.getvalue()


@pytest.mark.parametrize("path", ["device", "python"])
def test_run_audit_more_shards_than_devices(planted, path):
    """data_shards 16: the port's mesh holds 16 shards whatever the
    device count, so the walk's shard-local window ids line up and the
    lines equal the one-shard run's (svtrek_tpu builds its mesh from
    jax.devices()[:16], 8 devices here, and misplaces them: ROADMAP
    queue 3)."""
    _, bam, vcf = planted
    kw = dict(bam_file=bam, vcf_file=vcf, batch_windows=4, max_candidates=64,
              device="cpu", **AUDIT_PATHS[path])
    got = taudit.run_audit(AudtConfig(data_shards=16, **kw),
                           out=io.StringIO(), err=io.StringIO())
    dense = taudit.run_audit(AudtConfig(data_shards=1, **kw),
                             out=io.StringIO(), err=io.StringIO())
    assert got == dense and len(got) >= 4


def test_resolve_data_shards_defaults_to_one_cpu_shard():
    cpu = torch.device("cpu")
    assert taudit.resolve_data_shards(AudtConfig(data_shards=0), cpu) == 1
    assert taudit.resolve_data_shards(AudtConfig(data_shards=3), cpu) == 3


# ---- disc -----------------------------------------------------------------

@pytest.mark.parametrize("n", SHARDS)
def test_detect_breakpoints_sharded(n):
    """The Python feed at n shards: JAX's breakpoints at n shards and the
    port's dense ones; the dense block of reads overflows a shard's cap, so
    that shard takes a second page on the device (the JAX package rescans
    the batch on the host)."""
    prs = _projected(1, 301)
    stats = {}
    want = jdisc.detect_breakpoints(iter(prs), 50, batch_reads=128,
                                    n_shards=n)
    got = tdisc.detect_breakpoints(iter(prs), 50, batch_reads=128,
                                   device="cpu", stats=stats, n_shards=n)
    dense = tdisc.detect_breakpoints(iter(prs), 50, batch_reads=128,
                                     device="cpu")
    assert _dicts(got) == _dicts(want) == _dicts(dense)
    assert stats["scan_batches"] == 3 and stats["rescans"] == 0
    assert stats["scan_pages2"] >= 1


@pytest.mark.parametrize("n", SHARDS)
def test_detect_breakpoints_native_sharded(tmp_path, n):
    gfa_path, gaf = _native_gaf(tmp_path, 211)
    gfa = parse_gfa(gfa_path)
    stats = {}
    readers = [JaxNativeGafReader(gaf, gfa), NativeGafReader(gaf, gfa),
               NativeGafReader(gaf, gfa)]
    try:
        want = jdisc.detect_breakpoints_native(readers[0], 50,
                                               batch_reads=64, n_shards=n)
        got = tdisc.detect_breakpoints_native(readers[1], 50,
                                              batch_reads=64, device="cpu",
                                              stats=stats, n_shards=n)
        dense = tdisc.detect_breakpoints_native(readers[2], 50,
                                                batch_reads=64, device="cpu")
    finally:
        for r in readers:
            r.close()
    assert _dicts(got) == _dicts(want) == _dicts(dense)
    assert stats["scan_batches"] == 4 and stats["rescans"] == 0
    assert stats["scan_pages2"] >= 1


@pytest.fixture(scope="module")
def disc_bench(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_sharding_disc"))
    return build_disc_fixture(d, 3000, seed=1)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("feed", ["native", "python_parse"])
def test_run_discover_sharded_matches_jax(disc_bench, feed, n):
    gfa, gaf, fq = disc_bench
    kw = dict(gfa_file=gfa, gaf_file=gaf, fq_file=fq, batch_reads=1024,
              use_native_parse=feed == "native")
    want = jdisc.run_discover(DiscConfig(data_shards=n, **kw),
                              out=io.StringIO(), err=io.StringIO())
    stats = {}
    got = tdisc.run_discover(DiscConfig(data_shards=n, **kw),
                             out=io.StringIO(), err=io.StringIO(),
                             device="cpu", stats=stats)
    dense = tdisc.run_discover(DiscConfig(data_shards=1, **kw),
                               out=io.StringIO(), err=io.StringIO(),
                               device="cpu")
    assert got == want == dense and any(", seq: " in l for l in got)
    assert stats["data_shards"] == n and stats["scan_batches"] == 3


def test_run_discover_more_shards_than_devices(disc_bench):
    """data_shards 16 (more than JAX's 8 devices here): the breakpoints
    keep their rows, so the lines equal the one-shard run's."""
    gfa, gaf, fq = disc_bench
    kw = dict(gfa_file=gfa, gaf_file=gaf, fq_file=fq, batch_reads=1024)
    got = tdisc.run_discover(DiscConfig(data_shards=16, **kw),
                             out=io.StringIO(), err=io.StringIO(),
                             device="cpu")
    dense = tdisc.run_discover(DiscConfig(data_shards=1, **kw),
                               out=io.StringIO(), err=io.StringIO(),
                               device="cpu")
    assert got == dense and any(", seq: " in l for l in got)
