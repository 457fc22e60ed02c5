"""The port's device evidence walk against the JAX package on the CPU:
`audit_refine_step` and `audit_refine_step_csr` (svtrek_tpu_torch.ops.
audit_step) bit-identical to svtrek_tpu.ops.audit_step's, refined values,
counts and overflow flags; the dense and CSR packers equal to
svtrek_tpu.pipeline.pack's; then `run_audit` with `--extract device` and
with `--no-native-io` (the Python BAM reader) giving svtrek_tpu's result
lines and fallback counts, on planted fixtures, on every regime of
tests/test_fallback_stress.py and on a read past the top ops bucket."""
from __future__ import annotations

import dataclasses
import io
import os
import re

import numpy as np
import pytest
import torch

from svtrek_tpu.config import AudtConfig
from svtrek_tpu.constants import CIGAR_D, CIGAR_M, KIND_DEL_START
from svtrek_tpu.io.bam import BamRecord, BamWriter
from svtrek_tpu.native import native_bam_reader
from svtrek_tpu.ops import audit_step as jstep
from svtrek_tpu.pipeline import pack as jpack
from svtrek_tpu.pipeline.audit import run_audit as jax_run_audit
from svtrek_tpu_torch.ops import audit_step as tstep
from svtrek_tpu_torch.ops import cigar as tcigar
from svtrek_tpu_torch.ops import consensus as tconsensus
from svtrek_tpu_torch.pipeline import audit as taudit
from svtrek_tpu_torch.pipeline import pack as tpack
from tests.fixtures import PlantedSV, write_fixture
from tests.test_cigar_kernel import pack_reads, random_read
from tests.test_fallback_stress import dense_fixture  # noqa: F401
from tests.test_torch_pack import SVS as PACK_SVS
from tests.test_torch_pack import _windows


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a)))


def _breakpoint_tasks(rng, n_tasks):
    """tests/test_cigar_kernel.py's full-step tasks: reads piled on one
    breakpoint per window, plus random reads, over every kind."""
    tasks = []
    for _ in range(n_tasks):
        base = int(rng.integers(20_000, 200_000))
        bp = base + int(rng.integers(-200, 200))
        reads = []
        for _ in range(int(rng.integers(0, 20))):
            jitter = int(rng.integers(-3, 4))
            start = bp - int(rng.integers(100, 1500))
            reads.append((start, [(CIGAR_M, bp + jitter - start),
                                  (CIGAR_D, int(rng.integers(45, 80))),
                                  (CIGAR_M, 500)]))
        reads += [random_read(rng, base)
                  for _ in range(int(rng.integers(0, 6)))]
        tasks.append((int(rng.integers(0, 5)), reads, base - 2000,
                      base + 2000, base))
    return tasks


STEP_CASES = {
    # (seed, K, sweep_width): K 128 holds every window; K 16 overflows the
    # piled windows; sweep_width 2 overflows the consensus sweep.
    "k128": (0, 128, 128),
    "k128_b": (1, 128, 128),
    "k16": (2, 64, 128),
    "sweep2": (3, 128, 2),
}


def _compare(want, got):
    names = ("refined", "counts", "overflow")
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_audit_refine_step_matches_jax(name):
    seed, K, sw = STEP_CASES[name]
    rng = np.random.default_rng(1000 + seed)
    tasks = _breakpoint_tasks(rng, 32)
    if name == "k16":
        # A window of 80 candidates from reads of 10 D ops each: counts
        # past K and read_cap overflow.
        many = (60_000, [(CIGAR_M, 100), (CIGAR_D, 60)] * 10)
        tasks.append((KIND_DEL_START, [many] * 8, 59_000, 63_000, 60_100))
    packed = pack_reads(tasks, 32, pad_n=512)
    kw = dict(num_windows=len(tasks), K=K, sweep_width=sw)
    want = jstep.audit_refine_step(*packed, **kw)
    got = tstep.audit_refine_step(*(_t(a) for a in packed), **kw)
    _compare(want, got)
    ovf = np.asarray(want[2])
    assert np.asarray(want[0]).max() > 0
    if name != "k128" and name != "k128_b":
        assert ovf.any()


def _to_csr(packed, T_pad=64):
    """The CSR layout of a pack_reads batch: real ops back to back, a
    garbage tail."""
    ops, lens, pos, n_ops, *rest = packed
    keep = np.arange(ops.shape[1])[None, :] < n_ops[:, None]
    ops_flat = np.concatenate([ops[keep].astype(np.uint8),
                               np.full(T_pad, 7, np.uint8)])
    lens_flat = np.concatenate([lens[keep], np.full(T_pad, 99, np.int32)])
    return (ops_flat, lens_flat, pos, n_ops, *rest)


@pytest.mark.parametrize("seed", range(2))
def test_audit_refine_step_csr_matches_jax(seed):
    rng = np.random.default_rng(2000 + seed)
    tasks = _breakpoint_tasks(rng, 24)
    csr = _to_csr(pack_reads(tasks, 32, pad_n=256))
    kw = dict(num_windows=len(tasks), K=64)
    # The JAX step pads the runs to O on the device; the port's walk
    # reads the flat streams as they are.
    want = jstep.audit_refine_step_csr(*csr, O=32, **kw)
    got = tstep.audit_refine_step_csr(*(_t(a) for a in csr), **kw)
    _compare(want, got)
    # And the dense step on the same reads.
    dense = tstep.audit_refine_step(*(_t(a) for a in pack_reads(
        tasks, 32, pad_n=256)), num_windows=len(tasks), K=64)
    for a, b in zip(got, dense):
        assert torch.equal(a, b)


def test_audit_refine_step_runs_the_consensus_dispatch():
    """The step's consensus is consensus_pos_batch (K1 on CUDA tensors,
    the plain version here) and its walk is counted by device."""
    rng = np.random.default_rng(3)
    packed = pack_reads(_breakpoint_tasks(rng, 4), 32, pad_n=64)
    plain = tconsensus.plain_calls["consensus_pos"]
    walks = tcigar.walk_calls["cpu"]
    tstep.audit_refine_step(*(_t(a) for a in packed), num_windows=4, K=64)
    assert tconsensus.plain_calls["consensus_pos"] == plain + 1
    assert tcigar.walk_calls["cpu"] == walks + 1


# ---- the packers -------------------------------------------------------

@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_audit_device")
    bam, vcf = write_fixture(str(d), PACK_SVS, {1: 500_000, 2: 400_000},
                             seed=4, depth=24, noise=40)
    return str(d), bam, vcf


def _same_batch(got, want):
    assert type(got.batch).__name__ == type(want.batch).__name__
    _only_jax_fields(got.batch, want.batch)
    for f in dataclasses.fields(got.batch):
        a, b = getattr(got.batch, f.name), getattr(want.batch, f.name)
        if f.name in ("ops_flat", "lens_flat"):
            # The CSR streams' tail past the real ops is not read.
            assert a.shape == b.shape and a.dtype == b.dtype, f.name
            t = int(want.batch.n_ops.sum())
            a, b = a[:t], b[:t]
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert [dataclasses.astuple(w) for w in got.windows] == \
        [dataclasses.astuple(w) for w in want.windows]
    assert [tpack.as_read_list(r) for r in got.reads_per_window] == \
        [jpack.as_read_list(r) for r in want.reads_per_window]
    # The port keeps every window on the device; on these fixtures the JAX
    # package sends none to the oracle either.
    assert not want.oracle_windows and not hasattr(got, "oracle_windows")


def _only_jax_fields(got, want):
    """The port's batch has the JAX package's fields but the CSR layout's
    O bucket, which only JAX's device-side padding reads."""
    extra = {f.name for f in dataclasses.fields(want)} - \
        {f.name for f in dataclasses.fields(got)}
    assert extra <= {"ops_width"}, extra


@pytest.mark.parametrize("layout", ["native", "python"])
def test_packers_match_jax(planted, layout):
    """pack_chunk_native (the CSR layout) and pack_chunk on the Python
    reader's list form equal svtrek_tpu.pipeline.pack's."""
    _, bam, vcf = planted
    cfg = AudtConfig(bam_file=bam, batch_windows=4, refine_inv=True)
    jw, _ = _windows(jpack, vcf, cfg)
    tw, _ = _windows(tpack, vcf, cfg)
    reader = native_bam_reader(bam)
    py = taudit.python_fetch(taudit.BamReader(bam))
    for lo in range(0, len(jw), 4):
        if layout == "native":
            want = jpack.pack_chunk_native(jw[lo:lo + 4], reader, cfg)
            got = tpack.pack_chunk_native(tw[lo:lo + 4], reader, cfg)
        else:
            want = jpack.pack_chunk(jw[lo:lo + 4], py, cfg)
            got = tpack.pack_chunk(tw[lo:lo + 4], py, cfg)
        _same_batch(got, want)


# ---- run_audit ---------------------------------------------------------

def _fallbacks(err: str, device_key: str) -> tuple[int, ...]:
    m = re.search(r"kovf=(\d+) sweep=(\d+) long_ops=(\d+) "
                  + device_key + r"=(\d+)", err)
    assert m, err
    return tuple(int(x) for x in m.groups())


def _second_pass(err: str) -> tuple[int, int]:
    """The port's (wide_k, sweep_full): windows past K and rows whose
    sweep overflowed, both given a second pass on the device."""
    m = re.search(r"wide_k=(\d+) sweep_full=(\d+)", err)
    assert m, err
    return int(m.group(1)), int(m.group(2))


def _run_both(cfg_kw, d=None, tag="", second=False):
    """svtrek_tpu's and the port's run_audit (--device cpu) on one config;
    returns ((lines, fallbacks, cfg), (lines, fallbacks, cfg)), and with
    ``second`` the port's `_second_pass` counts as well."""
    out = []
    for run, extra, key in ((jax_run_audit, dict(data_shards=1), "device"),
                            (taudit.run_audit, dict(device="cpu"),
                             "dev_ovf")):
        kw = dict(cfg_kw)
        for f in ("output_file", "refined_vcf"):
            if f in kw:
                kw[f] = os.path.join(d, f"{tag}_{key}_{kw[f]}")
        cfg = AudtConfig(verbose=True, **kw, **extra)
        err = io.StringIO()
        lines = run(cfg, out=io.StringIO(), err=err)
        out.append((lines, _fallbacks(err.getvalue(), key), cfg))
    if second:
        return out, _second_pass(err.getvalue())
    return out


RUN_CASES = {
    "device_default": dict(extract="device"),
    "device_small_batches": dict(extract="device", batch_windows=3,
                                 max_candidates=64),
    "device_refine_inv_files": dict(extract="device", refine_inv=True,
                                    batch_windows=8, max_candidates=64,
                                    output_file="o.txt",
                                    refined_vcf="r.vcf"),
    "device_shard": dict(extract="device", num_shards=2, shard_index=0,
                         batch_windows=8, max_candidates=64),
    "python_default": dict(use_native_io=False),
    "python_small_batches": dict(use_native_io=False, batch_windows=3,
                                 max_candidates=64, refine_inv=True),
    "python_ins_consensus": dict(use_native_io=False, batch_windows=8,
                                 max_candidates=64, ins_consensus=True),
    "python_extract_host": dict(use_native_io=False, extract="host",
                                batch_windows=8, max_candidates=64),
}


@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_run_audit_device_paths_match_jax(planted, name):
    d, bam, vcf = planted
    (jl, jf, jcfg), (tl, tf, tcfg) = _run_both(
        dict(bam_file=bam, vcf_file=vcf, **RUN_CASES[name]), d, name)
    assert tl == jl
    assert len(tl) >= 4
    assert tf == jf
    for f in ("output_file", "refined_vcf"):
        if getattr(tcfg, f):
            with open(getattr(tcfg, f)) as a, open(getattr(jcfg, f)) as b:
                assert a.read() == b.read(), f
    if name == "python_ins_consensus":
        assert sum(", seq: " in l and "seq: NA" not in l for l in tl) >= 1


@pytest.mark.parametrize("path", ["device", "python"])
@pytest.mark.parametrize("cand_width,sweep_width", [
    (16, 8),     # K overflow AND sweep overflow territory
    (1024, 8),   # sweep overflow only
    (16, 1024),  # K overflow only
])
def test_dense_repeat_regimes_match_jax(dense_fixture, path, cand_width,
                                        sweep_width):
    """tests/test_fallback_stress.py's regimes on the device walk: the
    lines equal svtrek_tpu's; the dense window, which svtrek_tpu sends to
    the host oracle (its `device` count), takes the port's second pass on
    the device (wide_k + sweep_full), and the port's dev_ovf is 0."""
    bam, vcf, _, _ = dense_fixture
    kw = dict(bam_file=bam, vcf_file=vcf, cand_width=cand_width,
              sweep_width=sweep_width, max_candidates=cand_width,
              batch_windows=4)
    kw.update(extract="device" if path == "device" else "auto",
              use_native_io=path == "device")
    ((jl, jf, _), (tl, tf, _)), second = _run_both(kw, second=True)
    assert tl == jl and len(tl) == 1
    assert tf[:3] == jf[:3] and tf[3] == 0
    assert jf[3] >= 1 and sum(second) == jf[3]


@pytest.fixture(scope="module")
def long_read_fixture(tmp_path_factory):
    """A window holding one read of 16,400 CIGAR ops (past the top ops
    bucket), beside ordinary INS and DEL windows."""
    d = tmp_path_factory.mktemp("long_ops")
    bam, vcf = str(d / "long.bam"), str(d / "long.vcf")
    reads = [(40_000 + 7 * i, [(0, 9_990 - 7 * i), (1, 80), (0, 3_000)])
             for i in range(6)]
    reads += [(90_000 + 5 * i, [(0, 10_000 - 5 * i), (2, 300), (0, 2_000)])
              for i in range(6)]
    reads.append((48_000, [(0, 3), (2, 1)] * 8_200))
    reads.sort()
    with BamWriter(bam, [("1", 400_000)]) as w:
        for i, (s, cig) in enumerate(reads):
            qlen = sum(l for op, l in cig if op in (0, 1, 4))
            w.write(BamRecord(name=f"r{i}", flag=0, tid=0, pos=s, mapq=60,
                              cigar=cig, seq="A" * qlen))
    with open(vcf, "w") as fh:
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.write("1\t50000\ta\tN\t<INS>\t.\tPASS\tSVTYPE=INS\n")
        fh.write("1\t100000\tb\tN\t<DEL>\t.\tPASS\tSVTYPE=DEL;END=100300\n")
    return bam, vcf


@pytest.mark.parametrize("path", ["device", "python"])
def test_long_ops_window_matches_jax(long_read_fixture, path):
    """A read past MAX_OPS_BUCKET: svtrek_tpu sends its window to the host
    oracle (long_ops) on both device-walk paths; the port walks it on the
    device, with the same lines."""
    bam, vcf = long_read_fixture
    kw = dict(bam_file=bam, vcf_file=vcf, batch_windows=4,
              max_candidates=64)
    kw.update(extract="device") if path == "device" else \
        kw.update(use_native_io=False)
    (jl, jf, _), (tl, tf, _) = _run_both(kw)
    assert tl == jl and len(tl) == 2
    assert jf[2] >= 1 and tf[2] == 0
    assert tf[:2] == jf[:2] and tf[3] <= jf[3]


@pytest.fixture(scope="module")
def many_cand_fixture(tmp_path_factory):
    """A DEL window holding one read of 12 deletions past 50 bp and an INS
    window holding one read of 12 insertions of 60 bp (past the JAX device
    walk's read_cap of 8), each beside 6 reads that support the site."""
    d = tmp_path_factory.mktemp("many_cand")
    bam, vcf = str(d / "many.bam"), str(d / "many.vcf")
    reads = [(40_000 + 7 * i, [(0, 9_990 - 7 * i), (1, 80), (0, 3_000)])
             for i in range(6)]
    reads.append((45_000, [(0, 400), (1, 60)] * 12 + [(0, 500)]))
    reads += [(90_000 + 5 * i, [(0, 10_000 - 5 * i), (2, 300), (0, 2_000)])
              for i in range(6)]
    reads.append((95_000, [(0, 300), (2, 55)] * 12 + [(0, 500)]))
    reads.sort()
    with BamWriter(bam, [("1", 400_000)]) as w:
        for i, (s, cig) in enumerate(reads):
            qlen = sum(l for op, l in cig if op in (0, 1, 4))
            w.write(BamRecord(name=f"r{i}", flag=0, tid=0, pos=s, mapq=60,
                              cigar=cig, seq="A" * qlen))
    with open(vcf, "w") as fh:
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.write("1\t50000\ta\tN\t<INS>\t.\tPASS\tSVTYPE=INS\n")
        fh.write("1\t100000\tb\tN\t<DEL>\t.\tPASS\tSVTYPE=DEL;END=100300\n")
    return bam, vcf


@pytest.mark.parametrize("path", ["device", "python"])
def test_many_candidate_read_stays_on_device(many_cand_fixture, path):
    """A read with more candidates than the JAX walk's read_cap of 8:
    svtrek_tpu sends its window to the host oracle (dev_ovf); the port
    keeps every candidate on the device, with the same lines."""
    bam, vcf = many_cand_fixture
    kw = dict(bam_file=bam, vcf_file=vcf, batch_windows=4)
    kw.update(extract="device") if path == "device" else \
        kw.update(use_native_io=False)
    (jl, jf, _), (tl, tf, _) = _run_both(kw)
    assert tl == jl and len(tl) == 2
    assert jf[3] >= 2 and tf == (0, 0, 0, 0)


def test_long_read_chunk_packs_flat(long_read_fixture):
    """pack_chunk (the Python reader) lays a chunk that holds a read past
    the top ops bucket out flat, equal to pack_chunk_native's batch of
    the same windows, one shard and two; every window stays in the
    batch."""
    bam, vcf = long_read_fixture
    cfg = AudtConfig(bam_file=bam, batch_windows=4)
    tw, _ = _windows(tpack, vcf, cfg)
    reader = native_bam_reader(bam)
    py = taudit.python_fetch(taudit.BamReader(bam))
    for n in (1, 2):
        got = tpack.pack_chunk(tw, py, cfg, n_shards=n)
        want = tpack.pack_chunk_native(tw, reader, cfg, n_shards=n)
        assert isinstance(got.batch, tstep.AuditBatchCSR)
        assert int(got.batch.n_ops.max()) > tpack.MAX_OPS_BUCKET
        for f in dataclasses.fields(want.batch):
            np.testing.assert_array_equal(getattr(got.batch, f.name),
                                          getattr(want.batch, f.name),
                                          err_msg=f.name)
        assert got.windows == want.windows and \
            got.window_slots == want.window_slots
        assert [tpack.as_read_list(r) for r in got.reads_per_window] == \
            [tpack.as_read_list(r) for r in want.reads_per_window]


def test_no_native_io_never_opens_the_native_reader(planted, monkeypatch):
    """--no-native-io runs with the native library gone; the default path
    raises instead of switching to the Python reader."""
    _, bam, vcf = planted

    def no_lib(path):
        raise OSError("native library unavailable")

    monkeypatch.setattr(taudit, "native_bam_reader", no_lib)
    got = taudit.run_audit(
        AudtConfig(bam_file=bam, vcf_file=vcf, device="cpu",
                   use_native_io=False, max_candidates=64),
        out=io.StringIO(), err=io.StringIO())
    want = jax_run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                    data_shards=1, max_candidates=64),
                         out=io.StringIO(), err=io.StringIO())
    assert got == want
    with pytest.raises(taudit.NativeReaderUnavailable,
                       match="--no-native-io runs the Python"):
        taudit.run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                    device="cpu", extract="device"),
                         out=io.StringIO(), err=io.StringIO())


def test_ins_consensus_python_reader_matches_native(planted):
    """The Python reader's insert collection equals the native reader's
    svbam_ins_seqs over every planted INS site."""
    _, bam, _ = planted
    py, nat = taudit.BamReader(bam), native_bam_reader(bam)
    n = 0
    for tid, r in [(0, 119_999), (1, 159_999), (0, 50_000)]:
        lo, hi = r - 5, r + 5
        a = taudit._ins_seqs_py(py, tid, max(lo, 0), hi + 1, 50, lo, hi)
        assert a == nat.ins_seqs(tid, max(lo, 0), hi + 1, 50, lo, hi)
        n += len(a)
    assert n > 10
