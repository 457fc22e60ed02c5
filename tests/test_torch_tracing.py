"""The port's stage spans and counters: `svtrek_tpu_torch.tracing.span`,
the `[VERBOSE] stages` line of `pipeline.audit.run_audit` and the consensus
times on its ins_consensus line, read as the benchmark reads them
(`portbench/modes/audt.py::parse_verbose`), the C reader's inflate
counters, and the spans' profiler ranges as the benchmark's device trace
reader sees them (`portbench/devtrace.py`), all on --device cpu."""
from __future__ import annotations

import importlib.util
import io
import itertools
import os
import random
import sys
import threading
import zlib

import pytest
import torch

from svtrek_tpu_torch import tracing
from svtrek_tpu_torch.config import AudtConfig
from svtrek_tpu_torch.native import native_bam_reader
from svtrek_tpu_torch.native.bamlib import ReaderCounters
from svtrek_tpu_torch.pipeline import audit as taudit
from tests.fixtures import PlantedSV, write_fixture
from tests.test_ins_consensus import _rand_seq, build_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "portbench")
sys.path[:0] = [os.path.join(ROOT, "tools"), PB]

import devtrace  # noqa: E402
from ins_fixture import build_ins_fixture  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "portbench_mode_audt_for_tests", os.path.join(PB, "modes", "audt.py"))
audt_mode = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(audt_mode)

CHROM_LEN = 300_000
STAGES = ("queue_wait", "put_wait", "fetch", "extract", "inflate",
          "inflated_mb", "dispatch", "sync_wait", "write")
BEFORE = ("records", "windows", "reads", "batches", "parse", "fetch+pack",
          "device_wait", "emit", "total")
CONS_BEFORE = ("cons_sites", "cons_time", "cons_flushes", "cons_dp_calls")
CONS_STAGES = ("cons_seq_time", "cons_vote_time", "cons_dp_time")
HALF_MS = 0.0005  # the lines print each time rounded to the ms


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """One chromosome: a DEL, an INS and an INV."""
    d = tmp_path_factory.mktemp("tracing_planted")
    svs = [PlantedSV(1, 50_000, 50_400, "DEL", 400),
           PlantedSV(1, 120_000, 120_001, "INS", 120),
           PlantedSV(1, 180_000, 180_300, "INV", 300)]
    return write_fixture(str(d), svs, {1: CHROM_LEN}, seed=7)


@pytest.fixture(scope="module")
def ins_sites(tmp_path_factory):
    """8 sites of tools/ins_fixture.py, every insert-length class."""
    d = tmp_path_factory.mktemp("tracing_ins")
    bam, vcf, _ = build_ins_fixture(str(d), 8, seed=3)
    return bam, vcf


@pytest.fixture(scope="module")
def one_site(tmp_path_factory):
    """One noisy INS site of tests/test_ins_consensus.py (100 bases, 10
    reads): the plain DP runs it quickly under a profiler too."""
    d = tmp_path_factory.mktemp("tracing_one_site")
    insert = _rand_seq(random.Random(7), 100)
    return build_fixture(str(d), insert, depth=10, noisy=True, seed=7)


def _run(bam, vcf, **kw):
    """(lines, the [VERBOSE] numbers as the benchmark parses them)."""
    err = io.StringIO()
    lines = taudit.run_audit(
        AudtConfig(bam_file=bam, vcf_file=vcf, device="cpu", verbose=True,
                   **kw), out=io.StringIO(), err=err)
    return lines, audt_mode.parse_verbose(err.getvalue())


def _at_most(parts, whole):
    """The printed parts sum to at most the printed whole, up to their
    rounding."""
    assert sum(parts) <= whole + HALF_MS * (len(parts) + 1), (parts, whole)


@pytest.mark.parametrize("case", ["host_extract", "extract_device",
                                  "ins_consensus"])
def test_stage_tokens_print_parse_and_agree(planted, ins_sites, case):
    if case == "ins_consensus":
        lines, st = _run(*ins_sites, ins_consensus=True, batch_windows=3)
    else:
        extract = "device" if case == "extract_device" else "auto"
        lines, st = _run(*planted, extract=extract, batch_windows=1)
    assert lines
    assert set(BEFORE + STAGES) <= set(st)
    assert st["batches"] >= 3
    _at_most([st["fetch"], st["extract"]], st["fetch+pack"])
    _at_most([st["inflate"]], st["fetch"])
    _at_most([st["queue_wait"], st["dispatch"], st["device_wait"]],
             st["total"])
    _at_most([st["write"]], st["emit"])
    assert st["inflated_mb"] > 0
    if case == "extract_device":
        assert st["extract"] == 0
    if case == "ins_consensus":
        assert set(CONS_BEFORE + CONS_STAGES) <= set(st)
        _at_most([st[k] for k in CONS_STAGES], st["cons_time"])
        assert st["cons_dp_time"] > 0 and st["cons_sites"] == len(lines)
    else:
        assert not set(CONS_STAGES) & set(st)


def test_vote_tokens_print_and_parse(ins_sites):
    """vote_rounds= and vote_card= end the ins_consensus line: on the CPU
    the plain vote takes every cluster-round of the star engine and the
    card none, which the benchmark's reader of their share reads as 0; it
    reads 100 where the card voted them all, and None where the line lacks
    the tokens (a program before them) or nothing was voted."""
    import harness

    lines, st = _run(*ins_sites, ins_consensus=True, batch_windows=3)
    assert lines and st["cons_sites"] > 0
    assert st["cons_vote_rounds"] >= 1 and st["cons_vote_card"] == 0
    reader = harness.metric_reader("cons_vote_card_pct")

    def share(**stats):
        return reader.read(harness.Run({}, {}, {}, 1.0, [harness.Pass(
            1.0, len(lines), [], {**st, **stats})]))

    assert share() == 0.0
    assert share(cons_vote_card=st["cons_vote_rounds"]) == 100.0
    assert share(cons_vote_rounds=0.0) is None
    bare = {k: v for k, v in st.items()
            if k not in ("cons_vote_rounds", "cons_vote_card")}
    assert reader.read(harness.Run({}, {}, {}, 1.0, [harness.Pass(
        1.0, len(lines), [], bare)])) is None


def _bgzf_blocks(path: str) -> tuple[list[int], bytes]:
    """(each BGZF block's uncompressed size, the uncompressed stream),
    read with zlib alone."""
    data = open(path, "rb").read()
    sizes, parts, off = [], [], 0
    while off < len(data):
        xlen = int.from_bytes(data[off + 10:off + 12], "little")
        assert data[off + 12:off + 14] == b"BC"
        bsize = int.from_bytes(data[off + 16:off + 18], "little") + 1
        raw = zlib.decompress(data[off + 12 + xlen:off + bsize - 8], -15)
        assert len(raw) == int.from_bytes(data[off + bsize - 4:off + bsize],
                                          "little")
        sizes.append(len(raw))
        parts.append(raw)
        off += bsize
    return sizes, b"".join(parts)


def _header_len(stream: bytes) -> int:
    """Bytes of the BAM header: magic, text, references."""
    n = 8 + int.from_bytes(stream[4:8], "little")
    n_ref = int.from_bytes(stream[n:n + 4], "little")
    n += 4
    for _ in range(n_ref):
        n += 8 + int.from_bytes(stream[n:n + 4], "little")
    return n


def test_inflated_bytes_are_the_blocks_a_fetch_inflates(planted):
    """A fetch of the whole chromosome on a fresh handle inflates every
    block past the header's last (which the open left in the handle's
    cache), once; the same fetch again inflates nothing."""
    bam, _ = planted
    sizes, stream = _bgzf_blocks(bam)
    assert 3 <= len(sizes) < 64  # the handle caches 64 blocks
    last_header = next(i for i, end in enumerate(
        itertools.accumulate(sizes)) if end >= _header_len(stream))
    reader = native_bam_reader(bam)
    assert reader.take_counters() == ReaderCounters()  # the open's zeroed
    pos = reader.fetch_packed(0, 0, CHROM_LEN)[0]
    c = reader.take_counters()
    assert len(pos) > 0
    assert c.inflated_bytes == sum(sizes[last_header + 1:]) > 0
    assert c.inflate_ns > 0
    reader.fetch_packed(0, 0, CHROM_LEN)
    assert reader.take_counters() == ReaderCounters()


def test_spans_lie_in_their_pass_on_the_profilers_clock(one_site):
    """Under a CPU torch.profiler started on the calling thread, as the
    benchmark starts it, the consumer's ranges appear inside the pass that
    ran them, on the clock of the benchmark's own spans."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cfg = AudtConfig(bam_file=one_site[0], vcf_file=one_site[1],
                     device="cpu", ins_consensus=True)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(devtrace.WINDOW):
            for _ in range(2):
                with torch.profiler.record_function("portbench.pass"):
                    taudit.run_audit(cfg, out=io.StringIO(),
                                     err=io.StringIO())
    trace = devtrace.from_profiler(prof)
    passes = sorted((a, b) for a, b, n in trace.host
                    if n == "portbench.pass")
    assert len(passes) == 2
    want = ("svtrek.queue_wait", "svtrek.write", "svtrek.cons.seq",
            "svtrek.cons.vote")
    for name in want:
        spans = [(a, b) for a, b, n in trace.host if n == name]
        for lo, hi in passes:
            assert any(lo <= a <= b <= hi for a, b in spans), name
        assert all(any(lo <= a <= b <= hi for lo, hi in passes)
                   for a, b in spans), name
    # the timers around device work open no range
    assert not {n for _, _, n in trace.host if n.startswith("svtrek.")} - \
        set(want)


def test_no_profiler_opens_no_range(one_site, monkeypatch):
    """With no profiler running, every span is a timer alone."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler")

    want, _ = _run(*one_site, ins_consensus=True)
    monkeypatch.setattr(tracing, "profiler_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    got, st = _run(*one_site, ins_consensus=True)
    assert got == want
    assert st["cons_vote_time"] > 0


class _Stats:
    t_s = 0.0
    n = 0


def test_span_adds_to_a_field_a_dict_or_nothing():
    stats, counts = _Stats(), {}
    with tracing.span(stats, "t_s"):
        pass
    with tracing.span(counts, "t_s", "svtrek.test"):
        pass
    with tracing.span(None, "t_s", "svtrek.test"):
        pass
    assert stats.t_s > 0 and counts["t_s"] > 0
    tracing.add(counts, "t_s", 1.0)
    assert counts["t_s"] > 1.0


def test_span_opens_its_range_only_under_a_profiler(monkeypatch):
    opened = []
    real = tracing.profiler_range

    def spy(name, ids):
        opened.append((name, ids))
        return real(name, ids)

    monkeypatch.setattr(tracing, "profiler_range", spy)
    with tracing.span(None, "t_s", "svtrek.test", batch=3):
        pass
    assert opened == []
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        with tracing.span(None, "t_s", "svtrek.test", batch=3):
            pass
        with tracing.span(None, "t_s"):  # a timer only
            pass
    assert opened == [("svtrek.test", {"batch": 3})]
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "svtrek.test"]
    assert len(ev) == 1 and ev[0].kwinputs() == {"batch": 3}


def test_span_under_lock_loses_no_update():
    """Pool threads add to one AuditStats under its lock."""
    stats, lock = _Stats(), threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                tracing.add(stats, "n", 1, lock)
                with tracing.span(stats, "t_s", lock=lock):
                    pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert stats.n == 16 * 2000 and stats.t_s > 0
