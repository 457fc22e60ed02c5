"""The consensus reader's SEQ fetch in one call a flush: the native
`svbam_ins_seqs_batch` (`NativeBamReader.ins_seqs_batch`), which stages
its sites' blocks through the attached batch inflate a slice at a time
before it walks them, held site by site and string by string to the same
call on a reader with no stage attached (each site read lazily, a call a
site) and to the Python reader's `_ins_seqs_py`, on the CPU
(`stage_inflate("cpu")`: the same C staging, zlib a block); and
`run_audit --ins-consensus`, whose lines stay those of the lazy path while
its `ins_consensus` line counts what the consensus reader inflated.
"""
from __future__ import annotations

import io
import json
import os
import sys

import numpy as np
import pytest

from svtrek_tpu_torch import kernels
from svtrek_tpu_torch.config import AudtConfig
from svtrek_tpu_torch.io.bam import BamReader
from svtrek_tpu_torch.native import native_bam_reader
from svtrek_tpu_torch.native.bamlib import NativeBamReader
from svtrek_tpu_torch.pipeline import audit as taudit
from tests.fixtures import PlantedSV, write_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "portbench", "gen"),
                os.path.join(ROOT, "tools"), os.path.join(ROOT, "portbench")]

import bamio  # noqa: E402
import harness  # noqa: E402
import hg002  # noqa: E402
from ins_fixture import build_ins_fixture  # noqa: E402

audt_mode = harness.load_mode("audt")

BLOCK = kernels.BGZF_BLOCK_BYTES
INTERVAL = AudtConfig().consensus_interval
MIN_LEN = 50
LONG_LEN = 500_000
# the long fixture's insert sites (0-based reference positions): two 40 bp
# apart share their blocks; the reads at 2 start at 0; those at 330,000
# are mostly SEQ "*"
LONG_SITES = (2, 150_000, 150_040, 200_000, 260_000, 330_000)
TILE = 25 << 14  # a 16 kb bin's start, inside a 128 kb bin
BOUND_SITE = TILE - 20


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """The planted fixture: 8 kb reads of "A" bases, two INS sites on one
    chromosome 300 bp apart and one on another."""
    d = tmp_path_factory.mktemp("ins_batch_planted")
    svs = [PlantedSV(1, 50_000, 50_400, "DEL", 400),
           PlantedSV(1, 120_000, 120_001, "INS", 120),
           PlantedSV(1, 120_300, 120_301, "INS", 80),
           PlantedSV(2, 60_000, 60_001, "INS", 200)]
    bam, _ = write_fixture(str(d), svs, {1: 300_000, 2: 150_000}, seed=5)
    return bam


@pytest.fixture(scope="module")
def long_bam(tmp_path_factory):
    """Reads of 40-120 kb with random bases (records of 1-3 blocks, so
    SEQ bytes lie in blocks where no record starts), each with an insert
    of 50-400 bases at one of LONG_SITES; at 330,000 most reads have SEQ
    "*".  And one read with an insert at BOUND_SITE."""
    d = str(tmp_path_factory.mktemp("ins_batch_long"))
    rng = np.random.default_rng(21)
    reads = []  # (pos, ref length, cigar, query length, l_seq)
    for site in LONG_SITES:
        for k in range(10):
            span = int(rng.integers(40_000, 120_000))
            pos = 0 if site < 100 else max(
                site - int(rng.integers(1_000, span - 1_000)), 0)
            lead = site - pos + int(rng.integers(-2, 3)) if site >= 100 \
                else site
            lead = max(lead, 1)
            ins = int(rng.integers(MIN_LEN, 400))
            tail = span - lead
            cig = np.array([(lead << 4) | 0, (ins << 4) | 1,
                            (tail << 4) | 0], np.uint32)
            qlen = lead + ins + tail
            l_seq = 0 if site == 330_000 and k < 7 else qlen  # 0: SEQ "*"
            reads.append((pos, lead + tail, cig, l_seq))
    # BOUND_SITE's walk stops at a record past the index's bound: a short
    # read starts the first bin past the site, then the stop record, in
    # the site's 128 kb bin, fills 4 blocks with a 150 kb soft clip
    lead = BOUND_SITE - 380_000
    reads += [(380_000, lead + 1000, np.array(
                   [(lead << 4) | 0, (60 << 4) | 1, (1000 << 4) | 0],
                   np.uint32), lead + 1060),
              (TILE + 10, 100, np.array([100 << 4], np.uint32), 100),
              (TILE + 20, 20_000, np.array(
                  [(20_000 << 4) | 0, (150_000 << 4) | 4], np.uint32),
               170_000)]
    reads.sort(key=lambda r: r[0])
    pos = np.array([r[0] for r in reads], np.int64)
    ends = pos + np.array([r[1] for r in reads], np.int64)
    assert int(ends.max()) < LONG_LEN - 10_000  # the last site has no reads
    seqs = [bamio.pack_seq(rng.integers(0, 4, r[3])) for r in reads]
    quals = [bytes(rng.integers(0, 40, r[3]).astype(np.uint8))
             for r in reads]
    pieces, sizes = bamio.encode_records(pos, ends, [r[2] for r in reads],
                                         seqs, quals)
    assert int(sizes.max()) > 2 * bamio.BLOCK
    bam = os.path.join(d, "long.bam")
    bamio.write_bam(bam, "1", LONG_LEN, pos, ends, pieces, sizes, threads=2)
    return bam


@pytest.fixture(scope="module")
def hifi(tmp_path_factory):
    """A tiny hg002-hifi build of the benchmark's generator (12 loci):
    13.5 kb reads at 28x, so a site's walk often stops at the record whose
    prefix the index bounds."""
    d = tmp_path_factory.mktemp("ins_batch_hifi")
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                      "hg002-hifi.json")))
    cfg.update(loci=12, replays=1)
    return hg002.build(cfg, 2**31 + 77, str(d), threads=2)


def _sites(case: str, hifi=None) -> tuple[str, list[tuple[int, int]]]:
    """(fixture, [(tid, refined position)]) of a case."""
    if case == "hifi":
        return "hifi", [(0, lc["bp"] + d) for lc in hifi["loci"]
                        if lc["kind"] == "INS" for d in (0, 3)]
    if case == "planted":
        return "planted", [(0, 119_999), (0, 120_299), (1, 59_999),
                           (0, 50_000)]
    if case == "long":
        return "long", [(0, r) for r in LONG_SITES[1:5]]
    if case == "seq_star":
        return "long", [(0, 330_000), (0, 329_998)]
    if case == "no_reads":
        return "long", [(0, LONG_LEN - 500), (-1, 150_000), (0, 150_000)]
    if case == "lo_negative":
        return "long", [(0, 2), (0, 0), (0, 150_000)]
    if case == "shared_blocks":
        return "long", [(0, 150_000), (0, 150_040), (0, 150_000),
                        (0, 200_000)]
    if case == "stop_at_bound":
        return "long", [(0, BOUND_SITE)]
    if case == "small_slice":
        return "long", [(0, r) for r in LONG_SITES] + [(0, 150_000),
                                                       (0, BOUND_SITE)]
    raise ValueError(case)


def _args(sites):
    """ins_seqs_batch's arguments for the sites, as _resolve_ins_consensus
    builds them: region [r - 5, r + 6) clipped at 0, [lo, hi] = r +- 5."""
    tids = [t for t, _ in sites]
    return (tids, [max(r - INTERVAL, 0) for _, r in sites],
            [r + INTERVAL + 1 for _, r in sites], MIN_LEN,
            [r - INTERVAL for _, r in sites],
            [r + INTERVAL for _, r in sites])


CASES = ["planted", "hifi", "long", "seq_star", "no_reads", "lo_negative",
         "shared_blocks", "stop_at_bound", "small_slice"]


@pytest.mark.parametrize("case", CASES)
def test_batch_equals_per_site_and_python(planted, hifi, long_bam, case):
    """Each site's strings equal, in order, those of a lazy call of its
    own on an unstaged reader and the Python reader's; the staged batch
    leaves no block it reads to zlib and inflates them through the batch
    inflate."""
    which, sites = _sites(case, hifi)
    bam = {"planted": planted, "hifi": hifi["bam"]}.get(which, long_bam)
    tids, begs, ends, min_len, los, his = _args(sites)
    lazy, py = native_bam_reader(bam), BamReader(bam)
    want = [lazy.ins_seqs_batch([t], [b], [e], min_len, [lo], [hi])[0]
            for t, b, e, lo, hi in zip(tids, begs, ends, los, his)]
    assert want == [
        taudit._ins_seqs_py(py, t, b, e, min_len, lo, hi) if t >= 0 else []
        for t, b, e, lo, hi in zip(tids, begs, ends, los, his)]
    staged = native_bam_reader(bam)
    staged.stage_inflate("cpu", **({"_slice": (4, 3 * BLOCK)}
                                   if case == "small_slice" else {}))
    got = staged.ins_seqs_batch(tids, begs, ends, min_len, los, his)
    assert got == want
    c = staged.take_counters()
    nbytes, card, by_zlib = c.inflated_bytes, c.card_bytes, \
        c.zlib_staged_bytes
    assert card == 0 and by_zlib == 0
    n = sum(map(len, got))
    if case == "no_reads":
        assert got[0] == [] and got[1] == [] and got[2]
    if case == "seq_star":
        assert 0 < n <= 6  # the SEQ "*" reads add none
    if case == "lo_negative":
        assert got[0] and got[1]
    if case not in ("planted", "hifi"):
        assert all(len(s) >= MIN_LEN and set(s) <= set("ACGT")
                   for ss in got for s in ss)
    assert nbytes > 0 and n > 0
    # unattached, the batch walks lazily, to the same strings
    assert lazy.ins_seqs_batch(tids, begs, ends, min_len, los, his) == want


def test_batch_with_no_sites_or_unequal_arrays(long_bam):
    reader = native_bam_reader(long_bam)
    reader.stage_inflate("cpu")
    assert reader.ins_seqs_batch([], [], [], MIN_LEN, [], []) == []
    assert reader.ins_seqs_batch([-1, -1], [0, 0], [10, 10], MIN_LEN,
                                 [0, 0], [9, 9]) == [[], []]
    with pytest.raises(ValueError, match="differ in length"):
        reader.ins_seqs_batch([0, 0], [0], [10, 10], MIN_LEN, [0, 0],
                              [9, 9])


def test_batch_raises_what_the_batch_inflate_raises(long_bam, monkeypatch):
    def refuse(*a, **k):
        raise RuntimeError("no inflate today")

    monkeypatch.setattr(kernels, "bgzf_inflate", refuse)
    reader = native_bam_reader(long_bam)
    reader.stage_inflate("cpu")
    with pytest.raises(RuntimeError, match="no inflate today"):
        reader.ins_seqs_batch(*_args(_sites("long")[1]))


@pytest.fixture(scope="module")
def ins_sites(tmp_path_factory):
    """8 sites of tools/ins_fixture.py, every insert-length class, and a
    VCF of those up to 350 bases for the graph engine's plain DP."""
    d = tmp_path_factory.mktemp("ins_batch_ins")
    bam, vcf, sites = build_ins_fixture(str(d), 8, seed=3)
    rows = [l for l in open(vcf) if not l.startswith("#")]
    short = str(d / "short.vcf")
    with open(short, "w") as fh:
        fh.writelines([l for l in open(vcf) if l.startswith("#")] +
                      [r for r, s in zip(rows, sites) if s["length"] <= 350])
    assert 2 <= sum(s["length"] <= 350 for s in sites) < len(sites)
    return bam, {"star": vcf, "graph": short}


def _run(bam, vcf, engine):
    err = io.StringIO()
    lines = taudit.run_audit(
        AudtConfig(bam_file=bam, vcf_file=vcf, device="cpu", verbose=True,
                   ins_consensus=True, poa_engine=engine),
        out=io.StringIO(), err=err)
    return lines, audt_mode.parse_verbose(err.getvalue())


@pytest.mark.parametrize("engine", ["star", "graph"])
def test_run_audit_lines_and_tokens(ins_sites, monkeypatch, engine):
    """The lines equal the lazy path's (no stage attached: each site read
    lazily); the staged run prints the consensus reader's inflate: every
    byte through the batch inflate, so where that counts as the card's
    (the CPU's inflate attached as on a card) card_mb equals
    inflated_mb."""
    bam, vcfs = ins_sites
    with monkeypatch.context() as m:
        m.setattr(NativeBamReader, "stage_inflate",
                  lambda self, *a, **k: None)
        want, lazy = _run(bam, vcfs[engine], engine)
    attach = NativeBamReader.stage_inflate

    def as_card(self, device, **kw):
        attach(self, device, **kw)
        _, fn, h_in, h_out, h_meta, h_status = self._stage[:6]
        assert self._lib.svbam_stage_attach(
            self._h, fn, 1, h_in.data_ptr(), h_in.numel(), h_out.data_ptr(),
            h_meta.data_ptr(), h_status.data_ptr(), h_out.shape[0]) == 0

    monkeypatch.setattr(NativeBamReader, "stage_inflate", as_card)
    got, st = _run(bam, vcfs[engine], engine)
    assert got == want and all(", seq: " in l for l in got)
    assert st["cons_sites"] == lazy["cons_sites"] == len(got)
    assert st["cons_card_mb"] == st["cons_inflated_mb"] > 0
    assert lazy["cons_card_mb"] == 0 < lazy["cons_inflated_mb"]
    assert st["cons_inflate"] <= st["cons_seq_time"] + 0.001
    # the benchmark's readers of the two counters, on these passes
    run = harness.Run({}, {}, {}, 1.0, [harness.Pass(1.0, len(got), [], st)])
    assert harness.metric_reader("cons_card_pct").read(run) == 100.0
    ms = harness.metric_reader("cons_inflate_ms_per_site").read(run)
    assert ms == st["cons_inflate"] * 1000 / st["cons_sites"]


@pytest.mark.parametrize("stem", ["cons_card_pct",
                                  "cons_inflate_ms_per_site"])
def test_readers_read_nothing_without_their_tokens(stem):
    """A program whose ins_consensus line lacks the counters (the parent of
    this change) reads None; one that inflated nothing on the Python
    reader's path reads 0 or None, never a division by zero."""
    stats = {"records": 10.0, "cons_sites": 4.0, "cons_time": 0.2,
             "cons_seq_time": 0.04}
    run = harness.Run({}, {}, {}, 1.0, [harness.Pass(1.0, 10, [], stats)])
    assert harness.metric_reader(stem).read(run) is None
    stats.update(cons_inflate=0.0, cons_inflated_mb=0.0, cons_card_mb=0.0)
    assert harness.metric_reader(stem).read(run) in (None, 0.0)
