"""`audt --ins-consensus` in the port (svtrek_tpu_torch.pipeline.audit on
--device cpu) against svtrek_tpu.pipeline.audit.run_audit: the same
result lines, seq field included, on tests/test_ins_consensus.py's
fixtures, on a small copy of chip_smoke.py's multi-site fixture and on a
scaled-down spread-length site (tools/ins_fixture.py's
`build_spread_fixture`, whose pairs take K2's wide class); the CLI run
where `import jax` fails; and what the fixture builders write."""
from __future__ import annotations

import gzip
import hashlib
import io
import os
import random
import re
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

from svtrek_tpu.config import AudtConfig
from svtrek_tpu.pipeline.audit import run_audit as jax_run_audit
from svtrek_tpu_torch.pipeline import audit as taudit
from tests.test_ins_consensus import _rand_seq, build_fixture
from tests.test_torch_cli import _JAX_BLOCKED_RUN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from ins_fixture import (  # noqa: E402
    build_ins_fixture, build_spread_fixture,
)

from svtrek_tpu_torch.constants import CIGAR_I  # noqa: E402
from svtrek_tpu_torch.io.bam import BamReader  # noqa: E402
from svtrek_tpu_torch.ops.poa import majority_length_mode  # noqa: E402

# tests/test_ins_consensus.py's fixtures: (insert seed, length, depth,
# noisy, fixture seed)
FIXTURES = {
    "clean": (42, 80, 10, False, 0),
    "noisy": (7, 100, 10, True, 7),
    "depth2_na": (9, 64, 2, False, 9),
}


def _both(bam, vcf, **kw):
    """(JAX lines, port lines, port stderr) for one config."""
    want = jax_run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                    data_shards=1, **kw),
                         out=io.StringIO(), err=io.StringIO())
    err = io.StringIO()
    got = taudit.run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                      device="cpu", verbose=True, **kw),
                           out=io.StringIO(), err=err)
    return want, got, err.getvalue()


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    out = {}
    for name, (iseed, length, depth, noisy, seed) in FIXTURES.items():
        d = tmp_path_factory.mktemp(f"ins_{name}")
        insert = _rand_seq(random.Random(iseed), length)
        out[name] = (insert, *build_fixture(str(d), insert, depth=depth,
                                            noisy=noisy, seed=seed))
    return out


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_ins_consensus_matches_jax(fixtures, name):
    insert, bam, vcf = fixtures[name]
    want, got, err = _both(bam, vcf, ins_consensus=True)
    assert got == want
    assert len(got) == 1 and ", seq: " in got[0]
    if name == "clean":
        assert got[0].endswith(f"seq: {insert}")
        assert "[VERBOSE] ins_consensus sites=1 " in err
    if name == "depth2_na":
        assert "ref pos: NA" in got[0] and got[0].endswith("seq: NA")
        assert "ins_consensus" not in err


def test_flag_off_equals_flag_on_up_to_seq(fixtures):
    _, bam, vcf = fixtures["noisy"]
    on = taudit.run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                     device="cpu", ins_consensus=True),
                          out=io.StringIO(), err=io.StringIO())
    off = taudit.run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                      device="cpu"),
                           out=io.StringIO(), err=io.StringIO())
    assert [l.split(", seq:")[0] for l in on] == off
    assert all("seq:" not in l for l in off)


@pytest.mark.parametrize("batch_windows", [512, 7])
def test_multi_site_fixture_matches_jax(tmp_path, batch_windows):
    """24 sites of tools/ins_fixture.py (every insert-length class, two
    alleles, 2-read sites); 7-window batches give several consensus
    flushes, each with its own DP batches."""
    bam, vcf, sites = build_ins_fixture(str(tmp_path), 24, seed=3)
    assert {s["class"] for s in sites} >= {0, 1, 2}
    want, got, err = _both(bam, vcf, ins_consensus=True,
                           batch_windows=batch_windows)
    assert got == want
    assert len(got) == 24
    flushes = int(re.search(r"flushes=(\d+)", err).group(1))
    dp_calls = int(re.search(r"dp_calls=(\d+)", err).group(1))
    assert flushes >= (4 if batch_windows == 7 else 1)
    assert dp_calls >= flushes
    # The star engine's band routes: no pair of this fixture is
    # degenerate, so none takes the host DP.
    assert re.search(r"band_wide=\d+ band_scalar=0\b", err)


def test_cli_ins_consensus_runs_with_jax_blocked(fixtures, tmp_path):
    _, bam, vcf = fixtures["noisy"]
    want = jax_run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                    data_shards=1, ins_consensus=True),
                         out=io.StringIO(), err=io.StringIO())
    out_path = str(tmp_path / "nojax.txt")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_BLOCKED_RUN, "audt", "-b", bam, "-v",
         vcf, "-o", out_path, "--device", "cpu", "--ins-consensus"],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=ROOT),
        cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_MODULES=0" in proc.stderr
    assert [l for l in proc.stdout.splitlines() if l.startswith("(")] == want
    with open(out_path) as fh:
        assert fh.read().splitlines() == want


def test_spread_site_takes_the_wide_class_and_matches_jax(tmp_path):
    """One spread-length site, scaled down to inserts of 702-1,898 bases
    (20 reads over +-46 % of a 1,300-base median) so that the JAX
    package's scalar DP of its bands past 512 stays quick: the majority
    length mode keeps the reads, the median seed meets members more than
    527 bases away, whose pairs K2 runs in its wide class (band_wide_k2 >
    0: the wide kernel on cuda), and the port's line, seq included,
    equals the JAX package's."""
    bam, vcf, _ = build_spread_fixture(str(tmp_path), 1, seed=5,
                                       median=(1300, 1300), spread=0.46,
                                       depth=(20, 20))
    want, got, err = _both(bam, vcf, ins_consensus=True)
    assert got == want and len(got) == 1
    assert ", seq: " in got[0] and not got[0].endswith("seq: NA")
    wide = int(re.search(r"band_wide=(\d+)", err).group(1))
    wide_k2 = int(re.search(r"band_wide_k2=(\d+)", err).group(1))
    assert wide >= wide_k2 > 0
    assert re.search(r"band_scalar=0\b", err)


# sha256 of build_ins_fixture(DIR, 60, seed=0)'s BAM content (BGZF
# decompressed), VCF and sites.json, as the fixture was when the ins
# cell's numbers were taken: the builder must keep writing it.
INS_FIXTURE_60_SEED0 = \
    "48a3f8fb589a60bc1ce4cc6ebdf6aaa4c5b2ec5d8ba9b48b867305f938785072"


def test_fixture_builders_write_what_they_say(tmp_path):
    """build_spread_fixture: per site its read count of supporting reads,
    each with one insert at POS - 1 (within 2 bp), whose lengths are its
    docstring's evenly spaced ones up to the mutations, made of one
    repeated unit of 30-60 bases; 4 spanning reads; every read kept by the
    majority length mode, and members more than 527 bases from the median
    seed.  build_ins_fixture(seed=0) writes what it always wrote."""
    bam, vcf, sites = build_spread_fixture(str(tmp_path / "spread"), 3,
                                           seed=1)
    inserts = {s["pos"]: [] for s in sites}
    spanning = {s["pos"]: 0 for s in sites}
    with BamReader(bam) as reader:
        for rec in reader:
            pos = min(inserts, key=lambda p: abs(p - rec.pos))
            if len(rec.cigar) == 1:
                spanning[pos] += 1
                continue
            (_, lead), (op, n_ins), _ = rec.cigar
            assert op == CIGAR_I and abs(rec.pos + lead - (pos - 1)) <= 2
            inserts[pos].append(rec.seq[lead:lead + n_ins])
    with open(vcf) as fh:
        assert [int(l.split("\t")[1]) for l in fh if l[0] != "#"] == \
            [s["pos"] for s in sites]
    for s in sites:
        seqs = inserts[s["pos"]]
        mid, count = s["median"], s["reads"]
        assert 3000 <= mid <= 3400 and 12 <= count <= 20 and \
            30 <= s["unit"] <= 60 and spanning[s["pos"]] == 4
        assert len(seqs) == count
        want = np.rint(mid * (0.8 + 0.4 * np.arange(count) / (count - 1)))
        assert (want[0], want[-1]) == (s["shortest"], s["longest"])
        got = np.sort([len(x) for x in seqs])
        assert (np.abs(got - want) <= 0.05 * want).all()
        # one unit repeated: most of each read's 12-mers recur in it (in
        # random bases of this length almost none does)
        for x in seqs:
            kmers = Counter(x[i:i + 12] for i in range(len(x) - 11))
            assert sum(c for c in kmers.values() if c > 1) > \
                0.3 * (len(x) - 11)
        assert len(majority_length_mode(seqs)) == count
        seed = sorted(seqs, key=len)[count // 2]
        assert max(abs(len(x) - len(seed)) for x in seqs) > 527

    d = tmp_path / "ins"
    build_ins_fixture(str(d), 60, seed=0)
    h = hashlib.sha256(gzip.decompress((d / "ins.bam").read_bytes()))
    for name in ("ins.vcf", "sites.json"):
        h.update((d / name).read_bytes())
    assert h.hexdigest() == INS_FIXTURE_60_SEED0
