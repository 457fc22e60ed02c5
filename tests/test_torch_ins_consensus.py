"""`audt --ins-consensus` in the port (svtrek_tpu_torch.pipeline.audit on
--device cpu) against svtrek_tpu.pipeline.audit.run_audit: the same
result lines, seq field included, on tests/test_ins_consensus.py's
fixtures and on a small copy of chip_smoke.py's multi-site fixture; and
the CLI run where `import jax` fails."""
from __future__ import annotations

import io
import os
import random
import re
import subprocess
import sys

import pytest

from svtrek_tpu.config import AudtConfig
from svtrek_tpu.pipeline.audit import run_audit as jax_run_audit
from svtrek_tpu_torch.pipeline import audit as taudit
from tests.test_ins_consensus import _rand_seq, build_fixture
from tests.test_torch_cli import _JAX_BLOCKED_RUN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from ins_fixture import build_ins_fixture  # noqa: E402

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
