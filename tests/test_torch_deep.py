"""The windows past the first passes' widths (--cand-width,
--max-candidates, --sweep-width) on the CPU: on the deep BAM of
tools/torch_fixtures.py (a synthetic route fixture, not user traffic)
the port's audt on its three extract paths, at data_shards 1 and 2, and
its scan on both paths give the JAX package's lines byte for byte, with
every such window on the port's second device pass (wide_k, sweep_full)
and none on a host route (kovf, sweep, dev_ovf, scan's fallbacks), where
the JAX package sends them to the host.  With the port's wide cap
(pack.WIDE_MAX_K) lowered, audt's windows past it take the exact host
routes again, with the same lines."""
from __future__ import annotations

import io
import os
import re
import sys

import pytest

from svtrek_tpu.config import AudtConfig, ScanConfig
from svtrek_tpu.pipeline.audit import run_audit as jax_run_audit
from svtrek_tpu.pipeline.scan import run_scan as jax_run_scan
from svtrek_tpu_torch.config import ScanConfig as TScanConfig
from svtrek_tpu_torch.pipeline import audit as taudit
from svtrek_tpu_torch.pipeline import pack as tpack
from svtrek_tpu_torch.pipeline import scan as tscan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import audt_scalar  # noqa: E402
from torch_fixtures import build_deep_bam, deep_records  # noqa: E402

PATHS = {
    "host": {},
    "device": dict(extract="device"),
    "python": dict(use_native_io=False),
}
# A region of the deep BAM holding a record of the first tier (INS, 150-400
# reads) and one of the second (INS, 1,100-2,500 reads); the Python path
# scans the second's tiles only (the JAX package's Python scan walks every
# read of a tile past K in its oracle).
SCAN_REGIONS = {"native": (3_195_000, 3_605_000),
                "python": (3_598_000, 3_603_000)}
_JAX: dict = {}


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    return build_deep_bam(str(tmp_path_factory.mktemp("deep")), seed=0)


def _counts(err: str) -> dict[str, int]:
    m = re.search(r"kovf=(\d+) sweep=(\d+) long_ops=(\d+) (?:device|dev_ovf)"
                  r"=(\d+)\)", err)
    assert m, err
    out = dict(zip(("kovf", "sweep", "long_ops", "dev_ovf"),
                   map(int, m.groups())))
    m = re.search(r"wide_k=(\d+) sweep_full=(\d+)", err)
    if m:
        out.update(wide_k=int(m.group(1)), sweep_full=int(m.group(2)))
    return out


def _audit(run, cfg):
    err = io.StringIO()
    lines = run(cfg, out=io.StringIO(), err=err)
    return lines, _counts(err.getvalue())


def _jax(deep, path, **kw):
    key = (path, tuple(sorted(kw.items())))
    if key not in _JAX:
        bam, vcf = deep
        _JAX[key] = _audit(jax_run_audit, AudtConfig(
            bam_file=bam, vcf_file=vcf, verbose=True, data_shards=1,
            **PATHS[path], **kw))
    return _JAX[key]


def test_deep_bam_tiers(deep):
    """The fixture reaches the widths: the JAX package's host path sends
    every window of the first two tiers past --cand-width 128 (kovf),
    its device walk every such window past K or the sweep, and the lines
    equal tools/audt_scalar.py."""
    bam, vcf = deep
    lines, c = _jax(deep, "host")
    recs = deep_records()
    deep_windows = sum(1 + (s == "DEL") for _, s, t in recs if t < 2)
    assert c["kovf"] == deep_windows == 36
    assert _jax(deep, "device")[1]["dev_ovf"] == deep_windows
    assert lines == audt_scalar.audt_lines(bam, vcf)
    assert len(lines) == len(recs)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_deep_audit_matches_jax(deep, path, shards):
    bam, vcf = deep
    want, jc = _jax(deep, path)
    got, tc = _audit(taudit.run_audit, AudtConfig(
        bam_file=bam, vcf_file=vcf, verbose=True, device="cpu",
        data_shards=shards, **PATHS[path]))
    assert got == want
    assert (tc["kovf"], tc["sweep"], tc["long_ops"], tc["dev_ovf"]) == \
        (0, 0, 0, 0)
    if path == "host":
        # Past --cand-width 128: the 36 windows of the first two tiers.
        assert (tc["wide_k"], tc["sweep_full"]) == (jc["kovf"], jc["sweep"])
        assert tc["wide_k"] > 0
    else:
        # Past --max-candidates 1,024 (the second tier) and past
        # --sweep-width 128 within K (the first).
        assert tc["wide_k"] + tc["sweep_full"] == jc["dev_ovf"]
        assert tc["wide_k"] > 0 and tc["sweep_full"] > 0


@pytest.mark.parametrize("native", [True, False])
def test_deep_scan_matches_jax(deep, native):
    start, end = SCAN_REGIONS["native" if native else "python"]
    kw = dict(bam_file=deep[0], start=start, end=end,
              use_native_io=native)
    want = jax_run_scan(ScanConfig(**kw), out=io.StringIO())
    stats: dict = {}
    got = tscan.run_scan(TScanConfig(**kw), out=io.StringIO(),
                         device="cpu", stats=stats)
    assert got == want
    assert stats["fallbacks"] == 0 and stats["wide_k"] > 0
    assert any("support" in line and int(line.split()[-1]) > 1_024
               for line in got[1][:-1])


ROUTE_CASES = {
    # K 16: the third tier's windows of 17-32 candidates take the second
    # pass, the first two tiers' (past 32) the C scalar consensus.
    "host": dict(cand_width=16),
    # K 64, sweep 4: the third tier's rows take the full sweep, the first
    # two tiers' windows (past 32) the host oracle.
    "device": dict(extract="device", max_candidates=64, sweep_width=4),
}


@pytest.mark.parametrize("path", sorted(ROUTE_CASES))
def test_wide_cap_route_stays(deep, path, monkeypatch):
    """With the wide cap lowered to 32, the windows past it take the exact
    host routes (kovf, dev_ovf) and the others the second pass, with the
    JAX package's lines; its host routes split between the two."""
    bam, vcf = deep
    kw = ROUTE_CASES[path]
    want, jc = _jax(deep, "host" if path == "host" else "device", **{
        k: v for k, v in kw.items() if k != "extract"})
    monkeypatch.setattr(tpack, "WIDE_MAX_K", 32)
    got, tc = _audit(taudit.run_audit, AudtConfig(
        bam_file=bam, vcf_file=vcf, verbose=True, device="cpu", **kw))
    assert got == want
    if path == "host":
        assert tc["kovf"] == 36 and tc["wide_k"] > 0
        assert tc["kovf"] + tc["wide_k"] == jc["kovf"]
    else:
        assert tc["dev_ovf"] == 36 and tc["sweep_full"] > 0
        assert tc["dev_ovf"] + tc["wide_k"] + tc["sweep_full"] == \
            jc["dev_ovf"]
