"""The port's `audt` pipeline (svtrek_tpu_torch.pipeline.audit.run_audit on
--device cpu) against svtrek_tpu.pipeline.audit.run_audit: the same
result lines, the same refined VCF and the same fallback counts."""
from __future__ import annotations

import io
import os
import random
import re

import numpy as np
import pytest

from svtrek_tpu.config import AudtConfig
from svtrek_tpu.io.bam import BamRecord, BamWriter
from svtrek_tpu.pipeline.audit import run_audit as jax_run_audit
from svtrek_tpu_torch.pipeline import audit as taudit
from tests.fixtures import PlantedSV, simulate_reads_for_sv, write_fixture
from tests.test_torch_audit_device import _second_pass
from tests.test_golden_audit_e2e import CHROM_LEN, gen_reads, gen_vcf_lines

SVS = [
    PlantedSV(1, 50_000, 50_400, "DEL", 400),
    PlantedSV(1, 120_000, 120_001, "INS", 120),
    PlantedSV(1, 200_000, 203_000, "INV", 3000),
    PlantedSV(2, 80_000, 80_070, "DEL", 70),
    PlantedSV(2, 160_000, 160_001, "INS", 65),
    PlantedSV(1, 300_000, 300_050, "DEL", 50),   # emits nothing
    PlantedSV(2, 250_000, 250_300, "DEL", 300),
    PlantedSV(1, 400_000, 400_001, "INS", 200),
]


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_audit")
    bam, vcf = write_fixture(str(d), SVS, {1: 500_000, 2: 400_000}, seed=2,
                             depth=24, noise=40)
    return str(d), bam, vcf


def _run_both(cfg_kw, tmp_dir, tag):
    """Run both pipelines on the same config; returns (jax, torch), each
    (lines, stderr text, config)."""
    out = {}
    for name, run, extra in (
            ("jax", jax_run_audit, dict(data_shards=1)),
            ("torch", taudit.run_audit, dict(device="cpu"))):
        kw = dict(cfg_kw)
        for key in ("output_file", "refined_vcf"):
            if key in kw:
                kw[key] = os.path.join(tmp_dir, f"{tag}_{name}_{kw[key]}")
        cfg = AudtConfig(verbose=True, **kw, **extra)
        err = io.StringIO()
        lines = run(cfg, out=io.StringIO(), err=err)
        out[name] = (lines, err.getvalue(), cfg)
    return out["jax"], out["torch"]


def _fallbacks(err: str) -> tuple[int, int]:
    m = re.search(r"kovf=(\d+) sweep=(\d+)", err)
    return int(m.group(1)), int(m.group(2))


def _assert_routes(terr: str, jerr: str) -> None:
    """The JAX package's host routes (kovf, sweep) are the port's second
    passes (wide_k, sweep_full); no window here passes
    pack.WIDE_MAX_K, so the port's host routes count 0."""
    assert _fallbacks(terr) == (0, 0)
    assert _second_pass(terr) == _fallbacks(jerr)


CASES = {
    "default": {},
    "refine_inv": dict(refine_inv=True),
    "shard_1_of_2": dict(num_shards=2, shard_index=1),
    "files": dict(output_file="out.txt", refined_vcf="refined.vcf"),
    # Windows here hold 17-32 candidates: K=16 overflows every one of
    # them into the C scalar consensus, K=32 with a 2-anchor sweep budget
    # sends them through the host oracle instead.
    "small_k_overflow": dict(batch_windows=3, cand_width=16, sweep_width=4),
    "small_sweep_overflow": dict(batch_windows=3, cand_width=32,
                                 sweep_width=2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_audit_matches_jax(planted, name):
    d, bam, vcf = planted
    (jl, jerr, jcfg), (tl, terr, tcfg) = _run_both(
        dict(bam_file=bam, vcf_file=vcf, **CASES[name]), d, name)
    assert tl == jl
    assert len(tl) >= 1
    _assert_routes(terr, jerr)
    for key in ("output_file", "refined_vcf"):
        if getattr(tcfg, key):
            with open(getattr(tcfg, key)) as a, open(getattr(jcfg, key)) as b:
                assert a.read() == b.read(), key
    if name.startswith("small_"):
        wide_k, sweep_full = _second_pass(terr)
        assert (wide_k > 0) == (name == "small_k_overflow")
        assert (sweep_full > 0) == (name == "small_sweep_overflow")
        assert int(re.search(r"batches=(\d+)", terr).group(1)) > 3
    if name == "default":
        assert "device=cpu" in terr


def test_resume_matches_full_run(planted, tmp_path):
    _, bam, vcf = planted
    full = jax_run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                    data_shards=1),
                         out=io.StringIO(), err=io.StringIO())
    out = tmp_path / "partial.txt"
    out.write_text(full[0] + "\n" + full[1] + "\n")
    err = io.StringIO()
    got = taudit.run_audit(
        AudtConfig(bam_file=bam, vcf_file=vcf, output_file=str(out),
                   resume=True, device="cpu"),
        out=io.StringIO(), err=err)
    assert got == full[2:]
    assert "Resume: 2 result line" in err.getvalue()
    assert out.read_text().splitlines() == full


def test_resume_mismatch_aborts(planted, tmp_path):
    _, bam, vcf = planted
    out = tmp_path / "stale.txt"
    out.write_text("(DEL) chr: 9, org pos: 1, org end: 2, ref pos: NA, "
                   "ref end: NA, diff pos: NA, diff end: NA\n")
    err = io.StringIO()
    with pytest.raises(SystemExit):
        taudit.run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                    output_file=str(out), resume=True,
                                    device="cpu"),
                         out=io.StringIO(), err=err)
    assert "Resume mismatch" in err.getvalue()


def test_chrom_by_name_matches_jax(tmp_path):
    rng = random.Random(11)
    sv = PlantedSV(1, 50_000, 50_400, "DEL", 400)
    reads = sorted((s, c) for s, c, _ in simulate_reads_for_sv(sv, rng))
    bam, vcf = str(tmp_path / "x.bam"), str(tmp_path / "x.vcf")
    with BamWriter(bam, [("chrX", 500_000)]) as w:
        for i, (start0, cigar) in enumerate(reads):
            qlen = sum(l for op, l in cigar if op in (0, 1, 4))
            w.write(BamRecord(name=f"r{i}", flag=0, tid=0, pos=start0,
                              mapq=60, cigar=cigar, seq="A" * qlen))
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                 "chrX\t50000\tsv0\tN\t<DEL>\t.\tPASS\tSVTYPE=DEL;END=50400\n"
                 "chrZ\t90000\tsv1\tN\t<INS>\t.\tPASS\tSVTYPE=INS\n")
    for by_name in (True, False):
        (jl, _, _), (tl, terr, _) = _run_both(
            dict(bam_file=bam, vcf_file=vcf, chrom_by_name=by_name),
            str(tmp_path), f"byname{by_name}")
        assert tl == jl
        if by_name:
            assert tl[0].startswith("(DEL) chr: chrX, org pos: 50000")
            assert "ref pos: NA" not in tl[0]
            assert "'chrZ' not in the BAM header" in terr


@pytest.mark.parametrize("seed", [0, 5])
def test_golden_generators_match_jax(tmp_path, seed):
    """The refbench golden harness's random reads and VCF quirk surface
    (tests/test_golden_audit_e2e.py generators)."""
    rng = np.random.default_rng(seed)
    reads = gen_reads(rng)
    header = ("##fileformat=VCFv4.2\n"
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    vcf = tmp_path / "g.vcf"
    vcf.write_text(header + "\n".join(gen_vcf_lines(rng)) + "\n")
    bam = str(tmp_path / "g.bam")
    with BamWriter(bam, [("1", CHROM_LEN), ("2", CHROM_LEN)]) as w:
        for k, (tid, pos, cigar) in enumerate(reads):
            qlen = sum(l for op, l in cigar if op in (0, 1, 4))
            w.write(BamRecord(name=f"r{k}", flag=0, tid=tid, pos=pos,
                              mapq=60, cigar=cigar, seq="ACGT" * (qlen // 4)
                              + "ACGT"[: qlen % 4]))
    (jl, jerr, _), (tl, terr, _) = _run_both(
        dict(bam_file=bam, vcf_file=str(vcf)), str(tmp_path), "golden")
    assert tl == jl
    assert len(tl) > 10
    _assert_routes(terr, jerr)

