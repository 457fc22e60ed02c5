"""tools/audt_scalar.py, the independent scalar `audt` that chip_smoke.py
holds the port's output to on the card, against the JAX package: its
consensus and evidence walks against svtrek_tpu.oracle, its insert
collection against the native reader and its star consensus against
svtrek_tpu.ops.poa, and its result lines against
svtrek_tpu.pipeline.audit.run_audit on the planted fixtures, the golden
harness's random VCF quirk surface, small copies of the smoke's benchmark
and ins-consensus fixtures, and with --ins-consensus.  Likewise
tools/disc_scalar.py, the smoke's independent disc, against
svtrek_tpu.pipeline.discover.run_discover: every line, `seq:` on every
cluster."""
from __future__ import annotations

import ast
import io
import os
import random
import sys

import numpy as np
import pytest

from svtrek_tpu import constants as C
from svtrek_tpu.config import AudtConfig
from svtrek_tpu.io.bam import BamRecord, BamWriter
from svtrek_tpu.native import native_bam_reader
from svtrek_tpu.ops.poa import consensus_sequence
from svtrek_tpu.oracle import consensus_pos, extract_candidates
from svtrek_tpu.pipeline.audit import run_audit as jax_run_audit
from tests.fixtures import write_fixture
from tests.test_ins_consensus import _mutate as _mutate_ins
from tests.test_ins_consensus import _rand_seq
from tests.test_ins_consensus import build_fixture as build_ins_site
from tests.test_golden_audit_e2e import CHROM_LEN, gen_reads, gen_vcf_lines
from tests.test_torch_audit import SVS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import audt_scalar  # noqa: E402
import disc_scalar  # noqa: E402
from bench_disc import build_fixture as build_disc_fixture  # noqa: E402
from bench_e2e import build_fixture  # noqa: E402
from ins_fixture import build_ins_fixture  # noqa: E402

KINDS = {C.KIND_DEL_START: audt_scalar.START, C.KIND_DEL_END: audt_scalar.END,
         C.KIND_INS: audt_scalar.INS, C.KIND_POINT: audt_scalar.POINT}


def _jax_lines(bam: str, vcf: str, **kw) -> list[str]:
    return jax_run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                    data_shards=1, **kw),
                         out=io.StringIO(), err=io.StringIO())


def test_imports_neither_package():
    with open(os.path.join(ROOT, "tools", "audt_scalar.py")) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.startswith(("svtrek", "jax"))]


@pytest.mark.parametrize("seed", range(4))
def test_consensus_matches_oracle(seed):
    """Tight clusters, +-600 bp noise and duplicates, at the default and
    at non-default parameters."""
    rng = np.random.default_rng(seed)
    params = [(3, 5, 500), (2, 10, 300), (5, 2, 800)][seed % 3]
    for _ in range(300):
        n, center = int(rng.integers(0, 40)), int(rng.integers(1000, 10**8))
        mode = rng.integers(0, 3, n)
        locs = (center + np.where(
            mode == 0, rng.integers(-4, 5, n),
            np.where(mode == 1, rng.integers(-600, 600, n),
                     rng.integers(-30, 30, n)))).tolist()
        pos = center + int(rng.integers(-100, 100))
        assert audt_scalar.consensus_pos(locs, pos, *params) == \
            consensus_pos(locs, pos, *params), (locs, pos, params)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_evidence_matches_oracle(kind):
    """Random reads with every CIGAR op (H and P advance the walk), long
    I/D ops around the 50 bp thresholds and positions near 2^32."""
    rng = np.random.default_rng(100 + kind)
    for _ in range(400):
        n_ops = int(rng.integers(0, 12))
        ops = rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8], n_ops).astype(np.uint8)
        lens = np.where(rng.random(n_ops) < 0.4,
                        rng.choice([49, 50, 51, 200], n_ops),
                        rng.integers(1, 3000, n_ops)).astype(np.uint64)
        pos = int(rng.choice([int(rng.integers(0, 60_000)),
                              0xFFFFFFFF - int(rng.integers(0, 20_000))]))
        s = C.u32(int(rng.integers(0, 40_000)) - 5_000)
        e = C.u32(s + int(rng.integers(0, 40_000)))
        want = extract_candidates(
            kind, [(pos, list(zip(ops.tolist(), lens.tolist())))], s, e)
        assert audt_scalar.evidence(KINDS[kind], pos, ops, lens, s, e) == \
            want, (pos, ops, lens, s, e)


def test_planted_fixture_lines(tmp_path):
    bam, vcf = write_fixture(str(tmp_path), SVS, {1: 500_000, 2: 400_000},
                             seed=2, depth=24, noise=40)
    want = _jax_lines(bam, vcf)
    assert len(want) == 7
    assert audt_scalar.audt_lines(bam, vcf) == want


@pytest.mark.parametrize("seed", [0, 5])
def test_golden_generator_lines(tmp_path, seed):
    """CIEND= before END=, inferred types, chr prefixes, chrom 0 and X."""
    rng = np.random.default_rng(seed)
    reads = gen_reads(rng)
    vcf = str(tmp_path / "g.vcf")
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                 + "\n".join(gen_vcf_lines(rng)) + "\n")
    bam = str(tmp_path / "g.bam")
    with BamWriter(bam, [("1", CHROM_LEN), ("2", CHROM_LEN)]) as w:
        for k, (tid, pos, cigar) in enumerate(reads):
            w.write(BamRecord(name=f"r{k}", flag=0, tid=tid, pos=pos,
                              mapq=60, cigar=cigar, seq=""))
    want = _jax_lines(bam, vcf)
    assert len(want) > 10
    assert audt_scalar.audt_lines(bam, vcf) == want


def test_bench_fixture_lines(tmp_path):
    """The smoke's fixture generator at 60 records."""
    bam, vcf, _, _ = build_fixture(str(tmp_path), 60, 4, 100)
    want = _jax_lines(bam, vcf)
    assert len(want) == 60
    assert audt_scalar.audt_lines(bam, vcf) == want


@pytest.mark.parametrize("seed", range(3))
def test_star_consensus_matches_poa(seed):
    """Random clusters: noisy copies, empty and single members, identical
    members, two alleles of different lengths, non-ACGT bases."""
    rng = random.Random(seed)
    for k in range(25):
        base = _rand_seq(rng, rng.randint(20, 260))
        cluster = [_mutate_ins(rng, base, sub=0.05, ind=0.04)
                   for _ in range(rng.randint(0, 7))]
        if k % 4 == 0:
            cluster += [base + _rand_seq(rng, 90)] * 2 + [""]
        if k % 5 == 0:
            cluster.append(base.replace("A", "R", 3))
        assert audt_scalar.star_consensus(cluster) == \
            consensus_sequence(cluster), (seed, k)


def test_ins_seqs_match_native_reader(tmp_path):
    bam, _, sites = build_ins_fixture(str(tmp_path), 12, seed=5)
    scalar = audt_scalar.Bam(bam, with_seq=True)
    native = native_bam_reader(bam)
    rng = np.random.default_rng(1)
    for site in sites:
        for lo in (site["pos"] - 8, site["pos"] - 3, site["pos"] + 1):
            hi = lo + int(rng.integers(0, 12))
            assert audt_scalar.ins_seqs(scalar, 0, lo, hi) == \
                native.ins_seqs(0, max(lo, 0), hi + 1, C.SV_MIN_LENGTH,
                                lo, hi), (site, lo, hi)
    assert audt_scalar.ins_seqs(scalar, 3, 0, 10 ** 6) == []


@pytest.mark.parametrize("case", ["clean", "noisy", "depth2", "sites"])
def test_ins_consensus_lines(tmp_path, case):
    """--ins-consensus lines against the JAX package on
    tests/test_ins_consensus.py's fixtures and 24 sites of
    tools/ins_fixture.py; seq_lines limits the seq field to those lines."""
    if case == "sites":
        bam, vcf, _ = build_ins_fixture(str(tmp_path), 24, seed=3)
    else:
        depth, noisy = {"clean": (10, False), "noisy": (10, True),
                        "depth2": (2, False)}[case]
        bam, vcf = build_ins_site(str(tmp_path),
                                  _rand_seq(random.Random(11), 90),
                                  depth=depth, noisy=noisy, seed=11)
    want = _jax_lines(bam, vcf, ins_consensus=True)
    assert audt_scalar.audt_lines(bam, vcf, ins_consensus=True) == want
    some = audt_scalar.audt_lines(bam, vcf, ins_consensus=True,
                                  seq_lines={0})
    assert some[0] == want[0]
    assert some[1:] == [l.split(", seq:")[0] for l in want[1:]]


def test_disc_scalar_imports_only_the_python_projection():
    with open(os.path.join(ROOT, "tools", "disc_scalar.py")) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert sorted(m for m in names if m.startswith(("svtrek", "jax"))) == \
        ["svtrek_tpu_torch.io.gaf", "svtrek_tpu_torch.io.gfa"]


@pytest.mark.parametrize("case", ["triple", "bench"])
def test_disc_scalar_lines(tmp_path, case):
    """tests/test_torch_discover.py's fixture (INS through an alt segment,
    DEL, a mapq-0 read, a read on a missing node) and tools/bench_disc.py's
    at 10,000 reads; then the seq field limited to one cluster."""
    from svtrek_tpu.config import DiscConfig
    from svtrek_tpu.pipeline.discover import run_discover
    from tests.test_torch_discover import _disc_triple

    gfa, gaf, fq = (_disc_triple(tmp_path) if case == "triple" else
                    build_disc_fixture(str(tmp_path), 10_000, seed=2))
    want = run_discover(DiscConfig(gfa_file=gfa, gaf_file=gaf, fq_file=fq,
                                   data_shards=1),
                        out=io.StringIO(), err=io.StringIO())
    cl = disc_scalar.clusters(disc_scalar.signals(gfa, gaf))
    assert disc_scalar.disc_lines(fq, cl) == want
    assert len(want) >= 2 and any("seq: NA" not in l for l in want
                                  if "INS" in l)
    some = disc_scalar.disc_lines(fq, cl, seq_clusters={0})
    assert some[0] == want[0]
    assert some[1:] == [l.split(", seq:")[0] for l in want[1:]]
