"""The port stands alone: no module of svtrek_tpu_torch, and no tool that
chip_smoke.py loads, imports jax, jaxlib or anything of svtrek_tpu.  Each
module is imported in a fresh interpreter whose import system refuses those
packages.  Then the port's copies of the JAX package's host modules (io,
native, oracle, emit, the CLI parser) are held equal to the originals on
the same seeded inputs, compared as plain values, and the port-side audt
fixture builder to tools/bench_e2e.py's, byte for byte."""
from __future__ import annotations

import dataclasses
import enum
import filecmp
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
sys.path.insert(0, TOOLS)

PKG_MODULES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)[:-3].replace(os.sep, ".")
    .removesuffix(".__init__")
    for d, _, files in os.walk(os.path.join(ROOT, "svtrek_tpu_torch"))
    if "__pycache__" not in d and "_build" not in d
    for f in files if f.endswith(".py"))
# The tools chip_smoke.py imports, and the kernel and routes A/B timers
# that run beside it on the card.
SMOKE_TOOLS = ["audt_scalar", "bench_disc", "disc_scalar", "ins_fixture",
               "scan_scalar", "torch_fixtures", "torch_step_overhead",
               "torch_kernel_ab", "torch_routes_ab"]

# Run in a fresh interpreter: refuse jax, jaxlib and svtrek_tpu, import the
# module (svtrek_tpu_torch.__main__ runs the CLI, so with --help), report
# what was loaded.
_PROBE = r"""
import importlib, json, sys
BLOCKED = ("jax", "jaxlib", "svtrek_tpu")
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"refused: {name}")
        return None
sys.meta_path.insert(0, Refuse())
sys.path[:0] = [ROOT, TOOLS]
if NAME.endswith("__main__"):
    sys.argv = [NAME, "--help"]
    try:
        importlib.import_module(NAME)
    except SystemExit as e:
        assert e.code in (0, None), e.code
else:
    importlib.import_module(NAME)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)))
"""


def _probe(name: str) -> tuple[int, str, str]:
    code = (f"ROOT, TOOLS, NAME = {ROOT!r}, {TOOLS!r}, {name!r}\n" + _PROBE)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    return r.returncode, r.stdout, r.stderr


@pytest.fixture(scope="module")
def probes():
    """Every module's import probe, four interpreters at a time."""
    names = PKG_MODULES + SMOKE_TOOLS
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(names, pool.map(_probe, names)))


def test_module_list_covers_the_port():
    assert {"svtrek_tpu_torch.cli", "svtrek_tpu_torch.native.bamlib",
            "svtrek_tpu_torch.io.gaf_native", "svtrek_tpu_torch.oracle",
            "svtrek_tpu_torch.pipeline.audit", "svtrek_tpu_torch.ops.cigar",
            "svtrek_tpu_torch.ops.window_scan",
            "svtrek_tpu_torch.pipeline.scan",
            "svtrek_tpu_torch.ops.poa_graph",
            "svtrek_tpu_torch.ops.poa_graph_dp",
            "svtrek_tpu_torch.ops.poa_graph_batch"} <= set(PKG_MODULES)
    assert len(PKG_MODULES) >= 41


@pytest.mark.parametrize("name", PKG_MODULES + SMOKE_TOOLS)
def test_imports_nothing_of_jax_or_svtrek_tpu(probes, name):
    rc, out, err = probes[name]
    assert rc == 0, err[-3000:]
    assert json.loads(out.splitlines()[-1]) == []


def _plain(x):
    """Dataclasses, enums, arrays and containers as plain Python values,
    so that a copy's objects compare equal to the original's."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tolist())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "__slots__"):
        return tuple(_plain(getattr(x, s)) for s in x.__slots__)
    return x


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    from tests.fixtures import PlantedSV, write_fixture

    svs = [PlantedSV(1, 50_000, 50_400, "DEL", 400),
           PlantedSV(1, 120_000, 120_001, "INS", 120),
           PlantedSV(1, 200_000, 203_000, "INV", 3000),
           PlantedSV(2, 80_000, 80_070, "DEL", 70),
           PlantedSV(2, 160_000, 160_001, "INS", 65)]
    d = tmp_path_factory.mktemp("standalone")
    return write_fixture(str(d), svs, {1: 500_000, 2: 400_000}, seed=4,
                         depth=12, noise=30)


def test_iter_vcf_tasks_matches(planted):
    from svtrek_tpu.io.vcf import iter_vcf_tasks as jax_tasks
    from svtrek_tpu_torch.io.vcf import iter_vcf_tasks

    _, vcf = planted
    with open(vcf) as fh:
        lines = fh.readlines()
    # Add records the parser skips or reads unusually: a header-less
    # record, an unknown type, an END-less INV.
    lines += ["1\t700\tx\tN\t<BND>\t.\tPASS\tSVTYPE=BND\n",
              "2\t900\ty\tN\t<INV>\t.\tPASS\tSVTYPE=INV\n", "\n"]
    want = _plain(list(jax_tasks(lines)))
    assert _plain(list(iter_vcf_tasks(lines))) == want
    assert sum(type(t).__name__ == "VcfTask" for t in
               iter_vcf_tasks(lines)) >= 5


def test_gfa_gaf_projection_matches(tmp_path):
    from bench_disc import build_fixture
    from svtrek_tpu.io import gaf as jgaf
    from svtrek_tpu.io.gfa import parse_gfa as jax_parse_gfa
    from svtrek_tpu_torch.io import gaf
    from svtrek_tpu_torch.io.gfa import parse_gfa

    gfa_path, gaf_path, _ = build_fixture(str(tmp_path), 2_000, seed=3)
    jg, tg = jax_parse_gfa(gfa_path), parse_gfa(gfa_path)
    assert _plain(tg.segments) == _plain(jg.segments)
    jerr, terr = [], []
    want = list(jgaf.iter_gaf(gaf_path, jg, jerr))
    got = list(gaf.iter_gaf(gaf_path, tg, terr))
    assert _plain(got) == _plain(want) and terr == jerr
    wb = [_plain(jgaf.scan_breakpoints(p, 50)) for p in want]
    assert [_plain(gaf.scan_breakpoints(p, 50)) for p in got] == wb
    assert sum(map(len, wb)) > 20


def test_native_reader_fetch_matches(planted):
    from svtrek_tpu.native import native_bam_reader as jax_reader
    from svtrek_tpu_torch.native import bamlib, build, native_bam_reader

    bam, _ = planted
    j, t = jax_reader(bam), native_bam_reader(bam)
    for tid, beg, end in [(0, 45_000, 56_000), (1, 75_000, 90_000),
                          (0, 400_000, 400_100)]:
        assert _plain(t.fetch_packed(tid, beg, end)) == \
            _plain(j.fetch_packed(tid, beg, end))
        assert _plain(t.fetch(tid, beg, end)) == _plain(j.fetch(tid, beg, end))
    assert len(t.fetch(0, 45_000, 56_000)) > 10
    assert bamlib.load_library()._name == build.OUT
    assert os.path.dirname(build.OUT) == os.path.join(
        ROOT, "svtrek_tpu_torch", "_build")


def test_native_reader_raises_without_library(monkeypatch, planted):
    """No quiet None: a library that does not build is an OSError."""
    from svtrek_tpu_torch.native import bamlib, build

    monkeypatch.setenv("PATH", "")
    with pytest.raises(build.NativeBuildError):
        build.build(force=True)
    monkeypatch.setattr(bamlib, "_LIB", None)
    monkeypatch.setattr(build, "build", lambda: "/nonexistent/lib.so")
    with pytest.raises(OSError):
        bamlib.NativeBamReader(planted[0])


def test_oracle_consensus_pos_matches():
    from svtrek_tpu.oracle import consensus_pos as jax_consensus
    from svtrek_tpu_torch.oracle import consensus_pos

    rng = np.random.default_rng(5)
    for _ in range(300):
        center = int(rng.integers(1_000, 1_000_000))
        n = int(rng.integers(0, 40))
        locs = sorted((center + rng.integers(-600, 600, n)).tolist())
        pos = center + int(rng.integers(-100, 100))
        kw = dict(consensus_min_count=int(rng.integers(1, 5)),
                  consensus_interval=int(rng.integers(1, 10)),
                  consensus_interval_range=int(rng.integers(50, 600)))
        assert consensus_pos(locs, pos, **kw) == \
            jax_consensus(locs, pos, **kw)


def test_format_result_matches():
    from svtrek_tpu.constants import SVType as JSV
    from svtrek_tpu.emit import format_result as jax_format
    from svtrek_tpu_torch.constants import SVType
    from svtrek_tpu_torch.emit import format_result

    na = 0xFFFFFFFF
    for t in (SVType.INS, SVType.DEL, SVType.INV):
        for rs, re_ in [(1000, 2000), (na, 2000), (1000, na), (na, na),
                        (2**31 + 5, 7), (3, 2**32 - 2)]:
            args = (3, 990, 2010, rs, re_)
            assert format_result(t, *args) == jax_format(JSV(int(t)), *args)
    for t in (SVType.UNKNOWN, SVType.DUP):
        with pytest.raises(ValueError):
            format_result(t, 1, 2, 3, 4, 5)


@pytest.mark.parametrize("argv", [
    ["audt", "-b", "x.bam", "-v", "x.vcf"],
    ["disc", "-r", "g.gfa", "-a", "a.gaf", "-q", "r.fq"],
    ["audt", "-b", "x.bam", "-v", "x.vcf", "-t", "3", "--ins-consensus",
     "--poa-engine", "graph", "--sweep-width", "8"],
    ["scan", "-b", "x.bam", "-c", "chr2", "-s", "1", "-e", "9000",
     "--chrom-by-name", "--no-native-io", "--slide-size", "3"],
])
def test_build_parser_matches(argv):
    from svtrek_tpu import cli as jax_cli
    from svtrek_tpu_torch import cli

    got = vars(cli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jax_cli.build_parser().parse_args(argv))


def test_audt_fixture_matches_bench_e2e(tmp_path):
    """tools/torch_fixtures.py writes bench_e2e.build_fixture's files."""
    import bench_e2e
    import torch_fixtures

    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    want = bench_e2e.build_fixture(str(a), 60, 4, 100)
    got = torch_fixtures.build_fixture(str(b), 60, 4, 100)
    assert got[2:] == want[2:] and want[2] == 60 * 6
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "bench.bam" in names
    assert filecmp.cmpfiles(a, b, names, shallow=False)[0] == names


def test_python_bam_reader_matches(planted, tmp_path):
    """The port's Python BamReader (its numpy CIGAR and SEQ decode) gives
    svtrek_tpu's records: odd and even SEQ lengths, no SEQ, long CIGARs."""
    from svtrek_tpu.io.bam import BamReader as JaxReader
    from svtrek_tpu.io.bam import BamRecord, BamWriter
    from svtrek_tpu_torch.io.bam import BamReader

    bam = str(tmp_path / "odd.bam")
    rng = np.random.default_rng(9)
    with BamWriter(bam, [("1", 100_000)]) as w:
        for i in range(40):
            n = int(rng.integers(0, 300))
            cig = [(int(o), int(l)) for o, l in zip(
                rng.choice([0, 1, 2, 4, 5, 7, 8], n),
                rng.integers(1, 60, n))]
            qlen = sum(l for o, l in cig if o in (0, 1, 4, 7, 8))
            seq = "".join(rng.choice(list("ACGTN=M"), qlen)) if i % 5 \
                else "*"
            w.write(BamRecord(name=f"r{i}", flag=0, tid=0, pos=1_000 * i,
                              mapq=60, cigar=cig, seq=seq))
    for path, regions in ((bam, [(0, 0, 100_000), (0, 5_500, 9_000)]),
                          (planted[0], [(0, 45_000, 56_000),
                                        (1, 75_000, 90_000)])):
        got = [dataclasses.astuple(r) for t, b, e in regions
               for r in BamReader(path).fetch(t, b, e)]
        want = [dataclasses.astuple(r) for t, b, e in regions
                for r in JaxReader(path).fetch(t, b, e)]
        assert got == want and len(got) > 10


def test_poa_graph_matches():
    """ops/poa_graph.py (PoaGraph, consensus_sequence_poa): the same graphs
    (nodes, edges, weights, rings), alignments, device arrays and consensus
    as svtrek_tpu's on seeded clusters, with N bases, indels and a
    two-allele cluster."""
    import random

    from svtrek_tpu.ops import poa_graph as jpg
    from svtrek_tpu_torch.ops import poa_graph as pg
    from svtrek_tpu_torch.ops.poa import encode
    from tests.test_poa_graph import _mutate, _rand_seq

    def state(g):
        return _plain([g.base, [sorted(p) for p in g.preds],
                       [sorted(x) for x in g.succs],
                       [sorted(a) for a in g.aligned], g.node_w,
                       sorted(g.edge_w.items()), g.n_seqs])

    rng = random.Random(11)
    clusters = []
    for k in range(6):
        truth = _rand_seq(rng, rng.randint(20, 90))
        clusters.append([_mutate(rng, truth, 0.15)
                         for _ in range(rng.randint(2, 7))])
    clusters.append(["ACGNNTA", "ACGNTA", "ACNNNTA"])
    a = _rand_seq(rng, 40)
    clusters.append([a] * 3 + [a[:20] + _rand_seq(rng, 25) + a[20:]] * 2)
    assert pg.NEG == jpg.NEG
    for seqs in clusters:
        g, jg = pg.PoaGraph(), jpg.PoaGraph()
        g.add_first(encode(seqs[0]))
        jg.add_first(encode(seqs[0]))
        for s in seqs[1:]:
            q = encode(s)
            got, want = g.align(q), jg.align(q)
            assert got == want
            g.add_alignment(q, got[0])
            jg.add_alignment(q, want[0])
            assert state(g) == state(jg)
        assert g.topo_order() == jg.topo_order()
        assert g.max_indegree() == jg.max_indegree()
        shape = (len(g.base) + 3, g.max_indegree() + 1)
        assert _plain(g.to_arrays(*shape)) == _plain(jg.to_arrays(*shape))
        assert g.consensus() == jg.consensus()
        assert pg.consensus_sequence_poa(seqs) == \
            jpg.consensus_sequence_poa(seqs)
    assert pg.consensus_sequence_poa([]) == "" and \
        pg.consensus_sequence_poa(["", "AC"]) == "AC"
