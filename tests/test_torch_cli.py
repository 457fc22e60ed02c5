"""The port's command line (python -m svtrek_tpu_torch.cli): the audt run
on --device cpu, with and without --ins-consensus, --extract device and
--no-native-io, the scan and disc runs against svtrek_tpu's CLI, that the options it once
refused (`--data-shards 2`, SVTREK_COORDINATOR among them) now run, and
that it runs where JAX cannot be imported at all (the machine with the
card has none)."""
from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from svtrek_tpu import cli as jax_cli
from svtrek_tpu.config import AudtConfig
from svtrek_tpu.pipeline.audit import run_audit as jax_run_audit
from svtrek_tpu_torch import cli
from svtrek_tpu_torch.pipeline import audit as taudit
from tests.fixtures import PlantedSV, write_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from bench_disc import build_fixture as build_disc_fixture  # noqa: E402


@pytest.fixture(scope="module")
def audt_fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    svs = [PlantedSV(1, 50_000, 50_400, "DEL", 400),
           PlantedSV(1, 120_000, 120_001, "INS", 120),
           PlantedSV(1, 180_000, 180_300, "INV", 300)]
    bam, vcf = write_fixture(str(d), svs, {1: 300_000}, seed=7)
    want = jax_run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                    data_shards=1),
                         out=io.StringIO(), err=io.StringIO())
    return str(d), bam, vcf, want


def test_cli_audt_cpu(audt_fixture, capsys):
    d, bam, vcf, want = audt_fixture
    out_path = os.path.join(d, "out.txt")
    rc = cli.main(["audt", "-b", bam, "-v", vcf, "-o", out_path,
                   "--device", "cpu", "--verbose", "-t", "2"])
    assert rc == 0
    captured = capsys.readouterr()
    assert [l for l in captured.out.splitlines() if l.startswith("(")] == want
    assert "[VERBOSE]" in captured.err and "device=cpu" in captured.err
    with open(out_path) as fh:
        assert fh.read().splitlines() == want


def test_cli_trace_dir_writes_profiler_trace(audt_fixture, capsys):
    d, bam, vcf, want = audt_fixture
    trace_dir = os.path.join(d, "trace")
    rc = cli.main(["audt", "-b", bam, "-v", vcf, "-o",
                   os.path.join(d, "t.txt"), "--device", "cpu",
                   "--trace-dir", trace_dir])
    assert rc == 0
    assert "torch.profiler trace" in capsys.readouterr().err
    with open(os.path.join(trace_dir, "audt_trace.json")) as fh:
        trace = json.load(fh)
    assert "traceEvents" in trace
    # the stage ranges: the consumer's, and the workers' on their own rows
    # where this torch records every thread
    rows = {e["name"]: e["tid"] for e in trace["traceEvents"]
            if e.get("name", "").startswith("svtrek.")}
    assert {"svtrek.queue_wait", "svtrek.write"} <= set(rows)
    try:
        torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return
    assert rows["svtrek.fetch"] != rows["svtrek.queue_wait"]
    assert "svtrek.extract" in rows


# The options the port refused until the slice that ported them: the
# device evidence walk (--extract device, --no-native-io), the graph POA
# (--poa-engine graph) and mesh sharding (--data-shards 2, ROADMAP queue 1
# item 9), each with the shard count its run reports.
REFUSED = {
    "data_shards": (["--data-shards", "2"], 2),
    "extract_device": (["--extract", "device"], 1),
    "no_native_io": (["--no-native-io"], 1),
    "poa_graph": (["--poa-engine", "graph"], 1),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_cli_refuses_unported_options(audt_fixture, capsys, name):
    """Each option the port once refused runs and prints svtrek_tpu's
    lines (its data_shards=1 run's: the JAX package's lines do not depend
    on the shard count)."""
    d, bam, vcf, want = audt_fixture
    flags, shards = REFUSED[name]
    out_path = os.path.join(d, f"refused_{name}.txt")
    rc = cli.main(["audt", "-b", bam, "-v", vcf, "-o", out_path,
                   "--device", "cpu", "--verbose", *flags])
    assert rc == 0
    captured = capsys.readouterr()
    assert [l for l in captured.out.splitlines()
            if l.startswith("(")] == want
    assert f"dev_ovf=0) device=cpu data_shards={shards}" in captured.err
    with open(out_path) as fh:
        assert fh.read().splitlines() == want


def test_cli_ins_consensus_cpu(audt_fixture, capsys):
    """--ins-consensus runs (it was refused before kernels K2 and K3 were
    ported): the planted INS line gains its seq field, as in the JAX
    package, and the other lines are unchanged."""
    d, bam, vcf, plain = audt_fixture
    want = jax_run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                    data_shards=1, ins_consensus=True),
                         out=io.StringIO(), err=io.StringIO())
    out_path = os.path.join(d, "ins_consensus.txt")
    assert cli.main(["audt", "-b", bam, "-v", vcf, "-o", out_path,
                     "--device", "cpu", "--ins-consensus"]) == 0
    out = capsys.readouterr().out
    assert [l for l in out.splitlines() if l.startswith("(")] == want
    assert [l.split(", seq:")[0] for l in want] == plain
    assert sum(", seq: " in l for l in want) == 1
    with open(out_path) as fh:
        assert fh.read().splitlines() == want


def _run_coordinated(argv: list[str], cwd: str) -> list[str]:
    """The port's CLI in a subprocess that joins a one-process gloo group:
    SVTREK_COORDINATOR on a free local port, SVTREK_NUM_PROCS=1,
    SVTREK_PROC_ID=0.  Returns its result lines."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT,
               SVTREK_COORDINATOR=f"127.0.0.1:{port}", SVTREK_NUM_PROCS="1",
               SVTREK_PROC_ID="0")
    proc = subprocess.run(
        [sys.executable, "-m", "svtrek_tpu_torch.cli", *argv, "--device",
         "cpu"], capture_output=True, text=True, env=env, cwd=cwd,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [l for l in proc.stdout.splitlines() if l.startswith("(")]


def test_cli_refuses_coordinator(audt_fixture):
    """SVTREK_COORDINATOR (refused until mesh sharding and multi-process
    runs were ported) runs: the audt lines are svtrek_tpu's."""
    d, bam, vcf, want = audt_fixture
    assert _run_coordinated(["audt", "-b", bam, "-v", vcf, "-o",
                             os.path.join(d, "coord.txt")], d) == want


def _jax_cli_lines(argv) -> list[str]:
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert jax_cli.main(argv) == 0
    return stdout.getvalue().splitlines()


@pytest.mark.parametrize("mode", ["scan", "disc"])
def test_cli_refuses_other_modes(audt_fixture, capsys, mode):
    """Both modes are ported: scan (refused until the slice that ported
    it) prints svtrek_tpu.cli's lines, and a missing disc input gets
    svtrek_tpu.cli's file check."""
    if mode == "scan":
        d, bam, _, _ = audt_fixture
        argv = ["scan", "-b", bam, "-c", "1", "-s", "115000", "-e",
                "125000", "--window-size", "1000"]
        want = _jax_cli_lines([*argv, "-o", os.path.join(d, "scan_j.out")])
        out_path = os.path.join(d, "scan_t.out")
        assert cli.main([*argv, "-o", out_path, "--device", "cpu"]) == 0
        got = capsys.readouterr().out.splitlines()
        assert got == want and "INS Discovery in window" in got[0]
        with open(out_path) as fh:
            assert fh.read().splitlines() == want
        return
    with pytest.raises(SystemExit) as exc:
        cli.main(["disc", "-r", "g", "-a", "a", "-q", "q", "--device",
                  "cpu"])
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert "File couldn't be opened g" in err and "not ported" not in err


def test_missing_native_reader_raises(audt_fixture, monkeypatch, capsys):
    """No quiet fall back to the Python reader when the C library is
    unavailable: audt and scan exit 1 saying so; --no-native-io asks for
    the Python reader and runs."""
    d, bam, vcf, want = audt_fixture

    def no_lib(path):
        raise OSError("native library unavailable")

    monkeypatch.setattr(taudit, "native_bam_reader", no_lib)
    with pytest.raises(taudit.NativeReaderUnavailable,
                       match="native BAM reader"):
        taudit.run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                    device="cpu"),
                         out=io.StringIO(), err=io.StringIO())
    assert cli.main(["audt", "-b", bam, "-v", vcf, "--device", "cpu",
                     "-o", os.path.join(d, "nonative.txt")]) == 1
    assert "native BAM reader is unavailable" in capsys.readouterr().err
    assert cli.main(["scan", "-b", bam, "-c", "1", "-s", "1", "-e", "5000",
                     "--device", "cpu", "-o",
                     os.path.join(d, "nonative_scan.txt")]) == 1
    assert "native BAM reader is unavailable" in capsys.readouterr().err
    assert cli.main(["audt", "-b", bam, "-v", vcf, "--device", "cpu",
                     "--no-native-io", "-o",
                     os.path.join(d, "python_reader.txt")]) == 0
    assert [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("(")] == want


def test_cli_device_cuda_without_card_fails(audt_fixture, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the refusal")
    _, bam, vcf, _ = audt_fixture
    assert cli.main(["audt", "-b", bam, "-v", vcf, "-o", os.devnull]) == 1
    assert "no CUDA device is visible" in capsys.readouterr().err


_JAX_BLOCKED_RUN = """
import runpy, sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked in this process: " + name)
        return None

sys.meta_path.insert(0, _NoJax())
sys.argv = ["svtrek_tpu_torch.cli"] + sys.argv[1:]
try:
    runpy.run_module("svtrek_tpu_torch.cli", run_name="__main__")
finally:
    sys.stderr.write("JAX_MODULES=%d\\n" % sum(
        m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules))
"""


def test_cli_runs_with_jax_blocked(audt_fixture):
    d, bam, vcf, want = audt_fixture
    out_path = os.path.join(d, "nojax.txt")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_BLOCKED_RUN, "audt", "-b", bam, "-v",
         vcf, "-o", out_path, "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=d, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_MODULES=0" in proc.stderr
    assert [l for l in proc.stdout.splitlines() if l.startswith("(")] == want
    with open(out_path) as fh:
        assert fh.read().splitlines() == want


SCAN_FLAGS = {
    "no_native_io": ["-c", "1", "--no-native-io", "--slide-size", "2"],
    "chrom_by_name": ["-c", "1", "--chrom-by-name", "-t", "1",
                      "--batch-windows", "3"],
}


@pytest.mark.parametrize("name", sorted(SCAN_FLAGS))
def test_cli_scan_cpu(audt_fixture, capsys, name):
    d, bam, _, _ = audt_fixture
    argv = ["scan", "-b", bam, "-s", "110000", "-e", "130000",
            *SCAN_FLAGS[name]]
    want = _jax_cli_lines([*argv, "-o", os.path.join(d, f"j_{name}.out")])
    assert cli.main([*argv, "-o", os.path.join(d, f"t_{name}.out"),
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == want
    assert len(want) >= 2


def test_cli_scan_errors(audt_fixture, capsys):
    """A non-numeric -c without --chrom-by-name, a missing BAM, and
    --device cuda where there is no card."""
    d, bam, _, _ = audt_fixture
    assert cli.main(["scan", "-b", bam, "-c", "chr1", "-s", "1", "-e",
                     "2000", "--device", "cpu"]) == 1
    assert "not numeric" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["scan", "-b", os.path.join(d, "none.bam"), "-c", "1",
                  "-s", "1", "-e", "2000", "--device", "cpu"])
    assert "File couldn't be opened" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert cli.main(["scan", "-b", bam, "-c", "1", "-s", "1", "-e",
                         "2000", "-o", os.devnull]) == 1
        assert "no CUDA device is visible" in capsys.readouterr().err


def test_cli_scan_runs_with_jax_blocked(audt_fixture):
    """scan on both paths where JAX cannot be imported."""
    d, bam, _, _ = audt_fixture
    for flags in ([], ["--no-native-io"]):
        argv = ["scan", "-b", bam, "-c", "1", "-s", "115000", "-e",
                "125000", *flags]
        want = _jax_cli_lines([*argv, "-o", os.path.join(d, "j_nojax.out")])
        proc = subprocess.run(
            [sys.executable, "-c", _JAX_BLOCKED_RUN, *argv, "-o",
             os.path.join(d, "nojax_scan.txt"), "--device", "cpu"],
            capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=ROOT), cwd=d, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "JAX_MODULES=0" in proc.stderr
        assert proc.stdout.splitlines() == want


@pytest.fixture(scope="module")
def disc_fixture(tmp_path_factory):
    """tools/bench_disc.py's fixture at 3,000 reads and svtrek_tpu's CLI
    lines for it."""
    d = str(tmp_path_factory.mktemp("torch_cli_disc"))
    gfa, gaf, fq = build_disc_fixture(d, 3000, seed=1)
    out_path = os.path.join(d, "jax.txt")
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert jax_cli.main(["disc", "-r", gfa, "-a", gaf, "-q", fq, "-o",
                             out_path, "--data-shards", "1"]) == 0
    want = [l for l in stdout.getvalue().splitlines()
            if l.startswith("(DISC")]
    return d, ["-r", gfa, "-a", gaf, "-q", fq], want


def test_cli_disc_cpu(disc_fixture, capsys):
    d, inputs, want = disc_fixture
    out_path = os.path.join(d, "disc.txt")
    assert cli.main(["disc", *inputs, "-o", out_path, "--device", "cpu"]) \
        == 0
    out = capsys.readouterr().out
    assert [l for l in out.splitlines() if l.startswith("(DISC")] == want
    assert any(", seq: " in l and "seq: NA" not in l for l in want)
    with open(out_path) as fh:
        assert fh.read().splitlines() == want
    assert os.path.exists(out_path + ".ckpt.npz")


# The options disc refused until the slice that ported them: the graph POA
# (--poa-engine graph), mesh sharding (--data-shards 2) and multi-process
# runs (SVTREK_COORDINATOR, run in a subprocess of its own).
DISC_REFUSED = {
    "poa_graph": ["--poa-engine", "graph"],
    "data_shards": ["--data-shards", "2"],
    "coordinator": [],
}


def _jax_disc_lines(d: str, inputs: list[str], flags: list[str]):
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert jax_cli.main(["disc", *inputs, "-o",
                             os.path.join(d, "jax_run.txt"),
                             "--data-shards", "1", *flags]) == 0
    return [l for l in stdout.getvalue().splitlines()
            if l.startswith("(DISC")]


@pytest.mark.parametrize("name", sorted(DISC_REFUSED))
def test_cli_disc_refuses_unported_options(disc_fixture, capsys, name):
    """Each option disc once refused runs and prints svtrek_tpu's lines
    for it (the JAX CLI at the same flags, --data-shards 2 included)."""
    d, inputs, _ = disc_fixture
    flags = DISC_REFUSED[name]
    out_path = os.path.join(d, f"refused_{name}.txt")
    want = _jax_disc_lines(d, inputs, flags)
    capsys.readouterr()
    if name == "coordinator":
        got = _run_coordinated(["disc", *inputs, "-o", out_path], d)
    else:
        assert cli.main(["disc", *inputs, "-o", out_path, "--device", "cpu",
                         *flags]) == 0
        got = [l for l in capsys.readouterr().out.splitlines()
               if l.startswith("(DISC")]
    assert got == want and any(", seq: " in l for l in want)
    with open(out_path) as fh:
        assert fh.read().splitlines() == want


def test_cli_disc_device_cuda_without_card_fails(disc_fixture, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the refusal")
    d, inputs, _ = disc_fixture
    assert cli.main(["disc", *inputs, "-o", os.path.join(d, "c.txt")]) == 1
    assert "no CUDA device is visible" in capsys.readouterr().err


def test_cli_disc_runs_with_jax_blocked(disc_fixture):
    d, inputs, want = disc_fixture
    out_path = os.path.join(d, "nojax_disc.txt")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_BLOCKED_RUN, "disc", *inputs, "-o",
         out_path, "--device", "cpu"],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=ROOT),
        cwd=d, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_MODULES=0" in proc.stderr
    assert [l for l in proc.stdout.splitlines()
            if l.startswith("(DISC")] == want
