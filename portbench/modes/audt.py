"""The `audt` mode: the window runs whole passes of
`svtrek_tpu_torch.pipeline.audit.run_audit` over the cell's VCF, and the
plain reference (reference/audt_scalar.py, a frozen copy of
tools/audt_scalar.py, plain Python and numpy that imports nothing of the
program) decides `correct`.

A mode is a file `modes/<mode>.py` that a traffic mix names by its `mode`
key; the generator, the metrics and the device trace stay the
harness's.  It gives the harness two functions:

- `start(fx, traffic, root, device)`: import the port, build or load its
  libraries, and return a driver whose `warm()` makes the warm pass and
  whose `step()` one pass of the window, each returning (the outputs, or
  None where the pass raised; the program's numbers), and whose
  `operations` counts what one window pass attempts;
- `check(fx, config, traffic, seed, outputs, trace)`: after the window,
  the numbers compared (each {value, limit}), how many operations gave no
  output, and with --trace 1 the work the roofline readers divide by.

Here the reference reads the same generated BAM and the VCF of the
distinct loci once; the window's VCF lists those loci `replays` times over,
so line j of a pass is held to reference line j mod (lines of one copy).
Every line of every pass is compared whole up to `, seq: `; with
`--ins-consensus` the seq of a sample of INS sites drawn from the seed,
the longest site that takes the consensus's alignment among them, is
compared too.  Each number compared has the limit 0: the comparison is
exact.
"""
from __future__ import annotations

import importlib.util
import io
import os
import re
import sys
import traceback

import numpy as np

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = ", seq: "
POA_MAX_LEN = 4096  # the star consensus aligns no seed longer than this


def load_reference(tag: str = "portbench_audt_scalar"):
    """A fresh instance of the frozen reference module whose BAM decode
    runs once a path: its `Bam(path, with_seq)` returns the reads an
    earlier call decoded where they hold what this call asks for (reads
    with SEQ serve a call without), so its several walks share one
    decode."""
    spec = importlib.util.spec_from_file_location(
        tag, os.path.join(PB, "reference", "audt_scalar.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    decode, done = mod.Bam, {}

    def bam(path: str, with_seq: bool = False):
        if path not in done or (with_seq and not done[path][0]):
            done[path] = (with_seq, decode(path, with_seq=with_seq))
        return done[path][1]

    mod.Bam = bam
    return mod


def line_loci(ref, vcf_path: str) -> list[int]:
    """For each line the reference prints for ``vcf_path``, the index of
    the data record that printed it."""
    out, k = [], 0
    with open(vcf_path) as fh:
        for raw in fh:
            if len(raw) < 2 or raw.startswith("#"):
                continue
            rec = ref.parse_record(raw.rstrip("\n"))
            if rec is not None and ref.windows(rec[0], rec[2],
                                               rec[3]) is not None:
                out.append(k)
            k += 1
    return out


def seq_sample(lines, loci, at, n: int, seed: int) -> set[int]:
    """Indices of INS lines with a refined position whose seq is checked:
    the longest site the consensus aligns, the longest of all, and n - 2
    more drawn from the seed."""
    ins = [j for j, line in enumerate(lines)
           if line.startswith("(INS)") and not line.endswith("ref pos: NA")]
    if not ins or n <= 0:
        return set()
    length = {j: loci[at[j]]["length"] for j in ins}
    pick = {max(ins, key=length.get)}
    aligned = [j for j in ins if length[j] <= POA_MAX_LEN]
    if aligned:
        pick.add(max(aligned, key=length.get))
    rest = sorted(set(ins) - pick)
    rng = np.random.default_rng([seed % 2**63, 7])
    take = min(len(rest), max(0, n - len(pick)))
    pick.update(int(j) for j in rng.choice(rest, take, replace=False))
    return pick


def reference(bam: str, loci_vcf: str, loci, ins_consensus: bool,
              n_seq: int, seed: int, ref=None):
    """(reference lines of one copy, the line indices whose seq is
    compared)."""
    ref = ref or load_reference()
    lines = ref.audt_lines(bam, loci_vcf)
    if not ins_consensus:
        return lines, set()
    sample = seq_sample(lines, loci, line_loci(ref, loci_vcf), n_seq, seed)
    return ref.audt_lines(bam, loci_vcf, True, seq_lines=sample), sample


def compare(passes, expected: list[str], copies: int,
            sample: set[int]) -> dict:
    """The numbers compared over all passes, each {value, limit}.  A pass
    is its list of lines, or None where it raised."""
    n = len(expected)
    want = n * copies
    mism = miss = seq_mism = 0
    for lines in passes:
        if lines is None:
            miss += want
            continue
        miss += max(0, want - len(lines))
        mism += max(0, len(lines) - want)
        for j, got in enumerate(lines[:want]):
            exp = expected[j % n]
            g_head, g_sep, g_seq = got.partition(SEQ)
            e_head, e_sep, e_seq = exp.partition(SEQ)
            if g_head != e_head:
                mism += 1
            elif (j % n) in sample and (g_sep, g_seq) != (e_sep, e_seq):
                seq_mism += 1
    out = {"mismatched_lines": {"value": mism, "limit": 0},
           "missing_lines": {"value": miss, "limit": 0}}
    if sample:
        out["mismatched_seqs"] = {"value": seq_mism, "limit": 0}
    return out


def candidates(bam: str, loci_vcf: str, ref=None) -> tuple[int, int]:
    """(windows that fetch, candidates they hold) in one copy of the
    loci, from the reference's own walk: the work any implementation of
    the consensus must read."""
    ref = ref or load_reference()
    reads = ref.Bam(bam)
    n_win = n_cand = 0
    with open(loci_vcf) as fh:
        for raw in fh:
            if len(raw) < 2 or raw.startswith("#"):
                continue
            rec = ref.parse_record(raw.rstrip("\n"))
            wins = rec and ref.windows(rec[0], rec[2], rec[3])
            for kind, s, e, _ in wins or ():
                if kind == ref.POINT:
                    continue
                n_win += 1
                n_cand += sum(
                    len(ref.evidence(kind, p, ops, lens, s, e))
                    for p, _, ops, lens, *_ in reads.fetch(
                        rec[1] - 1, ref.u32(s - 1), ref.u32(e - 1)))
    return n_win, n_cand


_TOKEN = re.compile(r"([A-Za-z_+]+)=([0-9.]+)s?\b")


def parse_verbose(err_text: str) -> dict:
    """The numbers of run_audit's [VERBOSE] lines (AuditStats, read-only);
    those of its ins_consensus line get the prefix `cons_`."""
    out: dict = {}
    for line in err_text.splitlines():
        if not line.startswith("[VERBOSE]"):
            continue
        pre = "cons_" if line.startswith("[VERBOSE] ins_consensus") else ""
        for key, val in _TOKEN.findall(line):
            out[pre + key] = float(val)
    return out


def count_records(vcf_path: str) -> int:
    with open(vcf_path) as fh:
        return sum(1 for line in fh if len(line) > 1 and line[0] != "#")


class Driver:
    """run_audit in-process on the cell's inputs, as `svtrek_tpu_torch.cli
    audt` runs it, with --verbose and the traffic's options."""

    def __init__(self, fx: dict, options: dict, device: str):
        from svtrek_tpu_torch.config import AudtConfig
        from svtrek_tpu_torch.pipeline import audit

        self.fx, self.audit = fx, audit
        self.config = lambda vcf: AudtConfig(
            bam_file=fx["bam"], vcf_file=vcf, device=device, verbose=True,
            **options)
        self.operations = count_records(fx["vcf"])  # VCF records a pass

    def _pass(self, vcf: str):
        err = io.StringIO()
        try:
            lines = self.audit.run_audit(self.config(vcf), out=io.StringIO(),
                                         err=err)
        except Exception:  # counted as failed; the traceback is kept
            traceback.print_exc(file=sys.stderr)
            lines = None
        return lines, parse_verbose(err.getvalue())

    def warm(self):
        """One pass over the distinct loci: every shape the window uses."""
        return self._pass(self.fx["loci_vcf"])

    def step(self):
        return self._pass(self.fx["vcf"])


def start(fx: dict, traffic: dict, root: str, device: str) -> Driver:
    if root not in sys.path:
        sys.path.insert(0, root)
    from svtrek_tpu_torch.native import build as native_build

    native_build.build()
    if device == "cuda":
        from svtrek_tpu_torch.kernels import build as cuda_build

        cuda_build.build()
    return Driver(fx, dict(traffic.get("options", {})), device)


def check(fx: dict, config: dict, traffic: dict, seed: int, outputs: list,
          trace: bool) -> tuple[dict, int, dict]:
    """(the numbers compared, outputs missing, the work of the window)."""
    ref = load_reference()
    ins = bool(traffic.get("options", {}).get("ins_consensus"))
    expected, sample = reference(fx["bam"], fx["loci_vcf"], fx["loci"], ins,
                                 traffic.get("seq_sample", 0), seed, ref)
    checks = compare(outputs, expected, config["replays"], sample)
    work = {}
    if trace:
        n_win, n_cand = candidates(fx["bam"], fx["loci_vcf"], ref)
        copies = config["replays"] * len(outputs)
        work = {"windows": n_win * copies, "candidates": n_cand * copies}
    return checks, checks["missing_lines"]["value"], work
