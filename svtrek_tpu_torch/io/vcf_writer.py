"""Refined-VCF writer.

The reference's intended (never implemented) output artifact: its -o flag
is parsed and ignored (init.c:102-107; SURVEY.md §5), and simvcf's SVELDT
header documents the intended status vocabulary — SIMULATED / SUCCESS /
PARTIAL / INCORRECT (utils/simvcf.py:101).  This module defines the
completed behavior:

- header and pass-through lines are copied unchanged;
- refined records get POS rewritten to the refined start, the standalone
  END= INFO tag rewritten to the refined end (CIEND/SVEND etc. are left
  alone), and SVELDT= set to SUCCESS (all points refined), PARTIAL (some),
  or INCORRECT (none).
"""
from __future__ import annotations

import re

from .vcf import VcfTask
from ..constants import SVType

NA32 = 0xFFFFFFFF
_END_RE = re.compile(r"(?<![A-Za-z])END=[^;]*")
_SVELDT_RE = re.compile(r"SVELDT=[^;]*")


def _status(sv_type: SVType, rstart: int, rend: int) -> str:
    points = 1 if sv_type == SVType.INS else 2
    ok = int(rstart != NA32) + (int(rend != NA32) if points == 2 else 0)
    if ok == points:
        return "SUCCESS"
    if ok == 0:
        return "INCORRECT"
    return "PARTIAL"


def refine_record_line(task: VcfTask, rstart: int, rend: int) -> str:
    """Rewrite one data line with refined coordinates + SVELDT status."""
    fields = task.raw.split("\t")
    if len(fields) < 8:
        return task.raw
    status = _status(task.sv_type, rstart, rend)
    if rstart != NA32:
        fields[1] = str(rstart)
    info = fields[7]
    if task.sv_type != SVType.INS and rend != NA32:
        if _END_RE.search(info):
            info = _END_RE.sub(f"END={rend}", info, count=1)
        else:
            info += f";END={rend}"
    if _SVELDT_RE.search(info):
        info = _SVELDT_RE.sub(f"SVELDT={status}", info)
    else:
        info += f";SVELDT={status}"
    fields[7] = info
    return "\t".join(fields)


def write_refined_vcf(out_path: str, in_path: str,
                      results: dict[int, tuple[VcfTask, int, int]]):
    """Copy ``in_path`` to ``out_path`` rewriting refined records.

    results: line_index → (task, refined_start_u32, refined_end_u32).
    Line indices count data lines in input order, matching
    iter_vcf_tasks."""
    idx = 0
    with open(in_path) as fin, open(out_path, "w") as fout:
        for raw in fin:
            if len(raw) < 2 or raw.startswith("#"):
                fout.write(raw)
                continue
            hit = results.get(idx)
            if hit is not None:
                task, rs, re_ = hit
                fout.write(refine_record_line(task, rs, re_) + "\n")
            else:
                fout.write(raw)
            idx += 1
