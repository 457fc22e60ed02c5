"""`audt` mode pipeline: VCF + BAM → refined breakpoint records, with the
device step in PyTorch.

Port of svtrek_tpu/pipeline/audit.py.  A pool of producer
threads fetches and packs each chunk of windows, each thread with its own
BAM reader; this thread sends each batch to the device (`ops.audit_step`),
keeps a few in flight, and emits result lines in input order as records
complete.  The producers take one of the JAX pipeline's three branches:

- host extract (`extract` auto or host, the default): the native C reader
  fetches the chunk and runs the CIGAR evidence walk, and the device gets
  [B, K] candidate batches (`pack_chunk_cand` → `audit_consensus_step`);
- `--extract device`: the native C reader fetches the chunk, the device
  gets its flat CIGAR op/len streams and runs the walk, the grouping and
  the consensus (`pack_chunk_native` → `audit_refine_step_csr`);
- `--no-native-io`: the Python reader `io.bam.BamReader` fetches each
  window and the host packs padded [N, O] CIGAR matrices for the same
  device walk (`pack_chunk` → `audit_refine_step`), or the flat layout
  where a read passes the top ops bucket.

`--cand-width` and `--max-candidates` set the width K of the first
pass's batch and `--sweep-width` the anchors its consensus folds, as in
the JAX package.  A window past them takes a second pass on the batch's
device at the width it needs (`pack.WIDE_MAX_K` at most, K1's widest
row): the full sweep `ops.consensus.consensus_pos_full`, over the host
path's side batch of the windows past K (`PackedCandBatch.wide_batch`,
launched with the first) and the rows whose sweep overflowed, or over the
device walk regrouped at that width (`ops.audit_step.audit_refine_wide`
on the walk the step kept).  `wide_k` counts the windows past K and
`sweep_full` the other rows whose sweep overflowed.  Only a window past
WIDE_MAX_K candidates is refined on the host: on the host-extract path by
the C scalar consensus (`kovf`), on the device walk by `oracle.refine_task`
(`fallback_device`, printed `dev_ovf`).  A host-extracted first pass is at
most 8,192 wide, so every row whose sweep overflows takes the full sweep,
and `fallback_sweep` (`sweep`), the JAX package's host route for them,
stays 0.  The walk takes reads of any op count and every candidate of a
read, so `fallback_long`, the JAX package's windows with a read past its
top ops bucket, stays 0.

With `--ins-consensus`, each refined INS record also gets the consensus of
the inserted bases its supporting reads carry: the native reader decodes
them from SEQ, and one batched consensus call covers every site completed
by a collected batch: the star POA (`ops.poa_batch`, kernels K2 and K3 on
the card) or, with `--poa-engine graph`, the graph POA
(`ops.poa_graph_batch`, kernel G1).

With ``data_shards`` > 1 (`--data-shards N`; 0 means one shard per
visible card, or 1 on `--device cpu`) each batch is packed shard-blockwise
and refined by the sharded steps of `parallel.mesh`: a launch per shard on
its own device and stream (one card may hold several shards), gathered at
collect time.  With SVTREK_COORDINATOR exported, `torch.distributed` is
bootstrapped first (`parallel.mesh.init_distributed`); each process then
runs the records its `--num-shards/--shard-index` give it on its own
devices.  A native library that does not build is an error
(`NativeReaderUnavailable`), not a switch to the Python reader: only
`--no-native-io` asks for that.
"""
from __future__ import annotations

import functools
import itertools
import os
import queue
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from ..config import AudtConfig
from ..constants import SVType
from ..emit import format_result
from ..io.bam import BamReader
from ..io.vcf import VcfSkip, VcfTask, iter_vcf_tasks
from ..native import native_bam_reader
from ..oracle import refine_task

from ..device import resolve_device
from ..ops.audit_step import (
    AuditBatchCSR, audit_consensus_step, audit_consensus_wide,
    audit_refine_step, audit_refine_step_csr, audit_refine_wide, to_device,
)
from ..ops.poa_batch import consensus_sequence_batch
from ..ops.poa_graph_batch import consensus_sequence_poa_batch
from ..parallel.mesh import (
    ShardedOutput, init_distributed, launch_on_shards, read_on_shards,
    run_mesh, sharded_audit_step, sharded_audit_step_csr,
    sharded_consensus_step,
)
from ..refusals import raise_refused
from . import pack
from .pack import (
    INT64_MIN, PackedBatch, PackedCandBatch, as_read_list, pack_chunk,
    pack_chunk_cand, pack_chunk_native, window_tid, windows_for_task,
)

NA32 = 0xFFFFFFFF


class NativeReaderUnavailable(OSError):
    """The native C BAM reader did not build or load, or cannot open the
    BAM; nothing switches to the Python reader on its own."""


def open_native_reader(path: str):
    """The native C BAM reader; NativeReaderUnavailable when the C library
    did not build or the BAM or its index cannot be opened."""
    try:
        return native_bam_reader(path)
    except OSError as e:
        raise NativeReaderUnavailable(
            f"the native BAM reader is unavailable ({e}; svtrek_tpu_torch/"
            f"native did not build, or the BAM or its index cannot be "
            f"opened); --no-native-io runs the Python BAM reader") from e


def open_reader(cfg):
    """The run's BAM reader: the native C reader, or with --no-native-io
    (``cfg.use_native_io`` false) the Python `io.bam.BamReader`."""
    if cfg.use_native_io:
        return open_native_reader(cfg.bam_file)
    return BamReader(cfg.bam_file)


def reader_tid(reader, name: str) -> int:
    """tid of a reference name on either reader (chr-prefix tolerant)."""
    if hasattr(reader, "tid_by_name"):
        return reader.tid_by_name(name)
    return reader.tid_of(name)


def python_fetch(reader: BamReader):
    """fetch(tid, beg, end) → [(pos, [(op, len), ...]), ...] on the Python
    reader (the list form `pack.as_packed` normalises)."""
    def fetch(tid, beg, end):
        return [(rec.pos, rec.cigar)
                for rec in reader.fetch(tid, int(beg), int(end))]

    return fetch


@dataclass
class AuditResult:
    task: VcfTask
    rstart: int = NA32
    rend: int = NA32
    emit: bool = True
    chrom_label: object = None  # --chrom-by-name: print the CHROM name
    remaining: int = 0          # windows not yet applied (streaming emit)
    # --ins-consensus: POA consensus of the inserted sequence
    needs_seq: bool = False
    cons_tid: int = -1
    seq: str | None = None      # None = unresolved; "" = no consensus

    def line(self) -> str:
        chrom = (self.chrom_label if self.chrom_label is not None
                 else self.task.chrom_index)
        text = format_result(
            self.task.sv_type, chrom, self.task.pos,
            self.task.end, self.rstart, self.rend,
        )
        if self.needs_seq:
            text += f", seq: {self.seq if self.seq else 'NA'}"
        return text


@dataclass
class AuditStats:
    """Per-stage wall-clock and work counters (--verbose)."""

    parse_s: float = 0.0
    pack_s: float = 0.0      # producer pool: fetch + evidence walk + pack
                             # (aggregate worker-seconds)
    device_s: float = 0.0    # blocked on device results
    emit_s: float = 0.0
    cons_s: float = 0.0      # --ins-consensus: seq fetch + POA batches
    cons_sites: int = 0      # INS sites given a consensus sequence
    cons_flushes: int = 0    # batched consensus calls
    cons_dp_calls: int = 0   # DP batches those calls sent to the device
    cons_graph_scalar: int = 0  # graph engine: clusters on the scalar route
    cons_band_wide: int = 0  # star engine: pairs on the DP with a band
                             # above the JAX package's cap of 512
    cons_band_scalar: int = 0  # star engine: pairs on the host DP
    cons_band_wide_k2: int = 0  # star engine: pairs with a band above
                                # kernels.POA_STRIP_MAX_BAND (K2's wide
                                # kernel on cuda)
    total_s: float = 0.0
    records: int = 0
    windows: int = 0
    reads: int = 0
    batches: int = 0
    oracle_windows: int = 0  # host-fallback windows, all causes (total)
    fallback_kovf: int = 0   # past K and pack.WIDE_MAX_K candidates
    fallback_sweep: int = 0  # the JAX package's sweep route: 0 here
    fallback_long: int = 0   # the JAX package's long-read windows: 0 here
    fallback_device: int = 0  # device-walk overflow (K or sweep) past
                              # WIDE_MAX_K candidates
    wide_k: int = 0          # windows past K in a second device pass
    sweep_full: int = 0      # other rows whose sweep passed sweep_width,
                             # given the full sweep on the device
    device: str = ""
    data_shards: int = 1

    def report(self, err) -> None:
        # The JAX package prints the device-walk overflows as `device=N`;
        # here `device=` names the torch device, so they are `dev_ovf=N`.
        print(
            f"[VERBOSE] records={self.records} windows={self.windows} "
            f"reads={self.reads} batches={self.batches} "
            f"oracle_fallbacks={self.oracle_windows} "
            f"(kovf={self.fallback_kovf} sweep={self.fallback_sweep} "
            f"long_ops={self.fallback_long} dev_ovf={self.fallback_device}) "
            f"device={self.device} data_shards={self.data_shards} "
            f"wide_k={self.wide_k} sweep_full={self.sweep_full}",
            file=err,
        )
        print(
            f"[VERBOSE] parse={self.parse_s:.3f}s "
            f"fetch+pack={self.pack_s:.3f}s device_wait={self.device_s:.3f}s "
            f"emit={self.emit_s:.3f}s total={self.total_s:.3f}s",
            file=err,
        )
        if self.cons_sites:
            print(
                f"[VERBOSE] ins_consensus sites={self.cons_sites} "
                f"time={self.cons_s:.3f}s flushes={self.cons_flushes} "
                f"dp_calls={self.cons_dp_calls} "
                f"graph_scalar={self.cons_graph_scalar} "
                f"band_wide={self.cons_band_wide} "
                f"band_scalar={self.cons_band_scalar} "
                f"band_wide_k2={self.cons_band_wide_k2}",
                file=err,
            )


@functools.lru_cache(maxsize=None)
def _get_sharded_step(device_type: str, n: int, num_windows: int, K: int,
                      min_count: int, interval: int, range_: int,
                      sweep_width: int):
    return sharded_audit_step(
        run_mesh(device_type, n), num_windows=num_windows, K=K,
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width, keep=True)


@functools.lru_cache(maxsize=None)
def _get_sharded_csr(device_type: str, n: int, num_windows: int, K: int,
                     min_count: int, interval: int, range_: int,
                     sweep_width: int):
    return sharded_audit_step_csr(
        run_mesh(device_type, n), num_windows=num_windows, K=K,
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width, keep=True)


@functools.lru_cache(maxsize=None)
def _get_sharded_consensus(device_type: str, n: int, num_windows: int,
                           min_count: int, interval: int, range_: int,
                           sweep_width: int):
    return sharded_consensus_step(
        run_mesh(device_type, n), num_windows=num_windows,
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width)


def resolve_data_shards(cfg, device: torch.device, err=None) -> int:
    """How many shards to pack for: cfg.data_shards, or (0) one per
    visible card, 1 on the CPU.  With SVTREK_COORDINATOR exported,
    `torch.distributed` is bootstrapped first (gloo for a CPU run), and
    the process group and its shards in all are reported on ``err``."""
    n = cfg.data_shards
    if n <= 0:
        n = max(1, torch.cuda.device_count()) if device.type == "cuda" else 1
    if os.environ.get("SVTREK_COORDINATOR"):
        world = init_distributed(
            backend="gloo" if device.type == "cpu" else None, local_shards=n)
        print(f"[INFO] torch.distributed: {dist.get_backend()} backend, "
              f"process {dist.get_rank()} of {dist.get_world_size()}, "
              f"{world} shard(s) in all", file=err or sys.stderr)
    return n


def _walk_k(cfg: AudtConfig) -> int:
    """The device walk's first-pass width K (`--max-candidates`)."""
    return pack.pow2(min(cfg.max_candidates, 8192), 64)


def _full_kw(cfg: AudtConfig) -> dict:
    return dict(min_count=cfg.consensus_min_count,
                interval=cfg.consensus_interval,
                range_=cfg.consensus_interval_range)


def _by_shard(slots: np.ndarray, num_windows: int, mesh):
    """(shard, positions in ``slots``) of each shard that holds one of the
    window slots ``slots`` of a batch laid out shard-blockwise (one group
    with shard None on one device)."""
    if mesh is None:
        return [(None, np.arange(len(slots)))] if len(slots) else []
    shard = np.asarray(slots) // (num_windows // mesh.size)
    return [(int(s), np.flatnonzero(shard == s)) for s in np.unique(shard)]


def dispatch_refinement(packed: PackedCandBatch | PackedBatch,
                        cfg: AudtConfig, device: torch.device):
    """Launch the device step for one packed batch (asynchronous on
    CUDA), and on the host-extract path the second pass of its windows
    past K; returns (the first pass's device tensors, or a ShardedOutput
    for a batch packed for several shards; the second pass's parts or the
    walk's kept WalkStates), or None for an empty batch."""
    b = packed.batch
    if b.num_windows == 0:
        return None
    kw = dict(min_count=cfg.consensus_min_count,
              interval=cfg.consensus_interval,
              range_=cfg.consensus_interval_range,
              sweep_width=cfg.sweep_width)
    n = packed.n_shards
    mesh = run_mesh(device.type, n) if n > 1 else None
    if isinstance(packed, PackedCandBatch):
        if n > 1:
            first = _get_sharded_consensus(device.type, n, b.num_windows,
                                           *kw.values())(
                b.locs, b.counts, b.imprecise_pos)
        else:
            first = audit_consensus_step(b.locs, b.counts, b.imprecise_pos,
                                         device=device, **kw)
        wide = launch_on_shards(
            mesh, _by_shard(packed.wide_win, b.num_windows, mesh),
            lambda s, sel: audit_consensus_wide(
                *packed.wide_batch(sel),
                device=device if mesh is None else mesh.devices[s],
                **_full_kw(cfg)))
        return first, wide
    K = _walk_k(cfg)
    if n > 1:
        walk = (b.pos, b.n_ops, b.window_id, b.kind, b.inter_start,
                b.inter_end, b.imprecise_pos)
        if isinstance(b, AuditBatchCSR):
            first = _get_sharded_csr(device.type, n, b.num_windows, K,
                                     *kw.values())(
                b.ops_flat, b.lens_flat, *walk)
        else:
            first = _get_sharded_step(device.type, n, b.num_windows, K,
                                      *kw.values())(b.ops, b.lens, *walk)
        return first, first.kept
    common = [to_device(a, device) for a in (
        b.pos, b.n_ops, b.window_id, b.kind, b.inter_start, b.inter_end,
        b.imprecise_pos)]
    kept: list = []
    if isinstance(b, AuditBatchCSR):
        first = audit_refine_step_csr(
            to_device(b.ops_flat, device, np.uint8),
            to_device(b.lens_flat, device), *common,
            num_windows=b.num_windows, K=K, keep=kept, **kw)
    else:
        first = audit_refine_step(
            to_device(b.ops, device, np.int8), to_device(b.lens, device),
            *common, num_windows=b.num_windows, K=K, keep=kept, **kw)
    return first, kept


def _refine_on_host(w, reads, cfg: AudtConfig) -> int:
    return refine_task(w.kind, reads, w.inter_start, w.inter_end,
                       w.imprecise_pos, cfg.consensus_min_count,
                       cfg.consensus_interval, cfg.consensus_interval_range)


def _to_host(dev) -> tuple[np.ndarray, ...]:
    """A dispatched batch's results on the host (a sharded one gathered
    shard by shard)."""
    if isinstance(dev, ShardedOutput):
        return dev.gather()
    return tuple(x.cpu().numpy() for x in dev)


def _mesh_of(first):
    return first.mesh if isinstance(first, ShardedOutput) else None


def collect_refinement(packed: PackedCandBatch | PackedBatch, dev,
                       cfg: AudtConfig,
                       stats: AuditStats | None = None) -> list:
    """Copy one batch's results to the host, run the second pass of the
    rows whose sweep overflowed (on the batch's device) and read the
    windows past K, and take the C extractor's values past WIDE_MAX_K.
    Returns (window, refined) pairs."""
    if isinstance(packed, PackedBatch):
        return _collect_walk(packed, dev, cfg, stats)
    if dev is None:
        return []
    first, wide = dev
    mesh = _mesh_of(first)
    refined, sweep_ovf = _to_host(first)
    n_win = len(packed.windows)
    value = np.asarray(refined, np.int64)[:n_win].copy()
    is_wide = np.zeros(n_win, bool)
    is_wide[packed.wide_win] = True
    value[packed.wide_win] = read_on_shards(
        mesh, wide, np.empty(len(packed.wide_win), np.int64))
    on_host = packed.refined_c[:n_win] != INT64_MIN
    sweep = sweep_ovf[:n_win] & ~is_wide & ~on_host
    full = np.flatnonzero(sweep)
    if len(full):
        b = packed.batch
        value[full] = read_on_shards(mesh, launch_on_shards(
            mesh, _by_shard(full, b.num_windows, mesh),
            lambda s, sel: audit_consensus_wide(
                b.locs, b.counts, b.imprecise_pos, full[sel],
                device=(first[0].device if mesh is None
                        else mesh.devices[s]), **_full_kw(cfg))),
            np.empty(len(full), np.int64))
    out = []
    for i, w in enumerate(packed.windows):
        if on_host[i]:
            # Past WIDE_MAX_K candidates: the C extractor already ran the
            # exact scalar consensus over the full candidate set.
            if stats:
                stats.oracle_windows += 1
                stats.fallback_kovf += 1
            out.append((w, int(packed.refined_c[i])))
            continue
        if stats:
            stats.wide_k += int(is_wide[i])
            stats.sweep_full += int(sweep[i])
        out.append((w, int(value[i])))
    return out


def _collect_walk(packed: PackedBatch, dev, cfg: AudtConfig,
                  stats: AuditStats | None) -> list:
    """collect_refinement of a device-walk batch: the windows that
    overflowed on the device (K or the sweep) take the second pass on
    the batch's device, regrouped from the walk its step kept; past
    WIDE_MAX_K candidates, the scalar oracle over their reads."""
    if dev is None:
        return []
    first, kept = dev
    mesh = _mesh_of(first)
    refined, counts, overflow = _to_host(first)
    slots = np.asarray(packed.window_slots if packed.window_slots is not None
                       else range(len(packed.windows)), np.int64)
    value = np.asarray(refined, np.int64)[slots]
    second = np.flatnonzero(overflow[slots] &
                            (counts[slots] <= pack.WIDE_MAX_K))
    if len(second):
        B = len(overflow)
        b_loc = B if mesh is None else B // mesh.size
        rows = slots[second]
        value[second] = read_on_shards(mesh, launch_on_shards(
            mesh, _by_shard(rows, B, mesh),
            lambda s, sel: audit_refine_wide(
                kept[s or 0], rows[sel] % b_loc,
                pack.pow2(int(counts[rows[sel]].max()), 16),
                **_full_kw(cfg))),
            np.empty(len(second), np.int64))
    K = _walk_k(cfg)
    out = []
    for i, (w, slot) in enumerate(zip(packed.windows, slots)):
        if overflow[slot] and counts[slot] > pack.WIDE_MAX_K:
            if stats:
                stats.oracle_windows += 1
                stats.fallback_device += 1
            value[i] = _refine_on_host(
                w, as_read_list(packed.reads_per_window[i]), cfg)
        elif overflow[slot] and stats:
            if counts[slot] > K:
                stats.wide_k += 1
            else:
                stats.sweep_full += 1
        out.append((w, int(value[i])))
    return out


def _ins_seqs_py(reader: BamReader, tid: int, beg: int, end: int,
                 min_len: int, lo: int, hi: int) -> list[str]:
    """The Python reader's analog of the native svbam_ins_seqs: decoded SEQ
    substrings of I ops >= min_len whose refine_ins-convention reference
    position (it advances on every op but I and S, the
    refinement.c:137-139 quirk) lies in [lo, hi]."""
    out: list[str] = []
    for rec in reader.fetch(tid, beg, end):
        if rec.seq == "*":
            continue
        rp = rec.pos
        qpos = 0
        for op, ln in rec.cigar:
            if op == 1 and ln >= min_len and lo <= rp <= hi:
                out.append(rec.seq[qpos:qpos + ln])
            if op not in (1, 4):
                rp += ln
            if op in (0, 1, 4, 7, 8):
                qpos += ln
    return out


def _resolve_ins_consensus(records: list[AuditResult], reader,
                           cfg: AudtConfig, device: torch.device,
                           stats: AuditStats) -> None:
    """Attach a POA consensus of the inserted sequence to each refined INS
    record (svtrek_tpu/pipeline/audit.py:406-448).  Per record: reads
    overlapping the refined position whose >= 50 bp I op lands within
    consensus_interval of it contribute their inserted bases (the native
    reader's SEQ decode, or the Python reader's); one batched consensus
    call on ``device`` covers all records, of the star engine or, with
    ``cfg.poa_engine == "graph"``, the graph engine.  res.seq = "" when
    there is no consensus (printed NA)."""
    consensus_batch = consensus_sequence_poa_batch \
        if cfg.poa_engine == "graph" else consensus_sequence_batch
    t0 = time.perf_counter()
    interval = cfg.consensus_interval
    ins_seqs = reader.ins_seqs if hasattr(reader, "ins_seqs") else \
        functools.partial(_ins_seqs_py, reader)
    seq_lists: list[list[str]] = []
    for res in records:
        r = int(C.u32(res.rstart))
        lo, hi = r - interval, r + interval
        if res.cons_tid < 0:
            seq_lists.append([])
            continue
        seq_lists.append(ins_seqs(res.cons_tid, max(lo, 0), hi + 1,
                                  C.SV_MIN_LENGTH, lo, hi))
    counts = {"dp_calls": 0, "graph_scalar": 0, "band_wide": 0,
              "band_scalar": 0, "band_wide_k2": 0}
    for res, s in zip(records, consensus_batch(
            seq_lists, device=device, counts=counts)):
        res.seq = s or ""
        if s:
            stats.cons_sites += 1
    stats.cons_flushes += 1
    stats.cons_dp_calls += counts["dp_calls"]
    stats.cons_graph_scalar += counts["graph_scalar"]
    stats.cons_band_wide += counts["band_wide"]
    stats.cons_band_scalar += counts["band_scalar"]
    stats.cons_band_wide_k2 += counts["band_wide_k2"]
    stats.cons_s += time.perf_counter() - t0


def _resume_state(cfg, err):
    """One streaming scan of the existing output file (--resume): returns
    (n_done, first_line, last_line) or None, in O(1) memory."""
    if not (cfg.resume and cfg.output_file
            and os.path.exists(cfg.output_file)):
        return None
    n_done, first, last = 0, None, None
    with open(cfg.output_file) as fh:
        for line in fh:
            if line.strip():
                if first is None:
                    first = line.rstrip("\n")
                last = line.rstrip("\n")
                n_done += 1
    return (n_done, first, last) if n_done else None


def _task_prefix(task: VcfTask) -> tuple[str, str]:
    """The record-derived (deterministic) prefix of a result line, in both
    numeric-chrom and --chrom-by-name flavors."""
    num = format_result(task.sv_type, task.chrom_index, task.pos,
                        task.end, NA32, NA32).split(" ref pos:")[0]
    by_name = format_result(task.sv_type, task.chrom_name, task.pos,
                            task.end, NA32, NA32).split(" ref pos:")[0]
    return num, by_name


def _check_resume_identity(task: VcfTask, got_line: str, which: str,
                           cfg, err) -> None:
    """A resumed output line must belong to the record the count says it
    does; a different shard split or an edited VCF aborts instead of
    silently misaligning lines to records."""
    got = got_line.split(" ref pos:")[0]
    expect = _task_prefix(task)
    if got not in expect:
        print(
            f"[ERROR] Resume mismatch: {which} line of "
            f"{cfg.output_file} is {got!r} but record "
            f"{task.line_index} of this input/shard would emit "
            f"{expect[0]!r}. The output file belongs to a different "
            f"input or shard split; refusing to resume.",
            file=err,
        )
        raise SystemExit(1)


def run_audit(cfg: AudtConfig, out=None, err=None,
              collect_lines: bool = True) -> list[str]:
    """Full audt pipeline on `cfg.device`.  Returns the result lines (also
    written to ``out`` and cfg.output_file); ``collect_lines=False`` keeps
    memory flat on whole-genome runs.

    Raises Unsupported for options the port does not run,
    device.DeviceUnavailable when the card is asked for and absent, and
    NativeReaderUnavailable when the native reader is asked for (the
    default) and does not build or load."""
    out = out or sys.stdout
    err = err or sys.stderr
    raise_refused(cfg)
    device = resolve_device(cfg.device)
    n_shards = resolve_data_shards(cfg, device, err)
    stats = AuditStats(device=str(device), data_shards=n_shards)
    t_start = time.perf_counter()

    # Fail fast (bad BAM path, no native library) before the pool starts.
    # With --chrom-by-name this reader also resolves CHROM names against
    # the BAM header (the extension over the reference's tid = chrom-1).
    probe = open_reader(cfg)
    tid_cache: dict[str, int] = {}

    def tid_by_name(name: str) -> int:
        if name not in tid_cache:
            tid_cache[name] = reader_tid(probe, name)
        return tid_cache[name]

    print("[INFO] Started processing variation file.", file=out)

    # --ins-consensus: a dedicated main-thread reader for SEQ extraction
    # (the probe reader serves the producer's tid lookups, and BGZF cursor
    # state is not thread-safe).
    cons_reader = open_reader(cfg) if cfg.ins_consensus else None

    num_shards = cfg.num_shards or 1
    shard_index = cfg.shard_index
    resume_state = _resume_state(cfg, err)

    # Streaming record state (bounded by batches in flight): `pending`
    # holds kept records in input order with their unapplied window count.
    # Registration happens in the producer thread strictly before the
    # record's windows are packed (the queue put/get pair orders it before
    # any main-thread access).
    pending_records: deque[AuditResult] = deque()
    results: dict[int, AuditResult] = {}
    vcf_rows: dict | None = {} if cfg.refined_vcf else None
    by_name = cfg.chrom_by_name

    def gen_windows():
        """Producer-thread stream: VCF → shard filter → resume skip →
        window expansion, registering one AuditResult per kept record."""
        skipped = 0
        first_skipped = last_skipped = None
        n_done = resume_state[0] if resume_state else 0
        shard_i = 0
        with open(cfg.vcf_file, "r") as fh:
            it = iter_vcf_tasks(fh)
            while True:
                t_in = time.perf_counter()
                item = next(it, None)
                if item is None:
                    stats.parse_s += time.perf_counter() - t_in
                    break
                if isinstance(item, VcfSkip):
                    if item.message:
                        print(item.message, file=err)
                    stats.parse_s += time.perf_counter() - t_in
                    continue
                # --num-shards/--shard-index: record-level scale-out.
                keep = (shard_i % num_shards) == shard_index
                shard_i += 1
                if not keep:
                    stats.parse_s += time.perf_counter() - t_in
                    continue
                t = item
                wins, emit = windows_for_task(t, cfg)
                if skipped < n_done:
                    # --resume: skip records whose lines already exist.
                    if emit:
                        skipped += 1
                        if first_skipped is None:
                            first_skipped = t
                        last_skipped = t
                        if skipped == n_done:
                            _check_resume_identity(
                                first_skipped, resume_state[1], "first",
                                cfg, err)
                            _check_resume_identity(
                                last_skipped, resume_state[2], "last",
                                cfg, err)
                            print(
                                f"[INFO] Resume: {n_done} result line(s) "
                                f"already in {cfg.output_file}; skipping "
                                f"them.", file=err)
                    stats.parse_s += time.perf_counter() - t_in
                    continue
                stats.records += 1
                stats.windows += len(wins)
                res = AuditResult(t, emit=emit, remaining=len(wins))
                if by_name:
                    tid = tid_by_name(t.chrom_name)
                    res.chrom_label = t.chrom_name
                    if tid < 0:
                        print(f"[ERROR] CHROM {t.chrom_name!r} not in the "
                              f"BAM header; record {t.line_index} refines "
                              f"to NA.", file=err)
                    for w in wins:
                        w.tid = tid
                if cfg.ins_consensus and t.sv_type == SVType.INS and emit:
                    res.needs_seq = True
                    res.cons_tid = window_tid(wins[0]) if wins else -1
                results[t.line_index] = res
                pending_records.append(res)
                stats.parse_s += time.perf_counter() - t_in
                yield from wins
        if resume_state and skipped < n_done:
            print(
                f"[ERROR] Resume mismatch: {cfg.output_file} has "
                f"{n_done} result line(s) but this input/shard only "
                f"produces {skipped}. Refusing to resume.",
                file=err,
            )
            raise SystemExit(1)

    # Bounded batch queue: cfg.thread_number fetch+pack workers, each with
    # a private BAM handle (BGZF seek state and the native fetch buffers
    # are not shareable), feed packed batches in order to this thread.
    # The C fetch and extract release the GIL, so the workers overlap each
    # other and the device.  The branch is the JAX pipeline's
    # (svtrek_tpu/pipeline/audit.py:642-662).
    q: queue.Queue = queue.Queue(maxsize=max(2, cfg.tload_factor))
    stats_lock = threading.Lock()

    def producer():
        tls = threading.local()

        def work(chunk):
            if not hasattr(tls, "reader"):
                tls.reader = open_reader(cfg)
            t0 = time.perf_counter()
            if not cfg.use_native_io:
                pb = pack_chunk(chunk, python_fetch(tls.reader), cfg,
                                n_shards)
            elif cfg.extract == "device":
                pb = pack_chunk_native(chunk, tls.reader, cfg, n_shards)
            else:
                pb = pack_chunk_cand(chunk, tls.reader, cfg, n_shards)
            dt = time.perf_counter() - t0
            with stats_lock:
                stats.pack_s += dt  # aggregate worker-seconds
            return pb

        bw = cfg.batch_windows

        def chunk_stream():
            chunk = []
            for w in gen_windows():
                chunk.append(w)
                if len(chunk) >= bw:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk

        chunks = chunk_stream()
        n_workers = max(1, cfg.thread_number)
        try:
            with ThreadPoolExecutor(
                n_workers, thread_name_prefix="svtrek-pack"
            ) as ex:
                pending = deque(
                    ex.submit(work, c)
                    for c in itertools.islice(chunks, n_workers + 2)
                )
                while pending:
                    pb = pending.popleft().result()
                    nxt = next(chunks, None)
                    if nxt is not None:
                        pending.append(ex.submit(work, nxt))
                    q.put(pb)  # blocks when full → bounds work in flight
        except BaseException as e:  # surfaced in the consumer loop
            q.put(e)
            return
        q.put(None)

    prod = threading.Thread(target=producer, daemon=True,
                            name="svtrek-pack-producer")
    prod.start()

    # --trace-dir: a torch.profiler trace of the batch loop, host and card.
    trace_dir = cfg.trace_dir
    prof = None
    if trace_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()

    # Streamed, input-ordered emit: lines go to `out` (and the output file)
    # as soon as every earlier record has completed.
    lines: list[str] = []
    file_out = None
    if cfg.output_file:
        file_out = open(cfg.output_file,
                        "a" if cfg.resume else "w")

    def flush_frontier():
        t0 = time.perf_counter()
        while pending_records and pending_records[0].remaining == 0:
            head = pending_records[0]
            if (head.needs_seq and head.seq is None
                    and C.u32(head.rstart) != NA32):
                # Resolve every completed-but-unemitted INS site in one
                # batched POA call: one per collected device batch.
                batch = [r for r in pending_records
                         if r.remaining == 0 and r.needs_seq
                         and r.seq is None and C.u32(r.rstart) != NA32]
                _resolve_ins_consensus(batch, cons_reader, cfg, device,
                                       stats)
            res = pending_records.popleft()
            del results[res.task.line_index]
            if not res.emit:
                continue
            if vcf_rows is not None:
                vcf_rows[res.task.line_index] = (res.task, res.rstart,
                                                 res.rend)
            line = res.line()
            if collect_lines:
                lines.append(line)
            print(line, file=out)
            if file_out is not None:
                file_out.write(line + "\n")
        stats.emit_s += time.perf_counter() - t0

    def apply(pairs):
        for w, refined in pairs:
            res = results[w.record_index]
            if w.slot == 0:
                res.rstart = C.u32(refined)
            else:
                res.rend = C.u32(refined)
            res.remaining -= 1
        flush_frontier()

    # Keep several batches in flight: launches are asynchronous, and each
    # collect pays one device→host sync.
    in_flight: deque = deque()
    depth = max(2, cfg.tload_factor)
    try:
        while True:
            packed = q.get()
            if isinstance(packed, BaseException):
                raise packed
            if packed is None:
                break
            in_flight.append((packed, dispatch_refinement(packed, cfg,
                                                          device)))
            stats.batches += 1
            stats.reads += (packed.num_reads
                            if isinstance(packed, PackedCandBatch)
                            else packed.batch.num_reads)
            if len(in_flight) > depth:
                t0 = time.perf_counter()
                apply(collect_refinement(*in_flight.popleft(), cfg, stats))
                stats.device_s += time.perf_counter() - t0
        # Drain: each outstanding batch's results, in order.
        t0 = time.perf_counter()
        while in_flight:
            apply(collect_refinement(*in_flight.popleft(), cfg, stats))
        stats.device_s += time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if prof is not None:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "audt_trace.json")
        prof.export_chrome_trace(path)
        print(f"[INFO] Wrote torch.profiler trace to {path}", file=err)
    prod.join()

    # Final frontier flush: everything is applied, so all zero-window
    # records (and any tail) drain here.
    flush_frontier()
    if file_out is not None:
        file_out.close()
    if pending_records:
        raise RuntimeError(
            f"{len(pending_records)} record(s) never completed "
            f"(first remaining={pending_records[0].remaining}) — "
            f"window/batch accounting bug")

    print("[INFO] Ended processing variation file", file=out)

    if cfg.refined_vcf:
        from ..io.vcf_writer import write_refined_vcf

        write_refined_vcf(cfg.refined_vcf, cfg.vcf_file, vcf_rows)

    stats.total_s = time.perf_counter() - t_start
    if cfg.verbose:
        stats.report(err)
    return lines
