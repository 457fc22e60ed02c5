"""`disc` mode pipeline: GFA + GAF + FASTQ -> discovered SVs, with the device
steps in PyTorch.

A JAX-free copy of svtrek_tpu/pipeline/discover.py, line for line where
the output depends on it (that module imports the JAX scan at its top and
the JAX audit pipeline in run_discover, so it cannot be shared): project
every read's graph alignment onto the rank-0 backbone (the native C GAF
projector, or the Python parse with ``use_native_parse=False``), scan the
runs for >= 50 bp INS/DEL/clip signals in batches on the device
(`ops.discover`), cluster the signals across reads, and give each
insertion cluster the consensus of its reads' inserted bases: the star
POA (`ops.poa_batch`, kernels K2 and K3 on the card) or, with
`--poa-engine graph`, the graph POA (`ops.poa_graph_batch`, kernel G1).

Output lines, their order, and the `.ckpt.npz` detection checkpoint are
the JAX package's: a checkpoint written by either package restores in the
other.  With ``data_shards`` > 1 the scan of each batch is split over the
shards of `parallel.mesh` (`sharded_disc_step`), in the JAX package's
padded per-shard layout, and SVTREK_COORDINATOR bootstraps
`torch.distributed` first, as in audt.  Where the native GAF library does
not load, the JAX pipeline quietly takes the Python parse while this one
raises (`Unsupported`).
"""
from __future__ import annotations

import functools
import hashlib
import os
import sys
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import DiscConfig
from ..io.fastq import iter_fastq, reverse_complement
from ..io.gaf import Breakpoint, iter_gaf
from ..io.gfa import parse_gfa

from ..device import resolve_device
from ..ops.discover import (
    BP_CLIP, BP_DEL, BP_INS, scan_projected_runs_compact,
    scan_projected_runs_compact_csr,
)
from ..ops.poa_batch import consensus_sequence_batch
from ..ops.poa_graph_batch import consensus_sequence_poa_batch
from ..parallel.mesh import (
    ShardedOutput, make_global_array, run_mesh, sharded_disc_step,
)
from ..refusals import Unsupported
from .audit import resolve_data_shards

_TYPE_NAME = {BP_INS: "INS", BP_DEL: "DEL", BP_CLIP: "CLIP"}
# Reads with more runs go through the host scalar scan when they are read
# (the JAX package's largest run bucket); the order of the breakpoints
# depends on it.
_MAX_DEVICE_RUNS = 8192
_BP_CAP = 2048  # hits in a batch's first page (more take a second page)


@functools.lru_cache(maxsize=None)
def _get_sharded_disc(device_type: str, n: int, min_len: int):
    return sharded_disc_step(run_mesh(device_type, n), min_len=min_len,
                             cap=max(256, _BP_CAP // n))


def _padded_runs(N: int, O: int, counts, ref_start, flat_ops, flat_lens):
    """The padded [N, O] layout of a batch's flat runs: op 9 / len 0 past
    each read's runs; padding rows (past len(counts)) have n_runs 0."""
    n = len(counts)
    ops = np.full((N, O), 9, np.int8)
    lens = np.zeros((N, O), np.int32)
    n_runs = np.zeros(N, np.int32)
    rs = np.zeros(N, np.int32)
    n_runs[:n] = counts
    rs[:n] = ref_start
    total = len(flat_ops)
    if total:
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        starts = np.cumsum(counts, dtype=np.int64) - counts
        cols = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
        ops[rows, cols] = flat_ops
        lens[rows, cols] = flat_lens
    return ops, lens, n_runs, rs


@dataclass
class SvCluster:
    type: str
    ref_pos: int
    length: int
    support: int
    members: list[Breakpoint] = field(default_factory=list)
    seq: str | None = None

    def line(self) -> str:
        base = (
            f"(DISC {self.type}) ref pos: {self.ref_pos}, "
            f"len: {self.length}, support: {self.support}"
        )
        if self.type == "INS":
            base += f", seq: {self.seq if self.seq else 'NA'}"
        return base


def _count(stats: dict | None, key: str, n: float = 1) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


class _DeviceScanner:
    """Dispatch/collect window for the batched device scan.

    Batch k is scanned on the device while the host parses batches k+1 ..
    k+DEPTH; dispatch reads nothing back, and each collect makes one
    device-to-host copy of a batch's first page of hits (one a shard when
    sharded).  The batch's device inputs stay in `in_flight` until its
    collect: a batch (or shard) with more hits than the page's capacity
    gets a second page of the hits that follow in the same row-major
    ranking, compacted on the same device in one more launch sized from
    the first page's total, and read back after it (`scan_pages2` counts
    them; the JAX package rescans such a batch on the host, and `rescans`
    stays 0 here).  `meta` per dispatch maps row indices back to read
    identity."""

    DEPTH = 3

    def __init__(self, min_len: int, out: list, device: torch.device,
                 stats: dict | None = None, n_shards: int = 1):
        self.min_len = min_len
        self.out = out
        self.device = device
        self.stats = stats
        self.n_shards = n_shards
        self.mesh = run_mesh(device.type, n_shards) if n_shards > 1 else None
        self.step = (_get_sharded_disc(device.type, n_shards, min_len)
                     if n_shards > 1 else None)
        self.in_flight = deque()
        for key in ("reads", "scan_batches", "rescans", "scan_pages2",
                    "host_reads"):
            _count(stats, key, 0)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def dispatch(self, ops_flat, lens_flat, n_runs, ref_start, batch_reads,
                 meta):
        """Dispatch one batch's flat runs (both feeds), padded to O, the
        batch's longest read.  On one shard the device scatters them into
        the padded [N, O] layout and scans them.  Sharded, the host builds
        the JAX package's padded per-shard layout (N the batch size rounded
        up to the shard count: it decides which reads share a shard's cap)
        and each shard scans its block of rows.  JAX's pow2 run buckets
        for O limit its recompiles; no result depends on them."""
        O = max(int(n_runs.max()), 1)
        if self.step is not None:
            n = self.n_shards
            N = -(-max(len(n_runs), batch_reads) // n) * n
            inputs = [make_global_array(a, self.mesh) for a in _padded_runs(
                N, O, n_runs, ref_start, ops_flat, lens_flat)]
            self.in_flight.append((meta, N // n, self.step(*inputs),
                                   inputs))
        else:
            inputs = [self._to_dev(a) for a in (ops_flat, lens_flat, n_runs,
                                                ref_start)]
            dev = scan_projected_runs_compact_csr(
                *inputs, O=O, min_len=self.min_len, cap=_BP_CAP)
            # One buffer per batch: [total, rows, types, refs, read_pos,
            # lens].
            self.in_flight.append(
                (meta, 0, torch.cat([dev[0].view(1), *dev[1:]]),
                 (inputs, O)))
        _count(self.stats, "scan_batches")
        if len(self.in_flight) > self.DEPTH:
            self._collect(self.in_flight.popleft())

    def drain(self):
        while self.in_flight:
            self._collect(self.in_flight.popleft())

    def _emit(self, meta, row_off, rows, types, refs, reads_pos, lns):
        name_of, rc_of = meta
        for i in range(len(rows)):
            r = row_off + int(rows[i])
            self.out.append(Breakpoint(
                name_of(r), _TYPE_NAME[int(types[i])],
                int(refs[i]), int(reads_pos[i]), int(lns[i]), rc_of(r),
            ))

    def _page2(self, s: int, inputs, total: int, cap: int) -> np.ndarray:
        """Shard s's (or the batch's) hits of rank cap .. total - 1: [5,
        total - cap] rows, types, refs, read_pos, lens."""
        _count(self.stats, "scan_pages2")
        if self.mesh is None:
            flat, O = inputs
            page = scan_projected_runs_compact_csr(
                *flat, O=O, min_len=self.min_len, cap=total - cap, first=cap)
            return torch.stack(page[1:]).cpu().numpy()
        with self.mesh.on(s):
            page = scan_projected_runs_compact(
                *(a.shards[s] for a in inputs), min_len=self.min_len,
                cap=total - cap, first=cap)
            return torch.stack(page[1:]).cpu().numpy()

    def _collect(self, item):
        meta, n_loc, dev, inputs = item
        t0 = time.perf_counter()
        if isinstance(dev, ShardedOutput):
            totals, *res = dev.gather()
        else:
            flat = dev.cpu().numpy()
            totals, res = flat[:1], flat[1:].reshape(5, _BP_CAP)
        cap = len(res[0]) // len(totals)
        # Shard by shard, rows shifted by the shard's first row.
        pages = []
        for s, total in enumerate(totals.tolist()):
            page = np.stack([a[s * cap:s * cap + min(total, cap)]
                             for a in res])
            if total > cap:
                page = np.concatenate(
                    [page, self._page2(s, inputs, total, cap)], 1)
            pages.append(page)
        _count(self.stats, "scan_wait_s", time.perf_counter() - t0)
        for s, page in enumerate(pages):
            self._emit(meta, s * n_loc, *page)


def detect_breakpoints(projected, min_len: int, batch_reads: int = 512, *,
                       device: torch.device | str = "cpu",
                       use_device_scan: bool = True,
                       stats: dict | None = None,
                       n_shards: int = 1) -> list[Breakpoint]:
    """Batched device scan over projected reads (io.gaf.ProjectedRead) ->
    Breakpoint list, in the JAX package's order.

    Reads of more than _MAX_DEVICE_RUNS runs go through the host scalar
    scan (identical semantics) when they are read.  Each batch ships its
    runs back to back (the native feed's flat CSR layout), and the device
    pads them to the batch's own longest read; the JAX package's pow2 run
    buckets and batch-size padding exist to limit recompiles, and no
    result depends on them.  ``use_device_scan=False`` runs everything
    through the host scalar scan (`io.gaf.scan_breakpoints`), as the JAX
    package's ``device=False``.  ``n_shards > 1`` splits each batch's
    scan over the shards of a mesh (`_DeviceScanner`)."""
    from ..io.gaf import scan_breakpoints

    if not use_device_scan:
        out: list[Breakpoint] = []
        for p in projected:
            out.extend(scan_breakpoints(p, min_len))
        return out

    out: list[Breakpoint] = []
    batch: list = []
    scanner = _DeviceScanner(min_len, out, torch.device(device), stats,
                             n_shards)

    def flush():
        nonlocal batch
        if not batch:
            return
        reads = batch
        N = len(reads)
        cnt = np.fromiter((len(p.runs) for p in reads), np.int32, N)
        ref_start = np.fromiter(
            (p.reference_start for p in reads), np.int64, N
        ).astype(np.int32)
        total = int(cnt.sum(dtype=np.int64))
        flat_ops = np.fromiter(
            (o for p in reads for o, _ in p.runs), np.int8, total)
        flat_lens = np.fromiter(
            (l for p in reads for _, l in p.runs), np.int32, total)
        meta = (lambda r, reads=reads: reads[r].read_name,
                lambda r, reads=reads: reads[r].rc)
        scanner.dispatch(flat_ops, flat_lens, cnt, ref_start, batch_reads,
                         meta)
        batch = []

    for p in projected:
        _count(stats, "reads")
        if len(p.runs) > _MAX_DEVICE_RUNS:
            _count(stats, "host_reads")
            out.extend(scan_breakpoints(p, min_len))
            continue
        batch.append(p)
        if len(batch) >= batch_reads:
            flush()
    flush()
    scanner.drain()
    return out


def _scan_csr_rows(b, rows, min_len: int) -> list[Breakpoint]:
    """Exact host scalar scan of native-batch rows (reads past
    _MAX_DEVICE_RUNS runs)."""
    from ..io.gaf import ProjectedRead, scan_breakpoints

    out: list[Breakpoint] = []
    for i in rows:
        i = int(i)
        pr = ProjectedRead(
            read_name=b.name(i), read_len=int(b.read_len[i]),
            read_start=int(b.read_start[i]), read_end=int(b.read_end[i]),
            rc=bool(b.rc[i]), reference_start=int(b.ref_start[i]),
            runs=b.runs(i),
        )
        out.extend(scan_breakpoints(pr, min_len))
    return out


def detect_breakpoints_native(reader, min_len: int, batch_reads: int = 8192,
                              *, device: torch.device | str = "cpu",
                              stats: dict | None = None,
                              n_shards: int = 1) -> list[Breakpoint]:
    """Device scan fed by the C GAF projector (io/gaf_native.py).

    Each CSR batch ships its flat run arrays as they are, and the device
    scatters them into the padded layout; reads of more than
    _MAX_DEVICE_RUNS runs go through the host scalar scan when their batch
    is read, as in the JAX package.  The JAX package's pow2 stream length
    and batch-size padding exist to limit recompiles and are not carried
    over.  ``n_shards > 1`` splits each batch's scan over the shards of a
    mesh (`_DeviceScanner`)."""
    out: list[Breakpoint] = []
    scanner = _DeviceScanner(min_len, out, torch.device(device), stats,
                             n_shards)

    while (b := reader.next_batch(batch_reads)) is not None:
        _count(stats, "reads", b.n)
        big = b.n_runs > _MAX_DEVICE_RUNS
        if big.any():
            _count(stats, "host_reads", int(big.sum()))
            out.extend(_scan_csr_rows(b, np.nonzero(big)[0], min_len))
            keep = np.nonzero(~big)[0]
        else:
            keep = None
        n_keep = b.n if keep is None else len(keep)
        if n_keep == 0:
            continue
        counts = b.n_runs if keep is None else b.n_runs[keep]
        rs = b.ref_start if keep is None else b.ref_start[keep]
        if keep is None:
            # CSR is hole-free: the flat arrays are the concatenation.
            of, lf = b.flat_ops, b.flat_lens
        else:
            total = int(counts.sum(dtype=np.int64))
            starts_in = np.cumsum(counts, dtype=np.int64) - counts
            idx = (np.repeat(b.run_off[keep], counts)
                   + np.arange(total, dtype=np.int64)
                   - np.repeat(starts_in, counts))
            of, lf = b.flat_ops[idx], b.flat_lens[idx]

        def _map(r, keep=keep):
            return r if keep is None else int(keep[r])

        meta = (lambda r, b=b, m=_map: b.name(m(r)),
                lambda r, b=b, m=_map: bool(b.rc[m(r)]))
        scanner.dispatch(of, lf, np.ascontiguousarray(counts),
                         rs.astype(np.int32), batch_reads, meta)
    scanner.drain()
    return out


def cluster_breakpoints(bps: list[Breakpoint], min_count: int,
                        cluster_window: int = 100) -> list[SvCluster]:
    """Greedy single-linkage position clustering per type: sorted signals
    chain into one cluster while each consecutive gap is <=
    ``cluster_window``; clusters with support >= min_count survive, at the
    rounded means of position and length ((total + n/2)/n,
    refinement.c:65)."""
    clusters: list[SvCluster] = []
    for t in ("INS", "DEL", "CLIP"):
        sel = sorted(
            (b for b in bps if b.type == t), key=lambda b: (b.ref_pos, b.length)
        )
        cur: list[Breakpoint] = []

        def close():
            if len(cur) >= min_count:
                n = len(cur)
                pos = (sum(b.ref_pos for b in cur) + n // 2) // n
                ln = (sum(b.length for b in cur) + n // 2) // n
                clusters.append(SvCluster(t, pos, ln, n, list(cur)))

        for b in sel:
            if cur and b.ref_pos - cur[-1].ref_pos > cluster_window:
                close()
                cur = []
            cur.append(b)
        if cur:
            close()
    clusters.sort(key=lambda c: (c.type, c.ref_pos))
    return clusters


def consensus_insert_sequences(clusters: list[SvCluster], fq_path: str,
                               engine: str = "star", *,
                               device: torch.device | str = "cpu",
                               counts: dict | None = None) -> None:
    """Attach to each INS cluster the consensus of its supporting reads'
    inserted substrings (reverse-complement-normalized), all clusters in
    one call on ``device``: `consensus_sequence_batch` (star) or, with
    ``engine == "graph"``, `consensus_sequence_poa_batch` (``counts`` as
    theirs: "dp_calls" counts the DP batches, "graph_scalar" the graph
    engine's clusters on the scalar route, "band_wide" and "band_scalar"
    the star engine's pairs with a band above the JAX package's 512 on
    the DP and its pairs on the host DP, "band_wide_k2" its pairs with a
    band above kernels.POA_STRIP_MAX_BAND, K2's wide kernel's on cuda,
    "vote_rounds" the star engine's cluster-rounds voted and "vote_card"
    those voted by kernel K5)."""
    wanted: dict[str, list[tuple[SvCluster, Breakpoint]]] = {}
    for c in clusters:
        if c.type != "INS":
            continue
        for b in c.members:
            wanted.setdefault(b.read_name, []).append((c, b))
    if not wanted:
        return

    per_cluster: dict[int, list[str]] = {}
    for name, seq in iter_fastq(fq_path, names=wanted):
        hits = wanted.get(name)
        if not hits:
            continue
        for c, b in hits:
            s = reverse_complement(seq) if b.rc else seq
            sub = s[b.read_pos : b.read_pos + b.length]
            if sub:
                per_cluster.setdefault(id(c), []).append(sub)

    consensus_batch = consensus_sequence_poa_batch if engine == "graph" \
        else consensus_sequence_batch
    ins = [c for c in clusters if c.type == "INS"]
    seq_lists = [per_cluster.get(id(c), []) for c in ins]
    for c, s in zip(ins, consensus_batch(
            seq_lists, device=device, counts=counts)):
        if s:
            c.seq = s


def _ckpt_key(cfg: DiscConfig) -> str:
    """Input identity of the detection checkpoint: GFA/GAF path + size +
    mtime + the minimum SV length (svtrek_tpu's key, so that either
    package's checkpoint restores in the other)."""
    h = hashlib.sha256()
    for p in (cfg.gfa_file, cfg.gaf_file):
        st = os.stat(p)
        h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}".encode())
    h.update(f"minlen={cfg.sv_min_length}".encode())
    return h.hexdigest()[:16]


def _ckpt_path(cfg: DiscConfig) -> str:
    return (cfg.output_file or "svtrek.disc") + ".ckpt.npz"


def _save_ckpt(cfg: DiscConfig, bps: list[Breakpoint]) -> None:
    np.savez_compressed(
        _ckpt_path(cfg),
        key=np.array(_ckpt_key(cfg)),
        read_name=np.array([b.read_name for b in bps], dtype=object),
        type=np.array([b.type for b in bps], dtype=object),
        ref_pos=np.array([b.ref_pos for b in bps], np.int64),
        read_pos=np.array([b.read_pos for b in bps], np.int64),
        length=np.array([b.length for b in bps], np.int64),
        rc=np.array([b.rc for b in bps], bool),
    )


def _load_ckpt(cfg: DiscConfig) -> list[Breakpoint] | None:
    path = _ckpt_path(cfg)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=True) as z:
        if str(z["key"]) != _ckpt_key(cfg):
            return None
        return [
            Breakpoint(str(n), str(t), int(rp), int(qp), int(ln), bool(rc))
            for n, t, rp, qp, ln, rc in zip(
                z["read_name"], z["type"], z["ref_pos"],
                z["read_pos"], z["length"], z["rc"],
            )
        ]


def open_native_gaf(path: str, gfa):
    """The native C GAF projector, or Unsupported when it cannot load."""
    from ..io.gaf_native import NativeGafReader

    try:
        return NativeGafReader(path, gfa)
    except OSError as e:
        raise Unsupported(
            f"the native GAF reader is unavailable ({e}; "
            f"svtrek_tpu_torch/native did not build, or the GAF cannot be opened); the port takes "
            f"the Python parse only when asked (use_native_parse=False)"
        ) from e


def run_discover(cfg: DiscConfig, out=None, err=None, *,
                 device: torch.device | str = "cuda",
                 stats: dict | None = None) -> list[str]:
    """Full disc pipeline on ``device`` ("cuda", "cpu" or a torch.device).
    Returns the result lines (also written to ``out`` and
    cfg.output_file).  ``stats``, when given, receives phase seconds
    (detect_s, cluster_s, consensus_s, emit_s, total_s, scan_wait_s) and
    counts (reads, scan_batches, rescans (always 0: the JAX package's host
    rescans), scan_pages2, host_reads, breakpoints,
    clusters, ins_clusters, dp_calls, graph_scalar, band_wide,
    band_scalar, band_wide_k2, vote_rounds, vote_card) and, when the
    detection runs, its shard count (data_shards); nothing is printed for
    them.

    Raises Unsupported where the native GAF reader does not load, and
    device.DeviceUnavailable when the card is asked for and absent."""
    out = out or sys.stdout
    err = err or sys.stderr
    if not isinstance(device, torch.device):
        device = resolve_device(device)
    t_start = time.perf_counter()

    print("[INFO] Started graph discovery.", file=out)
    bps = _load_ckpt(cfg) if cfg.resume else None
    if bps is not None:
        print(f"[INFO] Resume: {len(bps)} breakpoint(s) restored from "
              f"{_ckpt_path(cfg)}; skipping GFA/GAF projection.", file=err)
    else:
        n_shards = resolve_data_shards(cfg, device, err)
        if stats is not None:
            stats["data_shards"] = n_shards
        gfa = parse_gfa(cfg.gfa_file)
        errors: list[str] = []
        if cfg.use_native_parse and cfg.use_device_scan:
            reader = open_native_gaf(cfg.gaf_file, gfa)
            try:
                bps = detect_breakpoints_native(
                    reader, cfg.sv_min_length, cfg.batch_reads,
                    device=device, stats=stats, n_shards=n_shards)
                errors = reader.errors
            finally:
                reader.close()
        else:
            projected = iter_gaf(cfg.gaf_file, gfa, errors)
            bps = detect_breakpoints(projected, cfg.sv_min_length,
                                     cfg.batch_reads, device=device,
                                     use_device_scan=cfg.use_device_scan,
                                     stats=stats, n_shards=n_shards)
        for name in errors:
            print(f"[ERROR] Read {name} has an invalid path.", file=err)
        # Checkpoint the projection + scan on every run with an output
        # file, so that a crash in the consensus leaves something to
        # resume.
        if cfg.output_file or cfg.resume:
            _save_ckpt(cfg, bps)
    t_detect = time.perf_counter()

    clusters = cluster_breakpoints(bps, cfg.consensus_min_count,
                                   cfg.cluster_window)
    t_cluster = time.perf_counter()
    counts = {"dp_calls": 0, "graph_scalar": 0, "band_wide": 0,
              "band_scalar": 0, "band_wide_k2": 0, "vote_rounds": 0,
              "vote_card": 0}
    consensus_insert_sequences(clusters, cfg.fq_file, cfg.poa_engine,
                               device=device, counts=counts)
    t_cons = time.perf_counter()

    file_out = None
    if cfg.output_file:
        file_out = open(cfg.output_file, "w")
    lines = []
    try:
        for c in clusters:
            line = c.line()
            lines.append(line)
            print(line, file=out)
            if file_out is not None:
                file_out.write(line + "\n")
                file_out.flush()
    finally:
        if file_out is not None:
            file_out.close()
    print("[INFO] Ended graph discovery.", file=out)
    t_end = time.perf_counter()
    if stats is not None:
        stats.update(
            detect_s=t_detect - t_start, cluster_s=t_cluster - t_detect,
            consensus_s=t_cons - t_cluster, emit_s=t_end - t_cons,
            total_s=t_end - t_start, breakpoints=len(bps),
            clusters=len(clusters),
            ins_clusters=sum(c.type == "INS" for c in clusters),
            **counts)
    return lines
