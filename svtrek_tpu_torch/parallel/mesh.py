"""Device-mesh sharding of the audit and disc steps.

Port of svtrek_tpu/parallel/mesh.py.  The JAX package shards each window
batch across a `jax.sharding` mesh with `shard_map`; here a `Mesh` holds
one `torch.device` and, on a card, one CUDA stream per shard.  Each
sharded step splits its shard-blockwise arrays into `mesh.size` equal
blocks along axis 0, sends each block to its shard's device and launches
the single-device op there under the shard's stream: `audit_refine_step`,
`audit_refine_step_csr`, `consensus_pos_batch` (kernel K1 on a card) or
`scan_projected_runs_compact`.  Windows and reads are independent, so no
step needs a collective: a call reads nothing back, and
`ShardedOutput.gather` copies each shard's results to the host on that
shard's own stream, so the copy is ordered after the shard's kernels.

A mesh may hold one card more than once (`make_mesh(n=4)` on one card
gives four shards on four streams), as the JAX package's tests run 8
shards on 8 virtual CPU devices; `make_mesh(["cpu"], n)` gives CPU shards,
the plain path.

Multi-process runs (`init_distributed`) bootstrap `torch.distributed`
from SVTREK_COORDINATOR / SVTREK_NUM_PROCS / SVTREK_PROC_ID.  Each process
builds its mesh from its own visible devices, never from a global device
list, and owns the rows it packed (`make_global_array`).
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from ..device import DeviceUnavailable
from ..ops.audit_step import (
    audit_refine_step, audit_refine_step_csr, to_device,
)
from ..ops.consensus import consensus_pos_batch
from ..ops.discover import scan_projected_runs_compact

# The process group's rendezvous and collectives give up after this long.
INIT_TIMEOUT_S = 60

_TORCH_DTYPE = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int32): torch.int32}


class Mesh:
    """The shards of a sharded step: shard i runs on ``devices[i]``, under
    ``streams[i]`` on a CUDA device (None on the CPU)."""

    def __init__(self, devices):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)
        self.streams = tuple(torch.cuda.Stream(device=d)
                             if d.type == "cuda" else None for d in devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def on(self, s: int):
        """Shard s's context: its device and its stream current."""
        stream = self.streams[s]
        if stream is None:
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(self.devices[s]))
        ctx.enter_context(torch.cuda.stream(stream))
        return ctx


def make_mesh(devices=None, n: int | None = None) -> Mesh:
    """A mesh of ``n`` shards (default: one per device) over ``devices``
    (default: every visible card); shard i takes ``devices[i % k]``."""
    if devices is None:
        k = torch.cuda.device_count()
        if k == 0:
            raise DeviceUnavailable(
                "make_mesh: no CUDA device is visible to PyTorch; pass "
                "devices=['cpu'] for a mesh of CPU shards")
        devices = [torch.device("cuda", i) for i in range(k)]
    devices = list(devices)
    n = n or len(devices)
    return Mesh([devices[i % len(devices)] for i in range(n)])


@functools.lru_cache(maxsize=None)
def run_mesh(device_type: str, n: int) -> Mesh:
    """The pipelines' mesh of n shards for a run on ``device_type``: over
    every visible card ("cuda"), or CPU shards ("cpu"); one per process
    and shape, so its streams are made once."""
    return make_mesh(None if device_type == "cuda" else [device_type], n)


_WORLD_SHARDS: int | None = None


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     local_shards: int | None = None) -> int:
    """`torch.distributed` bootstrap of a multi-process run: every process
    runs the same command with SVTREK_COORDINATOR=host:port,
    SVTREK_NUM_PROCS and SVTREK_PROC_ID exported (the arguments default
    from them).  The backend is NCCL where a card is visible and gloo on
    the CPU; ``backend="gloo"`` also serves processes that share one card,
    which NCCL refuses.

    Returns the global shard count: the sum over the process group of each
    process's ``local_shards`` (default: its visible cards, or 1), carried
    by an all_reduce.  Without a coordinator it returns ``local_shards``
    and starts nothing.  Idempotent: later calls return the first result.
    """
    global _WORLD_SHARDS
    if local_shards is None:
        local_shards = torch.cuda.device_count() or 1
    coordinator_address = coordinator_address or os.environ.get(
        "SVTREK_COORDINATOR", "")
    if not coordinator_address:
        return local_shards
    if _WORLD_SHARDS is None:
        num_processes = int(num_processes if num_processes is not None
                            else os.environ.get("SVTREK_NUM_PROCS", "1"))
        process_id = int(process_id if process_id is not None
                         else os.environ.get("SVTREK_PROC_ID", "0"))
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if not dist.is_initialized():
            dist.init_process_group(
                backend,
                init_method="tcp://" + coordinator_address.removeprefix(
                    "tcp://"),
                world_size=num_processes, rank=process_id,
                timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
            atexit.register(dist.destroy_process_group)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        count = torch.tensor([local_shards], dtype=torch.int64, device=dev)
        dist.all_reduce(count)
        _WORLD_SHARDS = int(count.item())
    return _WORLD_SHARDS


@dataclass
class ShardedArray:
    """A process's block of a global array, split along axis 0 over a
    mesh: ``shards[i]`` lies on ``mesh.devices[i]`` and holds the global
    rows from ``offsets[i]`` on (JAX's ``addressable_shards[i].index``)."""

    shards: list[torch.Tensor]
    offsets: list[int]


def _blocks(a: np.ndarray, n: int) -> list[np.ndarray]:
    if a.shape[0] % n:
        raise ValueError(f"axis 0 of length {a.shape[0]} not divisible by "
                         f"mesh size {n}")
    m = a.shape[0] // n
    return [a[s * m:(s + 1) * m] for s in range(n)]


def make_global_array(local: np.ndarray, mesh: Mesh) -> ShardedArray:
    """This process's rows of a global array, one block per shard on the
    shard's device.  Processes hold equal, consecutive blocks in rank
    order (as jax.make_array_from_process_local_data assumes), so a
    shard's global offset is rank * len(local) plus its place here."""
    local = np.asarray(local)
    rank = dist.get_rank() if dist.is_initialized() else 0
    shards = []
    for s, blk in enumerate(_blocks(local, mesh.size)):
        with mesh.on(s):
            shards.append(to_device(blk, mesh.devices[s], blk.dtype))
    m = local.shape[0] // mesh.size
    return ShardedArray(shards,
                        [rank * local.shape[0] + s * m
                         for s in range(mesh.size)])


class ShardedOutput:
    """One sharded-step call's per-shard results (``shards[i]``, a tuple of
    tensors on shard i's device), left where they were computed."""

    def __init__(self, mesh: Mesh, shards: list[tuple]):
        self.mesh = mesh
        self.shards = shards

    def gather(self) -> tuple[np.ndarray, ...]:
        """Each output's shards concatenated on the host: the JAX step's
        global outputs.  One copy per shard, made on the shard's stream."""
        parts = []
        for s, outs in enumerate(self.shards):
            with self.mesh.on(s):
                flat = torch.cat([o.reshape(-1).to(torch.int64)
                                  for o in outs]).cpu().numpy()
            cuts = np.cumsum([o.numel() for o in outs])[:-1]
            parts.append([
                p.reshape(o.shape).astype(
                    torch.empty(0, dtype=o.dtype).numpy().dtype)
                for p, o in zip(np.split(flat, cuts), outs)])
        return tuple(np.concatenate([p[k] for p in parts])
                     for k in range(len(parts[0])))


def _launch(mesh: Mesh, args, dtypes, local) -> ShardedOutput:
    """Run ``local`` on each shard's block of ``args`` (numpy arrays split
    here, or ShardedArrays already on the shards) under the shard's
    stream.  Reads nothing back."""
    if len(args) != len(dtypes):
        raise TypeError(f"expected {len(dtypes)} arrays, got {len(args)}")
    blocks = []
    for a in args:
        if isinstance(a, ShardedArray):
            if len(a.shards) != mesh.size:
                raise ValueError(f"a ShardedArray of {len(a.shards)} "
                                 f"shards on a mesh of {mesh.size}")
            blocks.append(a.shards)
        else:
            blocks.append(_blocks(np.asarray(a), mesh.size))
    outs = []
    for s, dev in enumerate(mesh.devices):
        with mesh.on(s):
            ins = []
            for blk, dt in zip((b[s] for b in blocks), dtypes):
                if isinstance(blk, torch.Tensor):
                    if blk.device != dev:
                        raise ValueError(f"shard {s} is on {blk.device}, "
                                         f"its mesh device is {dev}")
                    ins.append(blk.to(_TORCH_DTYPE[np.dtype(dt)]))
                else:
                    ins.append(to_device(blk, dev, dt))
            outs.append(tuple(local(*ins)))
    return ShardedOutput(mesh, outs)


def _windows_local(mesh: Mesh, num_windows: int) -> int:
    if num_windows % mesh.size:
        raise ValueError(f"num_windows {num_windows} not divisible by mesh "
                         f"size {mesh.size}")
    return num_windows // mesh.size


_I32 = np.int32
_WALK_DTYPES = (np.int8, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32)


def sharded_audit_step(mesh: Mesh, *, num_windows: int, K: int,
                       min_count: int = C.CONSENSUS_MIN_COUNT,
                       interval: int = C.CONSENSUS_INTERVAL,
                       range_: int = C.CONSENSUS_INTERVAL_RANGE,
                       sweep_width: int = 128):
    """The multi-device audit step for `mesh`.

    Expects batch arrays laid out shard-blockwise: reads axis N and window
    axis B both divisible by the mesh size, window_id *local to its
    shard's block* (padding reads use the local sentinel B//n).
    Returns fn(ops, lens, pos, n_ops, window_id, kind, istart, iend, ipos)
    -> ShardedOutput, whose gather() gives (refined [B], counts [B],
    overflow [B])."""
    b_loc = _windows_local(mesh, num_windows)

    def local(*a):
        return audit_refine_step(
            *a, num_windows=b_loc, K=K, min_count=min_count,
            interval=interval, range_=range_, sweep_width=sweep_width)

    return lambda *args: _launch(mesh, args, _WALK_DTYPES, local)


def sharded_audit_step_csr(mesh: Mesh, *, num_windows: int, K: int, O: int,
                           min_count: int = C.CONSENSUS_MIN_COUNT,
                           interval: int = C.CONSENSUS_INTERVAL,
                           range_: int = C.CONSENSUS_INTERVAL_RANGE,
                           sweep_width: int = 128):
    """The multi-device step for the flat (CSR) device-extract layout
    (ops.audit_step.AuditBatchCSR): each shard receives its own block of
    the flat op stream and scatters it into the padded [N_loc, O] matrices
    on its own device.

    Layout contract (pack.pack_chunk_native with n_shards > 1): every
    axis shard-blockwise, flat T, reads N, windows B all divisible by the
    mesh size; window_id shard-local with padding sentinel B_loc;
    per-shard flat tails beyond sum(local n_ops) are not read."""
    b_loc = _windows_local(mesh, num_windows)

    def local(*a):
        return audit_refine_step_csr(
            *a, num_windows=b_loc, K=K, O=O, min_count=min_count,
            interval=interval, range_=range_, sweep_width=sweep_width)

    return lambda *args: _launch(mesh, args, (np.uint8,) + _WALK_DTYPES[1:],
                                 local)


def sharded_consensus_step(mesh: Mesh, *, num_windows: int,
                           min_count: int = C.CONSENSUS_MIN_COUNT,
                           interval: int = C.CONSENSUS_INTERVAL,
                           range_: int = C.CONSENSUS_INTERVAL_RANGE,
                           sweep_width: int = 128):
    """The multi-device step for host-extracted candidate batches
    (pack.AuditBatchCand): the window axis of the consensus split across
    the mesh, one K1 launch per shard on a card.  Rows are independent
    windows, so the layout is the plain blockwise split.

    Returns fn(locs [B, K], counts [B], ipos [B]) -> ShardedOutput, whose
    gather() gives (refined [B], sweep_ovf [B])."""
    _windows_local(mesh, num_windows)

    def local(locs, counts, ipos):
        return consensus_pos_batch(
            locs, counts, ipos, min_count=min_count, interval=interval,
            range_=range_, sweep_width=sweep_width)

    return lambda *args: _launch(mesh, args, (_I32, _I32, _I32), local)


def sharded_disc_step(mesh: Mesh, *, min_len: int = 50, cap: int = 512):
    """Multi-device disc detection: the read axis of the projected-run scan
    (ops.discover.scan_projected_runs_compact) split across the mesh.

    Returns fn(ops [N, O], lens, n_runs, ref_start) -> ShardedOutput, with
    N divisible by the mesh size; padding rows use n_runs == 0 (no real
    runs, no breakpoints).  gather() gives per-shard compact blocks:
    totals [S], rows/types/refs/reads/lens [S * cap] with shard-LOCAL row
    indices (the caller adds s * (N/S)); a shard total > cap means the
    caller must rescan on the host."""

    def local(ops, lens, n_runs, ref_start):
        total, *rest = scan_projected_runs_compact(
            ops, lens, n_runs, ref_start, min_len=min_len, cap=cap)
        return (total.view(1), *rest)

    return lambda *args: _launch(mesh, args, (np.int8, _I32, _I32, _I32),
                                 local)


def make_sharded_demo_batch(num_devices: int, b_per_shard: int = 2,
                            reads_per_window: int = 4, O: int = 16,
                            seed: int = 0):
    """Synthetic shard-blockwise batch for dry runs and scaling tests
    (svtrek_tpu/parallel/mesh.py's, the same RNG calls and layout)."""
    rng = np.random.default_rng(seed)
    B = num_devices * b_per_shard
    N = B * reads_per_window
    ops = np.full((N, O), 9, np.int8)
    lens = np.zeros((N, O), np.int32)
    pos = np.zeros(N, np.int32)
    n_ops = np.zeros(N, np.int32)
    wid = np.zeros(N, np.int32)
    kind = np.zeros(B, np.int32)
    istart = np.zeros(B, np.int32)
    iend = np.zeros(B, np.int32)
    ipos = np.zeros(B, np.int32)
    r = 0
    for b in range(B):
        base = int(rng.integers(50_000, 90_000))
        kind[b] = C.KIND_DEL_START
        istart[b] = base - 2000
        iend[b] = base + 2000
        ipos[b] = base
        for _ in range(reads_per_window):
            start = base - int(rng.integers(200, 1200))
            cig = [(0, base - start + int(rng.integers(-2, 3))),
                   (2, 60), (0, 500)]
            ops[r, : len(cig)] = [o for o, _ in cig]
            lens[r, : len(cig)] = [l for _, l in cig]
            pos[r] = start
            n_ops[r] = len(cig)
            wid[r] = b % b_per_shard          # shard-local window id
            r += 1
    return ops, lens, pos, n_ops, wid, kind, istart, iend, ipos
