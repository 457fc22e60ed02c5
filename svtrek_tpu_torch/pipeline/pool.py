"""The ordered, bounded reader pool of audt's producer and scan's native
path.

`reader_map(fn, items, n_workers, open_reader)` runs ``fn(item, reader)``
on ``n_workers`` threads, each with one private BAM reader (BGZF seek
state and the native fetch buffers are not shareable), which
``open_reader()`` opens, and stages, at the worker's first call.  The
results come back in the order of ``items``, with at most
``n_workers + 2`` calls in flight; the C fetch and extract release the GIL,
so the workers overlap each other and the caller.  Each call's reader
counters and time go to the caller's `PoolStats`.  When a call raises, or
the caller stops early, the calls not yet started are cancelled (a started
one runs to its end), and every reader the map opened is closed when it
ends, its staging buffers with it.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from ..native.bamlib import ReaderCounters


@dataclass
class PoolStats:
    """What a map's calls did, summed over its workers."""

    counters: ReaderCounters = field(default_factory=ReaderCounters)
    busy_s: float = 0.0  # the calls' time, worker-seconds
    tail_s: float = 0.0  # workers idle at the map's end: the last call's
                         # end less each worker's, summed


def reader_map(fn, items, n_workers: int, open_reader, *,
               stats: PoolStats | None = None):
    """Yield ``fn(item, reader)`` for each item, in order (see the
    module's docstring)."""
    stats = PoolStats() if stats is None else stats
    lock = threading.Lock()
    readers: dict[int, object] = {}   # worker thread → its reader
    last_end: dict[int, float] = {}   # worker thread → its last call's end

    def call(item):
        me = threading.get_ident()
        reader = readers.get(me)
        if reader is None:
            reader = open_reader()
            with lock:
                readers[me] = reader
        t0 = time.perf_counter()
        out = fn(item, reader)
        t1 = time.perf_counter()
        counters = reader.take_counters()
        with lock:
            stats.counters += counters
            stats.busy_s += t1 - t0
            last_end[me] = t1
        return out

    it = iter(items)
    ex = ThreadPoolExecutor(n_workers, thread_name_prefix="svtrek-pool")
    pending: deque = deque()
    try:
        pending.extend(ex.submit(call, x)
                       for x in itertools.islice(it, n_workers + 2))
        while pending:
            result = pending.popleft().result()
            for x in itertools.islice(it, 1):
                pending.append(ex.submit(call, x))
            yield result
    finally:
        for fut in pending:
            fut.cancel()
        ex.shutdown(wait=True)
        for reader in readers.values():
            reader.close()
        if last_end:
            end = max(last_end.values())
            stats.tail_s = sum(end - t for t in last_end.values())
