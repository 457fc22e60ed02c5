"""Spans: the timers of the port's stages, which feed its `--verbose`
counters, and, where torch.profiler records the calling thread, named
ranges on the profiler's host timeline.

``with span(stats, field, name, **ids):`` adds the block's seconds to
``stats.<field>`` (to ``stats[field]`` where ``stats`` is a dict, as the
consensus's ``counts`` is; to nothing where it is None), under ``lock``
where pool threads share ``stats``.  With a ``name``, and a torch.profiler
running, the block is also a range of that name on the calling thread's
row, recorded where the profiler records that thread, with ``ids`` (the
batch index) as its inputs: a trace shows them where the profiler records
the calling thread alone with ``record_shapes=True`` (one that records
every thread drops a range's inputs).  A block that launches device work,
copies or synchronizes takes no name: Kineto can mirror a range that
encloses device work onto the device's timeline, where a reader of the
device's busy time would count it.  With no profiler running a span costs
a flag's read and two clock reads, and opens no range.

The flag is the process's: torch's per-thread check reads as off in every
thread of a profiler that records all threads (``profile_all_threads``),
the one it started in too.
"""
from __future__ import annotations

import time

from torch.autograd import profiler as _profiler


def profiler_range(name: str, ids: dict):
    """A torch.profiler range ``name`` with ``ids`` as its keyword inputs
    (torch.profiler.record_function drops its ``args`` string from the
    trace, and costs some 10 us a use where this costs 0.4)."""
    from torch._C._profiler import _RecordFunctionFast

    return _RecordFunctionFast(name, (), ids)


def add(stats, field: str, value, lock=None) -> None:
    """``stats.<field> += value`` (``stats[field]`` for a dict; nothing for
    None), under ``lock`` where one is given."""
    if stats is None:
        return
    if lock is not None:
        with lock:
            add(stats, field, value)
    elif isinstance(stats, dict):
        stats[field] = stats.get(field, 0) + value
    else:
        setattr(stats, field, getattr(stats, field) + value)


class span:
    """The timer, and the profiler range where one is recorded, of one
    stretch of a stage (see the module's docstring)."""

    __slots__ = ("stats", "field", "name", "lock", "ids", "t0", "rng")

    def __init__(self, stats, field: str, name: str | None = None, *,
                 lock=None, **ids):
        self.stats, self.field, self.name = stats, field, name
        self.lock, self.ids = lock, ids
        self.rng = None

    def __enter__(self):
        if self.name is not None and _profiler._is_profiler_enabled:
            self.rng = profiler_range(self.name, self.ids)
            self.rng.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rng is not None:
            self.rng.__exit__(*exc)
            self.rng = None
        add(self.stats, self.field, dt, self.lock)
        return False
