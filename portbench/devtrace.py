"""What the benchmark reads from a torch.profiler trace of its window.

The window is the benchmark's own `record_function` span WINDOW, on the
profiler's clock, which the device's events share.  The device is busy
where a kernel, a copy or a memset runs: the union of those intervals, so
that a kernel on a side stream or a copy beside a kernel counts once.
"""
from __future__ import annotations

from dataclasses import dataclass, field

WINDOW = "portbench.window"
SPANS = ("portbench.window", "portbench.pass")
TOP = 10


@dataclass
class Trace:
    """Device intervals and host spans of one traced window, in ns."""

    window: tuple[int, int]
    device: list[tuple[int, int, str]] = field(default_factory=list)
    host: list[tuple[int, int, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        return union_ns([(a, b) for a, b, _ in self.device],
                        *self.window) / 1e9

    def kernel_s(self, *names: str) -> float | None:
        """Device seconds of the kernels whose name contains one of
        ``names``, inside the window; None when none ran."""
        hit = [(a, b) for a, b, n in self.device if any(k in n for k in names)]
        if not hit:
            return None
        return sum(min(b, self.window[1]) - max(a, self.window[0])
                   for a, b in hit if b > self.window[0]
                   and a < self.window[1]) / 1e9

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest
        idle gaps named by the host span and host op under their middle."""
        by_name: dict[str, int] = {}
        for a, b, n in self.device:
            by_name[n] = by_name.get(n, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(gaps_ns([(a, b) for a, b, _ in self.device],
                              *self.window), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[_short(n), t / 1e9] for n, t in ops],
                "idle_gaps": [[self._host_at((a + b) // 2), (b - a) / 1e9]
                              for a, b in gaps]}

    def _host_at(self, t: int) -> str:
        span, op, op_len = "outside a pass", "", None
        for a, b, n in self.host:
            if a <= t < b:
                if n in SPANS:
                    if n != WINDOW:
                        span = n.split(".", 1)[1]
                elif op_len is None or b - a < op_len:
                    op, op_len = n, b - a
        return f"{span}: {_short(op) if op else 'host code, no torch op'}"


def _short(name: str) -> str:
    """A kernel's name without its argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:120]


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of [a, b) intervals, clipped to [lo, hi)."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps_ns(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end and end < hi:
            out.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out


def from_profiler(prof) -> Trace:
    """The window span, device activity and host ops of a finished
    torch.profiler.profile."""
    from torch.autograd import DeviceType

    window, device, host = None, [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        name = e.name()
        if name.startswith("portbench."):
            if name == WINDOW and e.device_type() == DeviceType.CPU:
                window = (a, b)
            elif e.device_type() == DeviceType.CPU:
                host.append((a, b, name))
            continue  # a span's mirror on the device's timeline is no work
        if e.device_type() == DeviceType.CUDA:
            device.append((a, b, name))
        else:
            host.append((a, b, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return Trace(window, device, host)
