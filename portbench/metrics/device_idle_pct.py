"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset runs on the card (one minus the union of their intervals,
over the window's span on the profiler's clock)."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
