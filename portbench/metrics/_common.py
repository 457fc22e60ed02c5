"""Arithmetic the metric readers share: sums over the window's passes."""


def total(run, key: str) -> float:
    """Sum of one --verbose number over the passes that printed it."""
    return sum(p.stats.get(key, 0.0) for p in run.passes)


def pass_seconds(run) -> float:
    return sum(p.seconds for p in run.passes)


def records_per_s(run) -> float:
    """Every record of every pass over the time of every pass."""
    return sum(p.operations for p in run.passes) / pass_seconds(run)

