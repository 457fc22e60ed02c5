"""Arithmetic the stage readers share: one number of run_audit's
`[VERBOSE] stages` or `ins_consensus` line, summed over the window's
passes, and None where no pass printed it (a program without the stage
spans and counters)."""
from _common import pass_seconds, total


def printed(run, key: str) -> bool:
    return any(key in p.stats for p in run.passes)


def pct_of_passes(run, key: str):
    """100 × the seconds of ``key`` over the seconds of the passes."""
    if not printed(run, key):
        return None
    return 100.0 * total(run, key) / pass_seconds(run)


def per(run, key: str, base: str, scale: float = 1000.0):
    """``key`` × ``scale`` over the passes' count ``base`` (records,
    cons_sites); ms a record or a site for a time in seconds."""
    n = total(run, base)
    if not printed(run, key) or not n:
        return None
    return total(run, key) * scale / n
