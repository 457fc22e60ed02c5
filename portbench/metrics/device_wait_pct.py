"""device_wait_pct: the share of the pass time the consumer thread spends
in collect (AuditStats.device_s, printed `device_wait=`), less the emit
and consensus time that runs inside it (`emit=`, which holds cons_s)."""
from _common import pass_seconds, total


def read(run):
    if not any("device_wait" in p.stats for p in run.passes):
        return None
    wait = max(0.0, total(run, "device_wait") - total(run, "emit"))
    return 100.0 * wait / pass_seconds(run)
