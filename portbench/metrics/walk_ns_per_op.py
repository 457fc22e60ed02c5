"""walk_ns_per_op: the C evidence walk's time a CIGAR op, in ns
(`extract=` over `walk_ops=` of run_audit's `[VERBOSE] stages` line:
AuditStats.extract_s, the worker-seconds in `svbam_extract_batch`, over
AuditStats.walk_ops, the ops of the reads it hands its windows' walks, a
read once for each window it falls in; 0 where the walk took no op, as on
--extract device).  None where no pass printed `walk_ops` (a program
without it)."""
from _common import total
from _stages import printed


def read(run):
    if not printed(run, "walk_ops"):
        return None
    ops = total(run, "walk_ops")
    return total(run, "extract") * 1e9 / ops if ops else 0.0
