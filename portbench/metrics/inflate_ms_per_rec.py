"""inflate_ms_per_rec: the producer pool's time inside BGZF inflate a
record, in ms (worker-seconds; the C reader's clock around each block it
inflates, AuditStats.inflate_s, printed `inflate=`)."""
from _stages import per


def read(run):
    return per(run, "inflate", "records")
