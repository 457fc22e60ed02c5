"""put_wait_pct: the share of the pass time the producer thread waits to
put a packed batch on the consumer's full queue (AuditStats.put_wait_s,
printed `put_wait=`): the pool waiting on the consumer."""
from _stages import pct_of_passes


def read(run):
    return pct_of_passes(run, "put_wait")
