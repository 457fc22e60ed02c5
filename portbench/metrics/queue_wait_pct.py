"""queue_wait_pct: the share of the pass time the consumer thread (the one
that dispatches to the card) waits on the producer pool's queue
(AuditStats.queue_wait_s, printed `queue_wait=`; span svtrek.queue_wait)."""
from _stages import pct_of_passes


def read(run):
    return pct_of_passes(run, "queue_wait")
