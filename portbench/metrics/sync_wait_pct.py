"""sync_wait_pct: the share of the pass time the consumer thread waits in a
batch's device-to-host result copies (AuditStats.sync_wait_s, printed
`sync_wait=`): the time it waits for the card."""
from _stages import pct_of_passes


def read(run):
    return pct_of_passes(run, "sync_wait")
