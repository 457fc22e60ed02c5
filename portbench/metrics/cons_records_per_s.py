"""cons_records_per_s: as audt_records_per_s, in a cell that runs
--ins-consensus (a metric of its own, with a bound of its own)."""
from _common import records_per_s


def read(run):
    return records_per_s(run)
