"""audt_records_per_s: VCF records refined a second over the window's whole
passes (host clock; every record of every pass over all their time)."""
from _common import records_per_s


def read(run):
    return records_per_s(run)
