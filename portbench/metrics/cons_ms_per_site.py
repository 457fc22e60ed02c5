"""cons_ms_per_site: the ins consensus's time a site, in ms
(AuditStats.cons_s over cons_sites: SEQ fetch, voting and the POA batches)."""
from _common import total


def read(run):
    sites = total(run, "cons_sites")
    if not sites:
        return None
    return total(run, "cons_time") * 1000.0 / sites
