"""fetch_walk_ms_per_rec: the producer pool's worker time a record, in ms
(AuditStats.pack_s, printed `fetch+pack=`: the C fetch, BGZF inflate,
evidence walk and pack, summed over the -t workers)."""
from _common import total


def read(run):
    records = total(run, "records")
    if not records or not any("fetch+pack" in p.stats for p in run.passes):
        return None
    return total(run, "fetch+pack") * 1000.0 / records
