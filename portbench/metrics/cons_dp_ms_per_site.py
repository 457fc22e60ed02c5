"""cons_dp_ms_per_site: the ins consensus's DP batches a site, in ms (each
`banded_cols_batch` call: pad, copy in, K2 and K3, copy back and the
segments, on the host's clock; AuditStats.cons_dp_s, printed `dp_time=`)."""
from _stages import per


def read(run):
    return per(run, "cons_dp_time", "cons_sites")
