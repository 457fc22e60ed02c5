"""inflate_mb_per_rec: the BGZF bytes the producer pool inflates a record,
in MB (the C reader's count of inflated bytes; blocks served from a
reader's cache count nothing; AuditStats.inflated_bytes, printed
`inflated_mb=`)."""
from _stages import per


def read(run):
    return per(run, "inflated_mb", "records", 1.0)
