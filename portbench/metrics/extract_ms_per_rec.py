"""extract_ms_per_rec: the producer pool's time in the C evidence walk
a record, in ms (worker-seconds in `svbam_extract_batch`: the CIGAR walk,
the candidates' sort, the scalar consensus past K; AuditStats.extract_s,
printed `extract=`, span svtrek.extract; 0 on --extract device)."""
from _stages import per


def read(run):
    return per(run, "extract", "records")
