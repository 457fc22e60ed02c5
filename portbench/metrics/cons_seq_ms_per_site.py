"""cons_seq_ms_per_site: the ins consensus's SEQ fetch a site, in ms (the
native `ins_seqs` calls of each flush; AuditStats.cons_seq_s, printed
`seq_time=` on the ins_consensus line; span svtrek.cons.seq)."""
from _stages import per


def read(run):
    return per(run, "cons_seq_time", "cons_sites")
