"""cons_inflate_ms_per_site: the consensus reader's time obtaining inflated
blocks a site, in ms (`inflate=` of run_audit's `[VERBOSE] ins_consensus`
line, read as `cons_inflate`: AuditStats.cons_inflate_s, zlib's time on a
block and the time around each staged slice's batch inflate, over
`cons_sites`); None where no pass printed it (a program without it)."""
from _stages import per


def read(run):
    return per(run, "cons_inflate", "cons_sites")
