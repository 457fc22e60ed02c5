"""cons_vote_ms_per_site: the ins consensus's host voting a site, in ms
(mode and seed selection, encode, accumulate and assemble of the star
consensus; AuditStats.cons_vote_s, printed `vote_time=`; span
svtrek.cons.vote)."""
from _stages import per


def read(run):
    return per(run, "cons_vote_time", "cons_sites")
