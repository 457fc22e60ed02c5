"""cons_vote_card_pct: the share of the star consensus's cluster-rounds
voted on the card, in % (100 x `vote_card` over `vote_rounds` of
run_audit's `[VERBOSE] ins_consensus` line, read as `cons_vote_card` and
`cons_vote_rounds`: AuditStats.cons_vote_card over
AuditStats.cons_vote_rounds).  How often kernel K5 engages; None where no
pass printed `vote_card` there (a program without it) or none voted."""
from _common import total
from _stages import printed


def read(run):
    rounds = total(run, "cons_vote_rounds")
    if not printed(run, "cons_vote_card") or not rounds:
        return None
    return 100.0 * (total(run, "cons_vote_card") / rounds)
